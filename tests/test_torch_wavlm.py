"""WavLM / HuBERT feature extraction and the SLD pipeline on the port
against the JAX package: ``models/wavlm.py``, ``projects/sld_pipeline.py``
and ``cli/run_sld_pipeline.py``. JAX and transformers are imported inside
the tests.

Sizes: width 32, 2 layers, 2 heads, two convolutions of 8 channels, a
positional conv of 16 taps in 4 groups (even: the trim runs), 32 buckets.
HF directories are written by ``transformers`` at random (safetensors) and
read by the port without it; JAX converts the same weights from HF's state
dict. Every hidden state agrees within 1e-4 (absolute and relative: float32
convolutions and products in another order) with JAX's, and within 3e-4 /
1e-3 with HF's own (JAX's own limits against HF); the pipeline's features
within 1e-4 and its manifests, tokens, BPE merges and joined files equal
JAX's.
"""

import json
import os
import wave as wavemod

import numpy as np
import pytest
import torch

# transformers without its TensorFlow half (nothing here needs it; its
# import alone takes seconds)
os.environ.setdefault("USE_TF", "0")

transformers = pytest.importorskip("transformers")

WIDTHS = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
              conv_dim=(8, 8), conv_kernel=(4, 2), conv_stride=(2, 2),
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def _hf_model(kind: str, seed: int = 0):
    torch.manual_seed(seed)
    stable = kind == "stable"
    norm = dict(conv_bias=stable, feat_extract_norm="layer" if stable else "group",
                do_stable_layer_norm=stable)
    if kind == "hubert":
        return transformers.HubertModel(transformers.HubertConfig(**WIDTHS, **norm)).eval()
    return transformers.WavLMModel(transformers.WavLMConfig(
        **WIDTHS, **norm, num_buckets=32, max_bucket_distance=50)).eval()


def _jax_features(hf, kind, wave):
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models import wavlm as jw

    to_cfg = jw.hf_hubert_config_to_config if kind == "hubert" else jw.hf_wavlm_config_to_config
    cfg = to_cfg(hf.config)
    params = jw.hf_wavlm_to_params({k: v.detach().numpy() for k, v in hf.state_dict().items()},
                                   cfg)
    model = jw.WavLMModel(cfg)
    out = jax.jit(lambda p, w: model.apply({"params": p}, w, output_hidden_states=True))(
        params, jnp.asarray(wave))
    return cfg, params, [np.asarray(h) for h in out["hidden_states"]]


def _port_model(path):
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.models.wavlm import WavLMModel, read_wavlm_checkpoint

    cfg, params = read_wavlm_checkpoint(str(path))
    model = WavLMModel(cfg)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("kind", ["base", "stable", "hubert"])
def test_features_from_an_hf_directory_match_jax_and_hf(kind, tmp_path):
    hf = _hf_model(kind)
    hf.save_pretrained(tmp_path / kind)
    wave = (0.1 * np.random.default_rng(1).normal(size=(2, 400))).astype(np.float32)
    model = _port_model(tmp_path / kind)
    assert model.cfg.use_rel_pos_bias == (kind != "hubert")
    with torch.no_grad():
        got = model(torch.from_numpy(wave), output_hidden_states=True)["hidden_states"]
        want_hf = hf(torch.from_numpy(wave), output_hidden_states=True).hidden_states
    _, _, want = _jax_features(hf, kind, wave)
    assert len(got) == len(want) == 3
    for i, (g, w, h) in enumerate(zip(got, want, want_hf)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4, err_msg=f"layer {i}")
        np.testing.assert_allclose(g.numpy(), h.numpy(), atol=3e-4, rtol=1e-3,
                                   err_msg=f"layer {i} against HF")


def test_flax_tree_loads_strictly_and_exports_to_hf(tmp_path):
    """JAX's tree (its HF conversion, conv kernels in Flax's (k, in, out))
    loads into the port with strict=True; the port's state dict goes back to
    the same tree; params_to_hf_wavlm writes a directory that transformers
    loads to the same features."""
    from spokennlp_tpu_torch.cli.hf_checkpoint import write_safetensors
    from spokennlp_tpu_torch.models import checkpoint_io
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.models.wavlm import WavLMModel, params_to_hf_wavlm

    hf = _hf_model("base", seed=3)
    wave = (0.1 * np.random.default_rng(4).normal(size=(1, 300))).astype(np.float32)
    jcfg, params, want = _jax_features(hf, "base", wave)
    from spokennlp_tpu_torch.models.wavlm import WavLMConfig

    cfg = WavLMConfig(**{f: getattr(jcfg, f) for f in WavLMConfig.__dataclass_fields__})
    model = WavLMModel(cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    assert tuple(model.feature_extractor.conv_0.kernel.shape) == (8, 1, 4)  # Conv1d's layout
    back = checkpoint_io.params_from_state_dict(model.state_dict())
    flat_back, flat = jax_params_to_state_dict(back), jax_params_to_state_dict(params)
    assert set(flat_back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(flat_back[k].numpy(), flat[k].numpy(), err_msg=k)

    out = tmp_path / "export"
    out.mkdir()
    hf.config.save_pretrained(out)
    write_safetensors(str(out / "model.safetensors"),
                      {k: torch.from_numpy(v) for k, v in params_to_hf_wavlm(back, cfg).items()})
    again = transformers.WavLMModel.from_pretrained(out).eval()
    with torch.no_grad():
        h = again(torch.from_numpy(wave), output_hidden_states=True).hidden_states
        mine = model.eval()(torch.from_numpy(wave), output_hidden_states=True)["hidden_states"]
    for i, (g, w, x) in enumerate(zip(mine, want, h)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4, err_msg=f"layer {i}")
        np.testing.assert_allclose(x.numpy(), w, atol=3e-4, rtol=1e-3, err_msg=f"HF layer {i}")


def test_chunked_extraction_matches_jax(tmp_path):
    """extract_wavlm_features streams chunks alone and drops a tail shorter
    than the first kernel, as JAX does: 300 samples in chunks of 128 are
    two chunks (the tail of 44 < 4 would be kept; 2 is dropped at 258)."""
    from spokennlp_tpu.models import wavlm as jw
    from spokennlp_tpu_torch.models.wavlm import extract_wavlm_features

    hf = _hf_model("stable", seed=5)
    hf.save_pretrained(tmp_path / "m")
    model = _port_model(tmp_path / "m")
    wave = (0.1 * np.random.default_rng(6).normal(size=(1, 258))).astype(np.float32)
    cfg, params, _ = _jax_features(hf, "stable", wave)
    want = jw.extract_wavlm_features(jw.WavLMModel(cfg), params, wave, layer=1,
                                     chunk_samples=128)
    got = extract_wavlm_features(model, wave, layer=1, chunk_samples=128)
    assert got.shape == want.shape and got.shape[1] == 2 * 31
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _write_audio(root):
    audio = root / "audio"
    audio.mkdir()
    words = ["yes", "no", "maybe"]
    lines = []
    t = np.linspace(0, 0.2, 3200)
    for i in range(6):
        wav = (0.3 * np.sin(2 * np.pi * (100 + 60 * i) * t)).astype(np.float32)
        with wavemod.open(str(audio / f"utt{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((wav * 32767).astype(np.int16).tobytes())
        lines.append(f"utt{i}\t{words[i % 3]} {words[(i + 1) % 3]}")
    (root / "trans.tsv").write_text("\n".join(lines))
    return audio


def test_run_sld_stages_match_jax(tmp_path):
    """Stages 1-6 on six synthetic 16 kHz waves, speeds 0.9 and 1.0, the
    WavLM of an HF directory (JAX: the Flax model on HF's weights; the
    port: its own reader and model on the CPU): features within 1e-4;
    manifests, labels, k-means tokens, joined files and BPE merges equal.
    Then the port's CLI runs stage 7 (run_sld, one epoch) on its own
    outputs."""
    from spokennlp_tpu.projects.sld_pipeline import run_sld_stages as jstages
    from spokennlp_tpu_torch.cli import run_sld_pipeline
    from spokennlp_tpu_torch.projects.sld_pipeline import run_sld_stages as tstages

    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.models import wavlm as jw

    hf = _hf_model("base", seed=7)
    hf.save_pretrained(tmp_path / "wavlm")
    cfg = jw.hf_wavlm_config_to_config(hf.config)
    params = jw.hf_wavlm_to_params({k: v.detach().numpy() for k, v in hf.state_dict().items()},
                                   cfg)
    # JAX's default stage-2 tap (extract_wavlm_features at layer 2), jitted
    # once for every wave length
    run = jax.jit(lambda p, w: jw.WavLMModel(cfg).apply({"params": p}, w,
                                                        output_hidden_states=True)["hidden_states"][2])
    audio = _write_audio(tmp_path)
    common = dict(audio_dir=str(audio), transcript_file=str(tmp_path / "trans.tsv"),
                  speeds=(0.9, 1.0), layer=2, model_name=str(tmp_path / "wavlm"),
                  n_clusters=6, valid_percent=0.34, seed=0, bpe_vocab_size=40)
    jstages(work_dir=str(tmp_path / "j"), start_stage=1, stop_stage=6,
            feature_fn=lambda w: np.asarray(run(params, jnp.asarray(w[None])))[0], **common)
    tstages(work_dir=str(tmp_path / "t"), start_stage=1, stop_stage=6, device="cpu", **common)
    for f in sorted((tmp_path / "j" / "feats").iterdir()):
        np.testing.assert_allclose(np.load(tmp_path / "t" / "feats" / f.name), np.load(f),
                                   atol=1e-4, rtol=1e-4, err_msg=f.name)
    for name in ("manifests.json", "speech_tokens.json", "train.jsonl", "valid.jsonl",
                 "bpe_merges.txt"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text(), name

    train_args = {"vocab_size_speech": 8, "block_size": 48, "max_text_length": 8,
                  "per_device_train_batch_size": 2, "num_train_epochs": 1, "hidden_size": 16,
                  "num_hidden_layers": 1, "num_attention_heads": 2, "decode_max_len": 48}
    state = run_sld_pipeline.main([
        "--audio_dir", str(audio), "--transcript_file", str(tmp_path / "trans.tsv"),
        "--work_dir", str(tmp_path / "t"), "--start_stage", "7", "--stop_stage", "7",
        "--train_args", json.dumps(train_args), "--device", "cpu"])
    res = state["train_result"]
    assert len(res["history"]) == 1 and np.isfinite(res["history"][0]["train_loss"])
    assert (tmp_path / "t" / "train_out" / "sld_results.json").exists()


# ---------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_features_on_card_match_the_cpu(cuda):
    """A WavLM of width 256 (4 layers, the large variant's stable LN and
    conv norm) on the card: every hidden state of a 1 s wave within 1e-4 of
    the CPU's, relative to its largest value."""
    from spokennlp_tpu_torch.models.wavlm import WavLMConfig, WavLMModel, extract_wavlm_features

    cfg = WavLMConfig(hidden_size=256, num_layers=4, num_heads=4, intermediate_size=1024,
                      conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True)
    cpu = WavLMModel(cfg, generator=torch.Generator().manual_seed(0)).eval()
    card = WavLMModel(cfg)
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda)
    wave = (0.1 * np.random.default_rng(3).normal(size=(1, 16000))).astype(np.float32)
    for layer in range(cfg.num_layers + 1):
        got = extract_wavlm_features(card, wave, layer)
        want = extract_wavlm_features(cpu, wave, layer)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), layer
