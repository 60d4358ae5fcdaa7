"""run_finetune_multimodal on the port against the JAX package's CLI. JAX is
imported inside the tests.

Both CLIs run on one synthetic clvts corpus (one word tokenizer for both)
with vis and audio features from .npy files, from one JAX-written trunk
checkpoint, at dropout 0, with JAX's fresh fusion initialisation carried
into the port through models/convert.py (strict). JAX's CLI sees one device
(its mesh monkeypatched to one CPU device): on the test process's 8 virtual
devices its batch would be 8 x the per-device batch. Every training batch
is equal, every epoch's losses agree within 1e-3 relative, and the eval
metrics are equal.

A modality whose features are all zero (a missing .npy) makes the
modality CL's gradient ill-conditioned in both packages: the LayerNorm of a
constant row has a 1 / sqrt(eps) = 1e6 slope and the normalisation of a
zero row 1 / eps = 1e8, so rounding noise decides Adam's next step. The
compared run therefore has every feature file; the zero fallback runs on
the port alone, in pretraining, where the missing modality reaches no loss
term.
"""

import json

import numpy as np
import pytest
import torch

CFG = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=48,
           max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)
SPECIAL = {"cls": 2, "pad": 0, "bos": 1, "sep": 3, "mask": 4, "vocab_size": CFG["vocab_size"]}
WORDS = ["intro", "topic", "shift", "detail", "recap", "slide", "proof", "lemma"]


def tokenize(s):
    return [5 + WORDS.index(w) * 7 % 50 for w in s.split()] or [5]


def write_video_corpus(root, n=6, seed=0, width=8):
    """clvts jsonl splits (5-8 clips a video, the last closing its topic,
    every second video with clip_end_seconds) and a vis and an audio .npy a
    video: (corpus dir, vis dir, audio dir)."""
    rng = np.random.default_rng(seed)
    d = root / "clvts"
    d.mkdir(exist_ok=True)
    for sub in ("vis", "audio"):
        (root / sub).mkdir(exist_ok=True)
    for split, cnt in (("train.jsonl", n), ("dev.jsonl", 2), ("test.jsonl", 2)):
        with open(d / split, "w") as f:
            for i in range(cnt):
                nc = int(rng.integers(5, 9))
                labels = [int(rng.random() < 0.4) for _ in range(nc)]
                labels[-1] = 1
                row = {"example_id": f"{split[:3]}{i}", "lecture": f"{split[:3]}{i}",
                       "text": [" ".join(rng.choice(WORDS, size=3)) for _ in range(nc)],
                       "labels": labels}
                if i % 2:
                    row["clip_end_seconds"] = np.cumsum(rng.uniform(5, 40, nc)).tolist()
                f.write(json.dumps(row) + "\n")
                for sub in ("vis", "audio"):
                    np.save(root / sub / f"{row['lecture']}.npy",
                            rng.normal(size=(nc, width)).astype(np.float32))
    return str(d), str(root / "vis"), str(root / "audio")


def _no_dropout(monkeypatch, *modules):
    import dataclasses

    for mod in modules:
        real = mod.build_configs

        def build(args, special, _real=real):
            enc, task, wcfg, tcfg = _real(args, special)
            return (dataclasses.replace(enc, hidden_dropout=0.0, attention_dropout=0.0), task,
                    wcfg, tcfg)

        monkeypatch.setattr(mod, "build_configs", build)
        monkeypatch.setattr(mod, "resolve_tokenizer", lambda args: (tokenize, dict(SPECIAL)))


def _run_both(tmp_path, monkeypatch, extra):
    """Both CLIs with ``extra`` flags: (JAX's results, the port's, and
    {"jax": [...], "port": [...]} of every training batch)."""
    import dataclasses

    import jax

    from spokennlp_tpu.cli import common as jcommon
    from spokennlp_tpu.cli import run_finetune_multimodal as jcli
    from spokennlp_tpu.configs import EncoderConfig as JEnc
    from spokennlp_tpu.models import checkpoint_io as jio
    from spokennlp_tpu.models import multimodal as jmm
    from spokennlp_tpu.models.encoder import Encoder as JEncoder
    from spokennlp_tpu.parallel import mesh as jmesh
    from spokennlp_tpu.projects import mmvts as jp
    from spokennlp_tpu_torch.cli import common as tcommon
    from spokennlp_tpu_torch.cli import run_finetune_multimodal as tcli
    from spokennlp_tpu_torch.models import multimodal as tmm
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.projects import mmvts as tp

    data, vis, audio = write_video_corpus(tmp_path)
    trunk_cfg = JEnc(**CFG, add_pooler=False)
    enc = JEncoder(trunk_cfg)
    ids = jax.numpy.ones((1, 8), jax.numpy.int32)
    trunk = jax.jit(enc.init)(jax.random.PRNGKey(3), ids)["params"]
    jio.save_checkpoint(str(tmp_path / "trunk"), trunk, trunk_cfg)

    _no_dropout(monkeypatch, jcommon, tcommon)
    for mod in (jmm, tmm):
        real = mod.MultimodalConfig
        monkeypatch.setattr(mod, "MultimodalConfig", lambda *a, _r=real, **kw:
                            dataclasses.replace(_r(*a, **kw), hidden_dropout=0.0,
                                                attention_dropout=0.0))
    monkeypatch.setattr(jmesh, "make_mesh",
                        lambda mp=1, devices=None: jmesh.Mesh(np.asarray(jax.devices()[:1])
                                                              .reshape(1, 1), ("data", "model")))
    captured = {}
    real_init = jp.MMVTSModel.init

    def recording_init(self, rng, *a, **kw):  # jitted: eagerly, 245 small compiles
        out = jax.jit(lambda r: real_init(self, r, *a, **kw))(rng)
        captured["fusion"] = jax.tree_util.tree_map(np.asarray, out["params"]["fusion"])
        return out

    monkeypatch.setattr(jp.MMVTSModel, "init", recording_init)
    batches = {"jax": [], "port": []}

    def recording(side, real):
        def make(*a, **kw):
            step = real(*a, **kw)

            def run(*sa):
                batch = sa[1] if side == "jax" else sa[0]
                batches[side].append({k: np.asarray(v.cpu() if side == "port" else v)
                                      for k, v in batch.items()})
                return step(*sa)
            return run
        return make

    for side, mod in (("jax", jp), ("port", tp)):
        monkeypatch.setattr(mod, "make_mmvts_train_step",
                            recording(side, mod.make_mmvts_train_step))
    argv = lambda out: ["--dataset_name", "clvts", "--data_dir", data, "--vis_feature_dir", vis,
                        "--audio_feature_dir", audio, "--output_dir", str(tmp_path / out),
                        "--model_name_or_path",
                        str(tmp_path / "trunk"), "--max_seq_length", "64",
                        "--max_clips_per_window", "8", "--mm_hidden_size", "16",
                        "--vis_hidden_size", "8", "--audio_hidden_size", "8",
                        "--num_cross_encoder_layers", "1", "--per_device_train_batch_size", "2",
                        "--gradient_accumulation_steps", "1", "--learning_rate", "1e-3",
                        "--num_train_epochs", "2", "--do_train", *extra]
    want = jcli.main(argv("jax"))

    real_model = tp.MMVTSModel

    class WithJaxFusion(real_model):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.fusion.load_state_dict(jax_params_to_state_dict(captured["fusion"]),
                                        strict=True)

    monkeypatch.setattr(tp, "MMVTSModel", WithJaxFusion)
    got = tcli.main(argv("port") + ["--device", "cpu"])
    return want, got, batches


def test_run_finetune_multimodal_matches_jax(tmp_path, monkeypatch):
    """ma_moe with the capacity dispatch, list-mode topic CL (near), modality
    CL over tv and av, the cat fuse of three modalities, the cross-encoder's
    own learning rate (Adam groups by path substring): batches (the
    host-sampled topic-CL indices among them), losses, eval metrics."""
    want, got, batches = _run_both(tmp_path, monkeypatch, [
        "--do_eval", "--cross_encoder_type", "ma_moe", "--moe_impl", "dispatch",
        "--do_modality_cl", "--align_pairs", "tv,av=0.5", "--do_topic_mm_cl",
        "--topic_cl_type", "list", "--topic_cl_choice", "near", "--topic_cl_neg_k", "2",
        "--cross_encoder_lr", "3e-3"])
    assert len(batches["port"]) == len(batches["jax"]) > 0
    for g, w in zip(batches["port"], batches["jax"]):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3, atol=1e-7, err_msg=k)
    assert {"topic_cl_anchor_valid", "vis_feats", "audio_feats"} <= batches["port"][0].keys()
    assert "moe_loss" in got["history"][-1] and "av_cl_loss" in got["history"][-1]
    assert got["eval"] == pytest.approx(want["eval"], abs=1e-12)
    saved = json.load(open(tmp_path / "port" / "mm_results.json"))
    assert saved["eval"] == pytest.approx(got["eval"], abs=1e-12)


def test_pretrain_mode_on_the_port(tmp_path, monkeypatch):
    """--do_pretrain (the alignment InfoNCE alone: its step against JAX's in
    tests/test_torch_mmvts.py) on make_optimizer's AdamW with a missing
    audio file (zeros, reaching no loss term): finite losses, no ts loss,
    no eval."""
    from spokennlp_tpu_torch.cli import common as tcommon
    from spokennlp_tpu_torch.cli import run_finetune_multimodal as tcli

    monkeypatch.setattr(tcommon, "resolve_tokenizer", lambda args: (tokenize, dict(SPECIAL)))
    data, vis, _ = write_video_corpus(tmp_path)
    got = tcli.main(["--dataset_name", "clvts", "--data_dir", data, "--vis_feature_dir", vis,
                     "--audio_feature_dir", str(tmp_path / "none"), "--output_dir",
                     str(tmp_path / "o"), "--hidden_size", "32", "--num_hidden_layers", "1",
                     "--num_attention_heads", "2", "--intermediate_size", "48",
                     "--max_seq_length", "64", "--max_clips_per_window", "8",
                     "--mm_hidden_size", "16", "--vis_hidden_size", "8",
                     "--num_train_epochs", "1", "--do_train", "--do_eval", "--do_pretrain",
                     "--align_pairs", "tv", "--device", "cpu"])
    last = got["history"][-1]
    assert "eval" not in got and last["ts_loss"] == 0.0 and np.isfinite(last["total_loss"])


def test_multimodal_cli_runs_in_one_process(tmp_path, monkeypatch):
    """Modality InfoNCE and the matrix topic CL take negatives across the
    whole batch: under a world size above 1 or a model-parallel size above
    1 the CLI raises and names the ROADMAP item; without a card the default
    device raises."""
    from spokennlp_tpu_torch.cli import run_finetune_multimodal as tcli

    base = ["--data_dir", str(tmp_path), "--dataset_name", "clvts", "--output_dir",
            str(tmp_path / "o"), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="item 4"):
        tcli.main(base + ["--model_parallel_size", "2"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="data parallel for MMVTS"):
        tcli.main(base)
    monkeypatch.delenv("WORLD_SIZE")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(base[:-2])


@pytest.mark.gpu
def test_multimodal_cli_on_the_card(tmp_path, monkeypatch):
    """The port's CLI on the card at small widths: rows 10 and 11 train the
    dense trunk, kernel 3 evaluates (auto); finite losses and metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from spokennlp_tpu_torch.cli import common as tcommon
    from spokennlp_tpu_torch.cli import run_finetune_multimodal as tcli
    from spokennlp_tpu_torch.ops.cuda import stack_block, train_blocks

    monkeypatch.setattr(tcommon, "resolve_tokenizer", lambda args: (tokenize, dict(SPECIAL)))
    data, vis, _ = write_video_corpus(tmp_path)
    for fn in (train_blocks.attention_train_fwd, stack_block.fused_encoder_stack):
        fn.launches = 0
    res = tcli.main(["--dataset_name", "clvts", "--data_dir", data, "--vis_feature_dir", vis,
                     "--output_dir", str(tmp_path / "o"), "--do_train", "--do_eval",
                     "--hidden_size", "64", "--num_hidden_layers", "2",
                     "--num_attention_heads", "2", "--intermediate_size", "128",
                     "--max_seq_length", "64", "--max_clips_per_window", "8",
                     "--mm_hidden_size", "32", "--vis_hidden_size", "8",
                     "--cross_encoder_type", "ma_moe", "--moe_impl", "dispatch",
                     "--num_train_epochs", "1", "--gradient_accumulation_steps", "1"])
    assert train_blocks.attention_train_fwd.launches > 0
    assert stack_block.fused_encoder_stack.launches > 0
    assert all(np.isfinite(v) for v in res["history"][-1].values())
    assert np.isfinite(res["eval"]["clip_f1"])
