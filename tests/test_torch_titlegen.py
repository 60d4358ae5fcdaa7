"""MUG Track 3 on the port against the JAX package: ``models/seq2seq.py``,
``models/palm.py`` and ``cli/run_title_generation.py``. JAX is imported
inside the tests.

Sizes: encoder width 32 (and 48 under a decoder of 32, which adds
``enc_proj``), 2 encoder and 2 decoder layers, 2 heads, vocabulary 40,
sources of 24 tokens, titles of 8. Parameters come from Flax's init and load
with ``strict=True``. In float32 the logits and log-probabilities agree
within 2e-5 (sums in another order; PALM's copy mass is a scatter here, a
one-hot einsum in JAX) and the losses within 1e-5 relative; greedy and beam
tokens are equal. EOS is made likelier (the tied embedding's row scaled,
PALM's generator bias raised) so that beams finish at different steps and
the pad-only extension, the frozen lengths and the early break all run.
"""

import json

import numpy as np
import pytest
import torch

V, S, T, B = 40, 24, 8, 3
ENC = dict(vocab_size=V, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
           max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0,
           add_pooler=False)
DEC = dict(vocab_size=V, hidden_size=32, num_decoder_layers=2, num_heads=2,
           intermediate_size=64, max_target_length=T, dropout=0.0, bos_token_id=1,
           eos_token_id=2, pad_token_id=0)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, V, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 17:] = 0
    mask[2, 9:] = 0
    ids[mask == 0] = 0
    dec = rng.integers(3, V, size=(B, T)).astype(np.int32)
    dec[:, 0] = 1
    dec_mask = np.ones((B, T), np.int32)
    dec_mask[1, 5:] = 0
    labels = np.where(dec_mask == 1, np.roll(dec, -1, axis=1), -100).astype(np.int32)
    labels[:, -1] = 2
    return {"input_ids": ids, "attention_mask": mask, "decoder_input_ids": dec,
            "decoder_attention_mask": dec_mask, "labels": labels}


def _models(arch, enc_width=32, eos_scale=4.0):
    """The JAX model, its params (EOS made likelier: the tied embedding's
    row scaled, or PALM's generator bias raised) and the port's model
    carrying them."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.configs import EncoderConfig as JEnc
    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict

    enc = dict(ENC, hidden_size=enc_width)
    if arch == "palm":
        from spokennlp_tpu.models import palm as jm
        from spokennlp_tpu_torch.models import palm as tm

        jmodel = jm.PalmModel(JEnc(**enc), jm.PalmConfig(**DEC))
        tmodel = tm.PalmModel(EncoderConfig(**enc), tm.PalmConfig(**DEC))
    else:
        from spokennlp_tpu.models import seq2seq as jm
        from spokennlp_tpu_torch.models import seq2seq as tm

        jmodel = jm.Seq2SeqModel(JEnc(**enc), jm.Seq2SeqConfig(**DEC))
        tmodel = tm.Seq2SeqModel(EncoderConfig(**enc), tm.Seq2SeqConfig(**DEC))
    x = _inputs()
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x["input_ids"]),
                         jnp.asarray(x["attention_mask"]),
                         jnp.asarray(x["decoder_input_ids"]))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    eos = DEC["eos_token_id"]
    if arch == "palm":  # the generator's EOS logit
        gen = {k: v.copy() for k, v in params["generator"].items()}
        gen["bias"][eos] += eos_scale
        params = {**params, "generator": gen}
    else:  # the tied table's EOS row
        emb = params["dec_embed"]["embedding"].copy()
        emb[eos] *= eos_scale
        params = {**params, "dec_embed": {"embedding": emb}}
    tmodel.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jmodel, params, tmodel.eval()


def _torch(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


@pytest.mark.parametrize("arch,enc_width", [("seq2seq", 32), ("seq2seq", 48), ("palm", 32)])
def test_forward_and_loss_match_jax(arch, enc_width):
    import jax.numpy as jnp

    jmodel, params, tmodel = _models(arch, enc_width)
    x = _inputs(1)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    jout = jmodel.apply({"params": params}, jx["input_ids"], jx["attention_mask"],
                        jx["decoder_input_ids"],
                        decoder_attention_mask=jx["decoder_attention_mask"])
    tx = _torch(x)
    with torch.no_grad():
        tout = tmodel(tx["input_ids"], tx["attention_mask"], tx["decoder_input_ids"],
                      decoder_attention_mask=tx["decoder_attention_mask"])
    keys = ("logits", "log_probs", "p_copy") if arch == "palm" else ("logits",)
    for k in keys:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=2e-5, rtol=2e-5,
                                   err_msg=k)
    if arch == "palm":
        from spokennlp_tpu.models.palm import palm_loss as jloss
        from spokennlp_tpu_torch.models.palm import palm_loss as tloss
    else:
        from spokennlp_tpu.models.seq2seq import seq2seq_loss as jloss
        from spokennlp_tpu_torch.models.seq2seq import seq2seq_loss as tloss
    want = float(jloss(jmodel, params, jx))
    with torch.no_grad():
        got = float(tloss(tmodel, tx))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if arch == "seq2seq":
        names = [k for k in tmodel.state_dict() if k.startswith("dec_embed")]
        assert names == ["dec_embed.embedding"]  # the LM head is the tied table
        assert ("enc_proj.kernel" in tmodel.state_dict()) == (enc_width != 32)


@pytest.mark.parametrize("arch,num_beams", [("seq2seq", 1), ("seq2seq", 3), ("palm", 3)])
def test_decoded_tokens_match_jax(arch, num_beams):
    import jax.numpy as jnp

    jmodel, params, tmodel = _models(arch)
    x = _inputs(2)
    ids, mask = jnp.asarray(x["input_ids"]), jnp.asarray(x["attention_mask"])
    if arch == "palm":
        from spokennlp_tpu.models.palm import palm_beam_decode as jbeam
        from spokennlp_tpu_torch.models.palm import palm_beam_decode as tbeam
    else:
        from spokennlp_tpu.models.seq2seq import beam_decode as jbeam
        from spokennlp_tpu.models.seq2seq import greedy_decode as jgreedy
        from spokennlp_tpu_torch.models.seq2seq import beam_decode as tbeam
        from spokennlp_tpu_torch.models.seq2seq import greedy_decode as tgreedy
    want = np.asarray(jbeam(jmodel, params, ids, mask, num_beams=num_beams))
    got = tbeam(tmodel, torch.from_numpy(x["input_ids"]), torch.from_numpy(x["attention_mask"]),
                num_beams=num_beams).numpy()
    np.testing.assert_array_equal(got, want)
    eos = DEC["eos_token_id"]
    # beams that finished early (pad after EOS) and, at one beam, greedy too
    assert (got[:, 1:-1] == eos).any()
    if arch == "seq2seq" and num_beams == 1:
        greedy = tgreedy(tmodel, torch.from_numpy(x["input_ids"]),
                         torch.from_numpy(x["attention_mask"])).numpy()
        np.testing.assert_array_equal(greedy, np.asarray(jgreedy(jmodel, params, ids, mask)))
        np.testing.assert_array_equal(greedy, got)


def _corpus(root, n_meetings=3, seed=0):
    rng = np.random.default_rng(seed)
    chars = list("预算方案讨论设计评审会议进度安排")
    rows = []
    for i in range(n_meetings):
        n = 12
        sents = [{"id": j + 1, "s": "".join(rng.choice(chars, size=int(rng.integers(3, 9))))}
                 for j in range(n)]
        topics = [{"id": end, "candidate": [
            {"title": "".join(rng.choice(chars, size=int(rng.integers(2, 5))))},
            {"title": "".join(rng.choice(chars, size=3))}]} for end in (4, 8, 12)]
        rows.append({"meeting_key": f"M{i}", "sentences": sents, "topic_segment_ids": topics})
    root.mkdir(parents=True, exist_ok=True)
    for name, part in (("train.jsonl", rows), ("dev.jsonl", rows[:1])):  # one decode batch
        with open(root / name, "w") as f:
            for r in part:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")


@pytest.mark.parametrize("arch", ["seq2seq", "palm"])
def test_run_title_generation_matches_jax(tmp_path, monkeypatch, arch):
    """Both CLIs on one corpus at dropout 0 from the same parameters (JAX's
    init, handed to the port's model): every batch each feeds its train
    step equal (the port's featuriser and shuffle against JAX's), per-epoch
    losses within 1e-4 relative (Adam on the noam rate after clipping,
    float32 sums in another order), and the decoded titles and rouge
    equal."""
    import dataclasses

    import jax

    from spokennlp_tpu import configs as jconf
    from spokennlp_tpu.cli import run_title_generation as jcli
    from spokennlp_tpu.models import palm as jpalm
    from spokennlp_tpu.models import seq2seq as js2s
    from spokennlp_tpu_torch import configs as tconf
    from spokennlp_tpu_torch.cli import run_title_generation as tcli
    from spokennlp_tpu_torch.models import palm as tpalm
    from spokennlp_tpu_torch.models import seq2seq as ts2s
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict

    _corpus(tmp_path)
    argv = lambda out: ["--train_file", str(tmp_path / "train.jsonl"), "--eval_file",
                        str(tmp_path / "dev.jsonl"), "--output_dir", str(tmp_path / out),
                        "--max_source_length", "48", "--max_target_length", "6",
                        "--per_device_train_batch_size", "4", "--num_train_epochs", "2",
                        "--num_beams", "2", "--hidden_size", "32", "--num_hidden_layers", "1",
                        "--num_decoder_layers", "1", "--num_attention_heads", "2",
                        "--intermediate_size", "64", "--warmup_steps", "2",
                        "--clip_grad_norm", "1.0", "--model_arch", arch]
    # dropout 0 on both sides (the CLIs have no dropout flag)
    for mod, name in ((jpalm, "PalmConfig"), (tpalm, "PalmConfig"), (js2s, "Seq2SeqConfig"),
                      (ts2s, "Seq2SeqConfig")):
        monkeypatch.setattr(mod, name, lambda *a, _c=getattr(mod, name), **kw:
                            dataclasses.replace(_c(*a, **kw), dropout=0.0))
    for conf in (jconf, tconf):
        monkeypatch.setattr(conf, "EncoderConfig", lambda *a, _c=conf.EncoderConfig, **kw: _c(
            *a, **{**kw, "hidden_dropout": 0.0, "attention_dropout": 0.0}))
    seen = {"jax": [], "port": []}
    jmodel_cls = jpalm.PalmModel if arch == "palm" else js2s.Seq2SeqModel
    real_init, real_jit = jmodel_cls.init, jax.jit

    def recording_init(self, *a, **kw):
        out = real_init(self, *a, **kw)
        seen["params"] = jax.tree_util.tree_map(np.asarray, out["params"])
        return out

    def recording_jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") != "train_step":
            return jitted

        def call(state, batch, rng):
            seen["jax"].append({k: np.asarray(v) for k, v in batch.items()})
            return jitted(state, batch, rng)

        return call

    monkeypatch.setattr(jmodel_cls, "init", recording_init)
    monkeypatch.setattr(jax, "jit", recording_jit)
    want = jcli.main(argv("jax"))
    monkeypatch.setattr(jax, "jit", real_jit)

    real_build, real_step = tcli.build_model, tcli.make_title_train_step

    def build_from_jax(*a, **kw):
        model, loss_fn, decode_fn = real_build(*a, **kw)
        model.load_state_dict(jax_params_to_state_dict(seen["params"]), strict=True)
        return model, loss_fn, decode_fn

    def recording_step(*a, **kw):
        step = real_step(*a, **kw)

        def call(batch):
            seen["port"].append({k: v.numpy() for k, v in batch.items()})
            return step(batch)

        return call

    monkeypatch.setattr(tcli, "build_model", build_from_jax)
    monkeypatch.setattr(tcli, "make_title_train_step", recording_step)
    got = tcli.main(argv("port") + ["--device", "cpu"])

    assert len(seen["port"]) == len(seen["jax"]) == 2 * 3  # 9 topics, batches of 4
    for g, w in zip(seen["port"], seen["jax"]):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    gl = [h["train_loss"] for h in got["history"]]
    wl = [h["train_loss"] for h in want["history"]]
    np.testing.assert_allclose(gl, wl, rtol=1e-4)
    assert ((tmp_path / "port" / "track3_submission.json").read_text()
            == (tmp_path / "jax" / "track3_submission.json").read_text())
    for k in ("rouge1", "rougeL"):
        np.testing.assert_allclose(got["final"][k], want["final"][k], rtol=1e-9)


def test_palm_checkpoint_loads_as_in_jax(tmp_path):
    """--palm_checkpoint: a ModelScope palm_v2 state dict (tests/test_palm.py's
    random one, a real HF BertModel for the encoder) saved as
    pytorch_model.bin; the port's CLI model built from it gives JAX's
    log-probabilities (JAX's palm_to_params on the same dict) within 2e-5,
    its vocabulary and positions taken from the checkpoint's tables."""
    import jax.numpy as jnp

    from spokennlp_tpu.models import hf_convert as jconv
    from spokennlp_tpu.models.palm import PalmModel as JPalm
    from spokennlp_tpu_torch.cli import run_title_generation as tcli
    from test_palm import CFG as JCFG, DEC_LAYERS, ENC_CFG as JENC, _make_state_dict

    sd, _ = _make_state_dict(np.random.default_rng(0))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "pytorch_model.bin")
    args = tcli.make_parser().parse_args([
        "--train_file", "-", "--eval_file", "-", "--output_dir", str(tmp_path / "o"),
        "--model_arch", "palm", "--palm_checkpoint", str(tmp_path),
        "--hidden_size", str(JENC.hidden_size), "--num_hidden_layers", str(JENC.num_layers),
        "--num_decoder_layers", str(DEC_LAYERS), "--num_attention_heads", str(JENC.num_heads),
        "--intermediate_size", str(JENC.intermediate_size), "--max_target_length", "16",
        "--device", "cpu"])
    model, _, _ = tcli.build_model(args, 7, 0, 101, 102, "cpu")  # 7: a corpus's small vocab
    assert model.cfg.vocab_size == JCFG.vocab_size
    assert model.enc_cfg.max_position_embeddings == JENC.max_position_embeddings
    rng = np.random.default_rng(1)
    src = rng.integers(1, JCFG.vocab_size, size=(2, 20)).astype(np.int32)
    mask = np.ones((2, 20), np.int32)
    mask[1, 15:] = 0
    tgt = rng.integers(1, JCFG.vocab_size, size=(2, 8)).astype(np.int32)
    want = JPalm(JENC, JCFG).apply({"params": jconv.palm_to_params(sd, JENC, DEC_LAYERS)},
                                   jnp.asarray(src), jnp.asarray(mask), jnp.asarray(tgt))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(src), torch.from_numpy(mask), torch.from_numpy(tgt))
    np.testing.assert_allclose(got["log_probs"].numpy(), np.asarray(want["log_probs"]),
                               atol=2e-5, rtol=2e-5)


def test_run_title_generation_wants_a_card_by_default(tmp_path):
    from spokennlp_tpu_torch.cli import run_title_generation as tcli

    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    _corpus(tmp_path, n_meetings=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--train_file", str(tmp_path / "train.jsonl"), "--eval_file",
                   str(tmp_path / "dev.jsonl"), "--output_dir", str(tmp_path / "o")])
