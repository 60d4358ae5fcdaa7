"""MUG Track 4 on the port against the JAX package: the BERT-CRF tagger
(``projects/mug/keyphrase.py``) and ``cli/run_mug.py --track keyphrase``.
JAX is imported inside the tests.

Sizes: BERT of width 32, 2 layers, 2 heads, 32-64 positions; a corpus of
three meetings of 16 sentences, one of them empty (an all-padding row whose
position 0 is masked). At dropout 0 the tagger's emissions agree within
1e-5 and its loss and every gradient within 1e-4 relative to the largest
(float32 sums in another order); Viterbi tags are equal. The two CLIs, from
one JAX-written tagger checkpoint, feed equal batches, their per-step
training losses agree within 1e-3 relative (AdamW steps in float32 summed
in another order, as for Tracks 1 and 2) and their submissions are
identical.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_mug import VOCAB, WORDS

CFG = dict(vocab_size=len(VOCAB), hidden_size=32, num_layers=2, num_heads=2,
           intermediate_size=64, max_position_embeddings=64, hidden_dropout=0.0,
           attention_dropout=0.0, add_pooler=False, pad_token_id=0)
B, L = 4, 32


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, len(VOCAB), size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 20:] = 0
    mask[2, :] = 0  # an empty sentence: all padding, position 0 masked too
    mask[3, 5:] = 0
    ids[mask == 0] = 0
    tags = rng.integers(0, 3, size=(B, L)).astype(np.int32) * mask
    return ids, mask, tags


def _jax_tagger():
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.configs import EncoderConfig
    from spokennlp_tpu.projects.mug.keyphrase import BertCrfTagger

    model = BertCrfTagger(EncoderConfig(**CFG))
    ones = jnp.ones((1, L), jnp.int32)
    params = model.init(jax.random.PRNGKey(5), ones, ones, tags=jnp.zeros((1, L), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    # transitions start at zero: give them values so the CRF reads them
    params["transitions"] = np.random.default_rng(9).normal(size=(3, 3)).astype(np.float32)
    return model, params


def _port_tagger(params):
    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.projects.mug.keyphrase import BertCrfTagger

    model = BertCrfTagger(EncoderConfig(**CFG))
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_tagger_loss_emissions_and_gradients_match_jax():
    import jax
    import jax.numpy as jnp

    jmodel, params = _jax_tagger()
    ids, mask, tags = _batch()

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                           tags=jnp.asarray(tags), deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return out["loss"], out["emissions"]

    (jloss, jem), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    tmodel = _port_tagger(params).train()
    out = tmodel(torch.from_numpy(ids), torch.from_numpy(mask), tags=torch.from_numpy(tags))
    out["loss"].backward()
    np.testing.assert_allclose(out["emissions"].detach().numpy(), np.asarray(jem), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(out["loss"].item(), float(jloss), rtol=1e-5)
    want = _flatten(jgrads)
    got = {n: p.grad.numpy() for n, p in tmodel.named_parameters()}
    assert got.keys() == want.keys()
    for n in want:
        scale = max(np.abs(want[n]).max(), 1e-12)
        assert np.abs(got[n] - want[n]).max() <= 1e-4 * scale, n


def test_decode_tags_matches_jax():
    from spokennlp_tpu.projects.mug import keyphrase as jk
    from spokennlp_tpu_torch.projects.mug import keyphrase as tk

    jmodel, params = _jax_tagger()
    ids, mask, _ = _batch(1)
    want = jk.decode_tags(jmodel, params, ids, mask)
    got = tk.decode_tags(_port_tagger(params), ids, mask)
    assert got.shape == (B, L)
    np.testing.assert_array_equal(got, want)


def write_kpe_corpus(root: Path, n_meetings=3, n_sent=16, seed=0):
    """train.jsonl / dev.jsonl of MUG meetings with key words (every
    meeting's first sentence empty) and vocab.txt."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_meetings):
        sents = [{"id": j + 1, "s": "" if j == 0 else "".join(
            rng.choice(WORDS, size=int(rng.integers(2, 6))))} for j in range(n_sent)]
        rows.append({"meeting_key": f"M{i}", "sentences": sents,
                     "candidate": [{"key_word": WORDS[:2]}, {"key_word": [WORDS[i % 5]]}]})
    root.mkdir(parents=True, exist_ok=True)
    for name in ("train.jsonl", "dev.jsonl"):
        with open(root / name, "w") as f:
            for r in rows:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")
    (root / "vocab.txt").write_text("\n".join(VOCAB))
    return rows


def _jax_checkpoint(path: Path, trunk_only=False):
    from spokennlp_tpu.configs import EncoderConfig
    from spokennlp_tpu.models import checkpoint_io as jio

    _, params = _jax_tagger()
    jio.save_checkpoint(str(path), params["encoder"] if trunk_only else params,
                        EncoderConfig(**CFG))
    return params


def test_trunk_checkpoint_keeps_the_fresh_head(tmp_path):
    from spokennlp_tpu_torch.models import checkpoint_io
    from spokennlp_tpu_torch.projects.mug.keyphrase import build_tagger

    want = _jax_checkpoint(tmp_path / "trunk", trunk_only=True)
    params, cfg = checkpoint_io.load_checkpoint(str(tmp_path / "trunk"))
    model = build_tagger(cfg, params, seed=3, device="cpu")
    fresh = build_tagger(cfg, None, seed=3, device="cpu")
    np.testing.assert_array_equal(model.encoder.layer_1.attention.qkv.kernel.detach().numpy(),
                                  want["encoder"]["layer_1"]["attention"]["qkv"]["kernel"])
    torch.testing.assert_close(model.emissions.kernel, fresh.emissions.kernel)
    assert not model.transitions.detach().any()


def test_run_mug_keyphrase_matches_jax(tmp_path, monkeypatch):
    """JAX's run_mug --track keyphrase and the port's on one corpus from one
    JAX tagger checkpoint: the batches each feeds its train step equal (the
    port's featuriser against JAX's), every step's loss within 1e-3
    relative, the tagged eval batches equal, the submissions identical and
    the metrics equal."""
    import jax

    from spokennlp_tpu.cli import run_mug as jrun
    from spokennlp_tpu.projects.mug import keyphrase as jk
    from spokennlp_tpu_torch.cli import run_mug as trun
    from spokennlp_tpu_torch.projects.mug import keyphrase as tk

    write_kpe_corpus(tmp_path)
    _jax_checkpoint(tmp_path / "ckpt")
    argv = lambda out: [
        "--track", "keyphrase", "--train_file", str(tmp_path / "train.jsonl"),
        "--eval_file", str(tmp_path / "dev.jsonl"), "--output_dir", str(tmp_path / out),
        "--vocab_file", str(tmp_path / "vocab.txt"), "--init_checkpoint", str(tmp_path / "ckpt"),
        "--max_seq_length", "16", "--num_train_epochs", "2", "--per_device_train_batch_size", "4",
        "--learning_rate", "1e-3", "--kpe_top_k", "5"]
    seen = {"jax": [], "port": [], "jax_loss": [], "port_loss": [], "jax_dec": [],
            "port_dec": []}
    real_jit = jax.jit

    def recording_jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") != "kpe_step":
            return jitted

        def call(state, batch, rng):
            seen["jax"].append({k: np.asarray(v) for k, v in batch.items()})
            state, metrics = jitted(state, batch, rng)
            seen["jax_loss"].append(float(metrics["loss"]))
            return state, metrics

        return call

    def recording_decode(record, real):
        def decode(*a):
            tags = real(*a)
            record.append((np.asarray(a[-2]), np.asarray(a[-1]), tags))
            return tags
        return decode

    monkeypatch.setattr(jax, "jit", recording_jit)
    monkeypatch.setattr(jk, "decode_tags", recording_decode(seen["jax_dec"], jk.decode_tags))
    want = jrun.main(argv("jax"))
    monkeypatch.setattr(jax, "jit", real_jit)

    real_step = tk.make_kpe_train_step

    def recording_step(*a, **kw):
        step = real_step(*a, **kw)

        def call(batch):
            seen["port"].append({k: v.numpy() for k, v in batch.items()})
            metrics = step(batch)
            seen["port_loss"].append(float(metrics["loss"]))
            return metrics

        return call

    monkeypatch.setattr(tk, "make_kpe_train_step", recording_step)
    monkeypatch.setattr(tk, "decode_tags", recording_decode(seen["port_dec"], tk.decode_tags))
    got = trun.main(argv("port") + ["--device", "cpu"])

    assert len(seen["port"]) == len(seen["jax"]) == 2 * 12  # 48 sentences, batches of 4
    for g, w in zip(seen["port"], seen["jax"]):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert any(not b["attention_mask"][:, 0].all() for b in seen["port"])  # empty rows trained
    np.testing.assert_allclose(seen["port_loss"], seen["jax_loss"], rtol=1e-3)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-3)
    assert len(seen["port_dec"]) == len(seen["jax_dec"]) == 12
    for (gi, gm, gt), (wi, wm, wt) in zip(seen["port_dec"], seen["jax_dec"]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gt, wt)
    assert ((tmp_path / "port" / "submission.jsonl").read_text()
            == (tmp_path / "jax" / "submission.jsonl").read_text())
    assert got["metrics"] == want["metrics"]
    assert json.loads((tmp_path / "port" / "keyphrase_results.json").read_text())["metrics"]


def test_run_mug_keyphrase_wants_a_card_by_default(tmp_path):
    from spokennlp_tpu_torch.cli import run_mug

    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    write_kpe_corpus(tmp_path, n_meetings=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_mug.main(["--track", "keyphrase", "--train_file", str(tmp_path / "train.jsonl"),
                      "--eval_file", str(tmp_path / "dev.jsonl"), "--output_dir",
                      str(tmp_path / "o")])
