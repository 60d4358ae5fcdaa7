"""The MUG slice of the port against the JAX package: native checkpoints
(``models/checkpoint_io.py``) in both directions, ``cli/run_mug.py`` Tracks 1
and 2 against JAX's CLI from one JAX-written checkpoint, and the fallback
tokenizer's ids across interpreters. JAX is imported inside the tests.

Sizes: PoNet of width 32, 2 layers, windows of 64 tokens, a corpus of three
meetings of 16 sentences. Both CLIs get a ``--vocab_file``: the port's
fallback tokenizer hashes with crc32, JAX's with the salted ``hash()``. At
dropout 0 the two CLIs' training losses agree within 1e-3 relative (the
same AdamW steps in float32 summed in another order) and their submissions
are identical.
"""

import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.models import checkpoint_io

REPO = Path(__file__).resolve().parents[1]
CFG = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
           max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0,
           add_pooler=False, pad_token_id=0)
WORDS = ["预算", "方案", "讨论", "设计", "评审"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(set("".join(WORDS)))


def write_mug_corpus(root: Path, n_meetings=3, n_sent=16, seed=0):
    """train.jsonl and dev.jsonl of MUG meetings (sentences, paragraph and
    topic segments with key sentences and key words), and vocab.txt."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_meetings):
        sents = [{"id": j + 1, "s": "".join(rng.choice(WORDS, size=int(rng.integers(2, 5))))}
                 for j in range(n_sent)]
        topics = [{"id": end, "candidate": [{"title": f"t{end}",
                                             "key_sentence": [end - 3, end - 1],
                                             "key_word": [WORDS[end % 5]]}]}
                  for end in range(4, n_sent + 1, 4)]
        rows.append({"meeting_key": f"M{i}", "sentences": sents,
                     "paragraph_segment_ids": [{"id": j} for j in range(2, n_sent + 1, 2)],
                     "topic_segment_ids": topics,
                     "candidate": [{"key_word": WORDS[:2], "key_sentence": [1, 5, 9]}],
                     "action_ids": [{"id": 3}]})
    root.mkdir(parents=True, exist_ok=True)
    for name in ("train.jsonl", "dev.jsonl"):
        with open(root / name, "w") as f:
            for r in rows:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")
    (root / "vocab.txt").write_text("\n".join(VOCAB))
    return rows


def _jax_checkpoint(path: Path, impl="fused", trunk_only=False):
    """A PoNet classifier (or its trunk) written by the JAX package."""
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.configs import EncoderConfig
    from spokennlp_tpu.models import checkpoint_io as jio
    from spokennlp_tpu.models.ponet import PoNetForTokenClassification

    cfg = EncoderConfig(vocab_size=len(VOCAB), **CFG, ponet_mixer_impl=impl)
    ones = jnp.ones((1, 64), jnp.int32)
    params = PoNetForTokenClassification(cfg).init(
        jax.random.PRNGKey(1), ones, attention_mask=ones,
        segment_ids=jnp.zeros((1, 64), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    jio.save_checkpoint(str(path), params["ponet"] if trunk_only else params, cfg)
    return params, cfg


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_checkpoint_from_jax_loads_into_the_port(tmp_path):
    import dataclasses

    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.models.ponet import PoNetForTokenClassification

    want, jcfg = _jax_checkpoint(tmp_path / "ckpt")
    assert checkpoint_io.is_native_checkpoint(str(tmp_path / "ckpt"))
    assert not checkpoint_io.is_native_checkpoint(str(tmp_path))
    params, cfg = checkpoint_io.load_checkpoint(str(tmp_path / "ckpt"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got, ref = _flatten(params), _flatten(want)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    PoNetForTokenClassification(cfg).load_state_dict(jax_params_to_state_dict(params),
                                                     strict=True)


def test_checkpoint_from_the_port_loads_into_jax(tmp_path):
    """The port writes a model's state_dict as the Flax tree; JAX reads it,
    by itself and into a target tree, and computes with it."""
    import jax.numpy as jnp

    from spokennlp_tpu.configs import EncoderConfig as JC
    from spokennlp_tpu.models import checkpoint_io as jio
    from spokennlp_tpu.models.ponet import PoNetForTokenClassification as JP
    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.models.ponet import PoNetForTokenClassification

    cfg = EncoderConfig(vocab_size=len(VOCAB), **CFG)
    model = PoNetForTokenClassification(cfg, generator=torch.Generator().manual_seed(0)).eval()
    tree = checkpoint_io.params_from_state_dict(model.state_dict())
    checkpoint_io.save_checkpoint(str(tmp_path / "ckpt"), tree, cfg)
    params, jcfg = jio.load_checkpoint(str(tmp_path / "ckpt"))
    assert jcfg == JC(**json.loads((tmp_path / "ckpt" / "config.json").read_text()))
    got = _flatten(params)
    want = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    again, _ = jio.load_checkpoint(str(tmp_path / "ckpt"), target=params)
    ids = np.arange(64, dtype=np.int32)[None] % len(VOCAB)
    jout = JP(jcfg).apply({"params": again}, jnp.asarray(ids))["token_logits"]
    with torch.no_grad():
        tout = model(torch.from_numpy(ids))["token_logits"]
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)


def test_trunk_checkpoint_keeps_the_fresh_head(tmp_path):
    from spokennlp_tpu_torch.cli.run_mug import build_model

    want, _ = _jax_checkpoint(tmp_path / "trunk", trunk_only=True)
    params, cfg = checkpoint_io.load_checkpoint(str(tmp_path / "trunk"))
    assert "ponet" not in params
    model = build_model(cfg, params, seed=3, device="cpu")
    fresh = build_model(cfg, None, seed=3, device="cpu")
    np.testing.assert_array_equal(model.ponet.layer_1.mixer.s.kernel.detach().numpy(),
                                  want["ponet"]["layer_1"]["mixer"]["s"]["kernel"])
    torch.testing.assert_close(model.classifier.kernel, fresh.classifier.kernel)


@pytest.mark.parametrize("track", ["topic_segmentation", "extractive_summarization"])
def test_run_mug_matches_jax(tmp_path, track):
    """JAX's run_mug and the port's on one corpus from one JAX checkpoint
    (ponet_mixer_impl="fused": training on the XLA mixer, prediction on the
    fused block's function): the per-epoch training losses within 1e-3
    relative, the submissions identical, the metrics equal."""
    from spokennlp_tpu.cli import run_mug as jrun
    from spokennlp_tpu_torch.cli import run_mug as trun

    write_mug_corpus(tmp_path)
    _jax_checkpoint(tmp_path / "ckpt")
    argv = lambda out: [
        "--track", track, "--train_file", str(tmp_path / "train.jsonl"),
        "--eval_file", str(tmp_path / "dev.jsonl"), "--output_dir", str(tmp_path / out),
        "--vocab_file", str(tmp_path / "vocab.txt"), "--init_checkpoint", str(tmp_path / "ckpt"),
        "--max_seq_length", "64", "--num_train_epochs", "2", "--per_device_train_batch_size", "2",
        "--learning_rate", "1e-3"] + (["--es_top_ratio", "0.3"] if track != "topic_segmentation"
                                      else [])
    want = jrun.main(argv("jax"))
    got = trun.main(argv("port") + ["--device", "cpu"])
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-3)
    assert ((tmp_path / "port" / "submission.jsonl").read_text()
            == (tmp_path / "jax" / "submission.jsonl").read_text())
    assert got["metrics"] == want["metrics"]
    assert json.loads((tmp_path / "port" / f"{track}_results.json").read_text())["metrics"]


def test_run_mug_refuses_what_is_not_ported(tmp_path):
    """Every track of JAX's run_mug is ported (Track 4 too): a track the
    reference lacks is refused, and each ported track asks for the card by
    default."""
    from spokennlp_tpu_torch.cli import run_mug

    write_mug_corpus(tmp_path, n_meetings=1)
    argv = ["--train_file", str(tmp_path / "train.jsonl"), "--eval_file",
            str(tmp_path / "dev.jsonl"), "--output_dir", str(tmp_path / "o")]
    with pytest.raises(SystemExit):
        run_mug.main(["--track", "title_generation", *argv])
    if torch.cuda.is_available():
        return  # the default device exists here
    for track in ("topic_segmentation", "extractive_summarization", "keyphrase"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_mug.main(["--track", track, *argv])


def test_fallback_tokenizer_ids_are_stable_across_interpreters():
    """Two fresh interpreters with different hash seeds give the same ids:
    crc32 of each word, not the salted hash()."""
    code = (
        "import argparse, json\n"
        "from spokennlp_tpu_torch.cli import common\n"
        "tok, special = common.resolve_tokenizer(argparse.Namespace(model_name_or_path=None, "
        "vocab_file=None))\n"
        "print(json.dumps([tok('预算 方案 topic segmentation'), special['vocab_size']]))\n")
    runs = []
    for seed in ("1", "2"):
        env = {**os.environ, "PYTHONPATH": str(REPO), "PYTHONHASHSEED": seed}
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        runs.append(json.loads(proc.stdout))
    assert runs[0] == runs[1]
    ids, V = runs[0]
    assert ids == [1000 + zlib.crc32(w.encode()) % (V - 1100)
                   for w in "预算 方案 topic segmentation".split()]
