"""Action-item detection on the port against the JAX package:
``projects/action_item.py``, ``cli/run_aid.py`` and ``cli/run_process_data.py
--dataset ami``. JAX is imported inside the tests.

Sizes: BERT of width 32, 2 layers, 2 heads, 32 positions, batches of 8
(four consistency pairs). The pairing draws from one numpy generator in the
same order, so the examples are equal for every drop_type x noisy_type; the
features are equal; in float32 the logits of the four poolings agree within
1e-5, the losses within 1e-6 relative and one AdamW step's parameters within
1e-5 (sums in another order). The two CLIs, from one trunk checkpoint at
dropout 0 with JAX's fresh head carried over, agree on every epoch's loss
within 1e-3 relative and on every positive-F1 figure.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

DROP_TYPES = ("none", "r-drop", "context-drop-fix", "context-drop-dynamic")
NOISY_TYPES = ("skip", "update", "remain")
POOLINGS = ("cls", "sep", "token_avg", "token_max")
CFG = dict(vocab_size=60, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
           max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)
L, B = 32, 8
WORDS = [f"w{i}" for i in range(40)]


def tokenize(s):
    return [5 + int(w[1:]) % 50 for w in s.split()] or [5]


def _meetings(n=3, n_sent=10, seed=0):
    rng = np.random.default_rng(seed)
    return [{"meeting": f"m{i}", "sentences": [
        {"text": " ".join(rng.choice(WORDS, size=int(rng.integers(1, 7)))),
         "label": int(rng.random() < 0.3)} for _ in range(n_sent)]} for i in range(n)]


@pytest.mark.parametrize("drop_type", DROP_TYPES)
@pytest.mark.parametrize("noisy_type", NOISY_TYPES)
def test_pairing_and_features_match_jax(drop_type, noisy_type):
    from spokennlp_tpu.projects import action_item as ja
    from spokennlp_tpu_torch.projects import action_item as ta

    kw = dict(drop_type=drop_type, noisy_type=noisy_type, max_seq_length=L)
    jcfg, tcfg = ja.AidConfig(**kw), ta.AidConfig(**kw)
    for use_global in (False, True):
        jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
        want, got = [], []
        for m in _meetings():
            want += ja.build_paired_examples(m["sentences"], jcfg, jrng, 2, use_global)
            got += ta.build_paired_examples(m["sentences"], tcfg, trng, 2, use_global)
        assert got == want
        assert trng.random() == jrng.random()  # the same number of draws
        if got:
            jf = ja.collate_examples(want, tokenize, jcfg, 2, 3)
            tf = ta.collate_examples(got, tokenize, tcfg, 2, 3)
            assert tf.keys() == jf.keys()
            for k in jf:
                np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)


def _batch(seed=0):
    from spokennlp_tpu_torch.projects.action_item import AidConfig, build_paired_examples
    from spokennlp_tpu_torch.projects.action_item import collate_examples

    cfg = AidConfig(max_seq_length=L)
    rng = np.random.default_rng(seed)
    ex = []
    for m in _meetings(seed=seed):
        ex += build_paired_examples(m["sentences"], cfg, rng)
    batch = collate_examples(ex[:B], tokenize, cfg, 2, 3)
    assert batch["token_type_ids"].any() and not batch["attention_mask"].all()
    return batch


def _models(pooling, dropout_rate=0.0, **cfg_kw):
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.configs import EncoderConfig as JEnc
    from spokennlp_tpu.projects import action_item as ja
    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.projects import action_item as ta

    enc = dict(CFG, add_pooler=pooling == "cls")
    kw = dict(classifier_input=pooling, max_seq_length=L, dropout_rate=dropout_rate, **cfg_kw)
    jcfg, tcfg = ja.AidConfig(**kw), ta.AidConfig(**kw)
    jmodel = ja.AidModel(JEnc(**enc), jcfg)
    ones = jnp.ones((2, L), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(1), ones, ones, jnp.zeros((2, L), jnp.int32),
                         jnp.zeros((2,), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = ta.AidModel(EncoderConfig(**enc), tcfg)
    tmodel.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jmodel, jcfg, params, tmodel, tcfg


@pytest.mark.parametrize("pooling", POOLINGS)
def test_aid_model_logits_match_jax(pooling):
    import jax.numpy as jnp

    jmodel, _, params, tmodel, _ = _models(pooling)
    batch = _batch()
    keys = ("input_ids", "attention_mask", "token_type_ids", "sep_position")
    want = jmodel.apply({"params": params}, *(jnp.asarray(batch[k]) for k in keys))
    with torch.no_grad():
        got = tmodel.eval()(*(torch.from_numpy(batch[k]) for k in keys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_cls_pooling_needs_the_pooler():
    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.projects.action_item import AidConfig, AidModel

    with pytest.raises(ValueError, match="add_pooler"):
        AidModel(EncoderConfig(**CFG, add_pooler=False), AidConfig(classifier_input="cls"))


@pytest.mark.parametrize("loss_type", ["ce", "focal_loss"])
@pytest.mark.parametrize("smoothing", [False, True])
@pytest.mark.parametrize("drop_type", ["none", "context-drop-dynamic"])
def test_aid_loss_matches_jax(loss_type, smoothing, drop_type):
    import jax.numpy as jnp

    from spokennlp_tpu.projects import action_item as ja
    from spokennlp_tpu_torch.projects import action_item as ta

    kw = dict(loss_type=loss_type, do_label_smoothing=smoothing, drop_type=drop_type,
              kl_alpha=0.7)
    rng = np.random.default_rng(4)
    logits = (3 * rng.normal(size=(B, 2))).astype(np.float32)
    logits[3] = [40.0, -40.0]  # a saturated row: the +1e-12 inside the logs
    labels = rng.integers(0, 2, size=B).astype(np.int32)
    for training in (True, False):
        want, waux = ja.aid_loss(jnp.asarray(logits), jnp.asarray(labels), ja.AidConfig(**kw),
                                 training)
        got, gaux = ta.aid_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                ta.AidConfig(**kw), training)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)
        assert gaux.keys() == waux.keys()
        for k in waux:
            np.testing.assert_allclose(gaux[k].item(), float(waux[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("pooling", ["cls", "token_max"])
def test_one_train_step_matches_jax(pooling):
    """make_aid_train_step against JAX's from the same parameters at dropout
    0: the loss, its parts and every updated parameter."""
    import jax
    import jax.numpy as jnp
    import optax

    from spokennlp_tpu.projects.action_item import make_aid_train_step as jstep
    from spokennlp_tpu.train.train_step import create_train_state
    from spokennlp_tpu_torch.projects.action_item import make_aid_train_step as tstep

    jmodel, jcfg, params, tmodel, tcfg = _models(pooling)
    params_before = _flatten(params)
    batch = _batch(1)
    tx = optax.adamw(1e-3, weight_decay=0.01)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    state, jm = jstep(jmodel, jcfg, tx)(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                        jax.random.PRNGKey(0))
    opt = torch.optim.AdamW(tmodel.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    tm = tstep(tmodel, tcfg, opt)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert tm.keys() == jm.keys() == {"loss", "ce", "kl"}
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7)
    from spokennlp_tpu_torch.models import checkpoint_io

    got = checkpoint_io.params_from_state_dict(tmodel.state_dict())
    want = jax.tree_util.tree_map(np.asarray, state.params)
    g, w = _flatten(got), _flatten(want)
    assert g.keys() == w.keys()
    for k in w:
        if k.endswith("attention.qkv.bias"):
            # the key bias shifts every score of a row alike, so the softmax
            # ignores it: its gradient is 0 up to rounding noise, which
            # Adam's first step scales to +-lr on either side. The q and v
            # biases are held; the key bias only to its decayed value +- lr
            np.testing.assert_allclose(g[k][[0, 2]], w[k][[0, 2]], atol=1e-5, rtol=1e-5)
            assert np.abs(g[k][1] - params_before[k][1]).max() <= 1e-3 * (1 + 1e-4)
            continue
        np.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=1e-5, err_msg=k)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _write_meetings(path: Path, meetings):
    with open(path, "w") as f:
        for m in meetings:
            f.write(json.dumps(m) + "\n")
    return str(path)


def test_run_aid_matches_jax(tmp_path, monkeypatch):
    """Both CLIs on one corpus from one JAX-written trunk checkpoint (dropout
    0 in its config and in the head), JAX's fresh classifier carried into
    the port, one tokenizer for both: every epoch's loss within 1e-3
    relative, the same positive-F1 figures, best_model written and, with
    --save_hf_format, best_model_hf loading back to best_model's trunk."""
    import dataclasses

    import jax

    from spokennlp_tpu.cli import common as jcommon
    from spokennlp_tpu.cli import run_aid as jcli
    from spokennlp_tpu.configs import EncoderConfig as JEnc
    from spokennlp_tpu.models import checkpoint_io as jio
    from spokennlp_tpu.projects import action_item as ja
    from spokennlp_tpu_torch.cli import common as tcommon
    from spokennlp_tpu_torch.cli import run_aid as tcli
    from spokennlp_tpu_torch.models import checkpoint_io
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.projects import action_item as ta

    train = _write_meetings(tmp_path / "train.jsonl", _meetings(3, 10, seed=1))
    dev = _write_meetings(tmp_path / "dev.jsonl", _meetings(2, 9, seed=2))
    jmodel, _, params, _, _ = _models("cls")
    jio.save_checkpoint(str(tmp_path / "ckpt"), params["encoder"], JEnc(**CFG, add_pooler=True))
    special = {"cls": 2, "pad": 0, "bos": 1, "sep": 3, "mask": 4, "vocab_size": CFG["vocab_size"]}
    for common in (jcommon, tcommon):
        monkeypatch.setattr(common, "resolve_tokenizer", lambda args: (tokenize, dict(special)))
    for mod in (ja, ta):
        real = mod.AidConfig
        monkeypatch.setattr(mod, "AidConfig", lambda *a, _real=real, **kw: dataclasses.replace(
            _real(*a, **kw), dropout_rate=0.0))
    captured = {}
    real_init = ja.AidModel.init

    def recording_init(self, *a, **kw):
        out = real_init(self, *a, **kw)
        captured["classifier"] = jax.tree_util.tree_map(np.asarray,
                                                        out["params"]["classifier"])
        return out

    monkeypatch.setattr(ja.AidModel, "init", recording_init)
    argv = lambda out: ["--train_file", train, "--eval_file", dev, "--output_dir",
                        str(tmp_path / out), "--model_name_or_path", str(tmp_path / "ckpt"),
                        "--max_seq_length", str(L), "--per_device_train_batch_size", str(B),
                        "--num_train_epochs", "2", "--learning_rate", "1e-3"]
    want = jcli.main(argv("jax"))

    real_model = ta.AidModel

    class WithJaxHead(real_model):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.classifier.load_state_dict(jax_params_to_state_dict(captured["classifier"]))

    monkeypatch.setattr(ta, "AidModel", WithJaxHead)
    got = tcli.main(argv("port") + ["--device", "cpu", "--save_hf_format"])
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=1e-3)
        for k in ("positive_f1", "precision", "recall"):
            assert g[k] == pytest.approx(w[k], abs=1e-9), k
    assert got["best_positive_f1"] == pytest.approx(want["best_positive_f1"], abs=1e-9)
    best, cfg = checkpoint_io.load_checkpoint(str(tmp_path / "port" / "best_model"))
    assert set(best) == {"encoder", "classifier"} and cfg.add_pooler
    ns = __import__("argparse").Namespace(model_name_or_path=str(tmp_path / "port" /
                                                                 "best_model_hf"))
    monkeypatch.undo()
    _, trunk = tcommon.maybe_load_pretrained(ns, cfg)
    loaded = jax_params_to_state_dict(trunk.get("encoder", trunk))
    ref = jax_params_to_state_dict(best["encoder"])
    for k in ref:
        torch.testing.assert_close(loaded[k], ref[k], rtol=0, atol=0, msg=k)


def test_run_aid_wants_a_card_by_default(tmp_path):
    from spokennlp_tpu_torch.cli import run_aid

    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    train = _write_meetings(tmp_path / "train.jsonl", _meetings(1, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_aid.main(["--train_file", train, "--eval_file", train, "--output_dir",
                      str(tmp_path / "o")])


def ami_tree(root: Path) -> str:
    """A small AMI NXT tree: tests/test_ami.py's meeting under four names
    (two train meetings, one dev, one test)."""
    from test_ami import _make_corpus

    for meet in ("ES2002a", "ES2005b", "ES2003a", "ES2004a"):
        d = _make_corpus(root, meet=meet)
    return d


def test_run_process_data_ami_matches_jax(tmp_path):
    """run_process_data --dataset ami --ami_meetings_jsonl writes the same
    TSVs and meetings jsonl as the JAX package's, which run_aid reads."""
    from spokennlp_tpu.cli import run_process_data as j_cli
    from spokennlp_tpu_torch.cli import run_process_data as t_cli

    raw = ami_tree(tmp_path / "ami")
    outs = {}
    for side, cli in (("j", j_cli), ("t", t_cli)):
        out = tmp_path / side
        cli.main(["--dataset", "ami", "--data_folder", raw, "--out_folder", str(out),
                  "--ami_meetings_jsonl"])
        outs[side] = {p.name: p.read_text() for p in sorted(out.iterdir())}
    assert outs["t"] == outs["j"]
    assert set(outs["t"]) == {"train.txt", "dev.txt", "test.txt", "train_meetings.jsonl",
                              "dev_meetings.jsonl", "test_meetings.jsonl"}
    meetings = [json.loads(l) for l in outs["t"]["train_meetings.jsonl"].splitlines()]
    assert len(meetings) == 2 and any(s["label"] for m in meetings for s in m["sentences"])
    assert os.path.getsize(tmp_path / "t" / "dev.txt") > 0
