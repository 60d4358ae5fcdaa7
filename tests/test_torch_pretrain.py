"""MLM+NSP pretraining and feature extraction in the port against the JAX
package on the CPU.

- The host masking walk and the batch builder are copies: the same numpy
  seed gives the same arrays.
- ``BertForPreTraining`` on JAX's parameters (loaded ``strict=True``):
  logits and losses within 1e-5 (float32, the same math summed in another
  order).
- ``run_pretrain_mlm`` writes a trunk that ``run_finetune`` reads back,
  and refuses a vocabulary without [MASK].
- ``run_extract_features`` writes JAX's JSONL, values within 1e-5, from the
  same checkpoint.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from spokennlp_tpu_torch.configs import EncoderConfig
from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
from spokennlp_tpu_torch.objectives import mlm

TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)
DCFG = dict(cls_token_id=2, sep_token_id=3, pad_token_id=0, mask_token_id=4)


def _docs(seed, n_docs=4):
    rng = np.random.default_rng(seed)
    return [[rng.integers(5, 96, size=rng.integers(3, 14)).tolist()
             for _ in range(rng.integers(2, 6))] for _ in range(n_docs)]


def test_masking_walk_and_batch_builder_match_jax():
    from spokennlp_tpu.objectives import mlm as jm

    ids = list(range(2, 40))
    flags = [i % 3 == 1 for i in range(len(ids))]
    for sub in (None, flags):
        want = jm.create_masked_lm_predictions(ids, (2, 3), 96, np.random.default_rng(5), 4,
                                               0.3, 8, sub)
        got = mlm.create_masked_lm_predictions(ids, (2, 3), 96, np.random.default_rng(5), 4,
                                               0.3, 8, sub)
        assert got == want
    want = jm.build_pretraining_batch(_docs(0), jm.PretrainDataConfig(**DCFG),
                                      np.random.default_rng(1), 32, 6, 0.15, 96)
    got = mlm.build_pretraining_batch(_docs(0), mlm.PretrainDataConfig(**DCFG),
                                      np.random.default_rng(1), 32, 6, 0.15, 96)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("add_pooler", [True, False])
def test_bert_for_pretraining_matches_jax(add_pooler):
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.configs import EncoderConfig as JaxEncoderConfig
    from spokennlp_tpu.objectives import mlm as jm

    cfg = EncoderConfig(**TINY, add_pooler=add_pooler, attention_impl="einsum")
    batch = mlm.build_pretraining_batch(_docs(2), mlm.PretrainDataConfig(**DCFG),
                                        np.random.default_rng(3), 32, 6, 0.15, 96)
    jmodel = jm.BertForPreTraining(JaxEncoderConfig(**dataclasses.asdict(cfg)))
    args = [jnp.asarray(batch[k]) for k in ("input_ids", "attention_mask", "token_type_ids",
                                             "mlm_positions")]
    params = jmodel.init(jax.random.PRNGKey(0), *args)["params"]
    jout = jmodel.apply({"params": params}, *args)
    jloss, jaux = jm.pretraining_loss(jout, {k: jnp.asarray(v) for k, v in batch.items()})

    port = mlm.BertForPreTraining(cfg).eval()
    port.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = port(tb["input_ids"], tb["attention_mask"], tb["token_type_ids"],
                   tb["mlm_positions"])
        loss, aux = mlm.pretraining_loss(out, tb)
    for k in ("mlm_logits", "nsp_logits"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    for k in ("mlm_loss", "nsp_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **TOL, err_msg=k)


def _write_vocab(path, n, with_mask=True):
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + (["[MASK]"] if with_mask else [])
    words += [f"w{i}" for i in range(n - len(words))]
    path.write_text("\n".join(words) + "\n")
    return str(path)


def _write_meetings(path, seed=0, n=6):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            sents = [{"text": " ".join(f"w{i}" for i in rng.integers(0, 70,
                                                                     size=rng.integers(3, 9)))}
                     for _ in range(rng.integers(3, 7))]
            f.write(json.dumps({"sentences": sents}) + "\n")
    return str(path)


def _pretrain_argv(tmp_path, vocab):
    return ["--train_file", _write_meetings(tmp_path / "meetings.jsonl"), "--output_dir",
            str(tmp_path / "pre"), "--vocab_file", vocab, "--device", "cpu",
            "--hidden_size", "32", "--num_hidden_layers", "2", "--num_attention_heads", "2",
            "--intermediate_size", "64", "--max_seq_length", "32", "--num_train_epochs", "1",
            "--per_device_train_batch_size", "4"]


def test_pretrain_cli_checkpoint_reloads_into_run_finetune(tmp_path):
    from spokennlp_tpu_torch.cli import common, run_finetune, run_pretrain_mlm
    from spokennlp_tpu_torch.models import checkpoint_io
    from spokennlp_tpu_torch.models.topic_seg import TopicSegModel
    from spokennlp_tpu_torch.configs import TopicSegConfig

    vocab = _write_vocab(tmp_path / "vocab.txt", 88)
    res = run_pretrain_mlm.main(_pretrain_argv(tmp_path, vocab))
    assert res["steps"] >= 2 and all(np.isfinite(res["final"][k])
                                     for k in ("loss", "mlm_loss", "nsp_loss", "grad_norm"))
    saved = json.loads((tmp_path / "pre" / "pretrain_results.json").read_text())
    assert saved == res["history"]
    ckpt = str(tmp_path / "pre" / "pretrained_model")
    trunk, cfg = checkpoint_io.load_checkpoint(ckpt)
    assert "pooler" in trunk and "encoder" not in trunk and cfg.add_pooler

    # the trunk goes under "encoder" of the task model, bit for bit
    args = run_finetune.make_parser().parse_args(["--output_dir", str(tmp_path / "ft"),
                                                  "--model_name_or_path", ckpt])
    loaded_cfg, tree = common.maybe_load_pretrained(args, EncoderConfig())
    model = TopicSegModel(loaded_cfg, TopicSegConfig())
    common.load_pretrained_into(model, tree)
    sd = model.state_dict()
    for name, value in jax_params_to_state_dict(trunk).items():
        assert torch.equal(sd["encoder." + name], value), name

    d = tmp_path / "wiki_section"
    d.mkdir()
    rng = np.random.default_rng(1)
    for split, n in (("train.jsonl", 4), ("dev.jsonl", 1), ("test.jsonl", 1)):
        with open(d / split, "w") as f:
            for _ in range(n):
                ns = int(rng.integers(6, 10))
                f.write(json.dumps({"sentences": [" ".join(
                    f"w{i}" for i in rng.integers(0, 70, size=4)) for _ in range(ns)],
                    "labels": [int(rng.random() < 0.3) for _ in range(ns - 1)] + [1]}) + "\n")
    out = run_finetune.main([
        "--data_dir", str(d), "--output_dir", str(tmp_path / "ft"), "--device", "cpu",
        "--model_name_or_path", ckpt, "--vocab_file", vocab, "--max_seq_length", "32",
        "--num_train_epochs", "1", "--per_device_train_batch_size", "2",
        "--gradient_accumulation_steps", "1", "--do_train"])
    assert out["train_steps"] >= 1


def test_pretrain_cli_refuses_a_vocab_without_mask(tmp_path):
    from spokennlp_tpu_torch.cli import run_pretrain_mlm

    vocab = _write_vocab(tmp_path / "vocab.txt", 88, with_mask=False)
    with pytest.raises(AssertionError, match="must define \\[MASK\\]"):
        run_pretrain_mlm.main(_pretrain_argv(tmp_path, vocab))


def test_extract_features_jsonl_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.cli import run_extract_features as jax_cli
    from spokennlp_tpu.configs import EncoderConfig as JaxEncoderConfig
    from spokennlp_tpu.models.encoder import Encoder as JaxEncoder
    from spokennlp_tpu_torch.cli import run_extract_features
    from spokennlp_tpu_torch.models import checkpoint_io

    cfg = EncoderConfig(**TINY, add_pooler=True)
    params = JaxEncoder(JaxEncoderConfig(**dataclasses.asdict(cfg))).init(
        jax.random.PRNGKey(1), jnp.ones((1, 16), jnp.int32))["params"]
    ckpt = str(tmp_path / "ckpt")
    checkpoint_io.save_checkpoint(ckpt, jax.tree.map(np.asarray, params), cfg)
    vocab = _write_vocab(tmp_path / "vocab.txt", 96)
    (tmp_path / "in.txt").write_text("w1 w2 w3 ||| w4 w5\nw6 w7 w8 w9 w10 w11\n\nw12 w13 w3\n")
    flags = ["--input_file", str(tmp_path / "in.txt"), "--model_name_or_path", ckpt,
             "--vocab_file", vocab, "--max_seq_length", "16", "--batch_size", "2",
             "--layers=-1,-2,0"]
    n_jax = jax_cli.main(flags + ["--output_file", str(tmp_path / "jax.jsonl")])
    n = run_extract_features.main(flags + ["--output_file", str(tmp_path / "port.jsonl"),
                                           "--device", "cpu"])
    assert n == n_jax == 3
    want = [json.loads(l) for l in (tmp_path / "jax.jsonl").read_text().splitlines()]
    got = [json.loads(l) for l in (tmp_path / "port.jsonl").read_text().splitlines()]
    assert [g["linex_index"] for g in got] == [w["linex_index"] for w in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert [f["token"] for f in g["features"]] == [f["token"] for f in w["features"]]
        for gf, wf in zip(g["features"], w["features"]):
            assert [l["index"] for l in gf["layers"]] == [l["index"] for l in wf["layers"]]
            for gl, wl in zip(gf["layers"], wf["layers"]):
                np.testing.assert_allclose(gl["values"], wl["values"], atol=1e-5, rtol=0)
