"""SLD data parallel on the port (projects/sld.py, cli/run_sld.py) on the
CPU: two gloo processes against one, one process against JAX's sharded SLD
step.

- One step on a global batch of 4 (``dryrun.sld_step``: dropout and time
  masking on, each rank 2 rows holding other counts of labels) equals the
  one-process step within the dry run's limits (loss 5e-4, gradient norm
  5e-3, relative); the time masks of the global batch and a greedy decode
  of the updated model equal one process's; each rank's own mean (the
  planted fault) misses the limits.
- run_sld inside the group (``--per_device_train_batch_size`` the global
  batch, as in JAX) gives the one-process epoch losses within the loss
  limit and the same WER/CER, and rank 0 alone writes the results and the
  kept checkpoints.
- The one-process SLD loss and gradient norm equal JAX's over its batch
  sharded on 2 CPU devices (its trainer's mesh), within 1e-5 (the loss)
  and 1e-4 (its parts and the gradient norm) relative, at dropout and time
  masking 0.
"""

import json
import os
import sys
from unittest import mock

import numpy as np
import pytest

# transformers (through run_sld's imports) loads TensorFlow without this
os.environ.setdefault("USE_TF", "0")

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_sld import _write_corpus  # noqa: E402

from spokennlp_tpu_torch import dryrun  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))


def _cli_flags(root):
    return ["--train_file", str(root / "train.jsonl"), "--eval_file", str(root / "eval.jsonl"),
            "--vocab_size_speech", "16", "--block_size", "32", "--max_text_length", "8",
            "--per_device_train_batch_size", "4", "--num_train_epochs", "2",
            "--learning_rate", "3e-3", "--clip_grad_norm", "0.5", "--hidden_size", "32",
            "--num_hidden_layers", "2", "--num_attention_heads", "2", "--decode_max_len", "32",
            "--device", "cpu"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("sld_dist")
    _write_corpus(root)
    res = dryrun.run_workers(2, "torch_dist_helper:sld_worker",
                             {"flags": _cli_flags(root), "out": str(root / "two")},
                             timeout=240, sys_path=[TESTS], threads=1)
    return res, root


@pytest.fixture(scope="module")
def single():
    return dryrun.sld_step(dryrun.SLD_TINY)


def test_two_ranks_equal_one_process(two_ranks, single):
    res, _ = two_ranks
    dryrun.check_step("sld", single, res["step"])
    for k in ("ce_speech", "ce_text", "kl_speech"):
        assert abs(res["step"][k] - single[k]) <= dryrun.LOSS_RTOL * max(1.0, abs(single[k])), k
    assert res["step"]["time_mask"] == single["time_mask"] and single["masked"] > 0
    assert res["step"]["tokens"] == single["tokens"]


def test_a_per_rank_mean_misses_the_limit(two_ranks, single):
    """The planted fault: each rank's CEs over its own label counts and its
    KL over its own rows, averaged over the ranks (DDP's reduction)."""
    with pytest.raises(AssertionError, match="sharded"):
        dryrun.check_step("per-rank mean", single, two_ranks[0]["fault"])


def test_run_sld_inside_the_group_equals_one_process(two_ranks, tmp_path):
    from spokennlp_tpu_torch.cli import run_sld

    res, root = two_ranks
    _write_corpus(tmp_path)
    one = run_sld.main(_cli_flags(tmp_path) + ["--output_dir", str(tmp_path / "one")])
    got = res["cli"]
    assert len(got["history"]) == len(one["history"]) == 2
    for g, w in zip(got["history"], one["history"]):
        assert abs(g["train_loss"] - w["train_loss"]) <= dryrun.LOSS_RTOL * w["train_loss"]
        assert (g["wer"], g["cer"]) == (w["wer"], w["cer"])
    saved = json.loads((root / "two" / "sld_results.json").read_text())
    assert saved["final"]["wer"] == got["final"]["wer"]
    kept = lambda d: sorted(p.name for p in (d / "checkpoints").iterdir())
    assert kept(root / "two") == kept(tmp_path / "one")


def test_the_global_batch_must_divide_over_the_ranks():
    from spokennlp_tpu_torch.parallel import dist
    from spokennlp_tpu_torch.projects import sld

    cfg, model, batch = dryrun.sld_setup(dryrun.SLD_TINY)
    ex = [{k: v[i] for k, v in batch.items()} for i in range(4)]
    with mock.patch.object(dist, "data_size", lambda: 3), \
            pytest.raises(ValueError, match="--per_device_train_batch_size 4"):
        sld.SLDTrainer(model, cfg, None, ex, ex, ["a"] * 4, str, batch_size=4)


def test_one_process_matches_jaxs_sharded_sld_step():
    import jax
    import jax.numpy as jnp
    import optax

    from spokennlp_tpu.models import gpt2 as jg
    from spokennlp_tpu.parallel import mesh as jmesh
    from spokennlp_tpu.projects import sld as jsld
    from spokennlp_tpu_torch.models.checkpoint_io import params_from_state_dict

    p = {**dryrun.SLD_TINY, "dropout": 0.0, "time_masking": 0.0}
    got = dryrun.sld_step(p)
    cfg, model, batch = dryrun.sld_setup(p)
    jcfg = jsld.SLDConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    g = model.config
    jmodel = jg.GPT2LMModel(jg.GPT2Config(**{f: getattr(g, f) for f in g.__dataclass_fields__}))
    grid = jmesh.make_mesh(1, devices=jax.devices()[:2])
    params = jmesh.shard_params(jax.tree.map(jnp.asarray, params_from_state_dict(
        model.state_dict())), grid)
    jb = jmesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, grid)

    def loss(params):
        out = jmodel.apply({"params": params}, jb["input_ids"], attention_mask=jb["attention_mask"],
                           deterministic=True)
        return jsld.sld_loss(out["logits"], jb["labels"], jb["attention_mask"], jcfg)

    (total, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    np.testing.assert_allclose(got["loss"], float(total), rtol=1e-5)
    for k in aux:  # the KL is a sum of q (log q - log p): its own rounding reads 2e-5
        np.testing.assert_allclose(got[k], float(aux[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["grad_norm"], float(optax.global_norm(grads)), rtol=1e-4)
