"""MMVTS data and expert parallel on the port (objectives/mmvts_losses.py,
projects/mmvts.py, models/multimodal.py, cli/run_finetune_multimodal.py) on
the CPU: two gloo processes against one, one process against JAX's step on
its (data 2, model 2) mesh.

- One step on a global batch of 4 windows (``dryrun.mmvts_step``: the
  modality InfoNCE over tv and av and the matrix topic CL over every rank's
  clips, ``ma_moe`` with the capacity dispatch planned over every rank's
  tokens, dropout 0.1) equals the one-process step within the dry run's
  limits (loss 5e-4, gradient norm 5e-3, relative), at mp 1 (dp 2) and at
  mp 2 (the experts and heads sharded); the eval argmax equals.
- Each per-rank shortcut the step replaces misses those limits: a per-rank
  mean, a per-rank MoE capacity, per-rank topic ids.
- run_finetune_multimodal inside the group (2 ranks at half the per-device
  batch: the same global batch; and at ``--model_parallel_size 2``) gives
  the one-process epoch losses within the loss limit and the same video
  metrics; rank 0 writes ``mm_results.json``.
- The one-process loss and gradient norm equal JAX's under
  ``make_mesh(2)`` over 4 CPU devices (batch over ``data``, heads, columns
  and experts over ``model``) within 1e-5 and 1e-4 relative, at dropout 0.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_mmvts_cli import write_video_corpus  # noqa: E402

from spokennlp_tpu_torch import dryrun  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
FAULTS = ("per_rank_mean", "per_rank_capacity", "per_rank_topic_ids")


def _flags(data, vis, audio, per_device):
    return ["--dataset_name", "clvts", "--data_dir", data, "--vis_feature_dir", vis,
            "--audio_feature_dir", audio, "--do_train", "--do_eval", "--device", "cpu",
            "--hidden_size", "32", "--num_hidden_layers", "1", "--num_attention_heads", "2",
            "--intermediate_size", "48", "--max_seq_length", "64", "--max_clips_per_window", "8",
            "--mm_hidden_size", "16", "--vis_hidden_size", "8", "--audio_hidden_size", "8",
            "--cross_encoder_type", "ma_moe", "--moe_impl", "dispatch",
            "--moe_capacity_factor", "0.5", "--do_modality_cl", "--align_pairs", "tv,av",
            "--do_topic_mm_cl", "--num_train_epochs", "2",
            "--per_device_train_batch_size", str(per_device)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mmvts_corpus")
    return write_video_corpus(root)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, corpus):
    root = tmp_path_factory.mktemp("mmvts_dist")
    res = dryrun.run_workers(2, "torch_dist_helper:mmvts_worker", {
        "flags": _flags(*corpus, 1), "out": str(root),
        "clis": {"dp": [], "mp": ["--per_device_train_batch_size", "2",
                                  "--model_parallel_size", "2"]}},
        timeout=240, sys_path=[TESTS], threads=1)
    return res, root


@pytest.fixture(scope="module")
def single():
    return dryrun.mmvts_step(dryrun.MMVTS_TINY)


@pytest.mark.parametrize("mp", [1, 2])
def test_two_ranks_equal_one_process(two_ranks, single, mp):
    got = two_ranks[0][f"mp {mp}"]
    dryrun.check_step(f"mp {mp}", single, got)
    for k in ("ts_loss", "modality_cl_loss", "topic_mm_cl_loss", "moe_loss"):
        assert abs(got[k] - single[k]) <= dryrun.LOSS_RTOL * max(1.0, abs(single[k])), k
    assert got["argmax"] == single["argmax"]


@pytest.mark.parametrize("fault", FAULTS)
def test_per_rank_shortcuts_miss_the_limit(two_ranks, single, fault):
    with pytest.raises(AssertionError, match="sharded"):
        dryrun.check_step(fault, single, two_ranks[0][fault])


def test_cli_inside_the_group_equals_one_process(two_ranks, corpus, tmp_path):
    from spokennlp_tpu_torch.cli import run_finetune_multimodal

    res, root = two_ranks
    one = run_finetune_multimodal.main(_flags(*corpus, 2) + ["--output_dir", str(tmp_path)])
    for name in ("dp", "mp"):
        got = res[name]
        assert len(got["history"]) == len(one["history"]) == 2
        for g, w in zip(got["history"], one["history"]):
            assert g.keys() == w.keys()
            for k in w:
                assert abs(g[k] - w[k]) <= dryrun.LOSS_RTOL * max(1.0, abs(w[k])), (name, k)
        assert got["eval"] == pytest.approx(one["eval"], abs=1e-9), name
        saved = json.loads((root / name / "mm_results.json").read_text())
        assert saved["eval"] == pytest.approx(got["eval"], abs=1e-12)


def test_one_process_matches_jaxs_data_and_model_parallel_step():
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax

    from spokennlp_tpu.configs import EncoderConfig as JEnc
    from spokennlp_tpu.models.multimodal import MultimodalConfig as JMM
    from spokennlp_tpu.objectives import mmvts_losses as jl
    from spokennlp_tpu.parallel import mesh as jmesh
    from spokennlp_tpu.projects import mmvts as jp
    from spokennlp_tpu_torch.models.checkpoint_io import params_from_state_dict

    p = {**dryrun.MMVTS_TINY, "dropout": 0.0}
    got = dryrun.mmvts_step(p)
    model, batch = dryrun.mmvts_setup(p)
    enc, mm = dryrun.mmvts_configs(p)
    jmodel = jp.MMVTSModel(JEnc(**dataclasses.asdict(enc)), JMM(**dataclasses.asdict(mm)))
    grid = jmesh.make_mesh(2, devices=jax.devices()[:4])
    params = jmesh.shard_params(jax.tree.map(jnp.asarray, params_from_state_dict(
        model.state_dict())), grid)
    jb = jmesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, grid)

    def loss(params):
        out = jmodel.apply({"params": params}, jb["input_ids"], jb["attention_mask"],
                           jb["clip_positions"], jb["clip_mask"], vis_feats=jb["vis_feats"],
                           audio_feats=jb["audio_feats"])
        return jl.mmvts_total_loss(None, out, jb["clip_labels"], jb["clip_mask"],
                                   **dryrun.MMVTS_LOSS)

    (total, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    np.testing.assert_allclose(got["loss"], float(total), rtol=1e-5)
    for k in ("ts_loss", "modality_cl_loss", "topic_mm_cl_loss", "moe_loss"):
        np.testing.assert_allclose(got[k], float(aux[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["grad_norm"], float(optax.global_norm(grads)), rtol=1e-4)
