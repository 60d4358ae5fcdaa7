"""The model axis on the port (``--model_parallel_size``: parallel/mesh.py,
parallel/dist.py, models/encoder.py, models/checkpoint_io.py) on the CPU,
and the deterministic embedding backward (models/encoder.py ``lookup``).

- The partition rule is JAX's ``param_partition_spec``, name for name, on
  the topic-segmentation (dense, Longformer, BigBird) and MMVTS trees.
- One step of the dense, the Longformer and the BigBird model, on the
  einsum path (each rank its heads and MLP columns) and the fused path's
  plain versions (the weights gathered whole), at world 2 (mp 2) and world 4 (mp 2 x dp 2),
  equals the one-process step within the dry run's limits (loss 5e-4,
  gradient norm 5e-3, relative); the gradient norm counted on each rank's
  shards alone (the planted fault) misses them.
- The one-process step equals JAX's own mp 2 step (``make_mesh(2)`` over 4
  of the test process's 8 CPU devices) within 1e-5 (loss) and 1e-4
  (gradient norm), relative.
- run_finetune and run_inference with ``--model_parallel_size 2`` inside the
  group (world 2; run_finetune and run_finetune_multimodal at world 4 too)
  give the one-process results; a native checkpoint crosses between mp 1
  and mp 2 bit for bit.
- The embedding's backward equals ``F.embedding``'s to 1e-6 and repeats
  itself bit for bit (on the card too: ``-m gpu``).

The ranks are spawned once a world (module-scoped fixtures), as in
tests/test_torch_dist.py.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_helper as helper  # noqa: E402
from test_torch_dist import _corpus  # noqa: E402
from test_torch_mmvts_cli import write_video_corpus  # noqa: E402

from spokennlp_tpu_torch import dryrun  # noqa: E402
from spokennlp_tpu_torch.parallel import mesh  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
ROWS = 4
TOPIC_FLAGS = ["--device", "cpu", "--hidden_size", "32", "--num_hidden_layers", "2",
               "--num_attention_heads", "2", "--intermediate_size", "64", "--max_seq_length",
               "64", "--num_train_epochs", "1", "--gradient_accumulation_steps", "1",
               "--threshold", "0.5"]


def _finetune_flags(data, out, per_device):
    return ["--data_dir", data, *TOPIC_FLAGS, "--do_train", "--do_eval", "--do_predict",
            "--per_device_train_batch_size", str(per_device), "--output_dir", out]


def _mmvts_flags(root, out, per_device):
    data, vis, audio = write_video_corpus(root)
    return ["--dataset_name", "clvts", "--data_dir", data, "--vis_feature_dir", vis,
            "--audio_feature_dir", audio, "--do_train", "--do_eval", "--device", "cpu",
            "--hidden_size", "32", "--num_hidden_layers", "1", "--num_attention_heads", "2",
            "--intermediate_size", "48", "--max_seq_length", "64", "--max_clips_per_window", "8",
            "--mm_hidden_size", "16", "--vis_hidden_size", "8", "--audio_hidden_size", "8",
            "--cross_encoder_type", "ma_moe", "--moe_impl", "dispatch", "--do_modality_cl",
            "--align_pairs", "tv,av", "--do_topic_mm_cl", "--num_train_epochs", "1",
            "--per_device_train_batch_size", str(per_device), "--output_dir", out]


def _model(seed):
    from spokennlp_tpu_torch.models.topic_seg import TopicSegModel

    enc, task, _ = helper.configs()
    return TopicSegModel(enc, task, generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    from spokennlp_tpu_torch.models import checkpoint_io

    root = tmp_path_factory.mktemp("mp2")
    data = _corpus(root)
    checkpoint_io.save_checkpoint(str(root / "ckpt_in"), checkpoint_io.params_from_state_dict(
        _model(7).state_dict()))
    clis = {"finetune": _finetune_flags(data, str(root / "ft"), 2) + ["--model_parallel_size",
                                                                      "2"],
            "inference": ["--data_dir", data, *TOPIC_FLAGS, "--per_device_eval_batch_size", "2",
                          "--model_parallel_size", "2", "--output_dir", str(root / "inf")]}
    res = dryrun.run_workers(2, "torch_dist_helper:mp_worker", {
        "rows": ROWS, "clis": clis, "checkpoint_in": str(root / "ckpt_in"),
        "checkpoint_out": str(root / "ckpt_out")}, timeout=300, sys_path=[TESTS], threads=1)
    return res, root, data


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp4")
    data = _corpus(root)
    clis = {"finetune": _finetune_flags(data, str(root / "ft"), 1) + ["--model_parallel_size",
                                                                      "2"],
            "mmvts": _mmvts_flags(root, str(root / "mm"), 1) + ["--model_parallel_size", "2"]}
    res = dryrun.run_workers(4, "torch_dist_helper:mp_worker", {"rows": ROWS, "clis": clis},
                             timeout=300, sys_path=[TESTS], threads=1)
    return res, root, data


@pytest.fixture(scope="module")
def single_steps():
    batch = dryrun.synthetic_batch(ROWS)
    return {f"{trunk} {impl}": dryrun.train_step_metrics(trunk, batch, impl)
            for trunk in dryrun.MP_TRUNKS for impl in dryrun.MP_IMPLS}


def test_partition_rule_is_jaxs():
    """param_partition_dim against JAX's param_partition_spec on every
    parameter of the dense, Longformer and BigBird topic-segmentation trees
    and the MMVTS tree (ma_moe, transformer projector and predictor)."""
    from jax.sharding import PartitionSpec

    from spokennlp_tpu.parallel.mesh import param_partition_spec
    from spokennlp_tpu_torch.models.multimodal import MultimodalConfig
    from spokennlp_tpu_torch.models.topic_seg import TopicSegModel
    from spokennlp_tpu_torch.projects.mmvts import MMVTSModel

    models = [TopicSegModel(*dryrun._configs(t)) for t in dryrun.MP_TRUNKS]
    enc, _ = dryrun._configs("dense")
    models.append(MMVTSModel(enc, MultimodalConfig(
        hidden_size=16, text_hidden_size=64, vis_hidden_size=8, audio_hidden_size=8,
        cross_encoder_type="ma_moe", num_cross_encoder_heads=2, intermediate_size=32,
        projector_type="transformer", predictor_type="transformer")))
    sharded = 0
    for model in models:
        for name, p in model.named_parameters():
            class Key:  # a jax tree path entry
                def __init__(self, key):
                    self.key = key

            spec = param_partition_spec(tuple(Key(k) for k in name.split(".")), p)
            want = next((i for i, a in enumerate(spec) if a == "model"), None)
            assert mesh.param_partition_dim(name, p.ndim) == want, (name, spec)
            assert isinstance(spec, PartitionSpec)
            sharded += want is not None
    assert sharded > 20


def test_steps_equal_one_process_at_world_2_and_4(world2, world4, single_steps):
    for res in (world2[0], world4[0]):
        for key, s in single_steps.items():
            dryrun.check_step(key, s, res[key])
    assert world2[0]["sharded_params"] == 2 * 6  # qkv, out, mlp_in, mlp_out: 6 a layer


def test_a_gradient_norm_of_each_ranks_shards_misses_the_limit(world2, single_steps):
    """The planted fault: the norm of each rank's own shards (no sum over the
    model group) as the clipping norm."""
    fault = world2[0]["fault"]
    assert abs(fault["loss"] - single_steps["dense einsum"]["loss"]) < 1e-5
    with pytest.raises(AssertionError, match="grad_norm"):
        dryrun.check_step("fault", single_steps["dense einsum"], fault)


def test_one_process_step_matches_jaxs_mp2_step(single_steps):
    import jax
    import jax.numpy as jnp

    from spokennlp_tpu.configs import EncoderConfig as JEnc
    from spokennlp_tpu.configs import TopicSegConfig as JTask
    from spokennlp_tpu.configs import TrainConfig as JTrain
    from spokennlp_tpu.models.topic_seg import TopicSegModel as JModel
    from spokennlp_tpu.parallel import mesh as jmesh
    from spokennlp_tpu.train.optim import make_optimizer as jax_optimizer
    from spokennlp_tpu.train.train_step import create_train_state
    from spokennlp_tpu.train.train_step import make_topic_seg_train_step as jax_step
    from spokennlp_tpu_torch.models.checkpoint_io import params_from_state_dict
    from spokennlp_tpu_torch.models.topic_seg import TopicSegModel

    enc, task = dryrun._configs("dense")
    port = TopicSegModel(enc, task, generator=torch.Generator().manual_seed(0))
    grid = jmesh.make_mesh(2, devices=jax.devices()[:4])
    assert dict(grid.shape) == {"data": 2, "model": 2}
    params = jmesh.shard_params(jax.tree.map(jnp.asarray, params_from_state_dict(
        port.state_dict())), grid)
    tx = jax_optimizer(JTrain(gradient_accumulation_steps=1), 10)
    jtask = JTask(**dataclasses.asdict(task))
    _, metrics = jax_step(JModel(JEnc(**dataclasses.asdict(enc)), jtask), jtask, tx)(
        create_train_state(params, tx), jmesh.shard_batch(dryrun.synthetic_batch(ROWS), grid),
        jax.random.PRNGKey(0))
    got = single_steps["dense einsum"]
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(metrics["grad_norm"]), rtol=1e-4)


def _params(path):
    from spokennlp_tpu_torch.models import checkpoint_io
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict

    return jax_params_to_state_dict(checkpoint_io.load_checkpoint(str(path))[0])


def test_clis_with_model_parallel_size_2_equal_one_process(world2, world4, tmp_path):
    """run_finetune (world 2: mp 2; world 4: mp 2 x dp 2 at half the
    per-device batch) against one process: train steps, the eval and
    predict metrics, the whole final weights written by rank 0; run_inference
    (world 2) its metrics."""
    from spokennlp_tpu_torch.cli import run_finetune, run_inference

    res2, root2, data = world2
    one = run_finetune.main(_finetune_flags(data, str(tmp_path / "ft"), 2))
    for res, root in ((res2, root2), (world4[0], world4[1])):
        got = res["finetune"]
        assert got["train_steps"] == one["train_steps"] >= 1
        for k, v in one.items():
            if k.startswith(("eval_", "predict_", "final_")):
                assert got[k] == pytest.approx(v, abs=1e-6), k
        # AdamW's first steps move an entry by about lr (5e-5) whatever its
        # gradient's size, and one whose gradient is 0 in exact arithmetic
        # (the key bias) by the sign of a rounding: the whole weights agree
        # within two steps' reach (a head or a column out of place would be
        # off by the weights' own scale, 1e-2 and more)
        want, have = _params(tmp_path / "ft" / "final_model"), _params(
            root / "ft" / "final_model")
        assert want.keys() == have.keys()
        reach = 2 * 5e-5 * one["train_steps"]
        for name, w in want.items():
            np.testing.assert_allclose(have[name].numpy(), w.numpy(), rtol=0, atol=reach,
                                       err_msg=name)
    inf = run_inference.main(["--data_dir", data, *TOPIC_FLAGS, "--per_device_eval_batch_size",
                              "2", "--output_dir", str(tmp_path / "inf")])["metrics"]
    assert res2["inference"] == pytest.approx({k: float(v) for k, v in inf.items()}, abs=1e-6)


def test_mmvts_cli_at_world_4_with_model_parallel_size_2(world4, tmp_path):
    """run_finetune_multimodal at world 4 (mp 2: the trunk's and fusion's
    heads and columns and the MoE's experts sharded; dp 2 at half the
    per-device batch) against one process: the epoch's losses within the
    dry run's limit, the video metrics equal."""
    from spokennlp_tpu_torch.cli import run_finetune_multimodal

    one = run_finetune_multimodal.main(_mmvts_flags(tmp_path, str(tmp_path / "mm"), 2))
    got = world4[0]["mmvts"]
    for g, w in zip(got["history"], one["history"]):
        assert g.keys() == w.keys()
        for k in w:
            assert abs(g[k] - w[k]) <= dryrun.LOSS_RTOL * max(1.0, abs(w[k])), k
    assert got["eval"] == pytest.approx(one["eval"], abs=1e-9)
    assert (world4[1] / "mm" / "mm_results.json").exists()


def test_native_checkpoints_cross_model_parallel_sizes_bit_for_bit(world2):
    """A checkpoint written at mp 1 loads into the mp 2 model (each rank its
    slices) and, gathered whole and written by rank 0, equals it bit for
    bit; the model's mp 2 shards are 6 parameters a layer."""
    _, root, _ = world2
    want, got = _params(root / "ckpt_in"), _params(root / "ckpt_out")
    assert want.keys() == got.keys()
    for name in want:
        assert torch.equal(want[name], got[name]), name


def test_check_model_parallel_and_shard_round_trip():
    model = _model(0)
    whole = {n: t.clone() for n, t in model.state_dict().items()}

    class Axis:
        def __init__(self, index):
            self.index, self.size = index, 2

    parts = []
    for index in range(2):
        m = _model(0)
        assert mesh.shard_module_(m, Axis(index)) == 12
        parts.append(m)
    for name, p in parts[0].named_parameters():
        mark = getattr(p, "model_shard", None)
        if mark is None:
            assert torch.equal(p, whole[name])
        else:
            q = dict(parts[1].named_parameters())[name]
            assert torch.equal(torch.cat([p, q], mark[0]), whole[name]), name
    with pytest.raises(ValueError, match="--model_parallel_size 3"):
        mesh.check_model_parallel(3, 4)


@pytest.mark.parametrize("rows", [2, 512, 5000])
def test_embedding_backward_equals_f_embedding_and_repeats(rows):
    """The one-hot product (2 and 512 rows) and the sorted segment sum (5000
    rows) against F.embedding's gradient (1e-6), every id repeated many
    times; two runs give the same bits."""
    from spokennlp_tpu_torch.models.encoder import ONE_HOT_ROWS, lookup

    assert (rows > ONE_HOT_ROWS) == (rows == 5000)
    gen = torch.Generator().manual_seed(rows)
    table = torch.randn(rows, 24, generator=gen, requires_grad=True)
    ids = torch.randint(0, min(rows, 40), (6, 50), generator=gen)
    probe = torch.randn(6, 50, 24, generator=gen)
    (want,) = torch.autograd.grad((F.embedding(ids, table) * probe).sum(), table)
    got = [torch.autograd.grad((lookup(table, ids) * probe).sum(), table)[0] for _ in range(2)]
    torch.testing.assert_close(got[0], want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[0], got[1])
    assert torch.equal(lookup(table, ids), F.embedding(ids, table))


@pytest.mark.gpu
def test_embedding_backward_repeats_itself_bit_for_bit_on_the_card():
    """A batch of 8 x 1024 ids with heavy repeats (token types, positions,
    a vocabulary with a pad id on half the tokens): both backward routes
    twice give the same bits, within 1e-5 of F.embedding's largest entry (a
    float32 sum of 6,000 rows in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from spokennlp_tpu_torch.models.encoder import lookup

    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows in (2, 512, 30522):
        table = torch.randn(rows, 768, device="cuda", generator=gen, requires_grad=True)
        ids = torch.randint(0, rows, (8, 1024), device="cuda", generator=gen)
        ids[:, 512:] = 0
        probe = torch.randn(8, 1024, 768, device="cuda", generator=gen)
        runs = [torch.autograd.grad((lookup(table, ids) * probe).sum(), table)[0]
                for _ in range(2)]
        assert torch.equal(runs[0], runs[1]), rows
        (want,) = torch.autograd.grad((F.embedding(ids, table) * probe).sum(), table)
        torch.testing.assert_close(runs[0], want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
