"""Data parallel in the port (parallel/dist.py, parallel/mesh.py) on the CPU:
two gloo processes against one.

- One train step sharded over 2 ranks equals the single-process step within
  the dry run's limits (loss 5e-4, gradient norm 5e-3, relative), with
  list-mode CSSL (whose indices span both ranks' rows), TSSP, the DA view
  and weighted cross-entropy, on a batch whose ranks hold different counts
  of labels and eop slots: a mean of per-rank losses misses that limit.
- ``allgather_ragged``, the engine's scorer and ``run_topic_seg_inference``
  give every rank the single-process results; ``run_finetune`` and
  ``run_inference`` run inside the group.
- ``dryrun_multichip(2)``: the dense and the sliding-window models.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_helper as helper  # noqa: E402

from spokennlp_tpu_torch import dryrun  # noqa: E402
from spokennlp_tpu_torch.parallel import mesh  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))


def _corpus(root):
    rng = np.random.default_rng(2)
    d = root / "wiki_section"
    d.mkdir()
    for split, n in (("train.jsonl", 5), ("dev.jsonl", 3), ("test.jsonl", 3)):
        with open(d / split, "w") as f:
            for _ in range(n):
                ns = int(rng.integers(8, 14))
                sents = [" ".join(f"w{i}" for i in rng.integers(0, 50, size=rng.integers(3, 8)))
                         for _ in range(ns)]
                labels = [int(rng.random() < 0.25) for _ in range(ns - 1)] + [1]
                f.write(json.dumps({"sentences": sents, "labels": labels}) + "\n")
    return str(d)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    flags = ["--data_dir", _corpus(root), "--device", "cpu", "--jax_distributed",
             "--hidden_size", "32", "--num_hidden_layers", "2", "--num_attention_heads", "2",
             "--intermediate_size", "64", "--max_seq_length", "64", "--num_train_epochs", "1",
             "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "1",
             "--do_train", "--do_eval", "--do_predict", "--threshold", "0.5"]
    res = dryrun.run_workers(2, "torch_dist_helper:worker", {"flags": flags, "out": str(root)},
                             timeout=240, sys_path=[TESTS])
    return res, root


def test_sharded_step_equals_the_single_process_step(two_ranks):
    res, _ = two_ranks
    single, sharded = helper.step(), res["step"]
    assert set(single) == set(sharded)
    for k in ("loss", "ts_loss", "cl_loss", "da_ts_loss", "tssp_loss"):
        assert abs(sharded[k] - single[k]) <= dryrun.LOSS_RTOL * max(1.0, abs(single[k])), k
    assert abs(sharded["grad_norm"] - single["grad_norm"]) <= (
        dryrun.GRAD_NORM_RTOL * max(1.0, single["grad_norm"]))
    # both ranks took the same clipped AdamW step as the single process
    for name, v in single["params"].items():
        assert sharded["params"][name] == pytest.approx(v, rel=1e-5), name


def test_a_mean_of_per_rank_losses_misses_the_limit():
    """The planted fault of a per-rank mean (DDP's default reduction): on
    this batch the ranks' label and eop counts differ, so averaging each
    rank's own cross-entropies misses the loss limit."""
    from spokennlp_tpu_torch.models.topic_seg import compute_topic_seg_loss
    from spokennlp_tpu_torch.train.train_step import batch_to_device

    _, task, _ = helper.configs()
    task = type(task)(**{**task.__dict__, "cl_loss_weight": 0.0})  # no cross-rank indices
    m = helper.model().train()
    batch = helper.global_batch()
    counts = [int((b["labels"][:, 0] != -100).sum()) for b in
              (mesh.shard_batch(batch, r, 2) for r in range(2))]
    assert counts[0] != counts[1]

    def loss(b):
        b = batch_to_device(b, torch.device("cpu"))
        views = [m(b["input_ids"][:, v], attention_mask=b["attention_mask"][:, v],
                   token_type_ids=b["token_type_ids"][:, v],
                   sent_positions=b["sent_positions"][:, v]) for v in (0, 1)]
        return float(compute_topic_seg_loss(task, views[0], views[1], b)[0])

    with torch.no_grad():
        full = loss(batch)
        per_rank = np.mean([loss(mesh.shard_batch(batch, r, 2)) for r in range(2)])
    assert abs(per_rank - full) > dryrun.LOSS_RTOL * max(1.0, abs(full))


def test_allgather_ragged_and_the_engine_under_two_ranks(two_ranks):
    res, _ = two_ranks
    # rank 0 gave [[], [0]], rank 1 [[], [1], [1, 1]]: rank order
    assert res["ragged"] == [[], [0], [], [1], [1, 1]]
    single = helper.scores()
    np.testing.assert_allclose(res["scores"]["logits"], single["logits"], atol=1e-5, rtol=0)
    assert len(res["scores"]["per_doc"]) == len(single["per_doc"])
    for got, want in zip(res["scores"]["per_doc"], single["per_doc"]):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert res["scores"]["metrics"] == pytest.approx(single["metrics"], abs=1e-6)


def test_clis_run_inside_the_group(two_ranks):
    res, root = two_ranks
    ft = res["finetune"]
    # 5 train documents at 2 rows a rank: global batches of 4
    assert ft["train_steps"] >= 1 and np.isfinite(ft["eval_f1"])
    assert any(k.startswith("predict_") for k in ft)
    saved = json.loads((root / "ft" / "all_results.json").read_text())
    assert saved["train_steps"] == ft["train_steps"]
    assert (root / "ft" / "final_model" / "params.msgpack").exists()
    assert {p.name for p in (root / "inf").iterdir()} >= {
        "predict_test_max_seq64_ts_score_lt.txt", "predict_test_max_seq64_ts_score_lt_results.json"}
    assert all(np.isfinite(v) for v in res["inference"].values())


def test_shard_batch_and_model_parallel_checks():
    batch = {"input_ids": np.arange(8).reshape(4, 2), "cssl_anchor_indices": np.arange(5)}
    got = mesh.shard_batch(batch, 1, 2)
    np.testing.assert_array_equal(got["input_ids"], [[4, 5], [6, 7]])
    np.testing.assert_array_equal(got["cssl_anchor_indices"], np.arange(5))
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch(batch, 0, 3)
    with pytest.raises(NotImplementedError, match="later slice"):
        mesh.check_model_parallel(2)
    assert [mesh.rank_rows(5, r, 2) for r in range(2)] == [(0, 3), (3, 6)]
    assert [mesh.rank_rows(1, r, 2) for r in range(2)] == [(0, 1), (1, 2)]


def test_dryrun_multichip_two_processes():
    out = dryrun.dryrun_multichip(2, timeout=240)
    for trunk in ("dense", "sliding_window"):
        assert np.isfinite(out["sharded"][trunk]["loss"])
