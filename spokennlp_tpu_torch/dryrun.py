"""Multi-process dry runs on the CPU: ``dryrun_multichip(n)`` (data
parallel) and ``dryrun_moe_ep(n)`` (the expert-sharded MoE).

Counterpart of ``__graft_entry__.dryrun_multichip``: one full train step of
the topic-segmentation model sharded over ``n`` data-parallel ranks (here
``n`` gloo processes on the CPU) must reproduce the single-process step:
the loss within 5e-4 relative and the gradient norm within 5e-3 relative
(JAX's own limits), at dropout 0, first for the dense model and then for the
sliding-window (Longformer) one. Each rank holds 2 of the 2n windows, with
another number of labelled sentences in each, so a loss averaged per rank
would not reproduce the step. Tensor parallel is not part of the port's
dry run (parallel/mesh.py).

``dryrun_moe_ep(n)`` is JAX's expert-parallel check
(tests/test_moe_dispatch.py ``test_dispatch_expert_sharded_ep``) over ``n``
gloo processes: the MoE layer in ``dispatch`` mode (8 experts, top 2,
capacity factor 2) with its ``w_in`` / ``w_out`` split over the ranks by
JAX's expert rule (``parallel/mesh.py expert_range``) and the gate and the
dispatch plan replicated; each rank computes its experts' capacity slots,
and the partial outputs are summed over the ranks (an all-reduce whose
backward is the identity: every rank's loss reads the whole sum). The
output must match the single-process layer's within JAX's limits (atol
1e-5, rtol 1e-4), the balance loss within 1e-4 relative, and the gradients
of a loss over both (x's and the gate's summed over the ranks, each rank's
experts') within the output's limits.

    python -m spokennlp_tpu_torch.dryrun 2          # both
    python -m spokennlp_tpu_torch.dryrun 2 moe_ep   # the MoE alone

``run_workers`` starts the processes (``python -c``, one a rank, joined by
``torch.distributed`` over ``tcp://localhost:<free port>``) and returns
what rank 0's function returned.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

LOSS_RTOL, GRAD_NORM_RTOL = 5e-4, 5e-3
L, K = 64, 8
MOE_TOL, MOE_AUX_RTOL = (1e-5, 1e-4), 1e-4  # (atol, rtol) of y and the gradients


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(n: int, target: str, payload: Dict, timeout: float = 300,
                sys_path: Sequence[str] = (), threads: int = 2):
    """Run ``module:function(payload)`` in ``n`` processes joined in one gloo
    process group (rank i in process i) and return rank 0's result (JSON).
    Every process is waited for, and killed at ``timeout`` seconds."""
    root = str(Path(__file__).resolve().parent.parent)
    port = free_port()
    module, fn = target.split(":")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        path = [root, *sys_path]

        def code(rank: int) -> str:
            return (
                f"import json, sys; sys.path[:0] = {path!r}; import torch; "
                f"torch.set_num_threads({threads}); "
                "from spokennlp_tpu_torch.parallel import dist; "
                f"dist.initialize_distributed('cpu', 'tcp://localhost:{port}', {n}, {rank}); "
                f"import {module} as m; res = m.{fn}(json.loads({json.dumps(payload)!r})); "
                "dist.destroy(); "
                f"{rank} == 0 and json.dump(res, open({out!r}, 'w'))"
            )

        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [*path, os.environ.get("PYTHONPATH", "")])}
        for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        procs = [subprocess.Popen([sys.executable, "-c", code(r)], env=env) for r in range(n)]
        try:
            codes = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise RuntimeError(f"data-parallel workers exited with {codes}")
        with open(out) as f:
            return json.load(f)


def synthetic_batch(n_rows: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """A paired-view (B, 2, L) batch like JAX's dry run's, with 1 to 4
    labelled sentences a row (3 of them eop slots at most)."""
    rng = np.random.default_rng(seed)
    B = n_rows
    batch = {
        "input_ids": rng.integers(3, 511, size=(B, 2, L)).astype(np.int32),
        "attention_mask": np.ones((B, 2, L), np.int32),
        "token_type_ids": np.zeros((B, 2, L), np.int32),
        "labels": np.full((B, 2, L), -100, np.int32),
        "sent_positions": np.zeros((B, 2, K), np.int32),
        "sent_mask": np.zeros((B, 2, K), np.int32),
        "eop_mask": np.zeros((B, 2, K), np.int32),
        "pair_orders": np.full((B, 2, K), -100, np.int32),
    }
    for b in range(B):
        n_sent = 1 + b % 4
        for v in range(2):
            for k, pos in enumerate([1, 9, 17, 25][:n_sent]):
                batch["sent_positions"][b, v, k] = pos
                batch["sent_mask"][b, v, k] = 1
                batch["labels"][b, v, pos] = int(rng.integers(0, 2))
                batch["eop_mask"][b, v, k] = int(k < 3)
                batch["pair_orders"][b, v, k] = int(rng.integers(0, 3))
    return batch


def _configs(trunk: str):
    from spokennlp_tpu_torch.configs import EncoderConfig, TopicSegConfig

    enc = EncoderConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
                        intermediate_size=128, max_position_embeddings=L, add_pooler=False,
                        hidden_dropout=0.0, attention_dropout=0.0)
    if trunk == "sliding_window":
        enc = dataclasses.replace(enc, attention_type="sliding_window", attention_window=16,
                                  position_style="roberta", pad_token_id=1,
                                  max_position_embeddings=L + 8)
    task = TopicSegConfig(cl_anchor_level="eop_matrix", do_tssp=True, do_da_ts=True,
                          classifier_dropout=0.0)
    return enc, task


def train_step_metrics(trunk: str, batch: Dict[str, np.ndarray], world: int = 1,
                       rank: int = 0) -> Dict[str, float]:
    """One step of a fresh model (weights from seed 0) on rank ``rank``'s rows
    of ``batch``: the step's metrics (the global batch's inside a process
    group)."""
    from spokennlp_tpu_torch.configs import TrainConfig
    from spokennlp_tpu_torch.models.topic_seg import TopicSegModel
    from spokennlp_tpu_torch.parallel.mesh import shard_batch
    from spokennlp_tpu_torch.train import optim
    from spokennlp_tpu_torch.train.train_step import batch_to_device, make_topic_seg_train_step

    enc, task = _configs(trunk)
    model = TopicSegModel(enc, task, generator=torch.Generator().manual_seed(0))
    opt = optim.make_optimizer(model, TrainConfig(gradient_accumulation_steps=1), 10)
    step = make_topic_seg_train_step(model, task, opt)
    local = batch_to_device(shard_batch(batch, rank, world), torch.device("cpu"))
    return {k: float(v) for k, v in step(local).items()}


def _dryrun_worker(payload: Dict) -> Dict:
    from spokennlp_tpu_torch.parallel import dist

    batch = synthetic_batch(payload["rows"])
    return {trunk: train_step_metrics(trunk, batch, dist.world_size(), dist.rank())
            for trunk in ("dense", "sliding_window")}


def dryrun_multichip(n_devices: int = 2, timeout: float = 300) -> Dict:
    """The sharded step over ``n_devices`` gloo processes against the
    single-process step, for the dense and the sliding-window model; raises
    if either is outside the limits. Returns both steps' metrics."""
    batch = synthetic_batch(2 * n_devices)
    single = {trunk: train_step_metrics(trunk, batch) for trunk in ("dense", "sliding_window")}
    sharded = run_workers(n_devices, "spokennlp_tpu_torch.dryrun:_dryrun_worker",
                          {"rows": 2 * n_devices}, timeout=timeout)
    for trunk in ("dense", "sliding_window"):
        s, d = single[trunk], sharded[trunk]
        if not np.isfinite(d["loss"]):
            raise AssertionError(f"{trunk}: non-finite sharded loss {d['loss']}")
        if abs(d["loss"] - s["loss"]) > LOSS_RTOL * max(1.0, abs(s["loss"])):
            raise AssertionError(f"{trunk}: sharded loss {d['loss']} != single-process "
                                 f"{s['loss']}")
        if abs(d["grad_norm"] - s["grad_norm"]) > GRAD_NORM_RTOL * max(1.0, abs(s["grad_norm"])):
            raise AssertionError(f"{trunk}: sharded grad_norm {d['grad_norm']} != "
                                 f"single-process {s['grad_norm']}")
        print(f"dryrun_multichip ok ({trunk}): {n_devices} gloo processes (dp={n_devices}), "
              f"loss {d['loss']:.6f} grad_norm {d['grad_norm']:.6f}; single-process loss "
              f"{s['loss']:.6f} grad_norm {s['grad_norm']:.6f}")
    return {"single": single, "sharded": sharded}


def _moe_setup():
    """The MoE layer (weights from seed 0), x, its mask (the second row
    padded after 12 tokens) and the loss's probe, as JAX's EP test sizes
    them: B=2, L=16, H=32, 8 experts of width 64, top 2."""
    from spokennlp_tpu_torch.models.multimodal import MoELayer, MultimodalConfig

    cfg = MultimodalConfig(hidden_size=32, intermediate_size=64, hidden_dropout=0.0,
                           attention_dropout=0.0, moe_num_experts=8, moe_top_k=2,
                           moe_residual=False, moe_impl="dispatch", moe_capacity_factor=2.0)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 16, 32)).astype(np.float32)).requires_grad_()
    mask = torch.ones((2, 16), dtype=torch.int32)
    mask[1, 12:] = 0
    probe = torch.from_numpy(rng.normal(size=(2, 16, 32)).astype(np.float32))
    return MoELayer(cfg, 32, generator=torch.Generator().manual_seed(0)), x, mask, probe


class _SumRanks(torch.autograd.Function):
    """An all-reduce sum whose backward is the identity (every rank's loss
    reads the whole sum)."""

    @staticmethod
    def forward(ctx, y):
        total = y.detach().clone()
        torch.distributed.all_reduce(total)
        return total

    @staticmethod
    def backward(ctx, g):
        return g


def _moe_result(layer, x, y, aux) -> Dict:
    """y, aux and the gradients of sum(y * probe) + aux (already run
    backward), as JSON lists."""
    as_list = lambda t: t.detach().numpy().tolist()
    return {"y": as_list(y), "aux": float(aux.detach()), "dx": as_list(x.grad),
            "dgate_kernel": as_list(layer.gate.kernel.grad),
            "dgate_bias": as_list(layer.gate.bias.grad),
            "dw_in": as_list(layer.w_in.grad), "dw_out": as_list(layer.w_out.grad)}


def moe_single() -> Dict:
    """The single-process layer: its forward, then the loss's gradients."""
    layer, x, mask, probe = _moe_setup()
    y, aux = layer(x, mask)
    ((y * probe).sum() + aux).backward()
    return _moe_result(layer, x, y, aux)


def _moe_ep_worker(payload: Dict) -> Dict:
    """One rank of the expert-sharded layer: the gate and the dispatch plan
    replicated, this rank's experts' slots, the partial outputs summed over
    the ranks; x's and the gate's gradients summed over the ranks, the
    experts' gathered in rank order. The balance loss enters the loss on
    rank 0 only, so that the summed gradients count it once."""
    from spokennlp_tpu_torch.models import multimodal as mm
    from spokennlp_tpu_torch.parallel import dist
    from spokennlp_tpu_torch.parallel.mesh import expert_range

    layer, x, mask, probe = _moe_setup()
    cfg = layer.cfg
    world, rank = dist.world_size(), dist.rank()
    experts = expert_range(rank, world, cfg.moe_num_experts)
    B, L, H = x.shape
    topi, gates_k, dense = mm.route(layer.gate(x.float()), cfg.moe_top_k, cfg.moe_num_experts)
    slot, gate, C = mm.dispatch_plan(mask, topi, gates_k, cfg)
    part = mm.dispatch_experts(x.reshape(B * L, H).float(), slot, gate, C,
                               layer.w_in[experts.start:experts.stop],
                               layer.w_out[experts.start:experts.stop], experts.start)
    y = _SumRanks.apply(part).reshape(B, L, H)
    aux = mm.balance_loss(dense, mask, cfg.moe_loss_weight)
    ((y * probe).sum() + (aux if rank == 0 else 0.0)).backward()
    for p in (x, layer.gate.kernel, layer.gate.bias):
        torch.distributed.all_reduce(p.grad)
    for p in (layer.w_in, layer.w_out):
        p.grad = torch.cat(dist.all_gather_tensors(p.grad[experts.start:experts.stop]))
    return _moe_result(layer, x, y, aux)


def dryrun_moe_ep(n_ranks: int = 2, timeout: float = 300) -> Dict:
    """The expert-sharded MoE over ``n_ranks`` gloo processes against the
    single-process layer; raises outside the limits. Returns both."""
    single = moe_single()
    sharded = run_workers(n_ranks, "spokennlp_tpu_torch.dryrun:_moe_ep_worker", {},
                          timeout=timeout, threads=1)
    atol, rtol = MOE_TOL
    for key in ("y", "dx", "dgate_kernel", "dgate_bias", "dw_in", "dw_out"):
        got, want = np.asarray(sharded[key]), np.asarray(single[key])
        if not np.allclose(got, want, atol=atol, rtol=rtol):
            raise AssertionError(f"dryrun_moe_ep: {key} differs by {np.abs(got - want).max()}")
    if abs(sharded["aux"] - single["aux"]) > MOE_AUX_RTOL * abs(single["aux"]):
        raise AssertionError(f"dryrun_moe_ep: aux {sharded['aux']} != {single['aux']}")
    print(f"dryrun_moe_ep ok: {n_ranks} gloo processes, 8 experts split "
          f"{8 // n_ranks} a rank; y, aux {sharded['aux']:.6e} and the gradients of x, the gate "
          f"and the experts match the single-process layer")
    return {"single": single, "sharded": sharded}


def main(argv: Optional[Sequence[str]] = None):
    args = list(sys.argv[1:] if argv is None else argv)
    n = int(args[0]) if args else 2
    if "moe_ep" not in args[1:]:
        dryrun_multichip(n)
    dryrun_moe_ep(n)


if __name__ == "__main__":
    main()
