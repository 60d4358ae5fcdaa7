"""Multi-process dry runs on the CPU (or, with ``device="cuda"``, ranks
sharing one card over gloo): each holds n gloo processes against one
process on the same global batch and raises outside its limits.

- ``dryrun_multichip(n)``: the topic-segmentation train step data parallel.
  Counterpart of ``__graft_entry__.dryrun_multichip``: one full train step
  sharded over ``n`` data-parallel ranks must reproduce the single-process
  step: the loss within 5e-4 relative and the gradient norm within 5e-3
  relative (JAX's own limits), first for the dense model and then for the
  sliding-window (Longformer) one. Each rank holds 2 of the 2n windows,
  with another number of labelled sentences in each, so a loss averaged
  per rank would not reproduce the step.
- ``dryrun_model_parallel()``: the model axis (``--model_parallel_size``
  2) at world 4 (mp 2 x dp 2) and world 2 (mp 2), dense, Longformer and
  BigBird, on the einsum path (each rank its heads and MLP columns) and the fused
  path's plain versions (the weights gathered whole), within the same
  limits.
- ``dryrun_sld_dp(n)``: SLD data parallel (``sld_step``): the global
  batch's time masks and dropout, the global CE counts and KL batch, the
  loss and gradient norm within the limits, the time masks and a greedy
  decode equal.
- ``dryrun_mmvts_dp(n, mp)``: MMVTS over (n // mp, mp) (``mmvts_step``):
  the modality InfoNCE and the matrix topic CL over every rank's clips, the
  MoE's dispatch planned over every rank's tokens (and its experts sharded
  over the model axis when mp > 1), within the limits, the eval argmax
  equal.
- ``dryrun_moe_ep(n)``: JAX's expert-parallel check
  (tests/test_moe_dispatch.py ``test_dispatch_expert_sharded_ep``) over
  ``n`` gloo processes: the MoE layer in ``dispatch`` mode (8 experts, top
  2, capacity factor 2) with its ``w_in`` / ``w_out`` split over the ranks
  by JAX's expert rule (``parallel/mesh.py``), through the layer's own
  expert-parallel path: the gate and the dispatch plan replicated, each
  rank its experts' capacity slots, the shares summed over the ranks (an
  all-reduce whose backward is the identity: every rank's loss reads the
  whole sum).
  The output must match the single-process layer's within JAX's limits
  (atol 1e-5, rtol 1e-4), the balance loss within 1e-4 relative, and the
  gradients of a loss over both (x's and the gate's summed over the ranks,
  each rank's experts') within the output's limits.

    python -m spokennlp_tpu_torch.dryrun 2                  # every gate
    python -m spokennlp_tpu_torch.dryrun 2 sld_dp mmvts_dp  # chosen gates
    python -m spokennlp_tpu_torch.dryrun 2 model_parallel   # worlds 4 and 2

``run_workers`` starts the processes (``python -c``, one a rank, joined by
``torch.distributed`` over ``tcp://localhost:<free port>``) and returns
what rank 0's function returned.
"""

from __future__ import annotations

import contextlib
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
                sys_path: Sequence[str] = (), threads: int = 2, device: str = "cpu"):
    """Run ``module:function(payload)`` in ``n`` processes joined in one gloo
    process group (rank i in process i) and return rank 0's result (JSON).
    Every process is waited for, and killed at ``timeout`` seconds.
    ``device`` "cuda": every rank on the one card (gloo crosses through the
    host; NCCL refuses two ranks on one GPU)."""
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
                f"dist.initialize_distributed({device!r}, 'tcp://localhost:{port}', {n}, {rank}, "
                "backend='gloo'); "
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


def _configs(trunk: str, impl: str = "einsum"):
    from spokennlp_tpu_torch.configs import EncoderConfig, TopicSegConfig

    enc = EncoderConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                        intermediate_size=128, max_position_embeddings=L, add_pooler=False,
                        hidden_dropout=0.0, attention_dropout=0.0, attention_impl=impl)
    if trunk == "sliding_window":
        enc = dataclasses.replace(enc, attention_type="sliding_window", attention_window=16,
                                  position_style="roberta", pad_token_id=1,
                                  max_position_embeddings=L + 8)
    elif trunk == "bigbird":  # 8 blocks of 8: 1 global, 2 random a row
        enc = dataclasses.replace(enc, attention_type="bigbird", bigbird_block_size=8,
                                  bigbird_num_global_blocks=1, bigbird_num_random_blocks=2)
    task = TopicSegConfig(cl_anchor_level="eop_matrix", do_tssp=True, do_da_ts=True,
                          classifier_dropout=0.0)
    return enc, task


def train_step_metrics(trunk: str, batch: Dict[str, np.ndarray], impl: str = "einsum",
                       mp: int = 1) -> Dict[str, float]:
    """One step of a fresh model (weights from seed 0) on this rank's rows of
    ``batch``: the step's metrics (the global batch's inside a process
    group). ``mp``: the process group is laid out as (world // mp, mp) and
    the model sharded over the model axis (parallel/mesh.py)."""
    from spokennlp_tpu_torch.configs import TrainConfig
    from spokennlp_tpu_torch.models.topic_seg import TopicSegModel
    from spokennlp_tpu_torch.parallel import dist
    from spokennlp_tpu_torch.parallel.mesh import shard_batch, shard_module_
    from spokennlp_tpu_torch.train import optim
    from spokennlp_tpu_torch.train.train_step import batch_to_device, make_topic_seg_train_step

    enc, task = _configs(trunk, impl)
    model = TopicSegModel(enc, task, generator=torch.Generator().manual_seed(0))
    mesh = dist.make_mesh(mp)
    shard_module_(model, dist.model_axis())
    opt = optim.make_optimizer(model, TrainConfig(gradient_accumulation_steps=1), 10)
    step = make_topic_seg_train_step(model, task, opt)
    local = batch_to_device(shard_batch(batch, mesh.data_index, mesh.data_size),
                            torch.device("cpu"))
    return {k: float(v) for k, v in step(local).items()}


def _dryrun_worker(payload: Dict) -> Dict:
    batch = synthetic_batch(payload["rows"])
    return {f"{trunk} {impl}": train_step_metrics(trunk, batch, impl, payload.get("mp", 1))
            for trunk in payload.get("trunks", ("dense", "sliding_window"))
            for impl in payload.get("impls", ["einsum"])}


def check_step(label: str, single: Dict[str, float], sharded: Dict[str, float]):
    """Raise unless the sharded step's loss and gradient norm are the
    single-process step's within LOSS_RTOL and GRAD_NORM_RTOL."""
    s, d = single, sharded
    if not np.isfinite(d["loss"]):
        raise AssertionError(f"{label}: non-finite sharded loss {d['loss']}")
    if abs(d["loss"] - s["loss"]) > LOSS_RTOL * max(1.0, abs(s["loss"])):
        raise AssertionError(f"{label}: sharded loss {d['loss']} != single-process {s['loss']}")
    if abs(d["grad_norm"] - s["grad_norm"]) > GRAD_NORM_RTOL * max(1.0, abs(s["grad_norm"])):
        raise AssertionError(f"{label}: sharded grad_norm {d['grad_norm']} != single-process "
                             f"{s['grad_norm']}")


def dryrun_multichip(n_devices: int = 2, timeout: float = 300) -> Dict:
    """The sharded step over ``n_devices`` gloo processes against the
    single-process step, for the dense and the sliding-window model; raises
    if either is outside the limits. Returns both steps' metrics."""
    batch = synthetic_batch(2 * n_devices)
    single = {trunk: train_step_metrics(trunk, batch) for trunk in ("dense", "sliding_window")}
    sharded = run_workers(n_devices, "spokennlp_tpu_torch.dryrun:_dryrun_worker",
                          {"rows": 2 * n_devices}, timeout=timeout)
    sharded = {trunk: sharded[f"{trunk} einsum"] for trunk in single}
    for key, s in single.items():
        d = sharded[key]
        check_step(key, s, d)
        print(f"dryrun_multichip ok ({key}): {n_devices} gloo processes (dp={n_devices}), "
              f"loss {d['loss']:.6f} grad_norm {d['grad_norm']:.6f}; single-process loss "
              f"{s['loss']:.6f} grad_norm {s['grad_norm']:.6f}")
    return {"single": single, "sharded": sharded}


MP_TRUNKS = ("dense", "sliding_window", "bigbird")
MP_IMPLS = ("einsum", "fused")
"""The model-axis gate's paths: the einsum path (each rank its heads and
MLP columns, summed over the model group) and ``fused`` (in training the
training kernels' path, their plain versions on the CPU: the weights
gathered whole)."""


def dryrun_model_parallel(worlds: Sequence[int] = (4, 2), mp: int = 2, rows: int = 4,
                          timeout: float = 300) -> Dict:
    """The model axis: one step of the dense, the sliding-window and the
    BigBird model (MP_TRUNKS) on both paths of MP_IMPLS, over ``world`` gloo
    processes laid out as (world // mp, mp) (world 4: mp 2 x dp 2; world 2:
    mp 2 alone) against the single-process step on the same global batch of
    ``rows``; raises outside the limits. Returns every run's metrics."""
    batch = synthetic_batch(rows)
    single = {f"{trunk} {impl}": train_step_metrics(trunk, batch, impl)
              for trunk in MP_TRUNKS for impl in MP_IMPLS}
    out = {"single": single}
    for world in worlds:
        sharded = run_workers(world, "spokennlp_tpu_torch.dryrun:_dryrun_worker",
                              {"rows": rows, "mp": mp, "impls": list(MP_IMPLS),
                               "trunks": list(MP_TRUNKS)}, timeout=timeout, threads=1)
        for key, s in single.items():
            check_step(f"{key}, world {world} mp {mp}", s, sharded[key])
        print(f"dryrun_model_parallel ok: world {world} as dp {world // mp} x mp {mp}, dense, "
              f"sliding-window and BigBird, einsum and fused (plain) paths equal one process "
              f"(dense einsum loss {sharded['dense einsum']['loss']:.6f}, single "
              f"{single['dense einsum']['loss']:.6f})")
        out[f"world {world}"] = sharded
    return out


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


def _moe_result(layer, x, y, aux, experts=lambda g: g) -> Dict:
    """y, aux and the gradients of sum(y * probe) + aux (already run
    backward), as JSON lists; ``experts`` makes an expert stack's gradient
    whole."""
    as_list = lambda t: t.detach().numpy().tolist()
    return {"y": as_list(y), "aux": float(aux.detach()), "dx": as_list(x.grad),
            "dgate_kernel": as_list(layer.gate.kernel.grad),
            "dgate_bias": as_list(layer.gate.bias.grad),
            "dw_in": as_list(experts(layer.w_in.grad)),
            "dw_out": as_list(experts(layer.w_out.grad))}


def moe_single() -> Dict:
    """The single-process layer: its forward, then the loss's gradients."""
    layer, x, mask, probe = _moe_setup()
    y, aux = layer(x, mask)
    ((y * probe).sum() + aux).backward()
    return _moe_result(layer, x, y, aux)


def _moe_ep_worker(payload: Dict) -> Dict:
    """One rank of the expert-sharded layer: the layer's own expert-parallel
    path (``MoELayer.forward`` on ``w_in`` / ``w_out`` cut by JAX's rule
    over a model axis spanning the ranks): the gate and the dispatch plan
    replicated, this rank's experts' slots, the shares summed over the
    ranks; x's and the gate's gradients come out whole on every rank, the
    experts' are gathered in rank order."""
    from spokennlp_tpu_torch.parallel import dist
    from spokennlp_tpu_torch.parallel.mesh import expert_range, shard_module_

    layer, x, mask, probe = _moe_setup()
    dist.make_mesh(dist.world_size())
    assert shard_module_(torch.nn.ModuleDict({"moe": layer}), dist.model_axis()) == 2
    y, aux = layer(x, mask)
    ((y * probe).sum() + aux).backward()
    experts = expert_range(dist.rank(), dist.world_size(), layer.cfg.moe_num_experts)
    assert layer.w_in.shape[0] == len(experts)
    return _moe_result(layer, x, y, aux, lambda g: torch.cat(dist.all_gather_tensors(g)))


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


# ------------------------------------------------------------- SLD, MMVTS


def _flat_grads(params, grads, path: Optional[str]):
    """Every gradient whole (model-sharded ones gathered over the model
    group: every rank calls this), flattened in float32; rank 0 saves the
    vector to ``path`` when given."""
    from spokennlp_tpu_torch.parallel import dist
    from spokennlp_tpu_torch.parallel.mesh import shard_axis

    parts = []
    for p, g in zip(params, grads):
        ax = shard_axis(p)
        if ax is not None:
            g = torch.cat(dist.all_gather_tensors(g, ax.group), p.model_shard[0])
        parts.append(g.detach().float().reshape(-1))
    flat = torch.cat(parts)
    if path and dist.rank() == 0:
        torch.save(flat.cpu(), path)
    return flat


def _rows_per_s(step, batch, rows: int, steps: int, device) -> float:
    """The global batch's rows trained a second over ``steps`` more calls of
    ``step(batch)`` (host clock after a synchronise; 0 steps: nan)."""
    import time

    if not steps:
        return float("nan")
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(batch)
    sync()
    return rows * steps / (time.perf_counter() - t0)


def _digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().to(torch.int64).numpy().tobytes()).hexdigest()[:16]


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


SLD_TINY = dict(gpt_vocab=120, speech_vocab=60, block=64, text=16, hidden_size=32, num_layers=2,
                num_heads=2, intermediate_size=64, rows=4, seed=0, device="cpu", decode=2,
                decode_new=8, dropout=0.1, time_masking=0.3)
"""The SLD gate's size: GPT-2 at 2 x 32 over blocks of 64, a global batch of
4 (JAX's per_device_train_batch_size), dropout and time masking on."""


def sld_setup(p: Dict):
    """(SLDConfig, GPT2LMModel drawn from seed ``p["seed"]`` on
    ``p["device"]``, the global batch of ``p["rows"]`` packed blocks in
    numpy: speech of 2 tokens to half a block, text of 2 to ``p["text"]``
    tokens, so each row holds another count of labels)."""
    from spokennlp_tpu_torch.models.gpt2 import GPT2Config, GPT2LMModel
    from spokennlp_tpu_torch.projects.sld import SLDConfig, pack_example

    cfg = SLDConfig(gpt_vocab_size=p["gpt_vocab"], vocab_size_speech=p["speech_vocab"],
                    block_size=p["block"], max_text_length=p["text"],
                    eos_token_id=p["gpt_vocab"] - 1, time_masking=p["time_masking"])
    drop = p["dropout"]
    gcfg = GPT2Config(vocab_size=cfg.total_vocab, hidden_size=p["hidden_size"],
                      num_layers=p["num_layers"], num_heads=p["num_heads"],
                      intermediate_size=p["intermediate_size"],
                      max_position_embeddings=p["block"], embd_dropout=drop,
                      resid_dropout=drop, attn_dropout=drop)
    model = GPT2LMModel(gcfg, generator=torch.Generator().manual_seed(p["seed"]))
    rng = np.random.default_rng(p["seed"] + 1)
    rows = []
    while len(rows) < p["rows"]:
        speech = rng.integers(0, p["speech_vocab"], size=rng.integers(2, p["block"] // 2))
        text = rng.integers(0, p["gpt_vocab"] - 1, size=rng.integers(2, p["text"] + 1))
        rows.append(pack_example(speech.tolist(), text.tolist(), cfg))
    batch = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    return cfg, model.to(p["device"]), batch


def sld_step(p: Dict) -> Dict:
    """One SLD train step (projects/sld.py ``make_sld_train_step``: AdamW,
    dropout and time masks from a generator seeded ``p["seed"] + 2``) on
    this data rank's rows of ``sld_setup``'s global batch: its metrics (the
    global batch's; ``grad_norm`` before clipping), a digest of the global
    batch's time-masked ids, then, on the updated model, the greedy decode
    of the first ``p["decode"]`` prompts (``p["decode_new"]`` tokens), and
    the rows trained a second over ``p["rate_steps"]`` more steps. With
    ``p["grads_path"]`` rank 0 saves the gradients there. ``p["fault"]``
    "per_rank_mean" plants each rank's own mean (DDP's reduction)."""
    from spokennlp_tpu_torch.models.generation import greedy_generate
    from spokennlp_tpu_torch.parallel import dist
    from spokennlp_tpu_torch.projects import sld

    cfg, model, batch = sld_setup(p)
    dev = torch.device(p["device"])
    m = dist.mesh()
    per = p["rows"] // m.data_size
    local = {k: torch.from_numpy(v[m.data_index * per:(m.data_index + 1) * per]).to(dev)
             for k, v in batch.items()}
    dp = dist.data_parallel()
    with dist.sharded_batch(dp):
        masked = sld.time_mask_inputs(local["input_ids"],
                                      torch.Generator(device=dev).manual_seed(p["seed"] + 3), cfg)
    if dp is not None and dp.world_size > 1:
        masked = dp.gather_const(masked)
    params = [q for q in model.parameters() if q.requires_grad]
    opt = torch.optim.AdamW(params, lr=1e-3, weight_decay=1e-4)
    seen, real = {}, opt.step

    def update(*a, **kw):
        seen["grads"] = [q.grad.clone() for q in params]
        return real(*a, **kw)

    opt.step = update
    step = sld.make_sld_train_step(model, cfg, opt,
                                   torch.Generator(device=dev).manual_seed(p["seed"] + 2))
    loss = real_loss = sld.sld_loss
    if p.get("fault") == "per_rank_mean":
        def loss(logits, labels, attention_mask, cfg, dp=None):
            total, aux = real_loss(logits, labels, attention_mask, cfg)
            return total / m.data_size, {k: v / m.data_size for k, v in aux.items()}
    with _patched(sld, "sld_loss", loss):
        metrics = {k: float(v) for k, v in step(local).items()}
    _flat_grads(params, seen["grads"], p.get("grads_path"))
    ids, mask = sld.build_prompts(batch["input_ids"][:p["decode"]], cfg)
    model.eval()
    with torch.no_grad():
        tokens = greedy_generate(model, torch.from_numpy(ids).to(dev),
                                 torch.from_numpy(mask).to(dev),
                                 max_len=ids.shape[1] + p["decode_new"], eos_id=cfg.text_end_id)
    model.train()
    return {**metrics, "time_mask": _digest(masked), "masked": int((masked != torch.from_numpy(
        batch["input_ids"]).to(dev)).sum()), "tokens": tokens.cpu().tolist(),
        "rows_per_s": _rows_per_s(step, local, p["rows"], p.get("rate_steps", 0), dev)}


def dryrun_sld_dp(n_ranks: int = 2, payload: Optional[Dict] = None, timeout: float = 300,
                  device: str = "cpu") -> Dict:
    """SLD data parallel over ``n_ranks`` gloo processes against one
    process on the same global batch (``sld_step``): the loss within
    LOSS_RTOL, the gradient norm within GRAD_NORM_RTOL, the time masks and
    the decoded tokens equal; raises otherwise. Returns both."""
    p = {**SLD_TINY, "device": device, **(payload or {})}
    single = sld_step(p)
    sharded = run_workers(n_ranks, "spokennlp_tpu_torch.dryrun:sld_step", p, timeout=timeout,
                          threads=1, device=device)
    check_step(f"dryrun_sld_dp ({n_ranks} ranks)", single, sharded)
    for key in ("time_mask", "tokens"):
        if sharded[key] != single[key]:
            raise AssertionError(f"dryrun_sld_dp: the {key} differ from one process's")
    print(f"dryrun_sld_dp ok: {n_ranks} gloo processes at a global batch of {p['rows']}, loss "
          f"{sharded['loss']:.6f} (one process {single['loss']:.6f}), grad_norm "
          f"{sharded['grad_norm']:.6f} ({single['grad_norm']:.6f}), the time masks "
          f"({single['masked']} tokens) and the decoded tokens equal")
    return {"single": single, "sharded": sharded}


MMVTS_TINY = dict(vocab=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                  L=64, K=8, mm_hidden=16, vis=8, audio=12, heads=2, mm_inter=32, experts=4,
                  capacity=0.5, expert_scale=20.0, rows=4, seed=0, device="cpu", impl="einsum",
                  dropout=0.1, mp=1)
"""The MMVTS gate's size: a dense trunk at 2 x 32, ``ma_moe`` with the
capacity dispatch (4 experts, top 2, capacity factor 0.5: tokens drop), the
modality InfoNCE over (text, vis) and (audio, vis), the matrix topic CL,
dropout 0.1, a global batch of 4 windows of 8 clips. ``expert_scale`` scales
the experts' initial weights (N(0, 0.02) makes their share of the output
too small for a change of the dispatch to show)."""

MMVTS_LOSS = dict(weight_label_zero=0.7, do_modality_cl=True, align_pairs={"tv": 0.33, "av": 0.33},
                  cl_temp=0.1, do_topic_mm_cl=True, topic_cl_type="matrix")


def mmvts_configs(p: Dict):
    """(EncoderConfig, MultimodalConfig) of the payload ``p``."""
    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.models.multimodal import MultimodalConfig

    H = p["hidden_size"]
    enc = EncoderConfig(vocab_size=p["vocab"], hidden_size=H, num_layers=p["num_layers"],
                        num_heads=p["num_heads"], intermediate_size=p["intermediate_size"],
                        max_position_embeddings=p["L"], add_pooler=False,
                        hidden_dropout=p["dropout"],
                        attention_dropout=p.get("trunk_attention_dropout", p["dropout"]),
                        attention_impl=p["impl"])
    if p.get("window"):  # a Longformer trunk (RoBERTa positions, pad id 1)
        enc = dataclasses.replace(enc, attention_type="sliding_window",
                                  attention_window=p["window"], position_style="roberta",
                                  pad_token_id=1, max_position_embeddings=p["L"] + 2)
    mm = MultimodalConfig(hidden_size=p["mm_hidden"], text_hidden_size=H,
                          vis_hidden_size=p["vis"], audio_hidden_size=p["audio"],
                          cross_encoder_type="ma_moe", num_cross_encoder_heads=p["heads"],
                          intermediate_size=p["mm_inter"], moe_num_experts=p["experts"],
                          moe_top_k=2, moe_impl="dispatch", moe_capacity_factor=p["capacity"],
                          hidden_dropout=p["dropout"], attention_dropout=p["dropout"])
    return enc, mm


def mmvts_setup(p: Dict):
    """(MMVTSModel drawn from seed ``p["seed"]`` on ``p["device"]``, the
    global batch in numpy: rows of 3 to K valid clips at BOS positions,
    suffix-padded tokens, labels with about 30 % topic ends, vis and audio
    features)."""
    from spokennlp_tpu_torch.projects.mmvts import MMVTSModel

    Lt, K, B = p["L"], p["K"], p["rows"]
    enc, mm = mmvts_configs(p)
    model = MMVTSModel(enc, mm, generator=torch.Generator().manual_seed(p["seed"]))
    with torch.no_grad():
        for name, q in model.named_parameters():
            if name.endswith(("w_in", "w_out")):
                q.mul_(p["expert_scale"])
    rng = np.random.default_rng(p["seed"] + 1)
    batch = {"input_ids": rng.integers(3, p["vocab"], size=(B, Lt)).astype(np.int64),
             "attention_mask": np.zeros((B, Lt), np.int64),
             "clip_positions": np.zeros((B, K), np.int64),
             "clip_mask": np.zeros((B, K), np.int64),
             "clip_labels": np.full((B, K), -100, np.int64),
             "vis_feats": np.zeros((B, K, p["vis"]), np.float32),
             "audio_feats": np.zeros((B, K, p["audio"]), np.float32)}
    for b in range(B):
        n = int(rng.integers(3, K + 1))
        pos = np.sort(rng.choice(np.arange(1, Lt - 4), size=n, replace=False))
        batch["attention_mask"][b, :pos[-1] + int(rng.integers(2, 5))] = 1
        batch["clip_positions"][b, :n] = pos
        batch["clip_mask"][b, :n] = 1
        batch["clip_labels"][b, :n] = (rng.random(n) < 0.3).astype(np.int64)
        batch["vis_feats"][b, :n] = rng.normal(size=(n, p["vis"]))
        batch["audio_feats"][b, :n] = rng.normal(size=(n, p["audio"]))
    return model.to(p["device"]), batch


def _per_rank_topic_ids(n: int):
    """The planted fault of topic ids numbered on each rank's rows alone
    (offsets restarting at every rank's first row)."""
    from spokennlp_tpu_torch.objectives import mmvts_losses

    real = mmvts_losses._flat_topic_ids

    def ids(labels, mask):
        parts = [real(lb, mk) for lb, mk in zip(labels.chunk(n), mask.chunk(n))]
        return torch.cat([a for a, _ in parts]), torch.cat([v for _, v in parts])

    return ids


def mmvts_step(p: Dict) -> Dict:
    """One MMVTS train step (projects/mmvts.py ``make_mmvts_train_step``,
    AdamW with clipping, MMVTS_LOSS) on this data rank's rows of
    ``mmvts_setup``'s global batch, the process group laid out as (world //
    mp, mp) with the model sharded over the model axis: the metrics (the
    global batch's), the gradient norm before clipping, then the updated
    model's eval argmax over the whole batch and the rows trained a second
    over ``p["rate_steps"]`` more steps. With ``p["grads_path"]`` rank 0
    saves the whole gradients there. ``p["fault"]`` plants a per-rank
    shortcut: "per_rank_mean", "per_rank_capacity" or "per_rank_topic_ids"."""
    from spokennlp_tpu_torch.configs import TrainConfig
    from spokennlp_tpu_torch.models import multimodal
    from spokennlp_tpu_torch.objectives import mmvts_losses
    from spokennlp_tpu_torch.parallel import dist
    from spokennlp_tpu_torch.parallel.mesh import shard_batch, shard_module_
    from spokennlp_tpu_torch.projects import mmvts
    from spokennlp_tpu_torch.train import optim
    from spokennlp_tpu_torch.train.train_step import batch_to_device

    model, batch = mmvts_setup(p)
    mesh = dist.make_mesh(p["mp"])
    shard_module_(model, dist.model_axis())
    dev = torch.device(p["device"])
    opt = optim.make_optimizer(model, TrainConfig(gradient_accumulation_steps=1), 10)
    seen, real = {}, opt.step

    def update(grads):
        seen["grads"] = [g.clone() for g in grads]
        seen["norm"] = float(optim.global_norm(grads, opt.params))
        return real(grads)

    opt.step = update
    step = mmvts.make_mmvts_train_step(model, opt, MMVTS_LOSS, seed=p["seed"] + 2)
    n = mesh.data_size
    fault = p.get("fault")
    patches = {
        "per_rank_mean": (mmvts_losses, "mmvts_total_loss", lambda *a, dp=None, _f=(
            mmvts_losses.mmvts_total_loss), **kw: (lambda t, x: (t / n, {
                k: v / n for k, v in x.items()}))(*_f(*a, **kw))),
        "per_rank_capacity": (multimodal, "dispatch_plan", lambda mask, topi, gates, cfg, dp=None,
                              _f=multimodal.dispatch_plan: _f(mask, topi, gates, cfg)),
        "per_rank_topic_ids": (mmvts_losses, "_flat_topic_ids", _per_rank_topic_ids(n)),
    }
    local = batch_to_device(shard_batch(batch, mesh.data_index, n), dev)
    with contextlib.ExitStack() as stack:
        if fault:
            stack.enter_context(_patched(*patches[fault]))
        metrics = {k: float(v) for k, v in step(local).items()}
    _flat_grads(opt.params, seen["grads"], p.get("grads_path"))
    model.eval()
    whole = batch_to_device(batch, dev)
    with torch.no_grad():
        out = model(whole["input_ids"], whole["attention_mask"], whole["clip_positions"],
                    whole["clip_mask"], vis_feats=whole["vis_feats"],
                    audio_feats=whole["audio_feats"])
    valid = whole["clip_mask"].bool()
    return {**metrics, "loss": metrics["total_loss"], "grad_norm": seen["norm"],
            "argmax": torch.argmax(out["logits"], -1)[valid].cpu().tolist(),
            "rows_per_s": _rows_per_s(step, local, p["rows"], p.get("rate_steps", 0), dev)}


def dryrun_mmvts_dp(n_ranks: int = 2, mp: int = 1, payload: Optional[Dict] = None,
                    timeout: float = 300, device: str = "cpu") -> Dict:
    """MMVTS over ``n_ranks`` gloo processes laid out as (n // mp, mp)
    against one process on the same global batch (``mmvts_step``: the
    modality InfoNCE over tv and av, the matrix topic CL, the ``ma_moe``
    capacity dispatch; with mp > 1 the experts and heads sharded): the loss
    within LOSS_RTOL, the gradient norm within GRAD_NORM_RTOL, the eval
    argmax equal; raises otherwise. Returns both."""
    p = {**MMVTS_TINY, "device": device, **(payload or {})}
    single = mmvts_step({**p, "mp": 1})
    sharded = run_workers(n_ranks, "spokennlp_tpu_torch.dryrun:mmvts_step", {**p, "mp": mp},
                          timeout=timeout, threads=1, device=device)
    label = f"dryrun_mmvts_dp ({n_ranks} ranks, mp {mp})"
    check_step(label, single, sharded)
    if sharded["argmax"] != single["argmax"]:
        raise AssertionError(f"{label}: the eval argmax differs from one process's")
    print(f"{label} ok: loss {sharded['loss']:.6f} (one process {single['loss']:.6f}), "
          f"grad_norm {sharded['grad_norm']:.6f} ({single['grad_norm']:.6f}), moe_loss "
          f"{sharded['moe_loss']:.6e}, the eval argmax of {len(single['argmax'])} clips equal")
    return {"single": single, "sharded": sharded}


def main(argv: Optional[Sequence[str]] = None):
    args = list(sys.argv[1:] if argv is None else argv)
    n = int(args[0]) if args else 2
    gates = args[1:] or ["multichip", "moe_ep", "sld_dp", "mmvts_dp", "model_parallel"]
    for gate in gates:
        if gate == "multichip":
            dryrun_multichip(n)
        elif gate == "moe_ep":
            dryrun_moe_ep(n)
        elif gate == "sld_dp":
            dryrun_sld_dp(n)
        elif gate == "mmvts_dp":
            dryrun_mmvts_dp(n)
            dryrun_mmvts_dp(n, mp=2)  # the experts and heads sharded
        elif gate == "model_parallel":
            dryrun_model_parallel()
        else:
            raise SystemExit(f"unknown gate {gate!r}: multichip, moe_ep, sld_dp, mmvts_dp, "
                             "model_parallel")


if __name__ == "__main__":
    main()
