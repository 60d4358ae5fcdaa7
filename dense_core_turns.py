#!/usr/bin/env python3
"""Times kernel 9 (the fused PoNet mixer block) and row 10 (the dense
training attention block, forward and backward) of two checkouts of the
port in turns on one CUDA card, splits each call's device time by kernel
name, and checks that the outputs that must not move are the same bits in
both.

    python3 dense_core_turns.py --parent DIR [--reps N]

DIR is another checkout of the repo (the parent commit, unpacked with ``git
archive``). The script runs one measuring process a checkout in the order
parent, this, this, parent, each building that checkout's kernels at first
use and printing one JSON line:

- ms a call (CUDA events after a warm-up) of kernel 9 in float32 and bf16
  at B=8, L=4096, H=768, window 3 (sentence runs of 37 tokens, suffix
  padding), and of row 10's forward and backward in bf16 and float32 at
  B=32, L=512, 12 heads of 64, dropout 0.1 (padded tails, two packed
  windows on odd rows); the card's SM clock and power draw read after each;
- the device time of one call of each, by kernel name (torch.profiler):
  kernel 9's projections GEMM (``gemm_bias_act``), GA (``ga_``), SMP and
  the mix (``smp_``) and the out projection with LayerNorm
  (``residual_ln``); row 10's projections (``qkv_proj``), ``attn_rows``
  (the forward's, or the backward's statistics pass), ``attn_dq``,
  ``attn_dkv``, the other GEMMs (``gemm_bias_act``: the out projection, or
  dctx and dx), the weight gradients and the rest;
- the peak device memory of one row 10 backward in bf16;
- sha256 digests of what must not move: the digests of
  ``backward_gemm_turns.py`` (every output of rows 1-8 and 11-13 in every
  mode, kernel 9 in bf16 and W8A8, row 10 in float32) without row 10's
  bf16 forward, and kernel 9 in W8A8 with float32 activations;
- digests of kernel 9 in float32 and of row 10's bf16 forward and backward
  from two calls, which must be equal within this checkout.

Then it prints the mean of each checkout and whether each digest is the
same in every run (the two-call digests: in the runs of this checkout).
Readings of one kernel move by up to a third between calls of the card, so
only two checkouts measured in one call are compared.

    python3 dense_core_turns.py --measure

measures the checkout the script is run from (its working directory) alone.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from backward_gemm_turns import digest, smi, time_ms

B, L, H, NH, HD = 32, 512, 768, 12, 64
PB, PL, PWINDOW = 8, 4096, 3
# kernel-name fragments of each part of a call's device time, first match wins
SPLIT = (("rows", ("attn_rows_kernel",)),
         ("dq", ("attn_dq_kernel",)),
         ("dkv", ("attn_dkv_kernel",)),
         ("proj", ("qkv_proj",)),
         ("gemm", ("gemm_bias_act",)),
         ("out", ("residual_ln",)),
         ("wgrad", ("weight_grad",)),
         ("ga", ("ga_",)),
         ("smp", ("smp_",)))
# backward_gemm_turns.py's digests that this work moves: row 10's bf16 forward
MOVED = ("digest row 10 forward bfloat16",)


def device_split(fn) -> dict:
    """ms of device time of one call of fn by part (SPLIT, then rest_ms);
    parts that took no time are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        key = next((f"{k}_ms" for k, names in SPLIT if any(n in e.key for n in names)), "rest_ms")
        split[key] = split.get(key, 0.0) + us / 1e3
    return split


def measure(reps: int) -> dict:
    """{reading: ms, or the digest of an output} of the checkout on sys.path,
    with the card's clock."""
    import torch

    import backward_gemm_turns
    from spokennlp_tpu_torch.ops.cuda import ponet_block as pb
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    out = {k: v for k, v in backward_gemm_turns.measure(1).items()
           if k.startswith("digest") and not k.startswith(MOVED)}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    HN = NH * HD
    seg = torch.ones((B, L), dtype=torch.int32, device=dev)
    for b in range(B):  # padded tails and, on odd rows, two packed windows
        n = L - (37 * b) % 300
        seg[b, n:] = 0
        if b % 2:
            seg[b, n // 2:n] = 2
    seed = torch.tensor([20231018], dtype=torch.int32, device=dev)
    att = [randn(H, 3, NH, HD, scale=H**-0.5), randn(3, NH, HD, scale=0.02),
           randn(NH, HD, H, scale=HN**-0.5), randn(H, scale=0.02)]
    n_valid = torch.tensor([PL, 3000, PL, 2100, PL, 100, PL, 3900], device=dev)
    pmask = (torch.arange(PL, device=dev)[None] < n_valid[:, None]).int()
    pseg = (torch.arange(PL, device=dev) // 37)[None].expand(PB, PL).contiguous()
    pon = [randn(5, H, H, scale=H**-0.5), randn(5, H, scale=0.02), randn(H, H, scale=H**-0.5),
           randn(H, scale=0.02)]
    ln = dict(ln_scale=1 + randn(H, scale=0.1), ln_bias=randn(H, scale=0.1))
    px = randn(PB, PL, H) + randn(PB, 1, H)
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        hidden, cot = randn(B, L, H).to(dt), randn(B, L, H).to(dt)
        wqkv = att[0].to(dt).reshape(H, 3 * HN).contiguous()
        wo = att[2].to(dt).reshape(HN, H).contiguous()
        bqkv = att[1].reshape(-1).contiguous()
        kw = dict(num_heads=NH, sm_scale=HD**-0.5, dropout_rate=0.1)
        phid = px.to(dt)
        calls = {
            "kernel 9": lambda q=False: pb.fused_ponet_mixer_block(
                phid, pmask, pseg, *pon, local_window=PWINDOW, sm_scale=H**-0.5, quantized=q,
                **ln),
            "row 10 forward": lambda: tb.attention_train_fwd(hidden, seg, seed, wqkv, bqkv, wo,
                                                             att[3], **kw),
            "row 10 backward": lambda: tb.attention_train_bwd(hidden, seg, seed, wqkv, bqkv, wo,
                                                              cot, **kw),
        }
        for name, fn in calls.items():
            out[f"{name} {dtype} ms"] = time_ms(fn, reps)
            out[f"{name} {dtype} sm clock, power draw"] = smi("clocks.sm,power.draw")
            out.update({f"{name} {dtype} {k}": v for k, v in device_split(fn).items()})
            if (name == "kernel 9") == (dtype == "float32"):  # what may move
                for run in ("a", "b"):
                    out[f"twice {name} {dtype} run {run}"] = digest(fn())
        if dtype == "float32":
            out["digest kernel 9 W8A8 float32"] = digest(calls["kernel 9"](True))
        else:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            calls["row 10 backward"]()
            torch.cuda.synchronize()
            out["row 10 backward bfloat16 peak GiB"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--measure", action="store_true", help="measure this checkout alone")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dense_core_turns: no CUDA device", file=sys.stderr)
        return 1
    if args.measure:
        sys.path.insert(0, os.getcwd())  # the measured checkout, before the script's own
        print(json.dumps(measure(args.reps)))
        return 0
    if not args.parent:
        ap.error("--parent or --measure")
    here = Path(__file__).resolve().parent
    roots = {"parent": Path(args.parent).resolve(), "this": here}
    print(f"card: {smi('name,power.limit')}")
    runs = []
    for label in ("parent", "this", "this", "parent"):
        root = roots[label]
        env = {**os.environ, "PYTHONPATH": str(root)}
        proc = subprocess.run([sys.executable, str(here / "dense_core_turns.py"), "--measure",
                               "--reps", str(args.reps)], cwd=root, env=env,
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": label, **row}))
        runs.append((label, row))
    for label in ("parent", "this"):
        rows = [r for l, r in runs if l == label]
        keys = set().union(*rows)
        print(json.dumps({"mean": label, **{
            k: sum(r.get(k, 0.0) for r in rows) / len(rows) for k in sorted(keys)
            if isinstance(rows[0].get(k, 0.0), float)}}))
    same = {k: len({r[k] for _, r in runs}) == 1 for k in runs[0][1] if k.startswith("digest")}
    mine = [r for l, r in runs if l == "this"]
    for k in mine[0]:
        if k.startswith("twice") and k.endswith(" run a"):
            name = k[len("twice "):-len(" run a")]
            same[f"{name}, this checkout"] = len(
                {r[f"twice {name} run {run}"] for r in mine for run in "ab"}) == 1
    print(json.dumps({"same output in every run": same}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
