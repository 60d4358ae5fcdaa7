#!/usr/bin/env python3
"""Times the sliding-window and BigBird rows kernels (``band_rows``,
``bigbird_rows``) inside kernels 7 and 8 (both modes) and rows 12 and 13
(forward and backward) of two checkouts of the port in turns on one CUDA
card, splits each call's device time by kernel name, and checks that the
outputs that must not move are the same bits in both.

    python3 rows_core_turns.py --parent DIR [--reps N]

DIR is another checkout of the repo (the parent commit, unpacked with ``git
archive``). The script runs one measuring process a checkout in the order
parent, this, this, parent, each building that checkout's kernels at first
use and printing one JSON line:

- ms a call (CUDA events after a warm-up) of kernel 7 in bf16 and W8A8 at
  B=8, L=2048 (window 512, CLS global), kernel 8 in bf16 and W8A8 at B=4,
  L=4096 (blocks of 64, 2 global and 3 random), and rows 12 and 13's
  forwards and backwards in bf16 at B=8, L=2048, dropout 0.1, all at
  BERT-base widths; the card's SM clock and power draw read after each;
- the device time of one call of each, by kernel name (torch.profiler):
  the rows kernel (``rows_ms``: ``band_rows`` or ``bigbird_rows``; in a
  backward its ``kGrad`` instance, the statistics pass), ``global_rows``,
  the projections (``qkv_proj``), the output projection and LayerNorm
  (``residual_ln``, ``gemm_bias_act``), the weight gradients, the
  backwards' gradient kernels and the rest (counts, casts, row
  quantisation, memsets);
- sha256 digests of what must not move: every float32 output of kernels 7
  and 8 (float and W8A8 modes) and of rows 12 and 13 (forward and
  backward), and every output of rows 1-6 and 9-11 (the digests of
  ``backward_gemm_turns.py`` without those of kernels 7 and 8 and rows 12
  and 13 in bf16);
- digests of the bf16 and W8A8 outputs of kernels 7 and 8 and of rows 12
  and 13's bf16 forwards and backwards from two calls, which must be equal
  within this checkout.

Then it prints the mean of each checkout and whether each digest is the
same in every run (the two-call digests: in the runs of this checkout).
Readings of one kernel move by up to a third between calls of the card, so
only two checkouts measured in one call are compared.

    python3 rows_core_turns.py --measure

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

H, NH, HD = 768, 12, 64
LB, LL, WINDOW = 8, 2048, 512
BB_B, BB_L, BLOCK = 4, 4096, 64
# kernel-name fragments of each part of a call's device time, first match wins
SPLIT = (("rows", ("band_rows_kernel", "bigbird_rows_kernel")),
         ("global_rows", ("global_rows_kernel",)),
         ("grad", ("band_dq_kernel", "band_dkv_kernel", "global_kv_grad_kernel",
                   "bigbird_dq_kernel", "bigbird_dkv_kernel")),
         ("proj", ("qkv_proj",)),
         ("out", ("residual_ln", "gemm_bias_act")),
         ("wgrad", ("weight_grad",)))
# backward_gemm_turns.py's digests that this work moves: the bf16 and W8A8
# outputs of kernels 7 and 8 and rows 12 and 13's bf16 forwards
MOVED = ("digest kernel 7 ", "digest kernel 8 ", "digest row 12 forward bfloat16",
         "digest row 13 forward bfloat16")


def device_split(fn) -> dict:
    """ms of device time of one call of fn by part (SPLIT, then rest_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {f"{k}_ms": 0.0 for k, _ in SPLIT}
    split["rest_ms"] = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        key = next((f"{k}_ms" for k, names in SPLIT if any(n in e.key for n in names)), "rest_ms")
        split[key] += us / 1e3
    return split


def measure(reps: int) -> dict:
    """{reading: ms, or the digest of an output} of the checkout on sys.path,
    with the card's clock."""
    import torch

    import backward_gemm_turns
    from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables
    from spokennlp_tpu_torch.ops.cuda import bigbird_block as bbk
    from spokennlp_tpu_torch.ops.cuda import sliding_block as sb
    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

    out = {k: v for k, v in backward_gemm_turns.measure(1).items()
           if k.startswith("digest") and not k.startswith(MOVED)}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    HN = NH * HD
    att = [randn(H, 3, NH, HD, scale=H**-0.5), randn(3, NH, HD, scale=0.02),
           randn(NH, HD, H, scale=HN**-0.5), randn(H, scale=0.02)]
    gqkv = [randn(H, 3, NH, HD, scale=H**-0.5), randn(3, NH, HD, scale=0.02)]
    ln = dict(ln_scale=1 + randn(H, scale=0.1), ln_bias=randn(H, scale=0.1))
    seed = torch.tensor([20231017], dtype=torch.int32, device=dev)
    lengths = lambda L, n: (torch.arange(L, device=dev)[None]
                            < torch.tensor(n, device=dev)[:, None]).int()
    mask = lengths(LL, [LL, 1024, LL, 1300, LL, 1650, LL, 1900])
    glob = torch.zeros_like(mask)
    glob[:, 0] = 1
    bmask = lengths(BB_L, [BB_L, 3072, BB_L, 100])
    tables = bigbird_tables(LL // BLOCK, 2, 3, 0, dev)
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        lhid, lcot = randn(LB, LL, H).to(dt), (randn(LB, LL, H) * mask[..., None]).to(dt)
        bhid = randn(BB_B, BB_L, H).to(dt)
        sw = sb.card_weights(att[0], att[1], *gqkv, att[2], dt)
        bw = bbk.card_weights(att[0], att[1], att[2], dt)
        kw = dict(num_heads=NH, sm_scale=HD**-0.5, dropout_rate=0.1)
        scfg = dict(kw, window=WINDOW, max_globals=16, global_rows=True)
        bcfg = dict(kw, block_size=BLOCK)
        calls = {}
        for mode, q in (("float", False), ("W8A8", True)):
            calls[f"kernel 7 {mode}"] = lambda q=q: sb.fused_sliding_attention_block(
                lhid, mask, glob, att[0], att[1], *gqkv, att[2], att[3], sm_scale=HD**-0.5,
                window=WINDOW, **ln, quantized=q)
            calls[f"kernel 8 {mode}"] = lambda q=q: bbk.fused_bigbird_attention_block(
                bhid, bmask, att[0], att[1], att[2], att[3], block_size=BLOCK,
                num_global_blocks=2, num_random_blocks=3, seed=0, sm_scale=HD**-0.5, **ln,
                quantized=q)
        calls["row 12 forward"] = lambda: ts.sliding_train_fwd(lhid, mask, glob, seed, sw, att[3],
                                                               **scfg)
        calls["row 12 backward"] = lambda: ts.sliding_train_bwd(lhid, mask, glob, seed, sw, lcot,
                                                                **scfg)
        calls["row 13 forward"] = lambda: tbb.bigbird_train_fwd(lhid, mask, seed, bw, att[3],
                                                                tables, **bcfg)
        calls["row 13 backward"] = lambda: tbb.bigbird_train_bwd(lhid, mask, seed, bw, lcot,
                                                                 tables, **bcfg)
        for name, fn in calls.items():
            if dtype == "float32":
                out[f"digest {name} float32"] = digest(fn())
                continue
            out[f"{name} ms"] = time_ms(fn, reps)
            out[f"{name} sm clock, power draw"] = smi("clocks.sm,power.draw")
            out.update({f"{name} {k}": v for k, v in device_split(fn).items()})
            for run in ("a", "b"):
                out[f"twice {name} bf16 run {run}"] = digest(fn())
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
        print("rows_core_turns: no CUDA device", file=sys.stderr)
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
        proc = subprocess.run([sys.executable, str(here / "rows_core_turns.py"), "--measure",
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
        print(json.dumps({"mean": label, **{k: sum(r[k] for r in rows) / len(rows)
                                             for k in rows[0] if isinstance(rows[0][k], float)}}))
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
