#!/usr/bin/env python3
"""Times the Longformer and BigBird training backwards (rows 12 and 13 of
PERF.md's table) of two checkouts of the port in turns on one CUDA card,
splits their device time between the GEMMs, the statistics pass and each of
the five gradient kernels, and checks that the outputs that must not move
are the same bits in both.

    python3 backward_core_turns.py --parent DIR [--dtype bfloat16|float32] [--reps N]

DIR is another checkout of the repo (the parent commit, unpacked with ``git
archive``). The script runs one measuring process a checkout in the order
parent, this, this, parent, each building that checkout's kernels at first
use and printing one JSON line:

- ms a call of rows 12 and 13's backwards in bf16 at B=8, L=2048, BERT-base
  widths, dropout 0.1 (CUDA events after a warm-up; the Longformer block
  with window 512 and CLS global, the BigBird block with blocks of 64, 2
  global and 3 random), the card's SM clock and power draw read after each;
- the device time of one call of each, by kernel name (torch.profiler):
  the GEMMs (the GEMM tile's kernels and the weight gradient), the
  statistics pass (``band_rows``, ``global_rows``, ``bigbird_rows``), each
  gradient kernel (``band_dq``, ``band_dkv``, ``global_kv_grad``,
  ``bigbird_dq``, ``bigbird_dkv``) and the rest (counts, memsets);
- sha256 digests of the outputs that this work leaves alone: those of
  ``backward_gemm_turns.py`` (every float32 output of rows 10-13, forward
  and backward; the bf16 and W8A8 outputs of the forward kernels 1, 2, 3,
  6-9 and of rows 10-13's forwards) and the bf16 backwards of rows 10 and
  11;
- digests of the bf16 projections' gradient (dproj: [dq dk dv ...] as the
  gradient kernels wrote it) of rows 12 and 13 from two calls, which must
  be equal.

With ``--dtype float32`` each process prints instead:

- ms a call of rows 12 and 13's backwards in float32 at the shapes above,
  the card's SM clock and power draw, and the device time of one call of
  each by kernel name as above, the global rows (``global_rows``) apart from
  the statistics pass;
- ms of device time of the float32 global rows alone
  (``rows_core_turns.global_rows_alone``: as kernel 7, row 12's forward and
  its statistics pass, 1 and 16 global tokens, B=8 and B=2);
- windows trained per second of the float32 Longformer recipe
  (``backward_gemm_turns.recipe_windows_per_s``: run_finetune at the CLI's
  default dtype, 3 optimizer steps of 4 micro-batches of 2 windows of 2048
  tokens, 12 layers);
- digests of what must not move: those of ``backward_gemm_turns.py`` (every
  bf16 and W8A8 output, the bf16 backwards included, and rows 10 and 11
  and kernel 9 in float32) but rows 12 and 13's float32 forwards and
  backwards; and digests of rows 12 and 13's float32 dproj and of the
  global rows alone from two calls, which may move but must be equal
  within this checkout.

Then it prints the mean of each checkout and whether each digest is the
same in every run (rows 12 and 13's dproj: in the runs of this
checkout). Readings of one kernel move by up to a third between calls of
the card, so only two checkouts measured in one call are compared.

    python3 backward_core_turns.py --measure [--dtype float32]

measures the checkout the script is run from (its working directory) alone.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from backward_gemm_turns import GEMM_KERNELS, digest, smi, time_ms
from rows_core_turns import global_rows_alone

B, L, H, NH, HD, I = 32, 512, 768, 12, 64, 3072
LB, LL, WINDOW, BLOCK = 8, 2048, 512, 64
STATS_KERNELS = ("band_rows", "global_rows", "bigbird_rows")
GRAD_KERNELS = ("band_dq", "band_dkv", "global_kv_grad", "bigbird_dq", "bigbird_dkv")


def device_split(fn, global_apart: bool = False) -> dict:
    """ms of device time of one call of fn, by kernel name: gemm_ms,
    stats_ms, one entry a gradient kernel, rest_ms; and grad_ms, the
    gradient kernels' sum. ``global_apart``: the global rows in
    global_rows_ms, not in stats_ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {"gemm_ms": 0.0, "stats_ms": 0.0, **{f"{k}_ms": 0.0 for k in GRAD_KERNELS},
             "rest_ms": 0.0, **({"global_rows_ms": 0.0} if global_apart else {})}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        key = next((f"{k}_ms" for k in GRAD_KERNELS if f"{k}_kernel" in e.key), None)
        if key is None and global_apart and "global_rows_kernel" in e.key:
            key = "global_rows_ms"
        if key is None:
            key = ("gemm_ms" if any(k in e.key for k in GEMM_KERNELS) else
                   "stats_ms" if any(f"{k}_kernel" in e.key for k in STATS_KERNELS) else "rest_ms")
        split[key] += us / 1e3
    split["grad_ms"] = sum(split[f"{k}_ms"] for k in GRAD_KERNELS)
    return split


def measure(reps: int, dtype: str = "bfloat16") -> dict:
    """{reading: ms, or the digest of an output} of the checkout on sys.path,
    with the card's clock."""
    import torch

    import backward_gemm_turns

    if dtype == "float32":
        return measure_f32(reps)
    from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables
    from spokennlp_tpu_torch.ops.cuda import bigbird_block as bbk
    from spokennlp_tpu_torch.ops.cuda import sliding_block as sb
    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

    out = {k: v for k, v in backward_gemm_turns.measure(1).items() if k.startswith("digest")}
    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    HN = NH * HD
    att = [randn(H, 3, NH, HD, scale=H**-0.5), randn(3, NH, HD, scale=0.02),
           randn(NH, HD, H, scale=HN**-0.5)]
    gqkv = [randn(H, 3, NH, HD, scale=H**-0.5), randn(3, NH, HD, scale=0.02)]
    seed = torch.tensor([20231016], dtype=torch.int32, device=dev)
    kw = dict(num_heads=NH, sm_scale=HD**-0.5, dropout_rate=0.1)

    # rows 10 and 11's bf16 backwards, which this work leaves alone
    seg = (torch.arange(L, device=dev)[None] < L - 37 * torch.arange(B, device=dev)[:, None]).int()
    cot, x = randn(B, L, H).to(dt), randn(B * L, H).to(dt)
    w1, w2 = randn(H, I, scale=H**-0.5).to(dt), randn(I, H, scale=I**-0.5).to(dt)
    out["digest row 10 backward bfloat16"] = backward_gemm_turns.digest(tb.attention_train_bwd(
        randn(B, L, H).to(dt), seg, seed, att[0].to(dt).reshape(H, 3 * HN).contiguous(),
        att[1].reshape(-1).contiguous(), att[2].to(dt).reshape(HN, H).contiguous(), cot, **kw))
    out["digest row 11 backward bfloat16"] = backward_gemm_turns.digest(tb.mlp_train_bwd(
        x, w1, randn(I, scale=0.02), w2, cot.reshape(B * L, H), activation="gelu"))

    # rows 12 and 13
    n_valid = torch.tensor([LL, 1024, LL, 1300, LL, 1650, LL, 1900], device=dev)
    mask = (torch.arange(LL, device=dev)[None] < n_valid[:, None]).int()
    glob = torch.zeros_like(mask)
    glob[:, 0] = 1
    lhid, lcot = randn(LB, LL, H).to(dt), (randn(LB, LL, H) * mask[..., None]).to(dt)
    sw = sb.card_weights(att[0], att[1], *gqkv, att[2], dt)
    bw = bbk.card_weights(att[0], att[1], att[2], dt)
    tables = bigbird_tables(LL // BLOCK, 2, 3, 0, dev)
    backwards = {
        "12": lambda **o: ts.sliding_train_bwd(lhid, mask, glob, seed, sw, lcot, window=WINDOW,
                                               max_globals=16, global_rows=True, **kw, **o),
        "13": lambda **o: tbb.bigbird_train_bwd(lhid, mask, seed, bw, lcot, tables,
                                                block_size=BLOCK, **kw, **o),
    }
    for row, fn in backwards.items():
        out[f"row {row} backward ms"] = time_ms(fn, reps)
        out[f"row {row} sm clock, power draw"] = smi("clocks.sm,power.draw")
        out.update({f"row {row} backward {k}": v for k, v in device_split(fn).items()})
        for run in ("a", "b"):
            bufs = {}
            fn(buffers=bufs)
            out[f"dproj row {row} bf16 run {run}"] = digest(bufs["dproj"])
    return out


# backward_gemm_turns.py's digests that the float32 rows and gradient
# kernels move: rows 12 and 13's float32 forwards and backwards
F32_MOVED = tuple(f"digest row {r} {p} float32" for r in (12, 13) for p in ("forward", "backward"))


def measure_f32(reps: int) -> dict:
    """measure's float32 counterpart (the module's docstring)."""
    import contextlib

    import torch

    import backward_gemm_turns
    from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables
    from spokennlp_tpu_torch.ops.cuda import bigbird_block as bbk
    from spokennlp_tpu_torch.ops.cuda import sliding_block as sb
    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

    out = {k.replace("moved digest", "digest"): v
           for k, v in backward_gemm_turns.measure(1).items()
           if k.startswith(("digest", "moved digest")) and not k.startswith(F32_MOVED)}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, dt = torch.device("cuda"), torch.float32
    g = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    HN = NH * HD
    att = [randn(H, 3, NH, HD, scale=H**-0.5), randn(3, NH, HD, scale=0.02),
           randn(NH, HD, H, scale=HN**-0.5)]
    gqkv = [randn(H, 3, NH, HD, scale=H**-0.5), randn(3, NH, HD, scale=0.02)]
    seed = torch.tensor([20231016], dtype=torch.int32, device=dev)
    kw = dict(num_heads=NH, sm_scale=HD**-0.5, dropout_rate=0.1)
    n_valid = torch.tensor([LL, 1024, LL, 1300, LL, 1650, LL, 1900], device=dev)
    mask = (torch.arange(LL, device=dev)[None] < n_valid[:, None]).int()
    glob = torch.zeros_like(mask)
    glob[:, 0] = 1
    lhid, lcot = randn(LB, LL, H), randn(LB, LL, H) * mask[..., None]
    sw = sb.card_weights(att[0], att[1], *gqkv, att[2], dt)
    bw = bbk.card_weights(att[0], att[1], att[2], dt)
    tables = bigbird_tables(LL // BLOCK, 2, 3, 0, dev)
    backwards = {
        "12": lambda **o: ts.sliding_train_bwd(lhid, mask, glob, seed, sw, lcot, window=WINDOW,
                                               max_globals=16, global_rows=True, **kw, **o),
        "13": lambda **o: tbb.bigbird_train_bwd(lhid, mask, seed, bw, lcot, tables,
                                                block_size=BLOCK, **kw, **o),
    }
    for row, fn in backwards.items():
        out[f"row {row} backward float32 ms"] = time_ms(fn, reps)
        out[f"row {row} float32 sm clock, power draw"] = smi("clocks.sm,power.draw")
        out.update({f"row {row} backward float32 {k}": v
                    for k, v in device_split(fn, global_apart=True).items()})
        for run in ("a", "b"):
            bufs = {}
            fn(buffers=bufs)
            out[f"dproj row {row} float32 run {run}"] = digest(bufs["dproj"])
    del lhid, lcot
    torch.cuda.empty_cache()
    out.update(global_rows_alone(randn(LB, LL, H), mask, sw, gqkv, seed, reps, w8a8=False,
                                 n_globs=(1, 16)))
    torch.cuda.empty_cache()
    with contextlib.redirect_stdout(sys.stderr):  # train_path's report
        out["recipe float32 windows per s"] = backward_gemm_turns.recipe_windows_per_s()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--measure", action="store_true", help="measure this checkout alone")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the backwards' dtype to time; float32 lets their outputs move")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("backward_core_turns: no CUDA device", file=sys.stderr)
        return 1
    if args.measure:
        sys.path.insert(0, os.getcwd())  # the measured checkout, before the script's own
        print(json.dumps(measure(args.reps, args.dtype)))
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
        proc = subprocess.run([sys.executable, str(here / "backward_core_turns.py"), "--measure",
                               "--reps", str(args.reps), "--dtype", args.dtype], cwd=root,
                              env=env, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": label, **row}))
        runs.append((label, row))
    for label in ("parent", "this"):
        rows = [r for l, r in runs if l == label]
        print(json.dumps({"mean": label, **{k: sum(r[k] for r in rows) / len(rows)
                                             for k in rows[0]
                                             if isinstance(rows[0][k], float)}}))
    same = {k: len({r[k] for _, r in runs}) == 1 for k in runs[0][1] if k.startswith("digest")}
    mine = [r for l, r in runs if l == "this"]
    tag = "bf16" if args.dtype == "bfloat16" else "float32"
    for row in ("12", "13"):
        same[f"dproj row {row} {tag}, this checkout"] = len(
            {r[f"dproj row {row} {tag} run {run}"] for r in mine for run in "ab"}) == 1
    for k in mine[0]:
        if k.startswith("twice") and k.endswith(" run a"):
            name = k[len("twice "):-len(" run a")]
            same[f"{name}, this checkout"] = len(
                {r[f"twice {name} run {run}"] for r in mine for run in "ab"}) == 1
    print(json.dumps({"same output in every run": same}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
