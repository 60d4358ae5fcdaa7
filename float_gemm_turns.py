#!/usr/bin/env python3
"""Times the float modes' kernels of two checkouts of the port in turns on one
CUDA card: kernels 1 and 2 (the attention and MLP blocks) and kernel 3 (the
whole stack, 12 layers) at B=32, L=512, BERT-base widths, bf16 and float32.

    python3 float_gemm_turns.py --parent DIR [--reps N]

DIR is another checkout of the repo (the parent commit, unpacked with ``git
archive``). The script runs one measuring process a checkout in the order
parent, this, this, parent, each building that checkout's kernels at first
use and printing one JSON line of CUDA-event times (ms a call, after a
warm-up) with the card's SM clock and power draw read just after, and a
digest (sha256 of the output's bytes) of each kernel's output on the same
inputs: the W8A8 modes of kernels 1-3 in both dtypes and the float modes in
bf16, which must not move, and the float modes in float32, which a change of
the float32 tile may move (``moved digest ...``); then it prints
the four lines, the mean of each checkout, whether each must-not-move digest
is the same in every run, and whether each moved digest differs from the
parent's and repeats within each checkout; it exits 1 if a must-not-move
digest differs or a moved one does not repeat. Readings of one kernel move
by up to a third between calls of the card, so only two checkouts measured
in one call are compared.

    python3 float_gemm_turns.py --measure

measures the checkout the script is run from (its working directory) alone.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

B, L, H, NH, HD, I, LAYERS = 32, 512, 768, 12, 64, 3072, 12


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def digest(t) -> str:
    import torch

    torch.cuda.synchronize()
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def measure(reps: int) -> dict:
    """{reading: ms, or the digest of an output} of the checkout on sys.path,
    the float32 float modes' digests marked as moved, with the card's
    clock."""
    import torch

    from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    seg = torch.ones((B, L), dtype=torch.int32, device=dev)
    for b in range(B):  # padded tails and, on odd rows, two packed windows
        n = L - (37 * b) % 300
        seg[b, n:] = 0
        if b % 2:
            seg[b, n // 2:n] = 2
    HN = NH * HD
    p = [randn(LAYERS, H, 3, NH, HD, scale=H**-0.5), randn(LAYERS, 3, NH, HD, scale=0.02),
         randn(LAYERS, NH, HD, H, scale=HN**-0.5), randn(LAYERS, H, scale=0.02),
         1 + randn(LAYERS, H, scale=0.1), randn(LAYERS, H, scale=0.1),
         randn(LAYERS, H, I, scale=H**-0.5), randn(LAYERS, I, scale=0.02),
         randn(LAYERS, I, H, scale=I**-0.5), randn(LAYERS, H, scale=0.02),
         1 + randn(LAYERS, H, scale=0.1), randn(LAYERS, H, scale=0.1)]
    out = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        hidden = randn(B, L, H).to(dt)
        w = [t[0].to(dt) if i in (0, 2, 6, 8) else t[0] for i, t in enumerate(p)]
        out[f"kernel 1 {dtype}"] = time_ms(lambda: fused_attention_block(
            hidden, seg, *w[:4], sm_scale=HD**-0.5, ln_scale=w[4], ln_bias=w[5]), reps)
        x = hidden.reshape(B * L, H)
        out[f"kernel 2 {dtype}"] = time_ms(lambda: fused_mlp_block(
            x, *w[6:], activation="gelu", eps=1e-12, quantized=False), reps)
        out[f"kernel 3 float {dtype}"] = time_ms(lambda: fused_encoder_stack(
            hidden, seg, *p, sm_scale=HD**-0.5, quantized=False), max(1, reps // 5))
        for mode, q in (("float", False), ("W8A8", True)):
            tag = "moved digest" if mode == "float" and dtype == "float32" else "digest"
            out[f"{tag} kernel 1 {mode} {dtype}"] = digest(fused_attention_block(
                hidden, seg, *w[:4], sm_scale=HD**-0.5, ln_scale=w[4], ln_bias=w[5],
                quantized=q))
            out[f"{tag} kernel 2 {mode} {dtype}"] = digest(fused_mlp_block(
                x, *w[6:], activation="gelu", eps=1e-12, quantized=q))
            out[f"{tag} kernel 3 {mode} {dtype}"] = digest(fused_encoder_stack(
                hidden, seg, *p, sm_scale=HD**-0.5, quantized=q))
    out["sm clock, power draw"] = smi("clocks.sm,power.draw")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--measure", action="store_true", help="measure this checkout alone")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("float_gemm_turns: no CUDA device", file=sys.stderr)
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
        proc = subprocess.run([sys.executable, str(here / "float_gemm_turns.py"), "--measure",
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
                                             for k in rows[0] if k.startswith("kernel")}}))
    same = {k: len({r[k] for _, r in runs}) == 1 for k in runs[0][1] if k.startswith("digest")}
    print(json.dumps({"same output in every run": same}))
    moved = {k: {"differs from the parent": runs[0][1][k] != runs[1][1][k],
                 "repeats in each checkout": all(len({r[k] for l, r in runs if l == label}) == 1
                                                 for label in roots)}
             for k in runs[0][1] if k.startswith("moved digest")}
    print(json.dumps({"moved outputs": moved}))
    repeats = all(m["repeats in each checkout"] for m in moved.values())
    return 0 if all(same.values()) and repeats else 1


if __name__ == "__main__":
    sys.exit(main())
