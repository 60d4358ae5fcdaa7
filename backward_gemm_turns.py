#!/usr/bin/env python3
"""Times the training kernels' backwards (rows 10-13 of PERF.md's table) of
two checkouts of the port in turns on one CUDA card, splits each backward's
device time between its GEMMs and its attention cores, and checks that the
outputs that must not move are the same bits in both.

    python3 backward_gemm_turns.py --parent DIR [--dtype bfloat16|float32] [--reps N]

DIR is another checkout of the repo (the parent commit, unpacked with ``git
archive``). The script runs one measuring process a checkout in the order
parent, this, this, parent, each building that checkout's kernels at first
use and printing one JSON line:

- ms a call of each backward in ``--dtype`` (bf16 by default; CUDA events
  after a warm-up): the attention block (row 10) and the MLP block (row 11)
  at B=32, L=512, BERT-base widths; the Longformer block (row 12, window
  512, CLS global) and the BigBird block (row 13, blocks of 64, 2 global and
  3 random) at B=8, L=2048;
- the device time of one call of each, by kernel name (torch.profiler),
  summed into its GEMM kernels (the GEMM tiles' kernels, the weight
  gradient and its reduction, the MLP's recomputed product) and the rest
  (the attention cores, the count and memset kernels);
- with ``--dtype float32``, ms a call of the float32 forwards of rows
  10-13 and of kernels 7 (B=8, L=2048) and 8 (B=8, L=2048, the Longformer
  masks), whose products run the same float32 tile as the backwards';
- with ``--dtype float32``, windows trained per second of the Longformer
  recipe (run_finetune at the CLI's default dtype, float32: 3 optimizer
  steps of 4 micro-batches of 2 windows of 2048 tokens, BERT-base widths,
  12 layers, weights from a seed) through the checkout's own
  chip_smoke.train_path (host clock between the steps' metrics events);
- the card's SM clock and power draw, read just after;
- sha256 digests, on the same inputs, of what must not move: the float32
  forwards of rows 10-13 (unless timed), kernel 9's float32 output, the bf16
  and W8A8 outputs of the forward kernels (1, 2, 3, 6-9 and rows 10-13's
  forwards) and the backwards in the other dtype; and of what the change may
  move (``moved digest ...``), the timed backwards' outputs and, with
  ``--dtype float32``, the float32 forwards of rows 10-13 and kernels 7 and
  8.

Then it prints the mean of each checkout, whether each must-not-move digest
is the same in every run, and whether each moved digest differs from the
parent's and repeats within each checkout; it exits 1 if a must-not-move
digest differs or a moved one does not repeat. Readings of one kernel move
by up to a third between calls of the card, so only two checkouts measured
in one call are compared.

    python3 backward_gemm_turns.py --measure [--dtype ...]

measures the checkout the script is run from (its working directory) alone.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

B, L, H, NH, HD, I = 32, 512, 768, 12, 64, 3072
LB, LL, WINDOW, BLOCK = 8, 2048, 512, 64
# kernels whose names hold one of these run the backwards' products
GEMM_KERNELS = ("gemm_bias_act", "qkv_proj", "weight_grad", "act_and_grad", "residual_ln")


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


def digest(out) -> str:
    import torch

    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def device_split(fn) -> dict:
    """ms of device time of one call of fn by kernel, summed into its GEMM
    kernels and the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {"gemm_ms": 0.0, "core_ms": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        key = "gemm_ms" if any(k in e.key for k in GEMM_KERNELS) else "core_ms"
        split[key] += us / 1e3
    return split


def recipe_windows_per_s(steps: int = 3) -> float:
    """Windows trained per second of the float32 Longformer recipe through
    the measured checkout's chip_smoke.py (``train_path``), its corpus and
    flags but --dtype, so run_finetune takes its default, float32."""
    import tempfile

    import chip_smoke as cs
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts

    with tempfile.TemporaryDirectory() as tmp:
        data = cs.write_corpus(Path(tmp), n_test_docs=4, n_train_docs=12, seed=2,
                               sentences=(150, 300))

        def argv(out, epochs):
            a = cs.longformer_train_argv(data, str(Path(tmp) / out), epochs)
            i = a.index("--dtype")
            return a[:i] + a[i + 2:]

        epochs = cs.epochs_for_steps(argv("probe", 1.0), steps)
        row = cs.train_path(argv("train", epochs), cs.LAYERS, cs.LF_TRAIN_B, accum=cs.LF_ACCUM,
                            kernels={"sliding_train_fwd": ts.sliding_train_fwd,
                                     "sliding_train_bwd": ts.sliding_train_bwd,
                                     "mlp_train_fwd": tb.mlp_train_fwd,
                                     "mlp_train_bwd": tb.mlp_train_bwd})
    return row["windows_per_s"]


def measure(reps: int, timed: str = "bfloat16") -> dict:
    """{reading: ms, or the digest of an output} of the checkout on sys.path,
    the backwards timed in ``timed``, with the card's clock."""
    import torch

    from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables
    from spokennlp_tpu_torch.ops.cuda import bigbird_block as bbk
    from spokennlp_tpu_torch.ops.cuda import sliding_block as sb
    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts
    from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.blhd_attention import snld_self_attention
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.ops.cuda.ponet_block import fused_ponet_mixer_block
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    HN, M = NH * HD, B * L
    seg = torch.ones((B, L), dtype=torch.int32, device=dev)
    for b in range(B):  # padded tails and, on odd rows, two packed windows
        n = L - (37 * b) % 300
        seg[b, n:] = 0
        if b % 2:
            seg[b, n // 2:n] = 2
    n_valid = torch.tensor([LL, 1024, LL, 1300, LL, 1650, LL, 1900], device=dev)
    mask = (torch.arange(LL, device=dev)[None] < n_valid[:, None]).int()
    glob = torch.zeros_like(mask)
    glob[:, 0] = 1
    seed = torch.tensor([20231016], dtype=torch.int32, device=dev)
    att = [randn(H, 3, NH, HD, scale=H**-0.5), randn(3, NH, HD, scale=0.02),
           randn(NH, HD, H, scale=HN**-0.5), randn(H, scale=0.02)]
    gqkv = [randn(H, 3, NH, HD, scale=H**-0.5), randn(3, NH, HD, scale=0.02)]
    mlp = [randn(H, I, scale=H**-0.5), randn(I, scale=0.02), randn(I, H, scale=I**-0.5),
           randn(H, scale=0.02)]
    ln = dict(ln_scale=1 + randn(H, scale=0.1), ln_bias=randn(H, scale=0.1))
    tables = bigbird_tables(LL // BLOCK, 2, 3, 0, dev)
    out = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        hidden, cot = randn(B, L, H).to(dt), randn(B, L, H).to(dt)
        lhid, lcot = randn(LB, LL, H).to(dt), (randn(LB, LL, H) * mask[..., None]).to(dt)
        x, cot2 = hidden.reshape(M, H), cot.reshape(M, H)
        wqkv = att[0].to(dt).reshape(H, 3 * HN).contiguous()
        wo = att[2].to(dt).reshape(HN, H).contiguous()
        bqkv = att[1].reshape(-1).contiguous()
        w1, w2 = mlp[0].to(dt).contiguous(), mlp[2].to(dt).contiguous()
        sw = sb.card_weights(att[0], att[1], *gqkv, att[2], dt)
        bw = bbk.card_weights(att[0], att[1], att[2], dt)
        kw = dict(num_heads=NH, sm_scale=HD**-0.5, dropout_rate=0.1)
        scfg = dict(kw, window=WINDOW, max_globals=16, global_rows=True)
        bcfg = dict(kw, block_size=BLOCK)
        m32, g32 = mask.contiguous(), glob.contiguous()
        forwards = {
            "10": lambda: tb.attention_train_fwd(hidden, seg, seed, wqkv, bqkv, wo, att[3], **kw),
            "11": lambda: tb.mlp_train_fwd(x, w1, mlp[1], w2, mlp[3], activation="gelu"),
            "12": lambda: ts.sliding_train_fwd(lhid, m32, g32, seed, sw, att[3], **scfg),
            "13": lambda: tbb.bigbird_train_fwd(lhid, m32, seed, bw, att[3], tables, **bcfg),
        }
        backwards = {
            "10": lambda: tb.attention_train_bwd(hidden, seg, seed, wqkv, bqkv, wo, cot, **kw),
            "11": lambda: tb.mlp_train_bwd(x, w1, mlp[1], w2, cot2, activation="gelu"),
            "12": lambda: ts.sliding_train_bwd(lhid, m32, g32, seed, sw, lcot, **scfg),
            "13": lambda: tbb.bigbird_train_bwd(lhid, m32, seed, bw, lcot, tables, **bcfg),
        }
        for row, fn in backwards.items():
            if dtype == timed:
                out[f"row {row} backward ms"] = time_ms(fn, reps)
                out.update({f"row {row} backward {k}": v for k, v in device_split(fn).items()})
                out[f"moved digest row {row} backward {dtype}"] = digest(fn())
            else:
                out[f"digest row {row} backward {dtype}"] = digest(fn())
        for row, fn in forwards.items():
            if dtype == timed == "float32":  # the float32 forwards' products moved with them
                out[f"row {row} forward ms"] = time_ms(fn, reps)
                out[f"moved digest row {row} forward {dtype}"] = digest(fn())
            else:
                out[f"digest row {row} forward {dtype}"] = digest(fn())
        # the forward kernels' outputs: bf16 and W8A8; in float32 kernels 7
        # and 8 (timed with --dtype float32) and kernel 9
        blk = lambda **q: fused_attention_block(hidden, seg, att[0].to(dt), att[1],
                                                att[2].to(dt), att[3], sm_scale=HD**-0.5, **ln,
                                                **q)
        mlpb = lambda **q: fused_mlp_block(x, w1, mlp[1], w2, mlp[3], **ln, activation="gelu",
                                           eps=1e-12, **q)
        stack_p = [t[None].expand(2, *t.shape).contiguous() for t in
                   (att[0], att[1], att[2], att[3], ln["ln_scale"], ln["ln_bias"], *mlp,
                    ln["ln_scale"], ln["ln_bias"])]
        slide = lambda **q: sb.fused_sliding_attention_block(
            lhid, mask, glob, att[0], att[1], *gqkv, att[2], att[3], sm_scale=HD**-0.5,
            window=WINDOW, **ln, **q)
        bird = lambda **q: bbk.fused_bigbird_attention_block(
            lhid, mask, att[0], att[1], att[2], att[3], block_size=BLOCK, num_global_blocks=2,
            num_random_blocks=3, seed=0, sm_scale=HD**-0.5, **ln, **q)
        pon = [randn(5, H, H, scale=H**-0.5), randn(5, H, scale=0.02), randn(H, H, scale=H**-0.5),
               randn(H, scale=0.02)]
        pseg = (torch.arange(LL, device=dev) // 37)[None].expand(LB, LL).contiguous()
        ponet = lambda **q: fused_ponet_mixer_block(lhid, mask, pseg, *pon, local_window=3,
                                                     sm_scale=HD**-0.5, **ln, **q)
        if dtype == "float32":
            if timed == "float32":
                for k, fn in (("7", slide), ("8", bird)):
                    out[f"kernel {k} float32 ms"] = time_ms(fn, reps)
                    out[f"moved digest kernel {k} float float32"] = digest(fn())
            out["digest kernel 9 float float32"] = digest(ponet())
            torch.cuda.empty_cache()
            continue
        for mode, q in (("float", False), ("W8A8", True)):
            out[f"digest kernel 1 {mode} bf16"] = digest(blk(quantized=q))
            out[f"digest kernel 2 {mode} bf16"] = digest(mlpb(quantized=q))
            out[f"digest kernel 3 {mode} bf16"] = digest(fused_encoder_stack(
                hidden, seg, *stack_p, sm_scale=HD**-0.5, quantized=q))
            out[f"digest kernel 7 {mode} bf16"] = digest(slide(quantized=q))
            out[f"digest kernel 8 {mode} bf16"] = digest(bird(quantized=q))
            out[f"digest kernel 9 {mode} bf16"] = digest(ponet(quantized=q))
        qkv = randn(B, 3, NH, L, HD).to(dt)
        out["digest kernel 6 bf16"] = digest(snld_self_attention(qkv, seg, HD**-0.5))
        torch.cuda.empty_cache()
    if timed == "float32":
        with contextlib.redirect_stdout(sys.stderr):  # train_path's report
            out["recipe float32 windows per s"] = recipe_windows_per_s()
    out["sm clock, power draw"] = smi("clocks.sm,power.draw")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--measure", action="store_true", help="measure this checkout alone")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the backwards' dtype to time; their outputs may move")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("backward_gemm_turns: no CUDA device", file=sys.stderr)
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
        proc = subprocess.run([sys.executable, str(here / "backward_gemm_turns.py"), "--measure",
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
                                             for k in rows[0] if isinstance(rows[0][k], float)}}))
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
