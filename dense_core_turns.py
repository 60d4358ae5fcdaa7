#!/usr/bin/env python3
"""Times kernel 9 (the fused PoNet mixer block) and row 10 (the dense
training attention block, forward and backward) of two checkouts of the
port in turns on one CUDA card, splits each call's device time by kernel
name, and checks that the outputs that must not move are the same bits in
both; with ``--dtype float32``, the float32 dense attention cores instead.

    python3 dense_core_turns.py --parent DIR [--dtype bfloat16|float32] [--reps N]

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
  kernel 9's projections GEMM (``gemm_bias_act``), GA (``ga_ms``, the sum
  of each GA kernel's: the column sums ``ga_partial``, g's ``ga_finish``,
  the scores ``ga_scores``, the softmax ``ga_softmax``), SMP,
  LMP and the mix (``smp_ms``, the sum of the tile summaries ``smp_tiles``,
  the parent's ``smp_edges``, the scan ``smp_scan``, which also finishes
  GA's pooled value, and ``smp_mix``) and the out projection with LayerNorm
  (``residual_ln``); row 10's projections (``qkv_proj``), ``attn_rows``
  (the forward's, or the backward's statistics pass), ``attn_dq``,
  ``attn_dkv``, the other GEMMs (``gemm_bias_act``: the out projection, or
  dctx and dx), the weight gradients and the rest;
- the peak device memory of one row 10 backward in bf16;
- sha256 digests of what must not move: the digests of
  ``backward_gemm_turns.py`` (every output of rows 1-7 and 11-12 in every
  mode, kernel 9 in bf16 and W8A8, row 10 in float32) without row 10's
  bf16 forward, kernel 9 in W8A8 with float32 activations and the timed
  kernel 9 calls' outputs in bf16 and float32 (kernel 8's and row 13's are
  left to ``rows_core_turns.py``: their BigBird global rows sum in another
  order since the global tiles split over clusters);
- digests of row 10's bf16 forward and backward from two calls, which must
  be equal within this checkout.

With ``--dtype float32`` each process prints instead:

- ms a call (CUDA events) of row 10's float32 forward and backward at the
  shapes above, split by kernel name as above, and of row 10's bf16
  backward beside them; of kernel 1 (the attention block, LayerNorm on),
  kernel 3 (the stack over 12 layers, batch 32, unquantised and W8A8 with
  float32 activations) and kernel 6 (the attention over a projected qkv) in
  float32; and of the blocks' dense core alone in float32
  (``attention_block.attention_core``, the blocks' launch);
- windows trained per second of the CLI's dense training step at its
  default dtype, float32 (``run_finetune`` with the composite step's flags
  but ``--dtype``: BERT-base, 12 layers, batch 32, 3 optimizer steps, host
  clock between the steps' metrics events) and windows per second of
  float32 dense serving (``run_inference`` at batch 32, ``auto``: the
  stack kernel), both through the checkout's own ``chip_smoke.py``;
- digests of what must not move: those of ``backward_gemm_turns.py``
  (every bf16 and W8A8 output of rows 1-12 and kernels 1-9 but 8, the bf16
  backwards included, kernel 9 and rows 11-12 in float32) but row 10's
  float32 forward and backward, and kernels 2, 7 and 8 in float32; and
  two-call digests of the timed float32 outputs, which may move but must
  repeat within a checkout.

Then it prints the mean of each checkout and whether each digest is the
same in every run (the two-call digests: in the runs of this checkout).
Readings of one kernel move by up to a third between calls of the card, so
only two checkouts measured in one call are compared.

    python3 dense_core_turns.py --measure

measures the checkout the script is run from (its working directory) alone.

    python3 dense_core_turns.py --parent DIR --paths

reads instead, in the same turns, MUG Track 1 end to end through each
checkout's ``chip_smoke.py`` (phase 16: ``run_mug`` from a PoNet-base
checkpoint in float32 and W8A8, then ``predict_boundaries`` on the kernel
path, windows/s by host clock).
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
         ("ga_partial", ("ga_partial",)),
         ("ga_finish", ("ga_finish",)),
         ("ga_scores", ("ga_scores",)),
         ("ga_softmax", ("ga_softmax",)),
         ("smp_tiles", ("smp_tiles",)),
         ("smp_edges", ("smp_edges",)),
         ("smp_scan", ("smp_scan",)),
         ("smp_mix", ("smp_mix",)))
# parts of SPLIT summed into kernel 9's pooling chain: GA, and SMP, LMP and
# the mix
GROUPS = {"ga": ("ga_partial", "ga_finish", "ga_scores", "ga_softmax"),
          "smp": ("smp_tiles", "smp_edges", "smp_scan", "smp_mix")}
# backward_gemm_turns.py's digests that the work measured in each dtype
# moves: row 10's bf16 forward, or row 10's float32 forward and backward;
# and in both, kernel 8's and row 13's, whose BigBird global rows sum in
# another order (rows_core_turns.py holds their other rows)
BIGBIRD = ("digest kernel 8 ", "digest row 13 ")
MOVED = {"bfloat16": ("digest row 10 forward bfloat16",) + BIGBIRD,
         "float32": ("digest row 10 forward float32", "digest row 10 backward float32") + BIGBIRD}


def device_split(fn, call_ms=None, tries: int = 3) -> dict:
    """ms of device time of one call of fn by part (SPLIT, then rest_ms);
    parts that took no time are left out. With ``call_ms`` (the call's time
    by CUDA events) it profiles again, up to ``tries`` times, while the parts
    add up to less than nine tenths of it (a trace that lost kernel records),
    and keeps the fullest trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(tries):
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
            key = next((f"{k}_ms" for k, names in SPLIT if any(n in e.key for n in names)),
                       "rest_ms")
            split[key] = split.get(key, 0.0) + us / 1e3
        if sum(split.values()) > sum(best.values()):
            best = split
        if call_ms is None or sum(best.values()) >= 0.9 * call_ms:
            break
    for group, parts in GROUPS.items():
        if any(f"{k}_ms" in best for k in parts):
            best[f"{group}_ms"] = sum(best.get(f"{k}_ms", 0.0) for k in parts)
    return best


def segments(device):
    """(B, L) segment ids: padded tails and, on odd rows, two packed windows."""
    import torch

    seg = torch.ones((B, L), dtype=torch.int32, device=device)
    for b in range(B):
        n = L - (37 * b) % 300
        seg[b, n:] = 0
        if b % 2:
            seg[b, n // 2:n] = 2
    return seg


def cli_rates() -> dict:
    """Windows trained per second of the dense training step and windows per
    second of dense serving through the CLI at its default dtype (float32),
    by the measured checkout's chip_smoke.py."""
    import contextlib
    import math
    import tempfile

    import chip_smoke as cs
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack

    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(sys.stderr):
        train_data = cs.write_corpus(Path(tmp), n_test_docs=4,
                                     n_train_docs=math.ceil(cs.TRAIN_STEPS * cs.B / 2.5), seed=1)
        train = cs.train_path(cs.cli_default_dtype(cs.train_argv(train_data,
                                                                 str(Path(tmp) / "train"))),
                              cs.LAYERS, cs.B)
        data = cs.write_corpus(Path(tmp), n_test_docs=120)
        serve = cs.main_path(cs.cli_default_dtype(cs.main_path_argv(data, str(Path(tmp) / "out"))),
                             1, cs.B, kernels={"fused_encoder_stack": fused_encoder_stack})
    return {"cli float32 dense training windows per s": train["windows_per_s"],
            "cli float32 dense serving windows per s": serve["windows_per_s"]}


def measure_f32(reps: int) -> dict:
    """measure's float32 counterpart (the module's docstring)."""
    import torch

    import backward_gemm_turns
    from spokennlp_tpu_torch.ops.cuda import sliding_block as sb
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
    from spokennlp_tpu_torch.ops.cuda.attention_block import attention_core, fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.bigbird_block import fused_bigbird_attention_block
    from spokennlp_tpu_torch.ops.cuda.blhd_attention import snld_self_attention
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack

    # every digest of backward_gemm_turns.py must stay but row 10's float32
    # ones, the bf16 backwards' ("moved digest" there) among them
    out = {k.replace("moved digest", "digest"): v
           for k, v in backward_gemm_turns.measure(1).items()
           if k.startswith(("digest", "moved digest")) and not k.startswith(MOVED["float32"])}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    HN, I, NL = NH * HD, 4 * H, 12
    seg = segments(dev)
    seed = torch.tensor([20231018], dtype=torch.int32, device=dev)
    att = [randn(H, 3, NH, HD, scale=H**-0.5), randn(3, NH, HD, scale=0.02),
           randn(NH, HD, H, scale=HN**-0.5), randn(H, scale=0.02)]
    mlp = [randn(H, I, scale=H**-0.5), randn(I, scale=0.02), randn(I, H, scale=I**-0.5),
           randn(H, scale=0.02)]
    ln = dict(ln_scale=1 + randn(H, scale=0.1), ln_bias=randn(H, scale=0.1))
    kw = dict(num_heads=NH, sm_scale=HD**-0.5, dropout_rate=0.1)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        hidden, cot = randn(B, L, H).to(dt), randn(B, L, H).to(dt)
        wqkv = att[0].to(dt).reshape(H, 3 * HN).contiguous()
        wo = att[2].to(dt).reshape(HN, H).contiguous()
        bqkv = att[1].reshape(-1).contiguous()
        calls = {"row 10 backward": lambda: tb.attention_train_bwd(hidden, seg, seed, wqkv, bqkv,
                                                                    wo, cot, **kw)}
        if dtype == "float32":
            calls["row 10 forward"] = lambda: tb.attention_train_fwd(hidden, seg, seed, wqkv,
                                                                     bqkv, wo, att[3], **kw)
        for name, fn in calls.items():
            ms = out[f"{name} {dtype} ms"] = time_ms(fn, reps)
            out.update({f"{name} {dtype} {k}": v for k, v in device_split(fn, ms).items()})
            if dtype == "float32":
                for run in ("a", "b"):
                    out[f"twice {name} {dtype} run {run}"] = digest(fn())
    hidden = randn(B, L, H)
    stack_p = [t[None].expand(NL, *t.shape).contiguous() for t in
               (att[0], att[1], att[2], att[3], ln["ln_scale"], ln["ln_bias"], *mlp,
                ln["ln_scale"], ln["ln_bias"])]
    qkv_b = randn(3, B, NH, L, HD)
    qkv_b[0] *= HD**-0.5
    qkv_s = randn(B, 3, NH, L, HD)
    timed = {
        "kernel 1": lambda: fused_attention_block(hidden, seg, *att, sm_scale=HD**-0.5, **ln),
        "kernel 3": lambda: fused_encoder_stack(hidden, seg, *stack_p, sm_scale=HD**-0.5,
                                                quantized=False),
        "kernel 3 W8A8": lambda: fused_encoder_stack(hidden, seg, *stack_p, sm_scale=HD**-0.5,
                                                     quantized=True),
        "kernel 6": lambda: snld_self_attention(qkv_s, seg, HD**-0.5),
        "core": lambda: attention_core(qkv_b, seg),
    }
    for name, fn in timed.items():
        out[f"{name} float32 ms"] = time_ms(fn, 3 if name.startswith("kernel 3") else reps)
        for run in ("a", "b"):
            out[f"twice {name} float32 run {run}"] = digest(fn())
    out["sm clock, power draw"] = smi("clocks.sm,power.draw")
    # what must not move in float32: kernels 2, 7 and 8
    x = hidden.reshape(B * L, H)
    out["digest kernel 2 float32"] = digest(fused_mlp_block(x, *mlp, **ln, activation="gelu",
                                                            eps=1e-12, quantized=False))
    LB, LL = 8, 2048
    n_valid = torch.tensor([LL, 1024, LL, 1300, LL, 1650, LL, 1900], device=dev)
    mask = (torch.arange(LL, device=dev)[None] < n_valid[:, None]).int()
    glob = torch.zeros_like(mask)
    glob[:, 0] = 1
    lhid = randn(LB, LL, H)
    gqkv = [randn(H, 3, NH, HD, scale=H**-0.5), randn(3, NH, HD, scale=0.02)]
    out["digest kernel 7 float32"] = digest(sb.fused_sliding_attention_block(
        lhid, mask, glob, att[0], att[1], *gqkv, att[2], att[3], sm_scale=HD**-0.5, window=512,
        **ln))
    out["digest kernel 8 float32"] = digest(fused_bigbird_attention_block(
        lhid, mask, att[0], att[1], att[2], att[3], block_size=64, num_global_blocks=2,
        num_random_blocks=3, seed=0, sm_scale=HD**-0.5, **ln))
    torch.cuda.empty_cache()
    out.update(cli_rates())
    return out


def measure(reps: int, dtype: str = "bfloat16") -> dict:
    """{reading: ms, or the digest of an output} of the checkout on sys.path,
    with the card's clock."""
    import torch

    if dtype == "float32":
        return measure_f32(reps)
    import backward_gemm_turns
    from spokennlp_tpu_torch.ops.cuda import ponet_block as pb
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    out = {k: v for k, v in backward_gemm_turns.measure(1).items()
           if k.startswith("digest") and not k.startswith(MOVED[dtype])}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    HN = NH * HD
    seg = segments(dev)
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
            if name == "kernel 9":  # must not move
                out[f"digest {name} {dtype}"] = digest(fn())
            elif dtype == "bfloat16":  # may move
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


def paths() -> dict:
    """{path: windows/s} of MUG Track 1 on the checkout on sys.path, through
    its chip_smoke.py's phase 16 (the same corpus, checkpoints and flags)."""
    import contextlib
    import tempfile

    import chip_smoke as cs

    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(sys.stderr):
        mug = cs.mug_path(cs.ponet_checkpoints(Path(tmp)),
                          cs.write_mug_corpus(Path(tmp) / "mug", n_train=3, n_eval=4), Path(tmp))
    return {f"MUG Track 1 {label}, kernel path, windows/s": mug[label]["kernel"]["windows_per_s"]
            for label in ("float32", "W8A8")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--measure", action="store_true", help="measure this checkout alone")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--paths", action="store_true", help="MUG Track 1 end to end instead")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="bfloat16: kernel 9 and row 10; float32: the float32 dense cores")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dense_core_turns: no CUDA device", file=sys.stderr)
        return 1
    if args.measure:
        sys.path.insert(0, os.getcwd())  # the measured checkout, before the script's own
        print(json.dumps(paths() if args.paths else measure(args.reps, args.dtype)))
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
                               "--reps", str(args.reps), "--dtype", args.dtype]
                              + ["--paths"] * args.paths, cwd=root,
                              env=env, capture_output=True, text=True)
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
