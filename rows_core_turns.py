#!/usr/bin/env python3
"""Times the sliding-window and BigBird rows kernels (``band_rows``,
``bigbird_rows``) and the Longformer global rows (``global_rows``) inside
kernels 7 and 8 (both modes) and rows 12 and 13 (forward and backward) of
two checkouts of the port in turns on one CUDA card, splits each call's
device time by kernel name, and checks that the outputs that must not move
are the same bits in both.

    python3 rows_core_turns.py --parent DIR [--dtype bfloat16|float32] [--reps N]

DIR is another checkout of the repo (the parent commit, unpacked with ``git
archive``). The script runs one measuring process a checkout in the order
parent, this, this, parent, each building that checkout's kernels at first
use and printing one JSON line:

- ms a call (CUDA events after a warm-up) of kernel 7 in bf16 and W8A8 at
  B=8, L=2048 (window 512, CLS global) and at B=2, kernel 8 in bf16 and
  W8A8 at B=4, L=4096 (blocks of 64, 2 global and 3 random), rows 12 and
  13's forwards and backwards in bf16 at B=8, L=2048, dropout 0.1, and row
  12's also at the recipe's micro-batch B=2, all at BERT-base widths; the
  card's SM clock and power draw read after each; where the checkout has
  it (``train_sliding.sliding_global_rows``), the global rows alone in each
  mode at B=8 and B=2 (device time);
- the device time of one call of each, by kernel name (torch.profiler):
  the rows kernel (``rows_ms``: ``band_rows`` or ``bigbird_rows``; in a
  backward its ``kGrad`` instance, the statistics pass), ``global_rows``,
  the projections (``qkv_proj``), the output projection and LayerNorm
  (``residual_ln``, ``gemm_bias_act``), the weight gradients, the
  backwards' gradient kernels and the rest (counts, casts, row
  quantisation, memsets);
- the BigBird rows kernel alone (``train_bigbird.bigbird_rows``, device
  time) as kernel 8 (bf16 ctx and the W8A8 block's float32 ctx, and in
  float32, B=4, L=4096) and as row 13's forward and statistics pass (B=8,
  L=2048, dropout 0.1; bf16 and float32), on every query tile; where the
  wrapper takes ``parts``, also on the global tiles alone and the other
  tiles alone;
- sha256 digests of what must not move: every output of kernels 7 and 8
  and rows 12 and 13 (forward and backward) in bf16, W8A8 and float32 but
  those that the bf16 BigBird global tiles move (kernel 8 in both modes,
  row 13 forward and backward, in bf16; float32 walks a global tile in one
  block, as before); of those, kernel 8's and row 13's forward output rows
  beyond the global blocks (rows 128 on), which do not depend on the
  global rows; of the BigBird rows kernel alone, its ctx rows 128 on and,
  in the statistics pass, every row's maximum (the global rows' too: the
  split takes the exact maximum over its blocks); kernel 7's output rows
  at or beyond n_glob (rows 1 on; CLS is the one global token); and every
  output of rows 1-6 and 9-11 (the digests of ``backward_gemm_turns.py``
  without those of kernel 8 and row 13);
- digests of the outputs of every timed call from two calls, which must be
  equal within this checkout.

Then it prints the mean of each checkout and whether each digest is the
same in every run (the two-call digests: in the runs of this checkout).
Readings of one kernel move by up to a third between calls of the card, so
only two checkouts measured in one call are compared.

With ``--dtype float32`` each process prints instead:

- ms a call (CUDA events) of the rows kernels alone in float32
  (``train_sliding.sliding_rows``, ``train_bigbird.bigbird_rows``):
  ``band_rows`` as kernel 7 (B=8, L=2048, CLS global), as row 12's forward
  (dropout 0.1) and as its statistics pass (with dctx), ``bigbird_rows`` as
  kernel 8 (B=4, L=4096) and as row 13's forward and statistics pass (B=8,
  L=2048); beside each, scaled_dot_product_attention on the same float32
  q, k, v with the boolean mask of the allowed keys, dense over L x L (the
  forwards);
- ms of device time of the float32 global rows alone
  (``sliding_global_rows``) as kernel 7, row 12's forward and its
  statistics pass, with 1 and 16 global tokens, at B=8 and B=2;
- ms a call and the device time by kernel name, as above, of kernels 7 and
  8 in float32 (float mode, and W8A8 with float32 activations) and of rows
  12 and 13's float32 forwards (row 12 and kernel 7 also at B=2);
- digests of what must not move: those of ``backward_gemm_turns.py``
  (every bf16 and W8A8 output, the bf16 backwards included, and rows 10
  and 11 and kernel 9 in float32) but rows 12 and 13's float32 forwards
  and backwards, kernels 1, 2, 3 (two layers) and 6 in float32, kernel 7
  (float and W8A8) and row 12 (forward and backward) in float32 without
  global rows, and kernel 7's and row 12's forward float32 output rows at
  or beyond n_glob (rows 1 on, CLS global); and two-call digests of the
  timed float32 outputs and the global rows alone, which may move but must
  repeat within a checkout.

    python3 rows_core_turns.py --measure [--dtype float32]

measures the checkout the script is run from (its working directory) alone.

    python3 rows_core_turns.py --parent DIR --paths [--trunk longformer|bigbird]

reads instead, in the same turns, the long-context main paths end to end
through ``chip_smoke.py``'s own functions of each checkout: Longformer's
engine call at batch 8 x 2048 (windows/s, host clock), the recipe's
training for 2 optimizer steps of 4 x 2 windows (windows trained/s) and the
W8A8 and float kernel paths of the W8A8 long-context serving phase (median
windows/s of 3 calls); with ``--trunk bigbird`` BigBird's engine call at
batch 4 x 4096 and its W8A8 serving phase's two kernel paths.
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
# backward_gemm_turns.py's digests that the BigBird global tiles move: every
# output of kernel 8 and row 13
MOVED = ("digest kernel 8 ", "digest row 13 ")
# the calls whose bf16 outputs the BigBird global tiles move (their global
# rows' sums run in another order); every other output must not move
MOVED_CALLS = ("kernel 8 float", "kernel 8 W8A8", "row 13 forward", "row 13 backward")
GLOBAL_ROWS = 2 * BLOCK  # the global blocks' rows of kernel 8 and row 13
# backward_gemm_turns.py's digests that the float32 rows and gradient
# kernels move: rows 12 and 13's float32 forwards and backwards; and those
# that the BigBird global tiles move (MOVED)
F32_MOVED = tuple(f"digest row {r} {p} float32" for r in (12, 13)
                  for p in ("forward", "backward")) + MOVED


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


def measure(reps: int, dtype: str = "bfloat16") -> dict:
    """{reading: ms, or the digest of an output} of the checkout on sys.path,
    with the card's clock."""
    import torch

    if dtype == "float32":
        return measure_f32(reps)
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
        calls, timed = {}, set()
        for mode, q in (("float", False), ("W8A8", True)):
            for nb, tag in ((LB, ""), (2, " B=2")):
                calls[f"kernel 7 {mode}{tag}"] = (
                    lambda q=q, nb=nb: sb.fused_sliding_attention_block(
                        lhid[:nb], mask[:nb], glob[:nb], att[0], att[1], *gqkv, att[2], att[3],
                        sm_scale=HD**-0.5, window=WINDOW, **ln, quantized=q))
                timed.add(f"kernel 7 {mode}{tag}")
            calls[f"kernel 7 {mode} no globals"] = lambda q=q: sb.fused_sliding_attention_block(
                lhid, mask, torch.zeros_like(glob), att[0], att[1], *gqkv, att[2], att[3],
                sm_scale=HD**-0.5, window=WINDOW, **ln, quantized=q, global_rows=False)
            calls[f"kernel 8 {mode}"] = lambda q=q: bbk.fused_bigbird_attention_block(
                bhid, bmask, att[0], att[1], att[2], att[3], block_size=BLOCK,
                num_global_blocks=2, num_random_blocks=3, seed=0, sm_scale=HD**-0.5, **ln,
                quantized=q)
            timed.add(f"kernel 8 {mode}")
        for nb, tag in ((LB, ""), (2, " B=2")):
            calls[f"row 12 forward{tag}"] = lambda nb=nb: ts.sliding_train_fwd(
                lhid[:nb], mask[:nb], glob[:nb], seed, sw, att[3], **scfg)
            calls[f"row 12 backward{tag}"] = lambda nb=nb: ts.sliding_train_bwd(
                lhid[:nb], mask[:nb], glob[:nb], seed, sw, lcot[:nb], **scfg)
            timed |= {f"row 12 forward{tag}", f"row 12 backward{tag}"}
        nog = dict(scfg, global_rows=False)
        calls["row 12 forward no globals"] = lambda: ts.sliding_train_fwd(
            lhid, mask, torch.zeros_like(glob), seed, sw, att[3], **nog)
        calls["row 12 backward no globals"] = lambda: ts.sliding_train_bwd(
            lhid, mask, torch.zeros_like(glob), seed, sw, lcot, **nog)
        calls["row 13 forward"] = lambda: tbb.bigbird_train_fwd(lhid, mask, seed, bw, att[3],
                                                                tables, **bcfg)
        calls["row 13 backward"] = lambda: tbb.bigbird_train_bwd(lhid, mask, seed, bw, lcot,
                                                                 tables, **bcfg)
        timed |= {"row 13 forward", "row 13 backward"}
        for name, fn in calls.items():
            if name not in MOVED_CALLS or dtype == "float32":
                out[f"digest {name} {dtype}"] = digest(fn())
            elif name != "row 13 backward":
                # the rows beyond the global blocks do not depend on the global rows
                out[f"digest {name} rows {GLOBAL_ROWS} on {dtype}"] = digest(
                    fn()[:, GLOBAL_ROWS:])
            if name.startswith("kernel 7 ") and dtype == "bfloat16" and name in timed:
                # the rows at or beyond n_glob (CLS only) do not depend on the global rows
                out[f"digest {name} rows 1 on bfloat16"] = digest(fn()[:, 1:])
            if dtype == "float32" or name not in timed:
                continue
            out[f"{name} ms"] = time_ms(fn, reps)
            out[f"{name} sm clock, power draw"] = smi("clocks.sm,power.draw")
            out.update({f"{name} {k}": v for k, v in device_split(fn).items()})
            for run in ("a", "b"):
                out[f"twice {name} bf16 run {run}"] = digest(fn())
        if dtype == "bfloat16" and hasattr(ts, "sliding_global_rows"):
            out.update(global_rows_alone(lhid, mask, sw, gqkv, seed, reps))
        out.update(bigbird_rows_alone(bhid, bmask, lhid, mask, bw, seed, tables))
        torch.cuda.empty_cache()
    return out


def bigbird_rows_alone(bhid, bmask, lhid, mask, bw, seed, tables) -> dict:
    """ms of device time of one launch of the BigBird rows kernel alone
    (``train_bigbird.bigbird_rows``) as kernel 8 (bf16 ctx and the W8A8
    block's float32 ctx; float32 q, k, v in the float mode) on the q, k, v of
    a block call at B=4, L=4096, and as row 13's forward and statistics pass
    (dropout 0.1) at B=8, L=2048, on every query tile; where the wrapper
    takes ``parts``, also on the global tiles alone and on the other tiles
    alone. With the digests of what must not move: ctx rows GLOBAL_ROWS on
    and, in the statistics pass, every row's maximum."""
    import inspect

    import torch

    from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables
    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb

    out = {}
    dev = bhid.device
    has_parts = "parts" in inspect.signature(tbb.bigbird_rows).parameters
    variants = {"": {}}
    if has_parts:
        variants.update({" global tiles": {"parts": "global"},
                         " window tiles": {"parts": "window"}})
    btables = bigbird_tables(BB_L // BLOCK, 2, 3, 0, dev)
    g = torch.Generator(device=dev).manual_seed(9)
    for label, hid, msk, tab, rate, modes in (
            ("kernel 8", bhid, bmask, btables, 0.0, (("bf16 ctx", None, False),
                                                    ("W8A8 float32 ctx", torch.float32, False))
             if bhid.dtype == torch.bfloat16 else (("float32", None, False),)),
            ("row 13", lhid, mask, tables, 0.1, (("forward", None, False),
                                                 ("statistics pass", None, True)))):
        bufs = {}
        tbb.bigbird_train_fwd(hid, msk, seed, bw, torch.zeros(H, device=dev), tab,
                              num_heads=NH, block_size=BLOCK, sm_scale=HD**-0.5,
                              dropout_rate=rate, buffers=bufs)
        qkv = bufs["qkv"]
        counts = torch.stack([msk.sum(1), torch.zeros_like(msk[:, 0])], 1).int().contiguous()
        dctx = torch.randn(hid.shape[0], hid.shape[1], NH * HD, generator=g,
                           device=dev).to(hid.dtype)
        for mode, cdt, grad in modes:
            for tag, kw in variants.items():
                fn = lambda cdt=cdt, grad=grad, kw=kw: tbb.bigbird_rows(
                    qkv, counts, seed, tab, block_size=BLOCK, dctx=dctx if grad else None,
                    dropout_rate=rate, ctx_dtype=cdt, **kw)
                dt = "" if hid.dtype == torch.bfloat16 else " float32"
                out[f"bigbird rows alone{dt}, {label} {mode}{tag} ms"] = device_split(fn)["rows_ms"]
                if not tag:
                    ctx, stats = fn()
                    out[f"digest bigbird rows alone{dt}, {label} {mode}, rows {GLOBAL_ROWS} on"
                        f" and maxima"] = digest(
                            [ctx[:, GLOBAL_ROWS:]] + ([stats[0]] if grad else []))
    return out


def measure_f32(reps: int) -> dict:
    """measure's float32 counterpart (the module's docstring)."""
    import torch
    import torch.nn.functional as F

    import backward_gemm_turns
    from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables
    from spokennlp_tpu_torch.ops.cuda import bigbird_block as bbk
    from spokennlp_tpu_torch.ops.cuda import sliding_block as sb
    from spokennlp_tpu_torch.ops.cuda import train_bigbird as tbb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts
    from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.blhd_attention import snld_self_attention
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack

    # every digest of backward_gemm_turns.py must stay but rows 12 and 13's
    # float32 ones, the bf16 backwards' ("moved digest" there) among them
    out = {k.replace("moved digest", "digest"): v
           for k, v in backward_gemm_turns.measure(1).items()
           if k.startswith(("digest", "moved digest"))
           and not k.replace("moved digest", "digest").startswith(F32_MOVED)}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, f32 = torch.device("cuda"), torch.float32
    g = torch.Generator(device=dev).manual_seed(19)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    HN, sm = NH * HD, HD**-0.5
    att = [randn(H, 3, NH, HD, scale=H**-0.5), randn(3, NH, HD, scale=0.02),
           randn(NH, HD, H, scale=HN**-0.5), randn(H, scale=0.02)]
    gqkv = [randn(H, 3, NH, HD, scale=H**-0.5), randn(3, NH, HD, scale=0.02)]
    ln = dict(ln_scale=1 + randn(H, scale=0.1), ln_bias=randn(H, scale=0.1))
    seed = torch.tensor([20231019], dtype=torch.int32, device=dev)
    lengths = lambda L, n: (torch.arange(L, device=dev)[None]
                            < torch.tensor(n, device=dev)[:, None]).int()
    mask = lengths(LL, [LL, 1024, LL, 1300, LL, 1650, LL, 1900])
    glob = torch.zeros_like(mask)
    glob[:, 0] = 1
    bmask = lengths(BB_L, [BB_L, 3072, BB_L, 100])
    tables = bigbird_tables(LL // BLOCK, 2, 3, 0, dev)
    btables = bigbird_tables(BB_L // BLOCK, 2, 3, 0, dev)

    def qkv_of(Bq, Lq, scale_q=True):
        x, w = randn(Bq, Lq, H), randn(H, 3, NH, HD, scale=H**-0.5)
        qkv = torch.einsum("blh,hsnd->sbnld", x, w) + randn(3, 1, NH, 1, HD, scale=0.02)
        if scale_q:
            qkv[0] *= sm
        return qkv.contiguous()

    def sdpa(qkv, allowed):
        q, k, v = qkv.unbind(0)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed, scale=1.0)

    # the rows kernels alone, with SDPA on the same q, k, v and the mask of
    # the allowed keys
    counts = torch.stack([mask.sum(1), glob.sum(1)], 1).int().contiguous()
    qkv, dctx = qkv_of(LB, LL), randn(LB, LL, HN) * mask[..., None]
    C = WINDOW // 2
    allowed = torch.stack([ts.sliding_model_allowed(LL, C, int(nv), 1, dev)
                           for nv in mask.sum(1)])[:, None]
    alone = {"band_rows as kernel 7": (lambda: ts.sliding_rows(qkv, counts, seed, window=WINDOW),
                                       sdpa(qkv, allowed)),
             "band_rows as row 12 forward": (lambda: ts.sliding_rows(
                 qkv, counts, seed, window=WINDOW, dropout_rate=0.1), None),
             "band_rows as row 12 statistics pass": (lambda: ts.sliding_rows(
                 qkv, counts, seed, window=WINDOW, dctx=dctx, dropout_rate=0.1), None)}
    for name, (fn, lib) in alone.items():
        out[f"{name} float32 ms"] = time_ms(fn, reps)
        if lib is not None:
            out[f"{name} float32 SDPA ms"] = time_ms(lib, reps)
        for run in ("a", "b"):
            out[f"twice {name} float32 run {run}"] = digest([t for t in fn() if t is not None])
    del qkv, dctx, allowed, alone
    torch.cuda.empty_cache()
    # the float32 global rows alone (their W8A8 mode in kernel 7 W8A8's split
    # below: a parent may not launch it alone)
    sw = sb.card_weights(att[0], att[1], *gqkv, att[2], f32)
    out.update(global_rows_alone(randn(LB, LL, H), mask, sw, gqkv, seed, reps, w8a8=False,
                                 n_globs=(1, 16)))
    torch.cuda.empty_cache()
    bcounts = lambda m: torch.stack([m.sum(1), torch.zeros_like(m.sum(1))], 1).int().contiguous()
    for Bq, Lq, m, t, modes in ((BB_B, BB_L, bmask, btables, ("kernel 8",)),
                                (LB, LL, mask, tables, ("row 13 forward",
                                                        "row 13 statistics pass"))):
        qkv, dctx = qkv_of(Bq, Lq), randn(Bq, Lq, HN) * m[..., None]
        reg = torch.from_numpy(tbb.bigbird_model_regions(
            Lq, BLOCK, t.G, t.R, t.rand.cpu().numpy(), t.rok.cpu().numpy())).to(dev) > 0
        allowed = (reg[None] & (torch.arange(Lq, device=dev)[None, None]
                                < m.sum(1)[:, None, None]))[:, None]
        cb = bcounts(m)
        for mode in modes:
            rate = 0.0 if mode == "kernel 8" else 0.1
            dc = dctx if mode.endswith("pass") else None
            name = f"bigbird_rows as {mode}"
            fn = lambda rate=rate, dc=dc: tbb.bigbird_rows(qkv, cb, seed, t, block_size=BLOCK,
                                                           dctx=dc, dropout_rate=rate)
            out[f"{name} float32 ms"] = time_ms(fn, reps)
            if dc is None:
                out[f"{name} float32 SDPA ms"] = time_ms(sdpa(qkv, allowed), reps)
            for run in ("a", "b"):
                out[f"twice {name} float32 run {run}"] = digest([x for x in fn() if x is not None])
        del qkv, dctx, allowed, reg
        torch.cuda.empty_cache()

    # kernels 7 and 8 and rows 12 and 13's forwards, split by kernel name
    lhid, bhid = randn(LB, LL, H), randn(BB_B, BB_L, H)
    bw = bbk.card_weights(att[0], att[1], att[2], f32)
    kw = dict(num_heads=NH, sm_scale=sm, dropout_rate=0.1)
    scfg = dict(kw, window=WINDOW, max_globals=16, global_rows=True)
    calls = {}
    for mode, q in (("float", False), ("W8A8", True)):
        for nb, tag in ((LB, ""), (2, " B=2")):
            calls[f"kernel 7 {mode}{tag}"] = (
                lambda q=q, nb=nb: sb.fused_sliding_attention_block(
                    lhid[:nb], mask[:nb], glob[:nb], att[0], att[1], *gqkv, att[2], att[3],
                    sm_scale=sm, window=WINDOW, **ln, quantized=q))
        calls[f"kernel 8 {mode}"] = lambda q=q: bbk.fused_bigbird_attention_block(
            bhid, bmask, att[0], att[1], att[2], att[3], block_size=BLOCK, num_global_blocks=2,
            num_random_blocks=3, seed=0, sm_scale=sm, **ln, quantized=q)
    for nb, tag in ((LB, ""), (2, " B=2")):
        calls[f"row 12 forward{tag}"] = lambda nb=nb: ts.sliding_train_fwd(
            lhid[:nb], mask[:nb], glob[:nb], seed, sw, att[3], **scfg)
    calls["row 13 forward"] = lambda: tbb.bigbird_train_fwd(lhid, mask, seed, bw, att[3], tables,
                                                            **kw, block_size=BLOCK)
    for name, fn in calls.items():
        out[f"{name} float32 ms"] = time_ms(fn, reps)
        out.update({f"{name} float32 {k}": v for k, v in device_split(fn).items()})
        for run in ("a", "b"):
            out[f"twice {name} float32 run {run}"] = digest(fn())
        if name.startswith(("kernel 7", "row 12")) and not name.endswith("B=2"):
            # the rows at or beyond n_glob (CLS is the one global token) do
            # not depend on the global rows
            out[f"digest {name} rows 1 on float32"] = digest(fn()[:, 1:])
    out["sm clock, power draw"] = smi("clocks.sm,power.draw")
    # kernel 7 and row 12 without global rows
    nog = torch.zeros_like(glob)
    for mode, q in (("float", False), ("W8A8", True)):
        out[f"digest kernel 7 {mode} no globals float32"] = digest(
            sb.fused_sliding_attention_block(lhid, mask, nog, att[0], att[1], *gqkv, att[2],
                                             att[3], sm_scale=sm, window=WINDOW, **ln,
                                             quantized=q, global_rows=False))
    ncfg = dict(scfg, global_rows=False)
    out["digest row 12 forward no globals float32"] = digest(
        ts.sliding_train_fwd(lhid, mask, nog, seed, sw, att[3], **ncfg))
    out["digest row 12 backward no globals float32"] = digest(
        ts.sliding_train_bwd(lhid, mask, nog, seed, sw, randn(LB, LL, H) * mask[..., None],
                             **ncfg))

    # what must not move in float32: kernels 1, 2, 3 and 6
    seg = torch.ones(32, 512, dtype=torch.int32, device=dev)
    seg[1::2, 400:] = 0
    hidden = randn(32, 512, H)
    mlp = [randn(H, 4 * H, scale=H**-0.5), randn(4 * H, scale=0.02),
           randn(4 * H, H, scale=(4 * H)**-0.5), randn(H, scale=0.02)]
    stack_p = [t[None].expand(2, *t.shape).contiguous() for t in
               (att[0], att[1], att[2], att[3], ln["ln_scale"], ln["ln_bias"], *mlp,
                ln["ln_scale"], ln["ln_bias"])]
    out["digest kernel 1 float32"] = digest(fused_attention_block(hidden, seg, *att, sm_scale=sm,
                                                                  **ln))
    out["digest kernel 2 float32"] = digest(fused_mlp_block(
        hidden.reshape(-1, H), *mlp, **ln, activation="gelu", eps=1e-12, quantized=False))
    for mode, q in (("float", False), ("W8A8", True)):
        out[f"digest kernel 3 {mode} float32"] = digest(fused_encoder_stack(
            hidden, seg, *stack_p, sm_scale=sm, quantized=q))
    out["digest kernel 6 float32"] = digest(snld_self_attention(randn(32, 3, NH, 512, HD), seg,
                                                                sm))
    return out


def global_rows_alone(x, mask, sw, gqkv, seed, reps: int, w8a8: bool = True,
                      n_globs=(1,)) -> dict:
    """ms of device time of one launch of the global rows alone
    (``train_sliding.sliding_global_rows``) in each mode (kernel 7 float and,
    with ``w8a8``, W8A8, row 12's forward and statistics pass at dropout
    0.1) with each of ``n_globs`` global tokens (CLS global: 1), at B=8 and
    B=2, on the global projections of x; in float32 also two-call digests of
    each mode's outputs."""
    import torch

    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts
    from spokennlp_tpu_torch.ops.cuda.int8_matmul import quantize_colwise, rowquant_plain

    out = {}
    dev = x.device
    kv = torch.einsum("blh,hsnd->sbnld", x.float(), gqkv[0][:, 1:]) + gqkv[1][1:, None, :, None]
    gkv = kv.to(x.dtype).contiguous()
    x8, sx = rowquant_plain(x.reshape(-1, H))
    w8, swq = quantize_colwise(sw["wgq"].float())
    g = torch.Generator(device=dev).manual_seed(5)
    dctx = torch.randn(x.shape[0], LL, NH * HD, generator=g, device=dev).to(x.dtype)
    modes = [("kernel 7 float", False, 0.0, False), ("kernel 7 W8A8", True, 0.0, False),
             ("row 12 forward", False, 0.1, False), ("row 12 statistics pass", False, 0.1, True)]
    for nb, tag in ((LB, ""), (2, " B=2")):
        quant = dict(x8=x8[:nb * LL], sx=sx.reshape(-1)[:nb * LL], wgq8=w8.contiguous(),
                     swgq=swq.reshape(-1).contiguous())
        for n_g in n_globs:
            counts = torch.stack([mask[:nb].sum(1), torch.full((nb,), n_g, device=dev)],
                                 1).int().contiguous()
            for mode, q, rate, grad in modes:
                if q and not w8a8:
                    continue
                fn = lambda q=q, rate=rate, grad=grad: ts.sliding_global_rows(
                    x[:nb], sw["wgq"], sw["bgq"], gkv[:, :nb].contiguous(), counts, seed,
                    sm_scale=HD**-0.5, dctx=dctx[:nb] if grad else None, dropout_rate=rate,
                    quant=quant if q else None)
                name = f"global rows alone, {mode}{tag}" + ("" if n_g == 1 else f" n_glob {n_g}")
                out[f"{name} ms"] = device_split(fn)["global_rows_ms"]
                if x.dtype == torch.float32:
                    for run in ("a", "b"):
                        out[f"twice {name} float32 run {run}"] = digest(
                            [t for t in fn() if t is not None])
    return out


def paths(trunk: str = "longformer") -> dict:
    """{path: windows/s} of the long-context main paths of the checkout on
    sys.path, through its chip_smoke.py's phases 9, 10 and 19 (Longformer)
    or 13 and 19 (BigBird: the engine call and W8A8 serving), with the same
    corpus, seeds and flags."""
    import tempfile

    import chip_smoke as cs

    if trunk == "bigbird":
        from spokennlp_tpu_torch.ops.cuda.bigbird_block import fused_bigbird_attention_block
        from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block

        with tempfile.TemporaryDirectory() as tmp:
            data = cs.write_corpus(Path(tmp), n_test_docs=24, n_train_docs=8, seed=3,
                                   sentences=(300, 600))
            infer = cs.main_path(
                cs.main_path_argv(data, str(Path(tmp) / "bb_out"), seq=cs.BB_L, batch=cs.BB_B,
                                  bigbird=True), cs.LAYERS, cs.BB_B,
                kernels={"bigbird_attention_block": fused_bigbird_attention_block,
                         "fused_mlp_block": fused_mlp_block}, long_tokens=cs.BB_LONG_TOKENS)
            serving = cs.long_serving_path("bigbird", data, str(Path(tmp) / "bb_w8a8"))
        return {"BigBird engine call, float, windows/s": infer["windows_per_s"],
                "BigBird W8A8 serving, W8A8 kernel path, windows/s":
                    serving["runs"]["w8a8 auto"]["windows_per_s"],
                "BigBird W8A8 serving, float kernel path, windows/s":
                    serving["runs"]["none auto"]["windows_per_s"]}
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
    from spokennlp_tpu_torch.ops.cuda import train_sliding as ts
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
    from spokennlp_tpu_torch.ops.cuda.sliding_block import fused_sliding_attention_block

    with tempfile.TemporaryDirectory() as tmp:
        data = cs.write_corpus(Path(tmp), n_test_docs=40, n_train_docs=8, seed=2,
                               sentences=(150, 300))
        infer = cs.main_path(
            cs.main_path_argv(data, str(Path(tmp) / "lf_out"), seq=cs.LF_L, batch=cs.LF_B,
                              window=cs.LF_WINDOW), cs.LAYERS, cs.LF_B,
            kernels={"sliding_attention_block": fused_sliding_attention_block,
                     "fused_mlp_block": fused_mlp_block}, long_tokens=cs.LF_LONG_TOKENS)
        argv = lambda out, epochs: cs.longformer_train_argv(data, str(Path(tmp) / out), epochs)
        epochs = cs.epochs_for_steps(argv("lf_train_out", 1.0), cs.LF_STEPS)
        train = cs.train_path(
            argv("lf_train_out", epochs), cs.LAYERS, cs.LF_TRAIN_B, accum=cs.LF_ACCUM,
            kernels={"sliding_train_fwd": ts.sliding_train_fwd,
                     "sliding_train_bwd": ts.sliding_train_bwd,
                     "mlp_train_fwd": tb.mlp_train_fwd, "mlp_train_bwd": tb.mlp_train_bwd})
        serving = cs.long_serving_path("longformer", data, str(Path(tmp) / "lf_w8a8"))
    return {"engine call, float, windows/s": infer["windows_per_s"],
            "recipe training, windows trained/s": train["windows_per_s"],
            "W8A8 serving, W8A8 kernel path, windows/s":
                serving["runs"]["w8a8 auto"]["windows_per_s"],
            "W8A8 serving, float kernel path, windows/s":
                serving["runs"]["none auto"]["windows_per_s"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--measure", action="store_true", help="measure this checkout alone")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--paths", action="store_true",
                    help="the Longformer main paths end to end instead of the kernels")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="bfloat16: the kernels in bf16 and W8A8; float32: the float32 rows "
                         "kernels")
    ap.add_argument("--trunk", choices=("longformer", "bigbird"), default="longformer",
                    help="with --paths: whose main paths")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("rows_core_turns: no CUDA device", file=sys.stderr)
        return 1
    if args.measure:
        sys.path.insert(0, os.getcwd())  # the measured checkout, before the script's own
        print(json.dumps(paths(args.trunk) if args.paths else measure(args.reps, args.dtype)))
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
                               "--reps", str(args.reps), "--dtype", args.dtype,
                               "--trunk", args.trunk] + ["--paths"] * args.paths, cwd=root,
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
