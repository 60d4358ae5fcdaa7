#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spokennlp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Preconditions: a CUDA card; prints the torch, CUDA and nvcc versions and
   the card's name and power limit.
2. Builds the kernels (csrc/*.cu, one nvcc per source for sm_90a) and prints
   the build time.
3. Inference kernel phase: each inference kernel against its plain PyTorch
   version at the main path's shapes (B=32, L=512, H=768, 12 heads of 64,
   I=3072), bfloat16 and float32, with padded tails and two packed segments;
   prints the largest error on valid rows and both times (CUDA events,
   after a warm-up).
4. Training kernel phase: the four training kernels (attention and MLP,
   forward and backward) at the same shapes, bfloat16 and float32, at
   dropout rate 0 and at 0.1 with the kernels' mask replayed in the plain
   version: the output, dx and every weight and bias gradient against the
   plain version's output and autograd gradients; the keep fraction of one
   (B, nh, L, L) mask within 1e-3 of 0.9; kernel and plain times.
5. Inference main path: topic-segmentation inference through the port's CLI
   (cli/run_inference.main) at BERT-base widths in bfloat16 on a synthetic
   wiki_section corpus of several hundred 512-token windows. Checks that
   each inference kernel ran once per layer per batch, that the metrics are
   finite, and that the fused path's logits agree with the einsum path's on
   one batch (argmax agreement >= 0.99).
6. Training main path: fine-tuning through cli/run_finetune.main at
   BERT-base widths and 12 layers, L=512, bfloat16, with the DA view, TSSP
   and eop_matrix CSSL, for a few optimizer steps on a synthetic corpus.
   Checks that each training kernel ran layers x views x steps times, that
   every loss and grad_norm is finite, and that the checkpoint written at
   the end reloads and equals the final model; prints steps/s and windows/s.
7. Fused against einsum training on one batch at dropout 0: the loss within
   1e-2 relative and the cosine similarity of every layer's weight-matrix
   gradients >= 0.99.
8. Prints the kernels as one JSON line, the card's name and power limit,
   and last {"ok": true, "device": {...}}.

Exits non-zero, and prints no result, without a card, outside the repo, or
when any phase fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# the main path's shapes: BERT-base over 512-token windows, batches of 32
B, L, H, NH, HD, I, LAYERS = 32, 512, 768, 12, 64, 3072, 12
# kernel against plain version, largest deviation allowed on valid rows
# (tests/test_torch_kernels.py gives the reasons)
TOL = {"float32": (1e-3, 1e-3), "bfloat16": (5e-2, 2e-2)}  # (atol, rtol)
# training kernels: max |kernel - plain| / max |plain| per output
# (tests/test_torch_train_blocks.py gives the reasons)
TRAIN_TOL = {"float32": 1e-3, "bfloat16": 3e-2}
MIN_ARGMAX_AGREEMENT = 0.99
DROPOUT = 0.1  # the encoder's attention_dropout, configs.py
KEEP_FRACTION_TOL = 1e-3
TRAIN_STEPS = 3  # optimizer steps of the training main path
LOSS_RTOL, MIN_GRAD_COSINE = 1e-2, 0.99
# the card's peaks (NVIDIA H100 SXM data sheet): dense bf16 tensor cores,
# float32 on the CUDA cores, HBM bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# name: (source, TPU kernel it replaces)
KERNELS = {
    "fused_attention_block": (
        "spokennlp_tpu_torch/csrc/attention_block.cu",
        "spokennlp_tpu/ops/pallas/attention_block.py:360",
    ),
    "fused_mlp_block": (
        "spokennlp_tpu_torch/csrc/mlp_block.cu",
        "spokennlp_tpu/ops/pallas/mlp_block.py:119",
    ),
    "attention_train_fwd": (
        "spokennlp_tpu_torch/csrc/train_attention.cu",
        "spokennlp_tpu/ops/pallas/train_blocks.py:353",
    ),
    "attention_train_bwd": (
        "spokennlp_tpu_torch/csrc/train_attention.cu",
        "spokennlp_tpu/ops/pallas/train_blocks.py:402",
    ),
    "mlp_train_fwd": (
        "spokennlp_tpu_torch/csrc/train_mlp.cu",
        "spokennlp_tpu/ops/pallas/train_blocks.py:607",
    ),
    "mlp_train_bwd": (
        "spokennlp_tpu_torch/csrc/train_mlp.cu",
        "spokennlp_tpu/ops/pallas/train_blocks.py:651",
    ),
}


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def segments(device):
    """(B, L) segment ids: every row has a padded tail, odd rows hold two
    packed windows."""
    import torch

    seg = torch.zeros((B, L), dtype=torch.int32)
    for b in range(B):
        n = L - (37 * b) % 300
        seg[b, :n] = 1
        if b % 2:
            seg[b, n // 2 : n] = 2
    return seg.to(device)


def time_ms(fn, reps=10) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_pair(kernel, plain, reps=10) -> dict:
    """Kernel and plain in turns (kernel, plain, plain, kernel) after a warm-up."""
    kernel(), plain()
    k1, p1, p2, k2 = (time_ms(kernel, reps), time_ms(plain, reps), time_ms(plain, reps),
                      time_ms(kernel, reps))
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, n_bytes: int, dtype: str) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate of their type and the bytes (each input read once, each
    output written once) over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, n_bytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None}


def compare(name, dtype, kernel, plain, valid):
    """Check kernel against plain on the valid rows; time both."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got, want = got[valid].float(), want[valid].float()
    if not torch.isfinite(got).all():
        fail(f"{name} {dtype}: non-finite output")
    err = (got - want).abs()
    atol, rtol = TOL[dtype]
    worst = (err - rtol * want.abs()).max().item()
    max_err = err.max().item()
    if worst > atol:
        fail(f"{name} {dtype}: max |err| {max_err:.3e} exceeds atol {atol} + rtol {rtol} * |ref|")
    row = {"max_abs_err": max_err, **timed_pair(kernel, plain)}
    print(f"kernel {name} {dtype}: max_abs_err {max_err:.3e}  kernel {row['ms']:.3f} ms  "
          f"plain {row['plain_ms']:.3f} ms")
    return row


def kernel_phase(device) -> dict:
    """{(name, dtype): row} for the inference kernels at the main path's shapes."""
    import torch

    from spokennlp_tpu_torch.ops.cuda.attention_block import (
        attention_block_plain, fused_attention_block,
    )
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain

    g = torch.Generator(device=device).manual_seed(0)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    seg = segments(device)
    valid = seg > 0
    M, HN = B * L, NH * HD
    rows = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        # the weights the kernels compute with, given to both sides
        qkv_k = randn(H, 3, NH, HD, scale=H**-0.5).to(dt)
        out_k = randn(NH, HD, H, scale=(NH * HD) ** -0.5).to(dt)
        att = dict(qkv_bias=randn(3, NH, HD, scale=0.02), out_bias=randn(H, scale=0.02))
        ln = dict(ln_scale=1 + randn(H, scale=0.1), ln_bias=randn(H, scale=0.1))
        hidden = randn(B, L, H).to(dt)
        call = lambda fn: fn(hidden, seg, qkv_k, att["qkv_bias"], out_k, att["out_bias"],
                             sm_scale=HD**-0.5, **ln)
        rows["fused_attention_block", dtype] = compare(
            "fused_attention_block", dtype, lambda: call(fused_attention_block),
            lambda: call(attention_block_plain), valid,
        )
        flops = 2 * M * H * 3 * HN + 4 * B * NH * L * L * HD + 2 * M * HN * H
        moved = nbytes(hidden, seg, qkv_k, out_k, *att.values(), *ln.values(), hidden)
        rows["fused_attention_block", dtype].update(bound(flops, moved, dtype))
        x = randn(M, H).to(dt)
        w1, w2 = randn(H, I, scale=H**-0.5).to(dt), randn(I, H, scale=I**-0.5).to(dt)
        b1, b2 = randn(I, scale=0.02), randn(H, scale=0.02)
        mlp = lambda fn, **kw: fn(x, w1, b1, w2, b2, ln["ln_scale"], ln["ln_bias"],
                                  activation="gelu", eps=1e-12, **kw)
        rows["fused_mlp_block", dtype] = compare(
            "fused_mlp_block", dtype, lambda: mlp(fused_mlp_block, quantized=False),
            lambda: mlp(mlp_block_plain), slice(None),
        )
        moved = nbytes(x, w1, b1, w2, b2, *ln.values(), x)
        rows["fused_mlp_block", dtype].update(bound(4 * M * H * I, moved, dtype))
    return rows


# ------------------------------------------------------------ training kernels


def _normalized_errors(got, want, names, dtype, label):
    """max |got - want| / max |want| for each named output; fails above the
    tolerance. Returns the largest absolute error over all outputs."""
    import torch

    worst_abs, parts = 0.0, []
    for name, gt, wt in zip(names, got, want):
        gt, wt = gt.float(), wt.float()
        if not torch.isfinite(gt).all():
            fail(f"{label}: non-finite {name}")
        abs_err = (gt - wt).abs().max().item()
        rel = abs_err / max(wt.abs().max().item(), 1e-30)
        worst_abs = max(worst_abs, abs_err)
        parts.append(f"{name} {rel:.2e}")
        if rel > TRAIN_TOL[dtype]:
            fail(f"{label}: {name} max|err|/max|ref| {rel:.3e} > {TRAIN_TOL[dtype]}")
    print(f"  {label}: " + ", ".join(parts))
    return worst_abs


def train_kernel_phase(device) -> dict:
    """{(name, dtype): row} for the four training kernels."""
    import torch

    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    g = torch.Generator(device=device).manual_seed(1)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    seg = segments(device)
    seed = torch.tensor([20231016], dtype=torch.int32, device=device)
    keep = tb.dropout_keep_mask(seed, B, NH, L, DROPOUT)
    frac = keep.float().mean().item()
    print(f"dropout keep fraction over one ({B}, {NH}, {L}, {L}) mask: {frac:.6f}")
    if abs(frac - (1.0 - DROPOUT)) > KEEP_FRACTION_TOL:
        fail(f"keep fraction {frac:.6f} not within {KEEP_FRACTION_TOL} of {1.0 - DROPOUT}")
    M, HN, sm = B * L, NH * HD, HD**-0.5
    att_names = ("out", "dx", "dqkv_kernel", "dqkv_bias", "dout_kernel", "dout_bias")
    mlp_names = ("out", "dx", "dw1", "db1", "dw2", "db2")
    rows = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        att_p = dict(qkv_kernel=randn(H, 3, NH, HD, scale=H**-0.5),
                     qkv_bias=randn(3, NH, HD, scale=0.02),
                     out_kernel=randn(NH, HD, H, scale=HN**-0.5), out_bias=randn(H, scale=0.02))
        hidden, cot = randn(B, L, H).to(dt), randn(B, L, H).to(dt)
        mlp_p = dict(w1=randn(H, I, scale=H**-0.5), b1=randn(I, scale=0.02),
                     w2=randn(I, H, scale=I**-0.5), b2=randn(H, scale=0.02))
        x, cot2 = randn(M, H).to(dt), randn(M, H).to(dt)
        err = {k: 0.0 for k in ("attention_train_fwd", "attention_train_bwd", "mlp_train_fwd",
                                 "mlp_train_bwd")}
        for rate in (0.0, DROPOUT):
            keep_r = keep if rate else None
            # kernels through the autograd wrapper; the plain version on the
            # weights rounded as the kernels round them, gradients by autograd
            leaves = {k: v.detach().requires_grad_() for k, v in att_p.items()}
            h = hidden.detach().requires_grad_()
            out = tb.attention_block_train(h, seg, *leaves.values(), seed, sm_scale=sm,
                                           dropout_rate=rate)
            got = [out, *torch.autograd.grad(out, [h, *leaves.values()], cot)]
            ref = {k: (v.to(dt) if k.endswith("kernel") else v).detach().requires_grad_()
                   for k, v in att_p.items()}
            h = hidden.detach().requires_grad_()
            out = tb.attention_train_plain(h, seg, *ref.values(), sm_scale=sm, dropout_rate=rate,
                                           keep=keep_r)
            want = [out, *torch.autograd.grad(out, [h, *ref.values()], cot)]
            label = f"attention_train {dtype} rate {rate}"
            err["attention_train_fwd"] = max(err["attention_train_fwd"], _normalized_errors(
                got[:1], want[:1], att_names[:1], dtype, label + " fwd"))
            err["attention_train_bwd"] = max(err["attention_train_bwd"], _normalized_errors(
                got[1:], want[1:], att_names[1:], dtype, label + " bwd"))

            leaves = {k: v.detach().requires_grad_() for k, v in mlp_p.items()}
            xx = x.detach().requires_grad_()
            out = tb.mlp_block_train(xx, *leaves.values())
            got = [out, *torch.autograd.grad(out, [xx, *leaves.values()], cot2)]
            ref = {k: (v.to(dt) if k.startswith("w") else v).detach().requires_grad_()
                   for k, v in mlp_p.items()}
            xx = x.detach().requires_grad_()
            out = tb.mlp_train_plain(xx, *ref.values(), activation="gelu")
            want = [out, *torch.autograd.grad(out, [xx, *ref.values()], cot2)]
            label = f"mlp_train {dtype} rate {rate}"
            err["mlp_train_fwd"] = max(err["mlp_train_fwd"], _normalized_errors(
                got[:1], want[:1], mlp_names[:1], dtype, label + " fwd"))
            err["mlp_train_bwd"] = max(err["mlp_train_bwd"], _normalized_errors(
                got[1:], want[1:], mlp_names[1:], dtype, label + " bwd"))

        # times at the training path's rate, the kernels called directly
        wqkv = att_p["qkv_kernel"].to(dt).reshape(H, 3 * HN).contiguous()
        bqkv = att_p["qkv_bias"].reshape(-1).contiguous()
        wo = att_p["out_kernel"].to(dt).reshape(HN, H).contiguous()
        bo = att_p["out_bias"]
        kw = dict(num_heads=NH, sm_scale=sm, dropout_rate=DROPOUT)
        ref = {k: (v.to(dt) if k.endswith("kernel") else v).detach().requires_grad_()
               for k, v in att_p.items()}
        h = hidden.detach().requires_grad_()
        with torch.no_grad():
            plain_fwd = lambda: tb.attention_train_plain(hidden, seg, *ref.values(), sm_scale=sm,
                                                         dropout_rate=DROPOUT, keep=keep)
            fwd = timed_pair(lambda: tb.attention_train_fwd(hidden, seg, seed, wqkv, bqkv, wo, bo,
                                                            **kw), plain_fwd)
        out = tb.attention_train_plain(h, seg, *ref.values(), sm_scale=sm, dropout_rate=DROPOUT,
                                       keep=keep)
        bwd = timed_pair(
            lambda: tb.attention_train_bwd(hidden, seg, seed, wqkv, bqkv, wo, cot, **kw),
            lambda: torch.autograd.grad(out, [h, *ref.values()], cot, retain_graph=True))
        del out
        in_bytes = nbytes(hidden, seg, wqkv, bqkv, wo, bo)
        qkv_flops, core = 2 * M * H * 3 * HN, 4 * B * NH * L * L * HD
        fwd.update(bound(qkv_flops + core + 2 * M * HN * H, in_bytes + nbytes(hidden), dtype))
        # recomputed q, k, v and p.v; dctx; dp, dq, dk, dv; dx; dWqkv; dWo
        bwd_flops = 3 * qkv_flops + 3 * core + 4 * M * H * HN
        out_bytes = nbytes(hidden) + 4 * (H * 3 * HN + 3 * HN + HN * H + H)
        bwd.update(bound(bwd_flops, in_bytes + nbytes(cot) + out_bytes, dtype))
        rows["attention_train_fwd", dtype] = {"max_abs_err": err["attention_train_fwd"], **fwd}
        rows["attention_train_bwd", dtype] = {"max_abs_err": err["attention_train_bwd"], **bwd}

        w1, w2 = mlp_p["w1"].to(dt).contiguous(), mlp_p["w2"].to(dt).contiguous()
        b1, b2 = mlp_p["b1"], mlp_p["b2"]
        ref = {k: (v.to(dt) if k.startswith("w") else v).detach().requires_grad_()
               for k, v in mlp_p.items()}
        xx = x.detach().requires_grad_()
        with torch.no_grad():
            fwd = timed_pair(lambda: tb.mlp_train_fwd(x, w1, b1, w2, b2, activation="gelu"),
                             lambda: tb.mlp_train_plain(x, *ref.values(), activation="gelu"))
        out = tb.mlp_train_plain(xx, *ref.values(), activation="gelu")
        bwd = timed_pair(
            lambda: tb.mlp_train_bwd(x, w1, b1, w2, cot2, activation="gelu"),
            lambda: torch.autograd.grad(out, [xx, *ref.values()], cot2, retain_graph=True))
        del out
        in_bytes = nbytes(x, w1, b1, w2, b2)
        fwd.update(bound(4 * M * H * I, in_bytes + nbytes(x), dtype))
        # recomputed x.W1; g.W2^T; dx; dW1; dW2
        out_bytes = nbytes(x) + 4 * (H * I + I + I * H + H)
        bwd.update(bound(10 * M * H * I, in_bytes + nbytes(cot2) + out_bytes, dtype))
        rows["mlp_train_fwd", dtype] = {"max_abs_err": err["mlp_train_fwd"], **fwd}
        rows["mlp_train_bwd", dtype] = {"max_abs_err": err["mlp_train_bwd"], **bwd}
        for name in err:
            r = rows[name, dtype]
            print(f"kernel {name} {dtype}: max_abs_err {r['max_abs_err']:.3e}  kernel "
                  f"{r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms "
                  f"({r['bound_by']})")
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ main paths


def write_corpus(root: Path, n_test_docs: int, n_train_docs: int = 2, seed: int = 0) -> str:
    """A wiki_section corpus (train/dev/test jsonl of {"sentences", "labels"})."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(2000)]
    d = root / f"wiki_section_{seed}"
    d.mkdir()
    for split, n in (("train.jsonl", n_train_docs), ("dev.jsonl", 2), ("test.jsonl", n_test_docs)):
        with open(d / split, "w") as f:
            for _ in range(n):
                ns = int(rng.integers(60, 120))
                sents = [" ".join(rng.choice(words, size=rng.integers(6, 20))) for _ in range(ns)]
                labels = [int(rng.random() < 0.15) for _ in range(ns)]
                labels[-1] = 1
                f.write(json.dumps({"sentences": sents, "labels": labels}) + "\n")
    return str(d)


def main_path_argv(data_dir, out_dir, device="cuda", hidden=H, layers=LAYERS, heads=NH,
                   inter=I, seq=L, batch=B):
    return [
        "--data_dir", data_dir, "--output_dir", out_dir, "--device", device,
        "--hidden_size", str(hidden), "--num_hidden_layers", str(layers),
        "--num_attention_heads", str(heads), "--intermediate_size", str(inter),
        "--max_seq_length", str(seq), "--dtype", "bfloat16",
        "--per_device_eval_batch_size", str(batch), "--threshold", "0.5",
    ]


def train_argv(data_dir, out_dir, batch=B, **kw):
    """run_finetune flags of the composite step (bench.py --train): DA view,
    TSSP, eop_matrix CSSL; one epoch, no accumulation, metrics every step."""
    return main_path_argv(data_dir, out_dir, batch=batch, **kw) + [
        "--do_train", "--do_eval", "--do_predict", "--num_train_epochs", "1",
        "--per_device_train_batch_size", str(batch), "--gradient_accumulation_steps", "1",
        "--logging_steps", "1", "--do_da_ts", "--do_tssp", "--tssp_loss_weight", "1.0",
        "--cl_loss_weight", "0.5", "--cl_anchor_level", "eop_matrix",
    ]


def main_path(argv, n_layers, batch_size) -> dict:
    """Run the inference CLI; check launches, metrics and logits against einsum."""
    import torch

    from spokennlp_tpu_torch.cli import common, run_inference
    from spokennlp_tpu_torch.data.windowing_fast import window_documents_stacked
    from spokennlp_tpu_torch.eval.inference import predict_windows_scanned
    from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block

    wrappers = {"fused_attention_block": fused_attention_block, "fused_mlp_block": fused_mlp_block}
    for w in wrappers.values():
        w.launches = 0
    out = run_inference.main(argv)
    launches = {name: w.launches for name, w in wrappers.items()}
    n_windows = out["num_windows"]
    n_batches = math.ceil(n_windows / batch_size)
    for name, n in launches.items():
        if n != n_layers * n_batches:
            fail(f"{name} ran {n} times, expected {n_layers} layers x {n_batches} batches")
    metrics = out["metrics"]
    if not np.isfinite(list(metrics.values())).all():
        fail(f"non-finite metrics {metrics}")
    windows_per_s = n_windows / out["predict_time_s"]
    print(f"inference main path: {n_windows} windows in {n_batches} batches, "
          f"{out['predict_time_s']:.3f} s in the engine call ({windows_per_s:.1f} windows/s); "
          f"launches {launches}")

    # the same weights on the einsum path, on the first batch
    results = {}
    for impl in ("auto", "einsum"):
        args = run_inference.make_parser().parse_args(argv + ["--attention_impl", impl])
        tokenize_fn, special = common.resolve_tokenizer(args)
        enc_cfg, task_cfg, wcfg, _ = common.build_configs(args, special)
        model = run_inference.build_model(args, enc_cfg, task_cfg)
        docs = common.load_docs(args, tokenize_fn)["test"]
        batch = window_documents_stacked(docs, wcfg)
        first = {k: v[:batch_size] for k, v in batch.items()}
        results[impl] = predict_windows_scanned(model, first, batch_size, gather_sents=True)
        del model
        torch.cuda.empty_cache()
    live = first["sent_labels"] != -100
    fused, einsum = results["auto"][live], results["einsum"][live]
    agreement = float((fused.argmax(-1) == einsum.argmax(-1)).mean())
    max_dlogit = float(np.abs(fused - einsum).max())
    print(f"fused vs einsum on {int(live.sum())} labelled sentences of one batch: "
          f"argmax agreement {agreement:.4f}, max |dlogit| {max_dlogit:.4f}")
    if agreement < MIN_ARGMAX_AGREEMENT:
        fail(f"argmax agreement {agreement:.4f} < {MIN_ARGMAX_AGREEMENT}")
    return {"launches": launches, "windows": n_windows, "windows_per_s": windows_per_s,
            "agreement": agreement, "max_dlogit": max_dlogit, "metrics": metrics}


def train_path(argv, n_layers, batch_size, device="cuda") -> dict:
    """Run the fine-tuning CLI; check launches (on the card), losses and the
    checkpoint."""
    import torch

    from spokennlp_tpu_torch.cli import run_finetune
    from spokennlp_tpu_torch.ops.cuda import train_blocks as tb

    wrappers = {n: getattr(tb, n) for n in ("attention_train_fwd", "attention_train_bwd",
                                            "mlp_train_fwd", "mlp_train_bwd")}
    on_card = device == "cuda"
    for w in wrappers.values():
        w.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    results = run_finetune.main(argv)
    launches = {name: w.launches for name, w in wrappers.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    out_dir = Path(argv[argv.index("--output_dir") + 1])
    events = [json.loads(l) for l in (out_dir / "metrics.jsonl").read_text().splitlines()]
    train = [e for e in events if e["event"] == "train"]
    steps = len(train)
    if steps < 2 or steps != results["train_steps"]:
        fail(f"{steps} train events for {results['train_steps']} steps")
    views = 2  # anchor and DA
    for name, n in launches.items():
        if on_card and n != n_layers * views * steps:
            fail(f"{name} ran {n} times, expected {n_layers} layers x {views} views x "
                 f"{steps} steps")
    keys = ("loss", "ts_loss", "cl_loss", "da_ts_loss", "tssp_loss", "grad_norm")
    for e in train:
        if not all(k in e and math.isfinite(e[k]) for k in keys):
            fail(f"step {e['step']}: missing or non-finite loss in {e}")
    # the checkpoint of the last eval reloads and equals the final model
    final = torch.load(out_dir / "final_model" / "model.pt", map_location="cpu",
                       weights_only=True)
    index = json.loads((out_dir / "checkpoints" / "checkpoints.json").read_text())
    latest = max(index, key=lambda e: e["step"])
    ckpt = torch.load(out_dir / "checkpoints" / latest["file"], map_location="cpu",
                      weights_only=True)
    if ckpt["model"].keys() != final.keys() or not all(
            torch.equal(ckpt["model"][k], final[k]) for k in final):
        fail("the last checkpoint differs from final_model")
    steady = (train[-1]["time"] - train[0]["time"]) / (steps - 1)
    row = {"launches": launches, "steps": steps, "steps_per_s": 1.0 / steady,
           "windows_per_s": batch_size / steady, "peak_gib": peak_gib,
           "losses": {k: train[-1][k] for k in keys}}
    print(f"training main path: {steps} optimizer steps of {batch_size} windows (x2 views), "
          f"steady {row['steps_per_s']:.3f} steps/s = {row['windows_per_s']:.2f} windows/s "
          f"trained; peak {peak_gib:.2f} GiB; last step {row['losses']}; launches {launches}; "
          f"checkpoint step {latest['step']} reloaded, equal to final_model")
    return row


def fused_vs_einsum_grads(argv, batch_size, device="cuda") -> dict:
    """One composite step's loss and gradients on the training kernels and on
    the einsum path, same weights, same batch, dropout 0."""
    import dataclasses

    import torch

    from spokennlp_tpu_torch.cli import common, run_finetune
    from spokennlp_tpu_torch.cli.run_inference import build_model
    from spokennlp_tpu_torch.data.featurization import batches_from_docs
    from spokennlp_tpu_torch.models.topic_seg import compute_topic_seg_loss
    from spokennlp_tpu_torch.train.train_step import batch_to_device

    args = run_finetune.make_parser().parse_args(argv)
    tokenize_fn, special = common.resolve_tokenizer(args)
    enc_cfg, task_cfg, wcfg, _ = common.build_configs(args, special)
    enc_cfg = dataclasses.replace(enc_cfg, hidden_dropout=0.0, attention_dropout=0.0)
    task_cfg = dataclasses.replace(task_cfg, classifier_dropout=0.0)
    docs = common.load_docs(args, tokenize_fn)["train"]
    np_batch = next(batches_from_docs(docs, wcfg, task_cfg, batch_size,
                                      np.random.default_rng(0)))
    batch = batch_to_device(np_batch, torch.device(device))
    res = {}
    for impl in ("train_fused", "einsum"):
        model = build_model(args, dataclasses.replace(enc_cfg, attention_impl=impl), task_cfg)
        model.train()
        views = [model(batch["input_ids"][:, v], attention_mask=batch["attention_mask"][:, v],
                       token_type_ids=batch["token_type_ids"][:, v],
                       sent_positions=batch["sent_positions"][:, v]) for v in (0, 1)]
        loss, _ = compute_topic_seg_loss(task_cfg, views[0], views[1], batch)
        names = [n for n, _ in model.named_parameters() if n.startswith("encoder.layer_")
                 and n.endswith("kernel")]
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        res[impl] = (loss.item(), dict(zip(names, grads)))
        del model, views, loss
        if device == "cuda":
            torch.cuda.empty_cache()
    (lf, gf), (le, ge) = res["train_fused"], res["einsum"]
    rel = abs(lf - le) / abs(le)
    cos = {n: torch.nn.functional.cosine_similarity(gf[n].flatten(), ge[n].flatten(), dim=0).item()
           for n in gf}
    worst = min(cos, key=cos.get)
    print(f"fused vs einsum training, one batch of {batch_size} at dropout 0: loss {lf:.6f} vs "
          f"{le:.6f} (rel {rel:.2e}); lowest gradient cosine {cos[worst]:.5f} ({worst}) over "
          f"{len(cos)} weight matrices")
    if not rel <= LOSS_RTOL:
        fail(f"fused loss {lf} vs einsum {le}: rel {rel:.3e} > {LOSS_RTOL}")
    if cos[worst] < MIN_GRAD_COSINE:
        fail(f"gradient cosine {cos[worst]:.5f} of {worst} < {MIN_GRAD_COSINE}")
    return {"loss_rel": rel, "min_cos": cos[worst]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from spokennlp_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {[l for l in nvcc.splitlines() if 'release' in l][0].strip()}")
    print(f"card: {card}")

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({build.library_path().name})")

    device = torch.device("cuda")
    rows = kernel_phase(device)
    rows.update(train_kernel_phase(device))

    with tempfile.TemporaryDirectory() as tmp:
        data = write_corpus(Path(tmp), n_test_docs=120)
        infer = main_path(main_path_argv(data, str(Path(tmp) / "out")), LAYERS, B)
        # about 2.9 windows a document: TRAIN_STEPS batches of B in one epoch
        train_data = write_corpus(Path(tmp), n_test_docs=4,
                                  n_train_docs=math.ceil(TRAIN_STEPS * B / 2.5), seed=1)
        train = train_path(train_argv(train_data, str(Path(tmp) / "train_out")), LAYERS, B)
        fused_vs_einsum_grads(train_argv(train_data, str(Path(tmp) / "grad_out")), batch_size=B)

    launches = {**infer["launches"], **train["launches"]}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], **rows[name, "bfloat16"]})
    f32 = {name: rows[name, "float32"] for name in KERNELS}
    print(json.dumps({"float32": f32}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
