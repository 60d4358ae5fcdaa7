#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spokennlp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Preconditions: a CUDA card; prints the torch, CUDA and nvcc versions and
   the card's name and power limit.
2. Builds the kernels (csrc/*.cu, nvcc for sm_90a) and prints the build time.
3. Kernel phase: each kernel against its plain PyTorch version at the main
   path's shapes (B=32, L=512, H=768, 12 heads of 64, I=3072), bfloat16 and
   float32, with padded tails and two packed segments; prints the largest
   error on valid rows and both times (CUDA events, after a warm-up).
4. Main path: topic-segmentation inference through the port's own CLI
   (cli/run_inference.main) at BERT-base widths in bfloat16 on a synthetic
   wiki_section corpus of several hundred 512-token windows. Checks that
   each kernel ran once per layer per batch, that the metrics are finite,
   and that the fused path's logits agree with the einsum path's on one
   batch (argmax agreement >= 0.99).
5. Prints the kernels as one JSON line, the card's name and power limit,
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
MIN_ARGMAX_AGREEMENT = 0.99
KERNELS = {
    "fused_attention_block": (
        "spokennlp_tpu_torch/csrc/attention_block.cu",
        "spokennlp_tpu/ops/pallas/attention_block.py:360",
    ),
    "fused_mlp_block": (
        "spokennlp_tpu_torch/csrc/mlp_block.cu",
        "spokennlp_tpu/ops/pallas/mlp_block.py:119",
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


def compare(name, dtype, kernel, plain, valid):
    """Check kernel against plain on the valid rows; time both in turns
    (kernel, plain, plain, kernel) after a warm-up."""
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
    k1, p1, p2, k2 = time_ms(kernel), time_ms(plain), time_ms(plain), time_ms(kernel)
    row = {"max_abs_err": max_err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}
    print(f"kernel {name} {dtype}: max_abs_err {max_err:.3e}  kernel {row['ms']:.3f} ms  "
          f"plain {row['plain_ms']:.3f} ms")
    return row


def kernel_phase(device) -> dict:
    """{(name, dtype): {"max_abs_err", "ms", "plain_ms"}} at the main path's shapes."""
    import torch

    from spokennlp_tpu_torch.ops.cuda.attention_block import (
        attention_block_plain, fused_attention_block,
    )
    from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block, mlp_block_plain

    g = torch.Generator(device=device).manual_seed(0)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=device) * scale
    seg = segments(device)
    valid = seg > 0
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
        x = randn(B * L, H).to(dt)
        w1, w2 = randn(H, I, scale=H**-0.5).to(dt), randn(I, H, scale=I**-0.5).to(dt)
        b1, b2 = randn(I, scale=0.02), randn(H, scale=0.02)
        mlp = lambda fn, **kw: fn(x, w1, b1, w2, b2, ln["ln_scale"], ln["ln_bias"],
                                  activation="gelu", eps=1e-12, **kw)
        rows["fused_mlp_block", dtype] = compare(
            "fused_mlp_block", dtype, lambda: mlp(fused_mlp_block, quantized=False),
            lambda: mlp(mlp_block_plain), slice(None),
        )
    return rows


def write_corpus(root: Path, n_test_docs: int, seed: int = 0) -> str:
    """A wiki_section corpus (train/dev/test jsonl of {"sentences", "labels"})."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(2000)]
    d = root / "wiki_section"
    d.mkdir()
    for split, n in (("train.jsonl", 2), ("dev.jsonl", 2), ("test.jsonl", n_test_docs)):
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


def main_path(argv, n_layers, batch_size) -> dict:
    """Run the CLI; check launches, metrics and logits against einsum."""
    import torch

    from spokennlp_tpu.data.windowing_fast import window_documents_stacked
    from spokennlp_tpu_torch.cli import common, run_inference
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
    print(f"main path: {n_windows} windows in {n_batches} batches, "
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

    with tempfile.TemporaryDirectory() as tmp:
        data = write_corpus(Path(tmp), n_test_docs=120)
        result = main_path(main_path_argv(data, str(Path(tmp) / "out")), LAYERS, B)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        row = rows[name, "bfloat16"]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": result["launches"][name], **row})
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
