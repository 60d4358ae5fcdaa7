"""A ``torch.profiler`` measurement of the port's composite train step.

The step of ``bench.py --train``: anchor and DA views, eop_matrix CSSL, TSSP
and AdamW, in bfloat16 compute, random weights from a seed, on one of the
two trunks of ``bench.py --train-trunk``:

- ``dense``: BERT-base at L=512, 32 windows of 64 sentence slots;
- ``longformer``: the reference's flagship Longformer-base (window 512,
  RoBERTa positions, pad id 1) at L=2048, 4 windows of 128 slots.

    python -m spokennlp_tpu_torch.train.profiling --trunk longformer \
        --impl auto einsum --out chiprun_out/train_profile.json

For each ``--impl`` it reports the step time (host clock around steps that
end in a synchronise, after warm-up steps), windows trained per second, the
peak device memory, and from a ``torch.profiler`` trace of a few steps the
device time of every kernel, the share taken by the port's own kernels
(``csrc/``), and the busy share (the union of kernel intervals over the
traced steps' host time). The command needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from spokennlp_tpu_torch.configs import EncoderConfig, TopicSegConfig, TrainConfig
from spokennlp_tpu_torch.models.topic_seg import TopicSegModel
from spokennlp_tpu_torch.train import optim
from spokennlp_tpu_torch.train.train_step import batch_to_device, make_topic_seg_train_step

WARMUP_STEPS, TRACED_STEPS, TOP_KERNELS, SEED, STEPS = 2, 2, 20, 0, 5
# trunk: (windows a step, sequence length, sentence slots a window)
SHAPES = {"dense": (32, 512, 64), "longformer": (4, 2048, 128)}


def synthetic_batch(B: int, L: int, K: int, vocab: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """The paired-view batch of ``bench.py --train``: random ids, every token
    attended, a sentence slot every 7 tokens. Labels are 0 or 1 with 30 %
    ignored (bench.py draws them from [-100, 2), ids that only JAX's clamping
    gather accepts)."""
    rng = np.random.default_rng(seed)
    pos = np.tile(np.arange(K)[None, None] * 7 + 1, (B, 2, 1)).astype(np.int32)
    labels = rng.integers(0, 2, size=(B, 2, L)).astype(np.int32)
    labels[rng.random((B, 2, L)) < 0.3] = -100
    return {
        "input_ids": rng.integers(3, vocab - 1, size=(B, 2, L)).astype(np.int32),
        "attention_mask": np.ones((B, 2, L), np.int32),
        "token_type_ids": np.zeros((B, 2, L), np.int32),
        "labels": labels,
        "sent_positions": pos,
        "sent_mask": np.ones((B, 2, K), np.int32),
        "eop_mask": np.ones((B, 2, K), np.int32),
        "pair_orders": rng.integers(0, 3, size=(B, 2, K)).astype(np.int32),
    }


def kernel_name(name: str) -> str:
    """A kernel's identifier without namespaces and template arguments."""
    base = re.sub(r"<.*", "", name.replace("(anonymous namespace)::", ""))
    base = base.split("(")[0].split()[-1] if base.split() else name
    return base.split("::")[-1]


def kernel_times(prof) -> Dict[str, Dict]:
    """{kernel identifier: {"launches", "ms", "port"}} from a profiler trace,
    and the union of the kernels' device intervals in ms under "_busy_ms"."""
    out: Dict[str, Dict] = defaultdict(lambda: {"launches": 0, "ms": 0.0, "port": False})
    intervals = []
    for evt in prof.events():
        # device-side spans of user annotations (Optimizer.step#...) are not kernels
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        start, end = evt.time_range.start, evt.time_range.end
        intervals.append((start, end))
        row = out[kernel_name(evt.name)]
        row["launches"] += 1
        row["ms"] += (end - start) / 1e3
        row["port"] |= "spk::" in evt.name
    busy, last = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > last:
            busy += end - max(start, last)
            last = end
    result = dict(out)
    result["_busy_ms"] = busy / 1e3
    return result


def trunk_config(trunk: str, impl: str) -> EncoderConfig:
    """The encoder of ``bench.py --train --train-trunk <trunk>``."""
    _, L, _ = SHAPES[trunk]
    base = dict(vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12,
                intermediate_size=3072, add_pooler=False, attention_impl=impl)
    if trunk == "longformer":
        return EncoderConfig(**base, max_position_embeddings=L + 8,
                             attention_type="sliding_window", attention_window=512,
                             position_style="roberta", pad_token_id=1)
    return EncoderConfig(**base, max_position_embeddings=L)


def measure(enc: EncoderConfig, batch_size: int = SHAPES["dense"][0],
            slots: int = SHAPES["dense"][2], steps: int = STEPS, device: str = "cuda",
            seq_len: Optional[int] = None) -> Dict:
    """One configuration's step times and trace at ``seq_len`` tokens
    (``enc.max_position_embeddings`` by default); the tests run it on the
    CPU at a small ``enc``."""
    seq_len = seq_len or enc.max_position_embeddings
    device = torch.device(device)
    task = TopicSegConfig(cl_anchor_level="eop_matrix", cl_loss_weight=0.5, do_tssp=True,
                          do_da_ts=True, tssp_loss_weight=1.0)
    model = TopicSegModel(enc, task, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(SEED)).to(device)
    opt = optim.make_optimizer(model, TrainConfig(gradient_accumulation_steps=1), 1000)
    step = make_topic_seg_train_step(model, task, opt, seed=SEED)
    batch = batch_to_device(
        synthetic_batch(batch_size, seq_len, slots, enc.vocab_size), device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for _ in range(WARMUP_STEPS):
        step(batch)
    sync()
    times: List[float] = []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = step(batch)
        sync()
        times.append(time.perf_counter() - t0)
    losses = {k: float(v) for k, v in metrics.items()}
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED_STEPS):
            step(batch)
        sync()
        traced_s = time.perf_counter() - t0
    kernels = kernel_times(prof)
    busy_ms = kernels.pop("_busy_ms")
    total_ms = sum(k["ms"] for k in kernels.values())
    port_ms = sum(k["ms"] for k in kernels.values() if k["port"])
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:TOP_KERNELS]
    mean = float(np.mean(times))
    return {
        "attention_impl": enc.attention_impl,
        "step_ms": [t * 1e3 for t in times],
        "step_ms_mean": mean * 1e3,
        "windows_per_s": batch_size / mean,
        "peak_gib": (torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda"
                     else None),
        "traced_steps": TRACED_STEPS,
        "traced_host_ms": traced_s * 1e3,
        "kernel_ms": total_ms,
        "port_kernel_share": port_ms / total_ms if total_ms else None,
        "busy_share": busy_ms / (traced_s * 1e3) if device.type == "cuda" else None,
        "kernels": {name: {**row, "ms_per_step": row["ms"] / TRACED_STEPS}
                    for name, row in top},
        "last_step": losses,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trunk", default="dense", choices=sorted(SHAPES),
                   help="the encoder and shape of bench.py --train-trunk")
    p.add_argument("--impl", nargs="+", default=["auto", "einsum"],
                   help="attention_impl values to measure in turn")
    p.add_argument("--out", default=None, help="write the results as JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    batch, seq, slots = SHAPES[args.trunk]
    enc = trunk_config(args.trunk, "auto")
    results = {"card": card, "torch": torch.__version__, "trunk": args.trunk, "batch": batch,
               "seq": seq, "slots": slots, "layers": enc.num_layers,
               "hidden": enc.hidden_size, "runs": []}
    for impl in args.impl:
        run = measure(trunk_config(args.trunk, impl), batch, slots, seq_len=seq)
        results["runs"].append(run)
        print(f"{impl}: step {run['step_ms_mean']:.1f} ms ({run['windows_per_s']:.2f} windows/s), "
              f"peak {run['peak_gib']} GiB, kernels {run['kernel_ms']:.1f} ms over "
              f"{TRACED_STEPS} steps, port share {run['port_kernel_share']}, busy "
              f"{run['busy_share']}", flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({k: v for k, v in results.items() if k != "runs"}))
    return results


if __name__ == "__main__":
    main()
