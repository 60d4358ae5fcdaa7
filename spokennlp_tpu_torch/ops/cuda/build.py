"""Build and load the package's CUDA kernels.

The sources under ``spokennlp_tpu_torch/csrc/`` are compiled with ``nvcc``
for Hopper (``sm_90a``), one ``nvcc`` per ``.cu`` file, all started together,
and linked into one shared library with a plain C interface, loaded with
``ctypes``. The library is built at first use into
``spokennlp_tpu_torch/_build/``, named by a hash of the sources, so an edited
source is rebuilt and an unchanged one is built once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F, _U, _Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint, ctypes.c_size_t
# C signatures of csrc/*.cu's extern "C" entries
_SIGNATURES = {
    "spk_attention_block": [_I] + [_P] * 12 + [_I] * 5 + [_F, _F, _I, _P],
    "spk_attention_block_w8a8": [_I] + [_P] * 17 + [_I] * 7 + [_F, _F, _I, _P],
    "spk_mlp_block": [_I] + [_P] * 10 + [_I] * 4 + [_F, _P],
    "spk_mlp_block_w8a8": [_I] + [_P] * 15 + [_I] * 4 + [_F, _P],
    "spk_rowquant": [_I] + [_P] * 3 + [_I] * 3 + [_P],
    "spk_w8a8_matmul": [_I] + [_P] * 6 + [_I] * 4 + [_P],
    "spk_snld_attention": [_I] + [_P] * 3 + [_I] * 4 + [_F, _P],
    "spk_attention_core": [_I] + [_P] * 3 + [_I] * 4 + [_P],
    "spk_encoder_stack": [_I, _I] + [_P] * 27 + [_I] * 8 + [_F, _F, _P],
    "spk_attention_train_fwd": [_I] + [_P] * 10 + [_I] * 5 + [_F, _U, _F, _P],
    "spk_attention_train_bwd": [_I] + [_P] * 19 + [_Z] + [_I] * 7 + [_F, _U, _F, _P],
    "spk_attention_rows": [_I] * 2 + [_P] * 6 + [_I] * 4 + [_F, _U, _F, _P],
    "spk_attention_grad": [_I] * 2 + [_P] * 7 + [_I] * 4 + [_F, _U, _F, _P],
    "spk_dropout_mask": [_P, _P, _I, _I, _I, _U, _P],
    "spk_mlp_train_fwd": [_I] + [_P] * 7 + [_I] * 4 + [_P],
    "spk_mlp_train_bwd": [_I] + [_P] * 14 + [_Z] + [_I] * 5 + [_P],
    "spk_weight_grad": [_I] + [_P] * 5 + [_Z] + [_I] * 4 + [_P],
    "spk_forward_tile": [_I, _I] + [_P] * 9 + [_I] * 5 + [_F, _F, _P],
    "spk_sliding_block": [_I] + [_P] * 19 + [_I] * 8 + [_F, _F, _I, _P],
    "spk_sliding_block_w8a8": [_I] + [_P] * 25 + [_I] * 8 + [_F, _F, _I, _P],
    "spk_sliding_train_fwd": [_I] + [_P] * 17 + [_I] * 8 + [_F, _U, _F, _P],
    "spk_sliding_train_bwd": [_I] + [_P] * 29 + [_Z] + [_I] * 10 + [_F, _U, _F, _P],
    "spk_sliding_dropout_mask": [_P] * 4 + [_I] * 5 + [_U, _P],
    "spk_sliding_rows": [_I] * 3 + [_P] * 6 + [_I] * 5 + [_U, _F, _P],
    "spk_sliding_global_rows": [_I] * 3 + [_P] * 15 + [_I] * 7 + [_F, _U, _F, _P],
    "spk_bigbird_block": [_I] + [_P] * 15 + [_I] * 8 + [_F, _F, _I, _P],
    "spk_bigbird_block_w8a8": [_I] + [_P] * 19 + [_I] * 8 + [_F, _F, _I, _P],
    "spk_bigbird_train_fwd": [_I] + [_P] * 13 + [_I] * 8 + [_F, _U, _F, _P],
    "spk_bigbird_train_bwd": [_I] + [_P] * 24 + [_Z] + [_I] * 10 + [_F, _U, _F, _P],
    "spk_bigbird_dropout_mask": [_P] * 5 + [_I] * 6 + [_U, _P],
    "spk_bigbird_rows": [_I] * 3 + [_P] * 8 + [_I] * 7 + [_U, _F, _P],
    "spk_ponet_block": [_I, _I] + [_P] * 24 + [_I] * 5 + [_F, _F, _P],
    "spk_int8_tile_smem": [_I],
    "spk_bf16_tile_smem": [_I],
}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libspokennlp_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists.

    Starts one ``nvcc -c`` per source at once, then links the objects.
    Writes the compilers' output (``-Xptxas -v``: registers, shared memory
    and spills of every kernel) beside the library as ``<name>.log``. Raises
    with that output if a compiler fails.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = so.with_name(f"{so.stem}.{src.stem}.{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    logs, failed = [], False
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        failed |= proc.returncode != 0
    objs = [str(obj) for _, obj, _ in jobs]
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        failed = proc.returncode != 0
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    log = "\n".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{log}")
    so.with_suffix(".log").write_text(f"{log}\nbuilt in {time.perf_counter() - t0:.1f} s\n")
    os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.spk_error_string.argtypes = [ctypes.c_int]
    lib.spk_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if code != 0:
        msg = library().spk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
