"""Activation table of the fused kernels.

Counterpart of ``_ACTIVATIONS`` in ``spokennlp_tpu/ops/pallas/int8_matmul.py``:
inside the kernels "gelu" is the tanh form, as on the TPU, while the einsum
path of the encoder uses the exact erf form (``models/encoder.py ACT2FN``).
The W8A8 matmul of that module is not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x, approximate=True)."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


ACTIVATIONS = {
    "none": lambda x: x,
    "gelu": gelu_tanh,
    "gelu_new": gelu_tanh,
    "relu": torch.relu,
    "silu": F.silu,
}

# the codes csrc/common.cuh's apply_activation takes
ACTIVATION_CODES = {"none": 0, "gelu": 1, "gelu_new": 1, "relu": 2, "silu": 3}
