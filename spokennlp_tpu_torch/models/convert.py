"""Carry JAX parameters into the port.

The port names its parameters after the Flax tree (module names joined by
dots, leaves ``kernel``/``bias``/``scale``/``embedding`` with the same
shapes), so the conversion is a flattening: the result loads with
``model.load_state_dict(sd, strict=True)``. That holds for every tree the
port reads (the encoders and task models, GPT-2, the SentEval classifier,
WavLM and HuBERT, the MMVTS model, CLIP's vision tower) with one
exception: the port's convolutions keep PyTorch's layouts, so the kernels of
WavLM's ``feature_extractor.conv_{i}`` and ``pos_conv``, (k, in / groups,
out) in Flax's NWC convolution, become ``Conv1d``'s (out, in / groups, k),
and CLIP's ``patch_embed``, (kh, kw, in, out) in Flax's NHWC convolution,
``Conv2d``'s (out, in, kh, kw) (``CONV_KERNEL``, ``conv_to_torch``;
``conv_to_flax`` is the inverse).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch

# the Flax NWC / NHWC convolution kernels among the port's parameters
CONV_KERNEL = re.compile(r"(^|\.)(feature_extractor\.conv_\d+|pos_conv|patch_embed)\.kernel$")
# Flax's kernel axes in PyTorch's order, by the kernel's rank: the inverse
# of each is the transpose by its argsort
_TO_TORCH = {3: (2, 1, 0), 4: (3, 2, 0, 1)}


def conv_to_torch(value: np.ndarray) -> np.ndarray:
    """A Flax convolution kernel in ``Conv1d`` / ``Conv2d``'s layout."""
    return np.ascontiguousarray(value.transpose(_TO_TORCH[value.ndim]))


def conv_to_flax(value: np.ndarray) -> np.ndarray:
    """A ``Conv1d`` / ``Conv2d`` kernel in Flax's layout."""
    return np.ascontiguousarray(value.transpose(np.argsort(_TO_TORCH[value.ndim])))


def jax_params_to_state_dict(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """Nested dicts of arrays (``jax.tree.map(np.asarray, params)``) to a
    ``state_dict`` of float32 tensors."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(tree: Mapping, prefix: str):
        for name, value in tree.items():
            key = f"{prefix}{name}"
            if isinstance(value, Mapping):
                walk(value, key + ".")
                continue
            value = np.array(value, dtype=np.float32)
            if CONV_KERNEL.search(key) and value.ndim in _TO_TORCH:
                value = conv_to_torch(value)
            out[key] = torch.from_numpy(value)

    walk(params, "")
    return out
