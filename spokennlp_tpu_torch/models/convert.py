"""Carry JAX parameters into the port.

The port names its parameters after the Flax tree (module names joined by
dots, leaves ``kernel``/``bias``/``scale``/``embedding`` with the same
shapes), so the conversion is a flattening: the result loads with
``model.load_state_dict(sd, strict=True)``. That holds for every tree the
port reads (the encoders and task models, GPT-2, the SentEval classifier,
WavLM and HuBERT) with one exception: the port's convolutions keep
``torch.nn.Conv1d``'s (out, in / groups, k) layout, so the kernels of
WavLM's ``feature_extractor.conv_{i}`` and ``pos_conv``, (k, in / groups,
out) in Flax's NWC convolution, are transposed (``CONV_KERNEL``).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch

# the Flax NWC convolution kernels among the port's parameters
CONV_KERNEL = re.compile(r"(^|\.)(feature_extractor\.conv_\d+|pos_conv)\.kernel$")


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
            if CONV_KERNEL.search(key) and value.ndim == 3:
                value = np.ascontiguousarray(value.transpose(2, 1, 0))
            out[key] = torch.from_numpy(value)

    walk(params, "")
    return out
