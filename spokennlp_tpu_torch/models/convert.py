"""Carry JAX parameters into the port.

The port names its parameters after the Flax tree (module names joined by
dots, leaves ``kernel``/``bias``/``scale``/``embedding`` with the same
shapes), so the conversion is a flattening: the result loads with
``model.load_state_dict(sd, strict=True)``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


def jax_params_to_state_dict(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """Nested dicts of arrays (``jax.tree.map(np.asarray, params)``) to a
    ``state_dict`` of float32 tensors."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(tree: Mapping, prefix: str):
        for name, value in tree.items():
            key = f"{prefix}{name}"
            if isinstance(value, Mapping):
                walk(value, key + ".")
            else:
                out[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    walk(params, "")
    return out
