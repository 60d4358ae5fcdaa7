"""The JAX package's native checkpoints: a directory with ``params.msgpack``
(flax's msgpack serialisation of the parameter tree) and ``config.json``
(the ``EncoderConfig`` dataclass).

Counterpart of ``spokennlp_tpu/models/checkpoint_io.py``, without flax: the
tree is read and written with the ``msgpack`` package and flax's array
extension (ext type 1: a msgpack triple of shape, dtype name and the
C-order buffer; ext type 3 a numpy scalar in the same form). Arrays that
flax split into chunks (``__msgpack_chunked_array__``) are joined on read.
So a JAX run's checkpoint loads into the port (``models/convert.py``), and
one the port writes loads into JAX.

A checkpoint holds whole weights whatever the mesh: ``model_state`` gathers
a model-sharded model's parameters before a save, ``load_state_`` cuts a
whole ``state_dict`` to this rank's shards after a load (parallel/mesh.py),
so a checkpoint written at ``--model_parallel_size 2`` loads at 1 with the
same bits, and the other way round.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional, Tuple

import numpy as np

from spokennlp_tpu_torch.configs import EncoderConfig

PARAMS_FILE = "params.msgpack"
CONFIG_FILE = "config.json"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
_MAX_LEAF_BYTES = 2**30  # flax chunks larger arrays; this writer refuses them


def _as_numpy(value) -> np.ndarray:
    if hasattr(value, "detach"):  # a torch tensor
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def _to_plain_tree(tree):
    """Nested plain dicts of C-contiguous numpy arrays."""
    if isinstance(tree, Mapping):
        return {str(k): _to_plain_tree(v) for k, v in tree.items()}
    return np.ascontiguousarray(_as_numpy(tree))


def _pack_ext(obj):
    import msgpack

    if isinstance(obj, np.ndarray):
        if obj.nbytes > _MAX_LEAF_BYTES:
            raise ValueError(f"an array of {obj.nbytes} bytes is above the msgpack leaf limit")
        payload = msgpack.packb((obj.shape, obj.dtype.name, obj.tobytes("C")), use_bin_type=True)
        return msgpack.ExtType(_EXT_NDARRAY, payload)
    raise TypeError(f"cannot serialise {type(obj).__name__}")


def _array_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, name, buffer = msgpack.unpackb(data, raw=True)
    name = name.decode()
    if name == "bfloat16":  # stored as its 16 bits; widened to float32 exactly
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _unpack_ext(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _array_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def params_from_state_dict(state_dict: Mapping) -> dict:
    """A flat ``state_dict`` (dotted names, as ``models/convert.py`` makes
    them) back into the nested Flax tree of numpy arrays (convolution
    kernels back in Flax's layout, ``convert.CONV_KERNEL``)."""
    from spokennlp_tpu_torch.models.convert import CONV_KERNEL, conv_to_flax

    tree: dict = {}
    for name, value in state_dict.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        value = _as_numpy(value)
        if CONV_KERNEL.search(name) and value.ndim in (3, 4):
            value = conv_to_flax(value)
        node[leaf] = value
    return tree


def save_checkpoint(path: str, params: Mapping, enc_cfg: Optional[EncoderConfig] = None):
    """Write the parameter tree (nested mappings of numpy arrays or tensors)
    and, when given, the encoder config to the directory ``path``."""
    import msgpack

    os.makedirs(path, exist_ok=True)
    data = msgpack.packb(_to_plain_tree(params), default=_pack_ext, strict_types=True)
    with open(os.path.join(path, PARAMS_FILE), "wb") as f:
        f.write(data)
    if enc_cfg is not None:
        with open(os.path.join(path, CONFIG_FILE), "w") as f:
            json.dump(dataclasses.asdict(enc_cfg), f, indent=2)


def is_native_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, PARAMS_FILE))


def load_checkpoint(path: str) -> Tuple[dict, Optional[EncoderConfig]]:
    """(the parameter tree as nested dicts of numpy arrays, the encoder
    config or None)."""
    import msgpack

    with open(os.path.join(path, PARAMS_FILE), "rb") as f:
        params = msgpack.unpackb(f.read(), ext_hook=_unpack_ext, raw=False)
    cfg = None
    cfg_path = os.path.join(path, CONFIG_FILE)
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = EncoderConfig(**json.load(f))
    return _unchunk(params), cfg


def model_state(model) -> dict:
    """``model``'s ``state_dict`` with its model-sharded parameters gathered
    whole (every rank of the model group calls it)."""
    from spokennlp_tpu_torch.parallel.mesh import gather_state_dict

    return gather_state_dict(model)


def load_state_(model, state: Mapping, strict: bool = True):
    """Load a whole ``state_dict`` into ``model``, each model-sharded
    parameter taking this rank's slice."""
    from spokennlp_tpu_torch.parallel.mesh import shard_state_dict

    model.load_state_dict(shard_state_dict(state, model), strict=strict)
