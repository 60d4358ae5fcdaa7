"""Reading HuggingFace checkpoint directories without ``transformers``.

The JAX package reads an HF directory through ``transformers.AutoConfig``
and ``AutoModel`` (``spokennlp_tpu/cli/common.py`` ``maybe_load_pretrained``).
The port reads the files themselves:

- ``config.json`` with ``json``, seen through an attribute view
  (``read_hf_config``) whose missing keys take the defaults of the matching
  ``transformers`` config class, written out in ``HF_CONFIG_DEFAULTS``
  (``save_pretrained`` leaves out keys that equal a base default);
- ``model.safetensors`` (what ``save_pretrained`` writes by default) with
  ``read_safetensors``: an 8-byte little-endian header length, a JSON header
  of names, dtypes, shapes and byte ranges, then the raw little-endian
  tensors; ``write_safetensors`` writes the same format;
- ``pytorch_model.bin`` with ``torch.load(..., weights_only=True)``.

``load_hf_checkpoint`` turns a directory of type bert, longformer, electra
or big_bird into an ``EncoderConfig`` and a parameter tree through
``models/hf_convert.py``. A directory it cannot read raises.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
import types
from typing import Dict, Mapping, Optional, Tuple

import torch

from spokennlp_tpu_torch.configs import EncoderConfig
from spokennlp_tpu_torch.models import hf_convert

CONFIG_FILE = "config.json"
SAFETENSORS_FILE = "model.safetensors"
BIN_FILE = "pytorch_model.bin"

_BERT_DEFAULTS = {
    "vocab_size": 30522, "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072, "hidden_act": "gelu",
    "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
    "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
    "pad_token_id": 0,
}
# the defaults of transformers' BertConfig, LongformerConfig, ElectraConfig
# and BigBirdConfig for every key that models/hf_convert.py reads
HF_CONFIG_DEFAULTS = {
    "bert": _BERT_DEFAULTS,
    "longformer": {**_BERT_DEFAULTS, "pad_token_id": 1, "attention_window": 512},
    "electra": {**_BERT_DEFAULTS, "hidden_size": 256, "embedding_size": 128,
                "num_attention_heads": 4, "intermediate_size": 1024},
    "big_bird": {**_BERT_DEFAULTS, "vocab_size": 50358, "hidden_act": "gelu_new",
                 "max_position_embeddings": 4096, "block_size": 64, "num_random_blocks": 3},
}
# where each type's task models keep the trunk (AutoModel strips it)
TRUNK_PREFIX = {"bert": "bert.", "longformer": "longformer.", "electra": "electra.",
                "big_bird": "bert."}

# safetensors dtype names <-> torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header of {n} bytes runs past the end of the file")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    header.pop("__metadata__", None)
    start, end_of_data = 8 + n, len(data) - 8 - n
    out = {}
    for name, info in header.items():
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not read")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = end - begin
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= end_of_data or count != itemsize * math.prod(shape):
            raise ValueError(f"{path}: {name} has byte range {begin}-{end} for shape {shape}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(data, dtype=dtype, count=count // itemsize,
                                     offset=start + begin).reshape(shape)
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None):
    """``tensors`` (CPU or card) to a ``.safetensors`` file, in name order,
    the header padded with spaces to a multiple of 8 bytes."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    if metadata:
        header["__metadata__"] = dict(metadata)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)


def read_hf_config(path: str) -> types.SimpleNamespace:
    """``<path>/config.json`` as attributes, missing keys at the defaults of
    its ``model_type``'s transformers config class."""
    with open(os.path.join(path, CONFIG_FILE)) as f:
        raw = json.load(f)
    model_type = raw.get("model_type")
    if model_type not in HF_CONFIG_DEFAULTS:
        raise ValueError(f"{path}: model_type {model_type!r} is not read; the port reads "
                         f"{sorted(HF_CONFIG_DEFAULTS)}")
    return types.SimpleNamespace(**{**HF_CONFIG_DEFAULTS[model_type], **raw})


def read_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The weights of an HF directory: ``model.safetensors`` where present
    (``from_pretrained`` prefers it), else ``pytorch_model.bin``."""
    st, pt = os.path.join(path, SAFETENSORS_FILE), os.path.join(path, BIN_FILE)
    if os.path.exists(st):
        return read_safetensors(st)
    if os.path.exists(pt):
        return torch.load(pt, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{path}: neither {SAFETENSORS_FILE} nor {BIN_FILE} (sharded "
                            "checkpoints are not read)")


def split_task_heads(sd: Dict, prefix: str) -> Tuple[Dict, Dict]:
    """(the trunk's state dict without its prefix, {name: Dense params} of
    the top-level Linear heads beside it, as ``hf_export`` writes a task
    model's). A bare trunk (no prefix) has no heads."""
    if prefix + "embeddings.word_embeddings.weight" not in sd:
        prefix = ""
    if "embeddings.word_embeddings.weight" not in sd and not prefix:
        raise ValueError("no trunk weights (embeddings.word_embeddings.weight) found")
    trunk = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    heads = {}
    if prefix:
        for key in sd:
            name, _, leaf = key.rpartition(".")
            if leaf == "weight" and not key.startswith(prefix) and "." not in name \
                    and name + ".bias" in sd and sd[key].ndim == 2:
                heads[name] = {"kernel": sd[key].T.copy(), "bias": sd[name + ".bias"]}
    return trunk, heads


def load_hf_checkpoint(path: str) -> Tuple[EncoderConfig, Dict]:
    """(encoder config, parameter tree) of an HF directory of type bert,
    longformer, electra or big_bird: the trunk's tree, or with task heads
    beside it ``{"encoder": trunk, head: {"kernel", "bias"}, ...}``."""
    hf_cfg = read_hf_config(path)
    sd = hf_convert.torch_state_dict_to_numpy(read_hf_state_dict(path))
    sd, heads = split_task_heads(sd, TRUNK_PREFIX[hf_cfg.model_type])
    if hf_cfg.model_type == "longformer":
        cfg = hf_convert.hf_longformer_config_to_encoder_config(hf_cfg)
        params = hf_convert.longformer_to_encoder_params(sd, cfg)
    elif hf_cfg.model_type == "electra":
        cfg = hf_convert.hf_electra_config_to_encoder_config(hf_cfg)
        params = hf_convert.electra_to_encoder_params(sd, cfg)
    else:
        cfg = hf_convert.hf_bert_config_to_encoder_config(hf_cfg)
        if hf_cfg.model_type == "big_bird":
            # HF BigBird keeps BERT's layout; block-sparse attention is an
            # attention_type of the trunk
            cfg = dataclasses.replace(cfg, attention_type="bigbird",
                                      bigbird_block_size=hf_cfg.block_size,
                                      bigbird_num_random_blocks=hf_cfg.num_random_blocks)
        params = hf_convert.bert_to_encoder_params(sd, cfg)
    if cfg.add_pooler and "pooler" not in params:
        # no pooler.dense (HF BigBird's is a bare Linear; the topic-seg head
        # reads none)
        cfg = dataclasses.replace(cfg, add_pooler=False)
    if heads:
        params = {"encoder": params, **heads}
    return cfg, params
