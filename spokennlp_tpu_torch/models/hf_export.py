"""Export the trunk's parameter tree as HF/ModelScope checkpoint directories.

The port's own copy of ``spokennlp_tpu/models/hf_export.py`` (the same
functions and files): the inverse of ``models/hf_convert.py``. It un-fuses
the (H, 3, nh, hd) QKV kernels into torch ``query/key/value`` Linears, flips
(in, out) kernels to torch's (out, in), and writes ``pytorch_model.bin`` and
``config.json``, the ``save_pretrained`` format that
``transformers.*.from_pretrained`` (and so ModelScope's HF-format loaders)
reads with no missing or unexpected keys. The reference saves every
fine-tuned model so (alimeeting4mug/src/models/trainer.py:33-60).

The mapping functions take nested dicts of numpy arrays
(``models/checkpoint_io.params_from_state_dict`` turns a ``state_dict`` into
one).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from spokennlp_tpu_torch.configs import EncoderConfig

TOKENIZER_FILES = (
    "vocab.txt",
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "merges.txt",
    "vocab.json",
    "sentencepiece.bpe.model",
)


def _np(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _put_linear(sd: Dict[str, np.ndarray], prefix: str, mod: Dict) -> None:
    """flax Dense {kernel (in,out), bias} -> torch Linear weight (out,in)/bias."""
    sd[prefix + ".weight"] = _np(mod["kernel"]).T.copy()
    sd[prefix + ".bias"] = _np(mod["bias"])


def _put_layernorm(sd: Dict[str, np.ndarray], prefix: str, mod: Dict) -> None:
    sd[prefix + ".weight"] = _np(mod["scale"])
    sd[prefix + ".bias"] = _np(mod["bias"])


def _put_qkv(
    sd: Dict[str, np.ndarray], lp: str, fused: Dict, cfg: EncoderConfig, suffix: str = ""
) -> None:
    """Un-fuse a (H, 3, nh, hd) QKV kernel / (3, nh, hd) bias into torch
    ``query/key/value{suffix}`` Linears (inverse of hf_convert.py:67-74)."""
    H = cfg.hidden_size
    kernel = _np(fused["kernel"])  # (H, 3, nh, hd)
    bias = _np(fused["bias"])  # (3, nh, hd)
    for j, name in enumerate(("query", "key", "value")):
        w = kernel[:, j].reshape(H, cfg.num_heads * cfg.head_dim)
        sd[f"{lp}attention.self.{name}{suffix}.weight"] = w.T.copy()
        sd[f"{lp}attention.self.{name}{suffix}.bias"] = bias[j].reshape(-1).copy()


def encoder_params_to_bert_sd(
    params: Dict, cfg: EncoderConfig, prefix: str = "bert."
) -> Dict[str, np.ndarray]:
    """Inverse of hf_convert.bert_to_encoder_params (BERT/StructBERT/ELECTRA/
    Longformer/BigBird all share this module layout; Longformer's fused
    qkv_global unpacks to ``*_global`` projections)."""
    p = prefix
    emb = params["embeddings"]
    sd: Dict[str, np.ndarray] = {
        p + "embeddings.word_embeddings.weight": _np(emb["word_embeddings"]["embedding"]),
        p + "embeddings.position_embeddings.weight": _np(
            emb["position_embeddings"]["embedding"]
        ),
        p + "embeddings.token_type_embeddings.weight": _np(
            emb["token_type_embeddings"]["embedding"]
        ),
    }
    _put_layernorm(sd, p + "embeddings.LayerNorm", emb["LayerNorm"])
    if "embeddings_project" in emb:  # ELECTRA small/base embedding factorization
        _put_linear(sd, p + "embeddings_project", emb["embeddings_project"])

    H = cfg.hidden_size
    for i in range(cfg.num_layers):
        lp = f"{p}encoder.layer.{i}."
        layer = params[f"layer_{i}"]
        attn = layer["attention"]
        _put_qkv(sd, lp, attn["qkv"], cfg)
        if "qkv_global" in attn:
            _put_qkv(sd, lp, attn["qkv_global"], cfg, suffix="_global")
        out_kernel = _np(attn["out"]["kernel"]).reshape(
            cfg.num_heads * cfg.head_dim, H
        )
        sd[lp + "attention.output.dense.weight"] = out_kernel.T.copy()
        sd[lp + "attention.output.dense.bias"] = _np(attn["out"]["bias"])
        _put_layernorm(sd, lp + "attention.output.LayerNorm", layer["attention_ln"])
        _put_linear(sd, lp + "intermediate.dense", layer["mlp_in"])
        _put_linear(sd, lp + "output.dense", layer["mlp_out"])
        _put_layernorm(sd, lp + "output.LayerNorm", layer["mlp_ln"])

    if "pooler" in params:
        _put_linear(sd, p + "pooler.dense", params["pooler"])
    return sd


def encoder_params_to_ponet_sd(
    params: Dict, cfg: EncoderConfig, prefix: str = "ponet."
) -> Dict[str, np.ndarray]:
    """Inverse of hf_convert.ponet_to_encoder_params — the ModelScope PoNet
    layout (five mixer projections replacing attention.self)."""
    p = prefix
    emb = params["embeddings"]
    sd: Dict[str, np.ndarray] = {
        p + "embeddings.word_embeddings.weight": _np(emb["word_embeddings"]["embedding"]),
        p + "embeddings.position_embeddings.weight": _np(
            emb["position_embeddings"]["embedding"]
        ),
        p + "embeddings.token_type_embeddings.weight": _np(
            emb["token_type_embeddings"]["embedding"]
        ),
    }
    _put_layernorm(sd, p + "embeddings.LayerNorm", emb["LayerNorm"])
    mixer_map = {
        "q": "dense_q",
        "k": "dense_k",
        "v": "dense_o",
        "s": "dense_segment",
        "l": "dense_local",
    }
    for i in range(cfg.num_layers):
        lp = f"{p}encoder.layer.{i}."
        layer = params[f"layer_{i}"]
        for ours, theirs in mixer_map.items():
            _put_linear(sd, lp + "attention.self." + theirs, layer["mixer"][ours])
        _put_linear(sd, lp + "attention.output.dense", layer["mixer"]["out"])
        _put_layernorm(sd, lp + "attention.output.LayerNorm", layer["mixer_ln"])
        _put_linear(sd, lp + "intermediate.dense", layer["mlp_in"])
        _put_linear(sd, lp + "output.dense", layer["mlp_out"])
        _put_layernorm(sd, lp + "output.LayerNorm", layer["mlp_ln"])
    if "pooler" in params:
        _put_linear(sd, p + "pooler.dense", params["pooler"])
    return sd


def palm_params_to_sd(
    params: Dict, enc_cfg: EncoderConfig, prefix: str = "palm."
) -> Dict[str, np.ndarray]:
    """Inverse of hf_convert.palm_to_params — the ModelScope palm_v2 /
    PreSumm layout (MUG Track 3 baseline checkpoints)."""
    p = prefix
    sd = encoder_params_to_bert_sd(params["encoder"], enc_cfg, prefix=p + "encoder.")
    sd[p + "decoder.embeddings.weight"] = _np(params["dec_embed"]["embedding"])
    _put_layernorm(sd, p + "decoder.layer_norm", params["decoder_ln"])
    n_dec = sum(1 for k in params if str(k).startswith("decoder_layer_"))
    for i in range(n_dec):
        layer = params[f"decoder_layer_{i}"]
        lp = f"{p}decoder.transformer_layers.{i}."
        for attn in ("self_attn", "context_attn"):
            for theirs, ours in (
                ("linear_query", "query"),
                ("linear_keys", "keys"),
                ("linear_values", "values"),
                ("final_linear", "final"),
            ):
                _put_linear(sd, lp + f"{attn}.{theirs}", layer[f"{attn}_{ours}"])
        _put_layernorm(sd, lp + "layer_norm_1", layer["layer_norm_1"])
        _put_layernorm(sd, lp + "layer_norm_2", layer["layer_norm_2"])
        _put_layernorm(sd, lp + "feed_forward.layer_norm", layer["ff_layer_norm"])
        _put_linear(sd, lp + "feed_forward.w_1", layer["w_1"])
        _put_linear(sd, lp + "feed_forward.w_2", layer["w_2"])
    if "linear_copy" in params:  # CopyGenerator form
        _put_linear(sd, "generator.linear", params["generator"])
        _put_linear(sd, "generator.linear_copy", params["linear_copy"])
    else:  # plain nn.Sequential(Linear, LogSoftmax)
        _put_linear(sd, "generator.0", params["generator"])
    return sd


_MODEL_TYPE_BY_ATTENTION = {
    "dense": "bert",
    "sliding_window": "longformer",
    "bigbird": "big_bird",
    "ponet": "ponet",
}


def encoder_config_to_hf_dict(
    cfg: EncoderConfig,
    model_type: Optional[str] = None,
    architectures: Optional[list] = None,
    **extra,
) -> Dict:
    """Inverse of the hf_*_config_to_encoder_config translators: an HF-format
    config.json dict ``transformers.AutoConfig`` can re-read."""
    model_type = model_type or _MODEL_TYPE_BY_ATTENTION.get(
        cfg.attention_type, "bert"
    )
    d: Dict = {
        "model_type": model_type,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "type_vocab_size": cfg.type_vocab_size,
        "layer_norm_eps": cfg.layer_norm_eps,
        "hidden_dropout_prob": cfg.hidden_dropout,
        "attention_probs_dropout_prob": cfg.attention_dropout,
        "hidden_act": cfg.hidden_act,
        "pad_token_id": cfg.pad_token_id,
        "initializer_range": 0.02,
    }
    if getattr(cfg, "embedding_size", None) and cfg.embedding_size != cfg.hidden_size:
        d["embedding_size"] = cfg.embedding_size
    if model_type == "longformer":
        d["attention_window"] = [cfg.attention_window] * cfg.num_layers
    if model_type == "big_bird":
        d["block_size"] = cfg.bigbird_block_size
        d["num_random_blocks"] = cfg.bigbird_num_random_blocks
        d["attention_type"] = "block_sparse"
    if model_type == "ponet":
        d["local_window_size"] = cfg.ponet_local_window
    if architectures:
        d["architectures"] = list(architectures)
    d.update(extra)
    return d


_TRUNK_PREFIX_BY_MODEL_TYPE = {
    "bert": "bert.",
    "electra": "electra.",
    "longformer": "longformer.",
    "big_bird": "bert.",  # HF BigBird keeps BERT naming under `bert.`
    "ponet": "ponet.",
}


def task_params_to_sd(
    params: Dict, cfg: EncoderConfig, model_type: Optional[str] = None
) -> Dict[str, np.ndarray]:
    """Full task-model tree (encoder + Dense heads) -> torch state dict.

    Top-level Flax Dense scopes (classifier, tssp_classifier, ...) become
    torch Linears under the same name — the layout the reference's task
    models produce (bert_for_ts.py: self.bert + self.classifier)."""
    model_type = model_type or _MODEL_TYPE_BY_ATTENTION.get(cfg.attention_type, "bert")
    prefix = _TRUNK_PREFIX_BY_MODEL_TYPE.get(model_type, "bert.")
    trunk = params["encoder"] if "encoder" in params else params
    if model_type == "ponet":
        sd = encoder_params_to_ponet_sd(trunk, cfg, prefix=prefix)
    else:
        sd = encoder_params_to_bert_sd(trunk, cfg, prefix=prefix)
    if "encoder" in params:
        for name, mod in params.items():
            if name == "encoder":
                continue
            if isinstance(mod, dict) and set(mod) == {"kernel", "bias"}:
                _put_linear(sd, name, mod)
    return sd


def save_hf_checkpoint(
    out_dir: str,
    params: Dict,
    cfg: EncoderConfig,
    model_type: Optional[str] = None,
    architectures: Optional[list] = None,
    tokenizer_src: Optional[str] = None,
    config_extra: Optional[Dict] = None,
) -> str:
    """Write a ModelScope/HF-consumable checkpoint dir.

    ``pytorch_model.bin`` (torch state dict) + ``config.json`` (+ tokenizer
    files copied from ``tokenizer_src``) — the save_pretrained format of
    alimeeting4mug/src/models/trainer.py:33-60. Accepts either a bare trunk
    tree or a full task tree (heads exported as top-level Linears).
    """
    os.makedirs(out_dir, exist_ok=True)
    sd = task_params_to_sd(params, cfg, model_type=model_type)
    torch_sd = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    torch.save(torch_sd, os.path.join(out_dir, "pytorch_model.bin"))
    hf_cfg = encoder_config_to_hf_dict(
        cfg, model_type=model_type, architectures=architectures, **(config_extra or {})
    )
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2, sort_keys=True)
    if tokenizer_src and os.path.isdir(tokenizer_src):
        for name in TOKENIZER_FILES:
            src = os.path.join(tokenizer_src, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out_dir, name))
    return out_dir
