"""Convert HuggingFace torch checkpoints into the trunk's parameter tree.

The port's own copy of ``spokennlp_tpu/models/hf_convert.py`` (numpy only;
the same functions and trees): an HF state dict is repacked into the
Flax-named layout the port's modules carry (fused QKV kernels of shape
(H, 3, num_heads, head_dim), (in, out) kernels, LayerNorm scale/bias), which
``models/convert.py`` flattens into a ``state_dict``.

All functions operate on a ``{name: np.ndarray}`` state dict.
``torch_state_dict_to_numpy`` widens half-precision tensors to float32
(numpy has no bfloat16), where the JAX package's copy would fail on them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from spokennlp_tpu_torch.configs import EncoderConfig


def torch_state_dict_to_numpy(state_dict) -> Dict[str, np.ndarray]:
    # .copy(): torch .numpy() returns a VIEW of the tensor storage, and
    # torch optimizers update in place — without the copy, converted params
    # silently track any further training of the source model
    def to_numpy(v):
        v = v.detach().cpu()
        if v.is_floating_point() and v.itemsize < 4:
            v = v.float()
        return v.numpy().copy()

    return {k: to_numpy(v) for k, v in state_dict.items()}


def _linear(sd: Dict[str, np.ndarray], prefix: str):
    """torch Linear -> flax Dense: kernel (in, out), bias (out,)."""
    return {
        "kernel": np.ascontiguousarray(sd[prefix + ".weight"].T),
        "bias": sd[prefix + ".bias"],
    }


def _layernorm(sd: Dict[str, np.ndarray], prefix: str):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def bert_to_encoder_params(
    sd: Dict[str, np.ndarray],
    cfg: EncoderConfig,
    prefix: str = "",
) -> Dict:
    """Map an HF ``BertModel`` state dict onto the Encoder param tree.

    ``prefix`` handles nesting, e.g. "bert." for BertForTokenClassification.
    Works for any BERT-architecture checkpoint (BERT, StructBERT, Chinese
    variants) since they share the module layout.
    """
    H, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    p = prefix

    params: Dict = {
        "embeddings": {
            "word_embeddings": {"embedding": sd[p + "embeddings.word_embeddings.weight"]},
            "position_embeddings": {
                "embedding": sd[p + "embeddings.position_embeddings.weight"]
            },
            "token_type_embeddings": {
                "embedding": sd[p + "embeddings.token_type_embeddings.weight"]
            },
            "LayerNorm": _layernorm(sd, p + "embeddings.LayerNorm"),
        }
    }

    for i in range(cfg.num_layers):
        lp = f"{p}encoder.layer.{i}."
        q_k = sd[lp + "attention.self.query.weight"].T.reshape(H, nh, hd)
        k_k = sd[lp + "attention.self.key.weight"].T.reshape(H, nh, hd)
        v_k = sd[lp + "attention.self.value.weight"].T.reshape(H, nh, hd)
        qkv_kernel = np.stack([q_k, k_k, v_k], axis=1)  # (H, 3, nh, hd)
        q_b = sd[lp + "attention.self.query.bias"].reshape(nh, hd)
        k_b = sd[lp + "attention.self.key.bias"].reshape(nh, hd)
        v_b = sd[lp + "attention.self.value.bias"].reshape(nh, hd)
        qkv_bias = np.stack([q_b, k_b, v_b], axis=0)  # (3, nh, hd)

        out_kernel = sd[lp + "attention.output.dense.weight"].T.reshape(nh, hd, H)

        attention = {
            "qkv": {"kernel": qkv_kernel, "bias": qkv_bias},
            "out": {
                "kernel": out_kernel,
                "bias": sd[lp + "attention.output.dense.bias"],
            },
        }
        # Longformer global-attention projections (query_global/key_global/
        # value_global) pack the same way into a fused qkv_global.
        if (lp + "attention.self.query_global.weight") in sd:
            qg = sd[lp + "attention.self.query_global.weight"].T.reshape(H, nh, hd)
            kg = sd[lp + "attention.self.key_global.weight"].T.reshape(H, nh, hd)
            vg = sd[lp + "attention.self.value_global.weight"].T.reshape(H, nh, hd)
            qgb = sd[lp + "attention.self.query_global.bias"].reshape(nh, hd)
            kgb = sd[lp + "attention.self.key_global.bias"].reshape(nh, hd)
            vgb = sd[lp + "attention.self.value_global.bias"].reshape(nh, hd)
            attention["qkv_global"] = {
                "kernel": np.stack([qg, kg, vg], axis=1),
                "bias": np.stack([qgb, kgb, vgb], axis=0),
            }

        params[f"layer_{i}"] = {
            "attention": attention,
            "attention_ln": _layernorm(sd, lp + "attention.output.LayerNorm"),
            "mlp_in": _linear(sd, lp + "intermediate.dense"),
            "mlp_out": _linear(sd, lp + "output.dense"),
            "mlp_ln": _layernorm(sd, lp + "output.LayerNorm"),
        }

    if cfg.add_pooler and (p + "pooler.dense.weight") in sd:
        params["pooler"] = _linear(sd, p + "pooler.dense")

    return params


def bert_pretraining_to_params(sd: Dict[str, np.ndarray], cfg: EncoderConfig) -> Dict:
    """Map an HF ``BertForPreTraining`` state dict onto objectives/mlm.py's
    ``BertForPreTraining`` param tree (trunk + MLM transform/LN/tied-decoder
    bias + NSP head). The MLM decoder weight is tied to the word embeddings
    on both sides, so only its bias transfers. Reference counterpart: the
    vendored TF pretraining heads (action-item-detection/script/
    run_pretraining.py get_masked_lm_output/get_next_sentence_output).
    """
    params: Dict = {"encoder": bert_to_encoder_params(sd, cfg, prefix="bert.")}
    params["mlm_transform"] = _linear(sd, "cls.predictions.transform.dense")
    params["mlm_ln"] = _layernorm(sd, "cls.predictions.transform.LayerNorm")
    params["mlm_output_bias"] = sd["cls.predictions.bias"]
    params["nsp_classifier"] = _linear(sd, "cls.seq_relationship")
    return params


def electra_to_encoder_params(
    sd: Dict[str, np.ndarray], cfg: EncoderConfig, prefix: str = ""
) -> Dict:
    """HF ElectraModel: BERT layout + optional embeddings_project, no pooler."""
    params = bert_to_encoder_params(sd, cfg, prefix)
    key = prefix + "embeddings_project.weight"
    if key in sd:
        params["embeddings"]["embeddings_project"] = _linear(
            sd, prefix + "embeddings_project"
        )
    return params


def hf_electra_config_to_encoder_config(hf_config, **overrides) -> EncoderConfig:
    kwargs = dict(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        embedding_size=hf_config.embedding_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        hidden_dropout=hf_config.hidden_dropout_prob,
        attention_dropout=hf_config.attention_probs_dropout_prob,
        hidden_act=hf_config.hidden_act,
        pad_token_id=hf_config.pad_token_id or 0,
        add_pooler=False,
    )
    kwargs.update(overrides)
    return EncoderConfig(**kwargs)


def longformer_to_encoder_params(
    sd: Dict[str, np.ndarray], cfg: EncoderConfig, prefix: str = ""
) -> Dict:
    """HF LongformerModel shares BERT's module layout plus *_global projections."""
    return bert_to_encoder_params(sd, cfg, prefix)


def hf_longformer_config_to_encoder_config(hf_config, **overrides) -> EncoderConfig:
    """Translate a transformers LongformerConfig.

    HF allows per-layer windows; the trunk uses one window (the max). HF's
    ``attention_window`` is the TOTAL window (one-sided = window // 2), same
    convention as ops/sliding_attention.py.
    """
    window = hf_config.attention_window
    if isinstance(window, (list, tuple)):
        window = max(window)
    kwargs = dict(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        hidden_dropout=hf_config.hidden_dropout_prob,
        attention_dropout=hf_config.attention_probs_dropout_prob,
        hidden_act=hf_config.hidden_act,
        pad_token_id=1 if hf_config.pad_token_id is None else hf_config.pad_token_id,
        attention_type="sliding_window",
        attention_window=window,
        position_style="roberta",
    )
    kwargs.update(overrides)
    return EncoderConfig(**kwargs)


def extend_position_embeddings(
    params: Dict, new_max: int, num_special: int = 0
) -> Dict:
    """Tile a pretrained position-embedding table out to ``new_max`` rows.

    The reference extends PoNet positions to 4096 by repeating the pretrained
    table (alimeeting4mug/src/topic_segment/ponet_topic_segmentation.py:
    466-482) and bumps config max for long inputs (ts_sentence_seq_labeling.
    py:295-307). ``num_special`` rows at the front (RoBERTa pad/offset rows)
    are kept fixed and excluded from the tile period.
    """
    import copy

    params = copy.deepcopy(params)
    table = np.asarray(params["embeddings"]["position_embeddings"]["embedding"])
    old_max, H = table.shape
    if new_max <= old_max:
        return params
    period = old_max - num_special
    reps = -(-(new_max - num_special) // period)
    body = np.tile(table[num_special:], (reps, 1))[: new_max - num_special]
    new_table = np.concatenate([table[:num_special], body], axis=0)
    params["embeddings"]["position_embeddings"]["embedding"] = new_table
    return params


def ponet_to_encoder_params(
    sd: Dict[str, np.ndarray], cfg: EncoderConfig, prefix: str = "ponet."
) -> Dict:
    """Map a ModelScope/official PoNet state dict onto the PoNetEncoder tree.

    The reference loads PoNet from ModelScope (alimeeting4mug/src/models/
    modeling_ponet.py:28,41 — ``self.ponet = PoNetModel(config)``; the
    implementation itself is NOT in the reference repo). The official PoNet
    code keeps BERT's module layout with the attention replaced by five
    projections::

        {prefix}embeddings.{word,position,token_type}_embeddings.weight
        {prefix}embeddings.LayerNorm.{weight,bias}
        {prefix}encoder.layer.N.attention.self.dense_q.{weight,bias}   -> mixer q
        {prefix}encoder.layer.N.attention.self.dense_k.{weight,bias}   -> mixer k
        {prefix}encoder.layer.N.attention.self.dense_o.{weight,bias}   -> mixer v
                                                       (GA's value projection)
        {prefix}encoder.layer.N.attention.self.dense_segment.*         -> mixer s
        {prefix}encoder.layer.N.attention.self.dense_local.*           -> mixer l
        {prefix}encoder.layer.N.attention.output.dense.*               -> mixer out
        {prefix}encoder.layer.N.attention.output.LayerNorm.*           -> mixer_ln
        {prefix}encoder.layer.N.intermediate.dense.*                   -> mlp_in
        {prefix}encoder.layer.N.output.dense.*                         -> mlp_out
        {prefix}encoder.layer.N.output.LayerNorm.*                     -> mlp_ln
        {prefix}pooler.dense.*                                         -> pooler

    Pair with ``dataclasses.replace(cfg, ponet_ga_per_head=True)`` — the
    official GA runs per attention head. Verified structurally (mapping +
    transposes) against a torch re-implementation of this layout in
    tests/test_ponet_convert.py; remaining semantic ambiguities are
    documented in models/ponet.py.
    """
    p = prefix
    params: Dict = {
        "embeddings": {
            "word_embeddings": {
                "embedding": sd[p + "embeddings.word_embeddings.weight"]
            },
            "position_embeddings": {
                "embedding": sd[p + "embeddings.position_embeddings.weight"]
            },
            "token_type_embeddings": {
                "embedding": sd[p + "embeddings.token_type_embeddings.weight"]
            },
            "LayerNorm": _layernorm(sd, p + "embeddings.LayerNorm"),
        }
    }
    mixer_map = {
        "q": "dense_q",
        "k": "dense_k",
        "v": "dense_o",
        "s": "dense_segment",
        "l": "dense_local",
    }
    for i in range(cfg.num_layers):
        lp = f"{p}encoder.layer.{i}."
        mixer = {
            ours: _linear(sd, lp + "attention.self." + theirs)
            for ours, theirs in mixer_map.items()
        }
        mixer["out"] = _linear(sd, lp + "attention.output.dense")
        params[f"layer_{i}"] = {
            "mixer": mixer,
            "mixer_ln": _layernorm(sd, lp + "attention.output.LayerNorm"),
            "mlp_in": _linear(sd, lp + "intermediate.dense"),
            "mlp_out": _linear(sd, lp + "output.dense"),
            "mlp_ln": _layernorm(sd, lp + "output.LayerNorm"),
        }
    if cfg.add_pooler and (p + "pooler.dense.weight") in sd:
        params["pooler"] = _linear(sd, p + "pooler.dense")
    return params


def ponet_config_to_encoder_config(hf_config, **overrides) -> EncoderConfig:
    """Translate a (ModelScope) PoNet config object / dict.

    Accepts anything exposing BERT-style config attrs (the ModelScope PoNet
    config keeps them: modeling_ponet.py:34-119 operates on config.hidden_size
    / num_labels etc.)."""
    get = (
        hf_config.get
        if isinstance(hf_config, dict)
        else lambda k, d=None: getattr(hf_config, k, d)
    )
    kwargs = dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=get("num_attention_heads"),
        intermediate_size=get("intermediate_size"),
        max_position_embeddings=get("max_position_embeddings"),
        type_vocab_size=get("type_vocab_size", 2),
        layer_norm_eps=get("layer_norm_eps", 1e-12),
        hidden_dropout=get("hidden_dropout_prob", 0.1),
        attention_dropout=get("attention_probs_dropout_prob", 0.1),
        hidden_act=get("hidden_act", "gelu"),
        pad_token_id=get("pad_token_id", 0) or 0,
        attention_type="ponet",
        ponet_ga_per_head=True,
        ponet_local_window=get("local_window_size", 3) or 3,
    )
    kwargs.update(overrides)
    return EncoderConfig(**kwargs)


def palm_to_params(
    sd: Dict[str, np.ndarray],
    enc_cfg: EncoderConfig,
    num_decoder_layers: int,
    prefix: str = "palm.",
) -> Dict:
    """Map a ModelScope palm_v2 state dict onto the PalmModel param tree.

    Layout (the public PreSumm/OpenNMT stack the ModelScope port keeps; see
    models/palm.py docstring for the offline caveat):

        {prefix}encoder.*                              BertModel names
        {prefix}decoder.embeddings.weight              target embeddings
        {prefix}decoder.transformer_layers.N.
            self_attn.{linear_query,linear_keys,linear_values,final_linear}
            context_attn.{...same four...}
            layer_norm_1 / layer_norm_2
            feed_forward.{w_1,w_2,layer_norm}
        {prefix}decoder.layer_norm                     final decoder LN
        generator.linear / generator.linear_copy       CopyGenerator
        (plain generator fallback: generator.0.weight  nn.Sequential form)
    """
    p = prefix
    params: Dict = {
        "encoder": bert_to_encoder_params(sd, enc_cfg, p + "encoder."),
        "dec_embed": {"embedding": sd[p + "decoder.embeddings.weight"]},
        "decoder_ln": _layernorm(sd, p + "decoder.layer_norm"),
    }
    for i in range(num_decoder_layers):
        lp = f"{p}decoder.transformer_layers.{i}."
        layer = {}
        for attn in ("self_attn", "context_attn"):
            for theirs, ours in (
                ("linear_query", "query"),
                ("linear_keys", "keys"),
                ("linear_values", "values"),
                ("final_linear", "final"),
            ):
                layer[f"{attn}_{ours}"] = _linear(sd, lp + f"{attn}.{theirs}")
        layer["layer_norm_1"] = _layernorm(sd, lp + "layer_norm_1")
        layer["layer_norm_2"] = _layernorm(sd, lp + "layer_norm_2")
        layer["ff_layer_norm"] = _layernorm(sd, lp + "feed_forward.layer_norm")
        layer["w_1"] = _linear(sd, lp + "feed_forward.w_1")
        layer["w_2"] = _linear(sd, lp + "feed_forward.w_2")
        params[f"decoder_layer_{i}"] = layer
    if "generator.linear.weight" in sd:  # CopyGenerator
        params["generator"] = _linear(sd, "generator.linear")
        params["linear_copy"] = _linear(sd, "generator.linear_copy")
    elif "generator.0.weight" in sd:  # plain nn.Sequential(Linear, LogSoftmax)
        params["generator"] = _linear(sd, "generator.0")
    return params


def hf_bert_config_to_encoder_config(hf_config, **overrides) -> EncoderConfig:
    """Translate a transformers BertConfig into an EncoderConfig."""
    kwargs = dict(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        hidden_dropout=hf_config.hidden_dropout_prob,
        attention_dropout=hf_config.attention_probs_dropout_prob,
        hidden_act=hf_config.hidden_act,
        pad_token_id=hf_config.pad_token_id or 0,
    )
    kwargs.update(overrides)
    return EncoderConfig(**kwargs)
