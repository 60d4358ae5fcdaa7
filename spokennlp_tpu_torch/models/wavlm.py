"""WavLM (and HuBERT) encoder: speech feature extraction for SLD, on
PyTorch.

Counterpart of ``spokennlp_tpu/models/wavlm.py`` (the reference dumps
layer-23 features of WavLM-Large, sld/fairseq/examples/hubert/simple_kmeans/
dump_wavlm_feature.py:38-112), weight-compatible with HF
``transformers.WavLMModel`` / ``HubertModel`` checkpoints:

- the conv waveform feature extractor: group norm after conv 0 for the
  "group" variant, a LayerNorm after every conv for "layer"; exact GELU;
- feature projection (LayerNorm -> Linear);
- the grouped positional conv embedding (weight norm folded into a plain
  kernel at conversion; k // 2 padding each side, one frame trimmed for an
  even kernel);
- the transformer encoder with WavLM's gated relative position bias: layer
  0 owns the bucketed table (``relative_position_buckets``) and computes
  the (nh, L, L) bias once; every layer gates it from its own attention
  input; post-LN ("base") and stable pre-LN ("large") layers;
- ``use_rel_pos_bias=False`` is HuBERT: the same stack with plain attention.

Parameter names follow the Flax tree, so a JAX tree loads with
``load_state_dict(jax_params_to_state_dict(tree), strict=True)``: dense
kernels (in, out), ``q_proj`` etc. (H, nh, hd), ``out_proj`` (nh, hd, H).
The convolutions keep ``torch.nn.Conv1d``'s layout, (out, in / groups, k),
where Flax's NWC kernels are (k, in / groups, out); models/convert.py
transposes those two kernels (``conv_{i}`` under ``feature_extractor``, and
``pos_conv``). The products stay ``torch.matmul`` and ``conv1d``: the JAX
model runs no TPU kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spokennlp_tpu_torch.models.encoder import LayerNorm


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # "group" (base) | "layer" (large)
    do_stable_layer_norm: bool = False  # True for WavLM-Large
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5
    # False = HuBERT: identical stack minus the gated relative-position bias
    # (reference alternative dumper: simple_kmeans/dump_hubert_feature.py)
    use_rel_pos_bias: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@functools.lru_cache(maxsize=8)
def relative_position_buckets(
    seq_len: int, num_buckets: int, max_distance: int
) -> np.ndarray:
    """(L, L) int bucket ids, WavLM's bidirectional T5-style bucketing
    (HF WavLMAttention._relative_positions_bucket semantics)."""
    ctx = np.arange(seq_len)[:, None]
    mem = np.arange(seq_len)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
    large = large / math.log(max_distance / max_exact) * (nb - max_exact)
    large = (max_exact + large).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(is_small, rel, large)


def _randn(shape, std: float, generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


class _Dense(nn.Module):
    """Flax dense: ``kernel`` (in..., out...) drawn normal(1 / sqrt(fan_in)),
    ``bias`` zeros (fresh weights serve tests and random-weight runs;
    checkpoints overwrite them)."""

    def __init__(self, kernel_shape, bias_shape, fan_in: int, generator=None):
        super().__init__()
        self.kernel = _randn(kernel_shape, 1.0 / math.sqrt(fan_in), generator)
        self.bias = nn.Parameter(torch.zeros(bias_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class _Conv(nn.Module):
    """A convolution in ``Conv1d``'s layout: ``kernel`` (out, in / groups,
    k), ``bias`` (out,) when ``bias``."""

    def __init__(self, cin: int, cout: int, k: int, groups: int = 1, bias: bool = True,
                 generator=None):
        super().__init__()
        self.kernel = _randn((cout, cin // groups, k), 1.0 / math.sqrt(cin // groups * k),
                             generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


class _FeatureEncoder(nn.Module):
    """Raw waveform (B, T) -> (B, frames, conv_dim[-1])."""

    def __init__(self, cfg: WavLMConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        cin = 1
        for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
            self.add_module(f"conv_{i}",
                            _Conv(cin, dim, k, bias=cfg.conv_bias, generator=generator))
            if cfg.feat_extract_norm == "group" and i == 0:
                self.group_norm = LayerNorm(dim, 1e-5)  # its scale and bias, in F.group_norm
            elif cfg.feat_extract_norm == "layer":
                self.add_module(f"conv_ln_{i}", LayerNorm(dim, 1e-5))
            cin = dim

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = waveform[:, None, :]  # (B, 1, T)
        for i, (dim, s) in enumerate(zip(c.conv_dim, c.conv_stride)):
            conv = getattr(self, f"conv_{i}")
            x = F.conv1d(x, conv.kernel, conv.bias, stride=s)
            if c.feat_extract_norm == "group" and i == 0:
                # one group a channel: each channel normalised over time
                gn = self.group_norm
                x = F.group_norm(x, dim, gn.scale, gn.bias, eps=1e-5)
            elif c.feat_extract_norm == "layer":
                x = getattr(self, f"conv_ln_{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = F.gelu(x, approximate="none")
        return x.transpose(1, 2)


class _GatedRelPosAttention(nn.Module):
    """Self-attention with WavLM's gated relative position bias."""

    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool, generator=None):
        super().__init__()
        self.cfg = cfg
        H, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        for name in ("q_proj", "k_proj", "v_proj"):
            self.add_module(name, _Dense((H, nh, hd), (nh, hd), H, generator))
        self.out_proj = _Dense((nh, hd, H), (H,), H, generator)
        if cfg.use_rel_pos_bias:
            self.gru_rel_pos_linear = _Dense((hd, 8), (8,), hd, generator)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, nh, 1, 1))
            if has_relative_position_bias:
                self.rel_attn_embed = _randn((cfg.num_buckets, nh), 0.02, generator)

    def forward(self, x, position_bias, attention_mask=None):
        c = self.cfg
        B, L, H = x.shape
        nh, hd = c.num_heads, c.head_dim
        gated_bias = None
        if c.use_rel_pos_bias:
            if position_bias is None:  # layer 0: the (nh, L, L) table lookup
                buckets = torch.from_numpy(relative_position_buckets(
                    L, c.num_buckets, c.max_bucket_distance)).to(x.device)
                position_bias = self.rel_attn_embed.float()[buckets].permute(2, 0, 1)
            # per-layer gate from the attention INPUT viewed per head (HF
            # WavLMAttention.forward steps 1-4)
            ghs = x.reshape(B, L, nh, hd).permute(0, 2, 1, 3)  # (B, nh, L, hd)
            proj = self.gru_rel_pos_linear(ghs).reshape(B, nh, L, 2, 4).sum(-1)
            gates = torch.sigmoid(proj.float())
            gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]  # (B, nh, L, 1)
            gate = gate_a * (gate_b * self.gru_rel_pos_const.float() - 1.0) + 2.0
            gated_bias = gate * position_bias[None]  # (B, nh, L, L)

        def heads(name):
            proj = getattr(self, name)
            return torch.einsum("blh,hnd->blnd", x, proj.kernel) + proj.bias

        q, k, v = heads("q_proj"), heads("k_proj"), heads("v_proj")
        scores = torch.einsum("blnd,bmnd->bnlm", q * (1.0 / math.sqrt(hd)), k).float()
        if gated_bias is not None:
            scores = scores + gated_bias
        if attention_mask is not None:
            scores = scores + (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        probs = F.softmax(scores, -1).to(x.dtype)
        ctx = torch.einsum("bnlm,bmnd->blnd", probs, v)
        out = torch.einsum("blnd,ndh->blh", ctx, self.out_proj.kernel) + self.out_proj.bias
        return out, position_bias


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool, generator=None):
        super().__init__()
        self.cfg = cfg
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.attention = _GatedRelPosAttention(cfg, has_relative_position_bias, generator)
        self.layer_norm = LayerNorm(H, cfg.layer_norm_eps)
        self.final_layer_norm = LayerNorm(H, cfg.layer_norm_eps)
        self.ff_in = _Dense((H, I), (I,), H, generator)
        self.ff_out = _Dense((I, H), (H,), I, generator)

    def _ff(self, h):
        return self.ff_out(F.gelu(self.ff_in(h), approximate="none"))

    def forward(self, x, position_bias, attention_mask=None):
        if self.cfg.do_stable_layer_norm:  # WavLM-Large pre-LN
            attn, position_bias = self.attention(self.layer_norm(x), position_bias,
                                                 attention_mask)
            x = x + attn
            x = x + self._ff(self.final_layer_norm(x))
        else:  # base post-LN
            attn, position_bias = self.attention(x, position_bias, attention_mask)
            x = self.layer_norm(x + attn)
            x = self.final_layer_norm(x + self._ff(x))
        return x, position_bias


class WavLMModel(nn.Module):
    """waveform (B, T) -> hidden states; the SLD recipe taps
    ``hidden_states[23]`` of WavLM-Large (dump_wavlm_feature.py). Fresh
    weights draw from ``generator``."""

    def __init__(self, cfg: WavLMConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        H, k, C = cfg.hidden_size, cfg.num_conv_pos_embeddings, cfg.conv_dim[-1]
        self.feature_extractor = _FeatureEncoder(cfg, generator)
        self.feat_ln = LayerNorm(C, cfg.layer_norm_eps)
        self.feat_proj = _Dense((C, H), (H,), C, generator)
        self.pos_conv = _Conv(H, H, k, groups=cfg.num_conv_pos_embedding_groups,
                              generator=generator)
        self.encoder_ln = LayerNorm(H, cfg.layer_norm_eps)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", _EncoderLayer(cfg, i == 0, generator))

    def forward(self, waveform: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                output_hidden_states: bool = False) -> Dict[str, Any]:
        """``attention_mask``: frame-level (B, frames), 1 = real."""
        c = self.cfg
        feats = self.feature_extractor(waveform.float())
        x = self.feat_proj(self.feat_ln(feats))
        k = c.num_conv_pos_embeddings
        pos = F.conv1d(x.transpose(1, 2), self.pos_conv.kernel, self.pos_conv.bias,
                       padding=k // 2, groups=c.num_conv_pos_embedding_groups)
        if k % 2 == 0:
            pos = pos[:, :, :-1]
        x = x + F.gelu(pos.transpose(1, 2), approximate="none")
        if not c.do_stable_layer_norm:
            x = self.encoder_ln(x)

        hidden_states: List[torch.Tensor] = [x]
        position_bias = None
        for i in range(c.num_layers):
            x, position_bias = getattr(self, f"layer_{i}")(x, position_bias, attention_mask)
            hidden_states.append(x)
        if c.do_stable_layer_norm:
            x = self.encoder_ln(x)
            hidden_states[-1] = x
        return {
            "last_hidden_state": x,
            "hidden_states": tuple(hidden_states) if output_hidden_states else None,
        }


# ---------------------------------------------------------------------------
# HF conversion, checkpoint reading and feature extraction
# ---------------------------------------------------------------------------


_HF_KEYS = {
    "hidden_size": "hidden_size", "num_layers": "num_hidden_layers",
    "num_heads": "num_attention_heads", "intermediate_size": "intermediate_size",
    "conv_dim": "conv_dim", "conv_kernel": "conv_kernel", "conv_stride": "conv_stride",
    "conv_bias": "conv_bias", "feat_extract_norm": "feat_extract_norm",
    "do_stable_layer_norm": "do_stable_layer_norm",
    "num_conv_pos_embeddings": "num_conv_pos_embeddings",
    "num_conv_pos_embedding_groups": "num_conv_pos_embedding_groups",
    "num_buckets": "num_buckets", "max_bucket_distance": "max_bucket_distance",
    "layer_norm_eps": "layer_norm_eps",
}


def _from_hf(hf_cfg: Mapping, fields, **extra) -> WavLMConfig:
    """WavLMConfig from the HF keys of ``fields``; a key the config lacks
    takes WavLMConfig's default (which is HF's)."""
    kw = {f: hf_cfg[_HF_KEYS[f]] for f in fields if _HF_KEYS[f] in hf_cfg}
    kw = {f: tuple(v) if isinstance(v, list) else v for f, v in kw.items()}
    return WavLMConfig(**kw, **extra)


def hf_wavlm_config_to_config(hf_cfg: Mapping) -> WavLMConfig:
    """An HF WavLM ``config.json`` (as a dict) -> WavLMConfig."""
    return _from_hf(hf_cfg, _HF_KEYS)


def hf_hubert_config_to_config(hf_cfg: Mapping) -> WavLMConfig:
    """An HF HuBERT ``config.json`` (as a dict) -> WavLMConfig with the
    rel-pos bias off (HuBERT = the same wav2vec2-family stack with
    plain MHA; reference alternative dumper: simple_kmeans/
    dump_hubert_feature.py)."""
    fields = [f for f in _HF_KEYS if f not in ("num_buckets", "max_bucket_distance")]
    return _from_hf(hf_cfg, fields, use_rel_pos_bias=False)


def hf_wavlm_to_params(sd: Dict[str, np.ndarray], cfg: WavLMConfig) -> Dict:
    """transformers WavLMModel / HubertModel numpy state dict -> the Flax
    tree (conv kernels in Flax's (k, in, out), as JAX converts them)."""
    c = cfg
    nh, hd = c.num_heads, c.head_dim

    def ln(name):
        return {"scale": sd[name + ".weight"], "bias": sd[name + ".bias"]}

    def dense(name):
        return {"kernel": sd[name + ".weight"].T, "bias": sd[name + ".bias"]}

    fe: Dict[str, Any] = {}
    for i in range(len(c.conv_dim)):
        base = f"feature_extractor.conv_layers.{i}."
        # torch conv1d weight (O, I, K) -> flax (K, I, O)
        conv = {"kernel": sd[base + "conv.weight"].transpose(2, 1, 0)}
        if c.conv_bias:
            conv["bias"] = sd[base + "conv.bias"]
        fe[f"conv_{i}"] = conv
        if c.feat_extract_norm == "group" and i == 0:
            fe["group_norm"] = ln(base + "layer_norm")
        elif c.feat_extract_norm == "layer":
            fe[f"conv_ln_{i}"] = ln(base + "layer_norm")

    # weight-normed positional conv: fold g * v / ||v|| into a plain kernel.
    # torch parametrized names (new) or weight_g/weight_v (old); dim=2 keeps
    # the kernel axis, so the norm reduces over (O, I/groups).
    p = "encoder.pos_conv_embed.conv."
    if p + "parametrizations.weight.original0" in sd:
        g = sd[p + "parametrizations.weight.original0"]
        v = sd[p + "parametrizations.weight.original1"]
    else:
        g = sd[p + "weight_g"]
        v = sd[p + "weight_v"]
    norm = np.sqrt((v**2).sum(axis=(0, 1), keepdims=True))
    w = g * v / np.maximum(norm, 1e-12)  # (O, I/groups, K)
    pos_conv = {"kernel": w.transpose(2, 1, 0), "bias": sd[p + "bias"]}

    params: Dict[str, Any] = {
        "feature_extractor": fe,
        "feat_ln": ln("feature_projection.layer_norm"),
        "feat_proj": dense("feature_projection.projection"),
        "pos_conv": pos_conv,
        "encoder_ln": ln("encoder.layer_norm"),
    }
    H = c.hidden_size
    for i in range(c.num_layers):
        b = f"encoder.layers.{i}."
        attn = {
            name: {
                "kernel": sd[b + f"attention.{name}.weight"].T.reshape(H, nh, hd),
                "bias": sd[b + f"attention.{name}.bias"].reshape(nh, hd),
            }
            for name in ("q_proj", "k_proj", "v_proj")
        }
        attn["out_proj"] = {
            "kernel": sd[b + "attention.out_proj.weight"].T.reshape(nh, hd, H),
            "bias": sd[b + "attention.out_proj.bias"],
        }
        if c.use_rel_pos_bias:
            attn["gru_rel_pos_linear"] = dense(b + "attention.gru_rel_pos_linear")
            attn["gru_rel_pos_const"] = sd[b + "attention.gru_rel_pos_const"]
            if i == 0:
                attn["rel_attn_embed"] = sd[b + "attention.rel_attn_embed.weight"]
        params[f"layer_{i}"] = {
            "attention": attn,
            "layer_norm": ln(b + "layer_norm"),
            "final_layer_norm": ln(b + "final_layer_norm"),
            "ff_in": dense(b + "feed_forward.intermediate_dense"),
            "ff_out": dense(b + "feed_forward.output_dense"),
        }
    return params


def params_to_hf_wavlm(params: Mapping, cfg: WavLMConfig) -> Dict[str, np.ndarray]:
    """The inverse of ``hf_wavlm_to_params``: an HF WavLMModel / HubertModel
    state dict (numpy), the positional conv in weight-norm form (the
    parametrized names, g = ||kernel|| over (out, in / groups) per tap)."""
    c = cfg
    H = c.hidden_size
    sd: Dict[str, np.ndarray] = {}

    def put_ln(name, tree):
        sd[name + ".weight"], sd[name + ".bias"] = tree["scale"], tree["bias"]

    def put_dense(name, tree):
        sd[name + ".weight"] = np.ascontiguousarray(np.asarray(tree["kernel"]).T)
        sd[name + ".bias"] = tree["bias"]

    fe = params["feature_extractor"]
    for i in range(len(c.conv_dim)):
        base = f"feature_extractor.conv_layers.{i}."
        sd[base + "conv.weight"] = np.ascontiguousarray(
            np.asarray(fe[f"conv_{i}"]["kernel"]).transpose(2, 1, 0))
        if c.conv_bias:
            sd[base + "conv.bias"] = fe[f"conv_{i}"]["bias"]
        if c.feat_extract_norm == "group" and i == 0:
            put_ln(base + "layer_norm", fe["group_norm"])
        elif c.feat_extract_norm == "layer":
            put_ln(base + "layer_norm", fe[f"conv_ln_{i}"])
    put_ln("feature_projection.layer_norm", params["feat_ln"])
    put_dense("feature_projection.projection", params["feat_proj"])
    w = np.asarray(params["pos_conv"]["kernel"]).transpose(2, 1, 0)  # (O, I/groups, K)
    p = "encoder.pos_conv_embed.conv."
    sd[p + "parametrizations.weight.original0"] = np.sqrt(
        (w**2).sum(axis=(0, 1), keepdims=True)).astype(np.float32)
    sd[p + "parametrizations.weight.original1"] = np.ascontiguousarray(w)
    sd[p + "bias"] = params["pos_conv"]["bias"]
    put_ln("encoder.layer_norm", params["encoder_ln"])
    for i in range(c.num_layers):
        b = f"encoder.layers.{i}."
        lp = params[f"layer_{i}"]
        attn = lp["attention"]
        for name in ("q_proj", "k_proj", "v_proj"):
            sd[b + f"attention.{name}.weight"] = np.ascontiguousarray(
                np.asarray(attn[name]["kernel"]).reshape(H, H).T)
            sd[b + f"attention.{name}.bias"] = np.asarray(attn[name]["bias"]).reshape(H)
        sd[b + "attention.out_proj.weight"] = np.ascontiguousarray(
            np.asarray(attn["out_proj"]["kernel"]).reshape(H, H).T)
        sd[b + "attention.out_proj.bias"] = attn["out_proj"]["bias"]
        if c.use_rel_pos_bias:
            put_dense(b + "attention.gru_rel_pos_linear", attn["gru_rel_pos_linear"])
            sd[b + "attention.gru_rel_pos_const"] = attn["gru_rel_pos_const"]
            if i == 0:
                sd[b + "attention.rel_attn_embed.weight"] = attn["rel_attn_embed"]
        put_ln(b + "layer_norm", lp["layer_norm"])
        put_ln(b + "final_layer_norm", lp["final_layer_norm"])
        put_dense(b + "feed_forward.intermediate_dense", lp["ff_in"])
        put_dense(b + "feed_forward.output_dense", lp["ff_out"])
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def read_wavlm_checkpoint(path: str) -> Tuple[WavLMConfig, Dict]:
    """(config, parameter tree) of an HF WavLM or HuBERT directory
    (``config.json`` and ``model.safetensors`` or ``pytorch_model.bin``),
    read without ``transformers``; the trunk of a task model (a ``wavlm.``
    or ``hubert.`` prefix) is taken. Another model type raises."""
    from spokennlp_tpu_torch.cli.hf_checkpoint import CONFIG_FILE, read_hf_state_dict
    from spokennlp_tpu_torch.models.hf_convert import torch_state_dict_to_numpy

    with open(os.path.join(path, CONFIG_FILE)) as f:
        raw = json.load(f)
    kind = raw.get("model_type")
    if kind not in ("wavlm", "hubert"):
        raise ValueError(f"{path}: model_type {kind!r}, expected 'wavlm' or 'hubert'")
    cfg = (hf_wavlm_config_to_config if kind == "wavlm" else hf_hubert_config_to_config)(raw)
    sd = torch_state_dict_to_numpy(read_hf_state_dict(path))
    prefix = kind + "."
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return cfg, hf_wavlm_to_params(sd, cfg)


@torch.no_grad()
def extract_wavlm_features(
    model: WavLMModel,
    waveforms: np.ndarray,  # (B, T) float32, 16 kHz
    layer: int,
    chunk_samples: int = 160_000,
) -> np.ndarray:
    """Layer-tap features for the k-means pipeline on the model's device,
    chunked like the reference's max_chunk streaming (dump_wavlm_feature.py:
    74-89): each chunk of ``chunk_samples`` runs alone, a tail shorter than
    the first conv kernel is dropped. Returns (B, frames, H) float32."""
    model.eval()
    device = next(model.parameters()).device
    chunks = []
    T = waveforms.shape[1]
    for s in range(0, T, chunk_samples):
        w = waveforms[:, s : s + chunk_samples]
        if w.shape[1] < model.cfg.conv_kernel[0]:
            break
        out = model(torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(device),
                    output_hidden_states=True)
        chunks.append(out["hidden_states"][layer].float().cpu().numpy())
    return np.concatenate(chunks, axis=1)
