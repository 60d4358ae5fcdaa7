"""CLIP ViT vision tower, PyTorch: frame features for MMVTS vis2d.

Counterpart of ``spokennlp_tpu/models/clip_vit.py``. The reference encodes
key frames with OpenAI CLIP's ViT-B/16 and max-pools the frames of each clip
(mmvts/src/models/vis_encoder/vis2d_encoder.py:14-35, vis_encoder.py:33-46):

- pre-norm ViT with QuickGELU (x * sigmoid(1.702 x)), a class token,
  learned absolute positions, ln_pre / ln_post and a linear projection;
- weights from an HF ``CLIPVisionModelWithProjection`` state dict
  (``hf_clip_vision_to_params``, numpy, the Flax tree; ``models/convert.py``
  carries it into the port, the patch convolution's kernel into
  ``Conv2d``'s (out, in, kh, kw) layout); the config from a ``config.json``
  dict (``clip_vit_config_from_dict``): the card's machine may lack
  ``transformers``;
- host-side preprocessing (bilinear resize, centre crop, CLIP
  normalisation) in numpy, the port's copy of JAX's;
- ``encode_clip_frames``: the tower on the model's device over batches of
  frames, then the max over each clip's frames (zeros for a clip without
  frames).

Parameter names follow the Flax tree (``patch_embed``, ``class_embedding``,
``positional_embedding``, ``ln_pre``, ``block_{i}.{ln_1,qkv,out,ln_2,mlp_in,
mlp_out}``, ``ln_post``, ``proj``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spokennlp_tpu_torch.models.encoder import (
    AttnOutProj, Dense, FusedQKV, LayerNorm, _lecun_normal_,
)

CLIP_IMAGE_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def clip_vit_config_from_dict(d: Mapping) -> CLIPViTConfig:
    """An HF ``config.json`` (a ``CLIPVisionConfig``'s, or a ``CLIPConfig``'s
    with its ``vision_config``) -> CLIPViTConfig; a key the dict lacks takes
    HF's default."""
    vision = d.get("vision_config", d)
    return CLIPViTConfig(
        image_size=vision.get("image_size", 224),
        patch_size=vision.get("patch_size", 32),
        hidden_size=vision.get("hidden_size", 768),
        num_layers=vision.get("num_hidden_layers", 12),
        num_heads=vision.get("num_attention_heads", 12),
        intermediate_size=vision.get("intermediate_size", 3072),
        projection_dim=d.get("projection_dim", vision.get("projection_dim", 512)),
        layer_norm_eps=vision.get("layer_norm_eps", 1e-5),
    )


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _ViTBlock(nn.Module):
    """Pre-norm residual attention block (CLIP convention)."""

    def __init__(self, cfg: CLIPViTConfig, generator=None):
        super().__init__()
        H, nh = cfg.hidden_size, cfg.num_heads
        self.ln_1 = LayerNorm(H, cfg.layer_norm_eps)
        self.qkv = FusedQKV(H, nh, H // nh, generator)
        self.out = AttnOutProj(nh, H // nh, H, generator)
        self.ln_2 = LayerNorm(H, cfg.layer_norm_eps)
        self.mlp_in = Dense(H, cfg.intermediate_size, generator)
        self.mlp_out = Dense(cfg.intermediate_size, H, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(self.ln_1(x)).unbind(2)
        hd = q.shape[-1]
        scores = torch.einsum("blnd,bmnd->bnlm", q * (1.0 / math.sqrt(hd)), k)
        probs = F.softmax(scores.float(), dim=-1).to(x.dtype)
        x = x + self.out(torch.einsum("bnlm,bmnd->blnd", probs, v))
        return x + self.mlp_out(quick_gelu(self.mlp_in(self.ln_2(x))))


class PatchEmbed(nn.Module):
    """Flax ``nn.Conv(H, (p, p), strides=(p, p), use_bias=False)`` over NHWC
    pixels; ``kernel`` in ``Conv2d``'s (H, 3, p, p) layout."""

    def __init__(self, cfg: CLIPViTConfig, generator=None):
        super().__init__()
        p = cfg.patch_size
        self.stride = p
        self.kernel = nn.Parameter(torch.empty(cfg.hidden_size, 3, p, p))
        _lecun_normal_(self.kernel.data, 3 * p * p, generator)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:  # (B, S, S, 3) -> (B, P, H)
        x = F.conv2d(pixels.permute(0, 3, 1, 2), self.kernel.to(pixels.dtype),
                     stride=self.stride)
        return x.flatten(2).transpose(1, 2)


class CLIPVisionTower(nn.Module):
    """pixels (B, H, W, 3) float in CLIP-normalised space -> (B, proj_dim)."""

    def __init__(self, cfg: CLIPViTConfig, dtype: torch.dtype = torch.float32,
                 generator=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        H = cfg.hidden_size
        self.patch_embed = PatchEmbed(cfg, generator)
        self.class_embedding = nn.Parameter(torch.empty(H))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.num_patches + 1, H))
        self.ln_pre = LayerNorm(H, cfg.layer_norm_eps)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", _ViTBlock(cfg, generator))
        self.ln_post = LayerNorm(H, cfg.layer_norm_eps)
        self.proj = nn.Parameter(torch.empty(H, cfg.projection_dim))
        for t in (self.class_embedding, self.positional_embedding, self.proj):
            nn.init.normal_(t.data, std=0.02, generator=generator)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = self.patch_embed(pixels.to(dt))
        B, _, H = x.shape
        x = torch.cat([self.class_embedding.to(dt).expand(B, 1, H), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding.to(dt)[None])
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"block_{i}")(x)
        return self.ln_post(x[:, 0]) @ self.proj.to(dt)


# ---------------------------------------------------------------------------
# HF checkpoint conversion (transformers CLIPVisionModelWithProjection)
# ---------------------------------------------------------------------------


def hf_clip_vision_to_params(sd: Dict[str, np.ndarray], cfg: CLIPViTConfig) -> Dict:
    """An HF ``CLIPVisionModelWithProjection`` numpy state dict -> the Flax
    parameter tree (``models/convert.py jax_params_to_state_dict`` makes the
    port's state dict of it).

    HF names: vision_model.embeddings.{class_embedding, patch_embedding.weight,
    position_embedding.weight}, vision_model.pre_layrnorm, vision_model.
    encoder.layers.N.{layer_norm1, self_attn.{q,k,v,out}_proj, layer_norm2,
    mlp.fc1/fc2}, vision_model.post_layernorm, visual_projection.weight.
    """
    c = cfg
    nh, hd = c.num_heads, c.hidden_size // c.num_heads
    p = "vision_model."

    def ln(name):
        return {"scale": sd[name + ".weight"], "bias": sd[name + ".bias"]}

    params: Dict[str, Any] = {
        # torch conv weight (O, I, kh, kw) -> flax (kh, kw, I, O)
        "patch_embed": {
            "kernel": sd[p + "embeddings.patch_embedding.weight"].transpose(2, 3, 1, 0)
        },
        "class_embedding": sd[p + "embeddings.class_embedding"].reshape(-1),
        "positional_embedding": sd[p + "embeddings.position_embedding.weight"],
        "ln_pre": ln(p + "pre_layrnorm"),
        "ln_post": ln(p + "post_layernorm"),
        "proj": sd["visual_projection.weight"].T,
    }
    for i in range(c.num_layers):
        q = p + f"encoder.layers.{i}."
        w = [sd[q + f"self_attn.{n}_proj.weight"].T for n in "qkv"]
        b = [sd[q + f"self_attn.{n}_proj.bias"] for n in "qkv"]
        params[f"block_{i}"] = {
            "ln_1": ln(q + "layer_norm1"),
            "ln_2": ln(q + "layer_norm2"),
            # torch Linear weight (out, in): DenseGeneral (in, 3, nh, hd)
            "qkv": {"kernel": np.stack(w, axis=1).reshape(c.hidden_size, 3, nh, hd),
                    "bias": np.stack(b, axis=0).reshape(3, nh, hd)},
            "out": {"kernel": sd[q + "self_attn.out_proj.weight"].T.reshape(nh, hd,
                                                                            c.hidden_size),
                    "bias": sd[q + "self_attn.out_proj.bias"]},
            "mlp_in": {"kernel": sd[q + "mlp.fc1.weight"].T, "bias": sd[q + "mlp.fc1.bias"]},
            "mlp_out": {"kernel": sd[q + "mlp.fc2.weight"].T, "bias": sd[q + "mlp.fc2.bias"]},
        }
    return params


# ---------------------------------------------------------------------------
# host-side preprocessing + per-clip frame features
# ---------------------------------------------------------------------------


def preprocess_images(images: np.ndarray, image_size: int = 224) -> np.ndarray:
    """uint8 / float (B, H, W, 3) -> CLIP-normalised float32 (B, S, S, 3):
    the shorter side bilinearly resized to S in numpy, then a centre crop."""
    imgs = np.asarray(images)
    if imgs.dtype == np.uint8:
        imgs = imgs.astype(np.float32) / 255.0
    B, H, W, _ = imgs.shape
    scale = image_size / min(H, W)
    nh, nw = max(int(round(H * scale)), image_size), max(int(round(W * scale)), image_size)

    def resize_axis(a, n, axis):
        src = np.linspace(0, a.shape[axis] - 1, n)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, a.shape[axis] - 1)
        frac = (src - lo).astype(np.float32)
        sl = [slice(None)] * a.ndim
        sl_lo, sl_hi = list(sl), list(sl)
        sl_lo[axis], sl_hi[axis] = lo, hi
        shape = [1] * a.ndim
        shape[axis] = n
        f = frac.reshape(shape)
        return a[tuple(sl_lo)] * (1 - f) + a[tuple(sl_hi)] * f

    imgs = resize_axis(imgs, nh, 1)
    imgs = resize_axis(imgs, nw, 2)
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    imgs = imgs[:, top:top + image_size, left:left + image_size]
    return ((imgs - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD).astype(np.float32)


@torch.no_grad()
def encode_clip_frames(model: CLIPVisionTower, frames: np.ndarray,
                       clip_frame_counts: Sequence[int], batch_size: int = 32) -> np.ndarray:
    """Frame features max-pooled per clip (vis_encoder.py:33-46) ->
    (n_clips, proj_dim) float32. ``frames`` (n_frames, H, W, 3) are
    preprocessed on the host and run on the model's device in batches of
    ``batch_size`` (a short last batch repeats its last frame, as in JAX);
    ``clip_frame_counts`` sums to n_frames, a clip of 0 frames gives zeros."""
    model.eval()
    device = next(model.parameters()).device
    pixels = preprocess_images(frames, model.cfg.image_size)
    feats = []
    for s in range(0, pixels.shape[0], batch_size):
        chunk = pixels[s:s + batch_size]
        real = chunk.shape[0]
        if real < batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_size - real, 0)])
        out = model(torch.from_numpy(chunk).to(device))
        feats.append(out[:real].float().cpu().numpy())
    flat = np.concatenate(feats, axis=0)
    out, pos = [], 0
    for cnt in clip_frame_counts:
        out.append(flat[pos:pos + cnt].max(axis=0) if cnt
                   else np.zeros(flat.shape[-1], np.float32))
        pos += cnt
    return np.stack(out)
