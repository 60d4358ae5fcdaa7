"""MMVTS project glue, PyTorch: the text encoder and the multimodal fusion
end to end.

Counterpart of ``spokennlp_tpu/projects/mmvts.py`` (the reference script,
mmvts/src/main_multimodal.py:90-705): clip transcripts are windowed like
emnlp2023 sentences (BOS-marked, shared-sentence overlap); the text encoder
gives clip features at the BOS positions; cached per-clip vis / audio
features are zero-padded onto the same (B, K) grid; the fusion model and the
composite loss run over the clip grid.

The text trunk is the port's encoder, so on the card ``auto`` runs its
kernels: the dense trunk trains on rows 10 and 11 and evaluates batches of
at most 32 on kernel 3; a ``sliding_window`` trunk (Longformer) takes an
all-zeros ``global_attention_mask`` with ``prefix_globals=0`` (the
reference's text encoder passes no global token), which resolves to rows 12
and 11 in training and kernels 7 and 2 at inference, without global rows.

Parameter names follow the Flax tree (``text_encoder``, ``fusion``), so a
JAX tree loads with ``load_state_dict(..., strict=True)``.

Inside a process group the train step runs JAX's SPMD step over the global
batch: each data rank takes its rows, the forward runs under
``dist.sharded_batch`` (dropout drawn over the global batch, the MoE's
dispatch planned over every rank's tokens), the loss is the rank's share
of the global batch's (``mmvts_losses.mmvts_total_loss(dp=...)``), and the
gradients and metrics are summed over the data group before the optimizer
call; under the model axis the trunk's and the fusion layers' heads and
MLP columns and the MoE's experts are sharded (parallel/mesh.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from spokennlp_tpu_torch.configs import EncoderConfig, WindowingConfig
from spokennlp_tpu_torch.data import windowing as W
from spokennlp_tpu_torch.models.encoder import Encoder
from spokennlp_tpu_torch.models.multimodal import MultiModalForTS, MultimodalConfig
from spokennlp_tpu_torch.objectives import mmvts_losses
from spokennlp_tpu_torch.objectives.cssl import gather_sentence_features
from spokennlp_tpu_torch.parallel.dist import data_parallel, sharded_batch
from spokennlp_tpu_torch.train.optim import TrainOptimizer
from spokennlp_tpu_torch.train.train_step import step_generator

IGNORE = -100
TOPIC_CL_KEYS = {"topic_cl_anchor_valid": "anchor_valid", "topic_cl_pos": "pos",
                 "topic_cl_neg": "neg"}


class MMVTSModel(nn.Module):
    """Text trunk + clip gathering + multimodal fusion."""

    def __init__(self, enc_cfg: EncoderConfig, mm_cfg: MultimodalConfig,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.enc_cfg, self.mm_cfg, self.dtype = enc_cfg, mm_cfg, dtype
        self.text_encoder = (Encoder(enc_cfg, dtype, generator)
                             if "text" in mm_cfg.modalities else None)
        self.fusion = MultiModalForTS(mm_cfg, dtype, generator)

    def forward(self, input_ids, attention_mask, clip_positions, clip_mask, vis_feats=None,
                audio_feats=None, generator: Optional[torch.Generator] = None):
        text_feats = None
        if self.text_encoder is not None:
            gmask, prefix = None, None
            if self.enc_cfg.attention_type == "sliding_window":
                # reference parity: no global tokens (HF Longformer's default);
                # the all-zeros mask and the prefix promise keep the kernels
                gmask, prefix = torch.zeros_like(attention_mask), 0
            out = self.text_encoder(input_ids, attention_mask=attention_mask,
                                    global_attention_mask=gmask, prefix_globals=prefix,
                                    generator=generator)
            text_feats = gather_sentence_features(out.last_hidden_state, clip_positions)
        return self.fusion(clip_mask, text_feats=text_feats, vis_feats=vis_feats,
                           audio_feats=audio_feats, generator=generator)


def featurize_video(
    clip_token_ids: Sequence[Sequence[int]],
    clip_labels: Sequence[int],
    clip_features: Dict[str, np.ndarray],  # e.g. {"vis": (n_clips, Hv), ...}
    wcfg: WindowingConfig,
    example_id: int = 0,
    max_clips_per_window: int = 128,
):
    """Window a video's clip transcripts and align its cached clip features.

    MMVTS labels: 1 = end of topic. The windower works in the B-EOP=0 space,
    so labels are inverted on the way in and the window's labels come back
    out in MMVTS space (masked slots IGNORE)."""
    inv = [0 if lab == 1 else 1 for lab in clip_labels]  # to B-EOP=0 space
    windows = W.window_document(clip_token_ids, inv, wcfg, example_id=example_id,
                                max_sentences_per_window=max_clips_per_window)
    out = []
    K = max_clips_per_window
    for w in windows:
        clip_mask = w.sent_mask
        lab = np.where(w.sent_labels != IGNORE, 1 - np.maximum(w.sent_labels, 0),
                       IGNORE).astype(np.int32)
        feats = {}
        for name, arr in clip_features.items():
            f = np.zeros((K, arr.shape[-1]), arr.dtype)
            for k in range(K):
                if clip_mask[k] and 0 <= w.sent_ids[k] < len(arr):
                    f[k] = arr[w.sent_ids[k]]
            feats[name] = f
        out.append({
            "example_id": w.example_id,
            "input_ids": w.input_ids,
            "attention_mask": w.attention_mask,
            "clip_positions": w.sent_positions,
            "clip_mask": clip_mask,
            "clip_labels": lab,
            "clip_ids": w.sent_ids,
            **{f"{k}_feats": v for k, v in feats.items()},
        })
    return out


def make_mmvts_train_step(model: MMVTSModel, optimizer, loss_kwargs: Dict,
                          seed: int = 0) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """``step(batch) -> scalar aux losses`` over the composite objective.

    ``batch`` holds tensors on the model's device: input_ids, attention_mask,
    clip_positions, clip_mask, clip_labels, the present ``*_feats`` and, for
    list-mode topic CL, the host-sampled ``topic_cl_*`` indices.
    ``optimizer`` is a ``TrainOptimizer`` (clipping, schedule, accumulation:
    ``train/optim.py make_optimizer``) or a ``torch.optim.Optimizer`` (the
    module learning-rate groups, ``make_module_lr_optimizer``, which JAX
    chains with nothing). A parameter the loss does not reach (the trunk's
    pooler) gets a zero gradient, as ``jax.grad`` gives it. Dropout masks
    come from a generator seeded from (seed, step)."""
    params = [p for p in model.parameters() if p.requires_grad]
    calls = [0]

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        dp = data_parallel()
        device = batch["input_ids"].device
        generator = step_generator(device, seed, calls[0])
        calls[0] += 1
        kwargs = dict(loss_kwargs)
        if "topic_cl_anchor_valid" in batch:
            kwargs["topic_cl_indices"] = {v: batch[k] for k, v in TOPIC_CL_KEYS.items()}
        with sharded_batch(dp):
            out = model(batch["input_ids"], batch["attention_mask"], batch["clip_positions"],
                        batch["clip_mask"], vis_feats=batch.get("vis_feats"),
                        audio_feats=batch.get("audio_feats"), generator=generator)
            loss, aux = mmvts_losses.mmvts_total_loss(model.mm_cfg, out, batch["clip_labels"],
                                                      batch["clip_mask"], dp=dp, **kwargs)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        metrics = {k: v.detach() for k, v in aux.items() if torch.is_tensor(v) and v.ndim == 0}
        if dp is not None:
            dp.all_reduce_(grads)
            names = sorted(metrics)
            shares = torch.stack([metrics[k].float() for k in names])
            dp.all_reduce_([shares])
            metrics = dict(zip(names, shares.unbind()))
        if isinstance(optimizer, TrainOptimizer):
            optimizer.step(grads)
        else:
            for p, g in zip(params, grads):
                p.grad = g
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        return metrics

    return step


def make_mmvts_pretrain_step(model: MMVTSModel, optimizer, align_pairs=None,
                             cl_temp: float = 0.1, seed: int = 0):
    """Modality-alignment pretraining (reference: mmvts/src/pretrain.py):
    the cross-modal InfoNCE alone, no segmentation loss."""
    return make_mmvts_train_step(model, optimizer, dict(
        ts_lw=0.0, do_modality_cl=True,
        align_pairs=align_pairs or {"tv": 1.0, "av": 1.0, "at": 1.0}, cl_temp=cl_temp),
        seed=seed)
