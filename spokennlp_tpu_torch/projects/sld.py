"""SLD: Smoothed Label Distillation for discrete-speech-token ASR, on
PyTorch.

Counterpart of ``spokennlp_tpu/projects/sld.py``, the rebuild of the
reference's modified run_clm trainer (reference: sld/transformers/examples/
pytorch/language-modeling/run_clm.py:74-1022):

- sequence packing ``speech_tokens + [speech_end] + text_tokens + [text_end]``
  with speech ids offset by ``gpt_vocab_size + 2`` (:510-540);
- 30% input time-masking to EOS during training (:788-791), drawn from the
  step's ``torch.Generator``;
- composite loss = w_s * CE_speech + w_t * CE_text + w_kl * T^2 *
  KL(log_softmax(masked speech logits / T) || softmax(smoothed one-hot / T))
  with the reference's mask-multiplies and eps additions (:787-831); the
  target index is clamped at 0 before the one-hot (an index outside the
  speech vocabulary gives a zero row, as ``jax.nn.one_hot`` gives), the KL
  is "batchmean" over B, and both CEs go through ops/losses.py;
- per-epoch greedy or beam decode -> WER/CER (models/generation.py +
  eval/asr_metrics.py), the best checkpoints by WER kept
  (``max_to_keep=2``) as native checkpoints (models/checkpoint_io.py) where
  JAX keeps Orbax ones.

One card: JAX's data-parallel mesh is not ported (ROADMAP, queue 1).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from spokennlp_tpu_torch.ops.losses import cross_entropy_with_ignore

IGNORE = -100


@dataclasses.dataclass(frozen=True)
class SLDConfig:
    gpt_vocab_size: int = 50257  # original text vocab
    vocab_size_speech: int = 2000
    block_size: int = 1024
    max_text_length: int = 256
    weight_ce_speech: float = 1.0
    weight_ce_text: float = 1.0
    weight_kl_speech: float = 1.0
    kl_temperature: float = 1.0
    label_smoothing_eps: float = 0.1
    time_masking: float = 0.3
    eos_token_id: int = 50256

    @property
    def speech_end_id(self) -> int:
        return self.gpt_vocab_size + 1  # added after text_end

    @property
    def text_end_id(self) -> int:
        return self.gpt_vocab_size

    @property
    def total_vocab(self) -> int:
        return self.gpt_vocab_size + 2 + self.vocab_size_speech


def pack_example(
    speech_tokens: Sequence[int],
    text_token_ids: Sequence[int],
    cfg: SLDConfig,
) -> Optional[Dict[str, np.ndarray]]:
    """Pack one (speech codes, text ids) pair into a fixed block.

    Mirrors tokenize_function (:510-540): truncate text to max_text_length,
    offset speech codes by gpt_vocab_size + 2, truncate speech to fit, pad
    with eos / -100.
    """
    if not len(speech_tokens) or not len(text_token_ids):
        return None
    text = list(text_token_ids)[: cfg.max_text_length]
    max_speech = cfg.block_size - 2 - len(text)
    speech = [int(t) + cfg.gpt_vocab_size + 2 for t in speech_tokens][:max_speech]
    seq = speech + [cfg.speech_end_id] + text + [cfg.text_end_id]
    n = len(seq)
    pad = cfg.block_size - n
    return {
        "input_ids": np.asarray(seq + [cfg.eos_token_id] * pad, np.int32),
        "attention_mask": np.asarray([1] * n + [0] * pad, np.int32),
        "labels": np.asarray(seq + [IGNORE] * pad, np.int32),
    }


def time_mask_inputs(input_ids: torch.Tensor, generator: Optional[torch.Generator],
                     cfg: SLDConfig) -> torch.Tensor:
    """Randomly replace a fraction of input tokens with EOS (:788-791)."""
    if cfg.time_masking <= 0:
        return input_ids
    mask = torch.rand(input_ids.shape, generator=generator,
                      device=input_ids.device) < cfg.time_masking
    return torch.where(mask, cfg.eos_token_id, input_ids)


def sld_loss(logits: torch.Tensor, labels: torch.Tensor, attention_mask: torch.Tensor,
             cfg: SLDConfig):
    """The reference composite loss, exactly (:787-831).

    logits: (B, L, V_total); labels/attention_mask: (B, L).
    Returns (loss, {"ce_speech", "ce_text", "kl_speech"}).
    """
    B = logits.shape[0]
    Vs = cfg.vocab_size_speech
    T = cfg.kl_temperature
    eps = 1e-9
    maskf = attention_mask.float()

    # ---- KL over the speech sub-vocabulary (reference quirks preserved:
    # logits multiplied by the mask then eps-shifted BEFORE the softmax)
    speech_logits = logits[:, :-1, -Vs:].float() * maskf[:, :-1, None] + eps
    tgt = (labels[:, 1:].long() - cfg.gpt_vocab_size - 2) * attention_mask[:, 1:].long()
    tgt = torch.clamp(tgt, min=0)
    # jax.nn.one_hot: a zero row for an index outside [0, Vs)
    one_hot = (tgt[..., None] == torch.arange(Vs, device=tgt.device)).float()
    smoothed = one_hot * (1.0 - cfg.label_smoothing_eps) + cfg.label_smoothing_eps / Vs
    smoothed = smoothed * maskf[:, 1:, None] + eps
    log_p = F.log_softmax(speech_logits / T, dim=-1)
    q = F.softmax(smoothed / T, dim=-1)
    # torch KLDivLoss(reduction="batchmean"): sum over all elements / B
    kl = torch.sum(q * (torch.log(torch.clamp(q, min=1e-30)) - log_p)) / B
    loss_kl = kl * (T**2)

    # ---- CE over text / speech target subsets
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:].long()
    text_labels = torch.where(shift_labels >= cfg.gpt_vocab_size + 1, IGNORE, shift_labels)
    speech_labels = torch.where(shift_labels < cfg.gpt_vocab_size + 1, IGNORE, shift_labels)
    loss_ce_text = cross_entropy_with_ignore(shift_logits, text_labels)
    loss_ce_speech = cross_entropy_with_ignore(shift_logits, speech_labels)

    loss = (
        cfg.weight_ce_speech * loss_ce_speech
        + cfg.weight_ce_text * loss_ce_text
        + cfg.weight_kl_speech * loss_kl
    )
    return loss, {"ce_speech": loss_ce_speech, "ce_text": loss_ce_text, "kl_speech": loss_kl}


def make_sld_train_step(model, cfg: SLDConfig, optimizer: torch.optim.Optimizer,
                        generator: Optional[torch.Generator] = None, scheduler=None,
                        clip_grad_norm: float = 0.0):
    """step(batch of tensors) -> metrics: time masking and dropout from
    ``generator``, the SLD loss, then (after optax's global-norm clip when
    ``clip_grad_norm`` > 0) ``optimizer``'s step and ``scheduler``'s.
    The metrics are the loss and its parts before the update, as in JAX."""
    from spokennlp_tpu_torch.train.optim import clip_by_global_norm_

    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        ids = time_mask_inputs(batch["input_ids"], generator, cfg)
        out = model(ids, attention_mask=batch["attention_mask"], generator=generator)
        loss, aux = sld_loss(out["logits"], batch["labels"], batch["attention_mask"], cfg)
        grads = torch.autograd.grad(loss, params)
        if clip_grad_norm > 0:
            clip_by_global_norm_(grads, clip_grad_norm)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        if scheduler is not None:
            scheduler.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    return step


# ---------------------------------------------------------------------------
# decode eval: prompts end at speech_end, references are the raw text
# ---------------------------------------------------------------------------


def build_prompts(batch_input_ids: np.ndarray, cfg: SLDConfig):
    """Left-padded speech prompts (reference :657-668)."""
    prompts = []
    for row in batch_input_ids.tolist():
        p = row.index(cfg.speech_end_id) + 1 if cfg.speech_end_id in row else len(row)
        prompts.append(row[:p])
    max_len = max(len(p) for p in prompts)
    ids = np.full((len(prompts), max_len), cfg.eos_token_id, np.int32)
    mask = np.zeros((len(prompts), max_len), np.int32)
    for i, p in enumerate(prompts):
        ids[i, max_len - len(p) :] = p
        mask[i, max_len - len(p) :] = 1
    return ids, mask


def extract_text_tokens(generated: np.ndarray, cfg: SLDConfig) -> List[List[int]]:
    """Tokens between speech_end and text_end (reference :683-691)."""
    out = []
    for row in generated.tolist():
        if cfg.speech_end_id in row:
            start = row.index(cfg.speech_end_id) + 1
            if cfg.text_end_id in row:
                out.append(row[start : row.index(cfg.text_end_id)])
            else:
                out.append(row[start:])
        else:
            out.append([])
    return out


class SLDTrainer:
    """End-to-end SLD training: epoch loop with input time-masking,
    per-epoch KV-cache decode -> WER/CER, best-checkpoint retention.

    The reference's Accelerate loop (run_clm.py:740-905) with its per-epoch
    ``model.generate`` eval (:647-739), as the JAX package rebuilds it:
    fixed-shape packed batches (the last filled by repetition), one prompt
    length for the whole eval set. ``model`` (models/gpt2.py, its weights
    already in place) trains on its own device with ``optimizer`` (and
    ``scheduler``, ``clip_grad_norm``); time masks and dropout draw from a
    generator seeded with ``seed``, the batch order from numpy's
    ``default_rng(seed)``."""

    def __init__(
        self,
        model,
        cfg: SLDConfig,
        optimizer: torch.optim.Optimizer,
        train_examples: Sequence[Dict[str, np.ndarray]],
        eval_examples: Sequence[Dict[str, np.ndarray]],
        eval_texts: Sequence[str],
        detokenize_fn,
        batch_size: int = 8,
        num_epochs: int = 3,
        seed: int = 0,
        decode_max_len: Optional[int] = None,
        num_beams: int = 1,
        checkpoint_dir: Optional[str] = None,
        metric_for_best: str = "wer",
        scheduler=None,
        clip_grad_norm: float = 0.0,
    ):
        self.model = model
        self.cfg = cfg
        self.train_examples = list(train_examples)
        self.eval_examples = list(eval_examples)
        self.eval_texts = list(eval_texts)
        self.detokenize_fn = detokenize_fn
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.seed = seed
        self.num_beams = num_beams
        self.decode_max_len = decode_max_len or cfg.block_size
        self.checkpoint_dir = checkpoint_dir
        self.metric_for_best = metric_for_best
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step_fn = make_sld_train_step(model, cfg, optimizer, self.generator, scheduler,
                                           clip_grad_norm)
        self._kept: List[tuple] = []  # (metrics, epoch) of the checkpoints on disk

        # one prompt length for the whole eval set
        self._prompt_ids, self._prompt_mask = build_prompts(
            np.stack([e["input_ids"] for e in self.eval_examples]), cfg
        )

    def _batches(self, rng: np.random.Generator):
        order = rng.permutation(len(self.train_examples))
        bs = self.batch_size
        for s in range(0, len(order), bs):
            take = order[s : s + bs].tolist()
            while len(take) < bs:  # pad the tail by repetition (one shape)
                take.append(take[len(take) - len(order[s : s + bs])])
            chunk = [self.train_examples[i] for i in take]
            yield {
                k: np.stack([c[k] for c in chunk])
                for k in ("input_ids", "attention_mask", "labels")
            }

    def decode_eval(self) -> Dict[str, float]:
        """KV-cache decode over the eval prompts -> WER/CER (reference:
        per-epoch generate + jiwer metrics, run_clm.py:647-739)."""
        from spokennlp_tpu_torch.eval.asr_metrics import cer as cer_fn
        from spokennlp_tpu_torch.eval.asr_metrics import wer as wer_fn
        from spokennlp_tpu_torch.models.generation import beam_generate, greedy_generate

        n = self._prompt_ids.shape[0]
        bs = self.batch_size
        hyps: List[str] = []
        for s in range(0, n, bs):
            ids = self._prompt_ids[s : s + bs]
            mask = self._prompt_mask[s : s + bs]
            pad = bs - ids.shape[0]
            if pad:
                ids = np.concatenate([ids, np.repeat(ids[-1:], pad, 0)])
                mask = np.concatenate([mask, np.repeat(mask[-1:], pad, 0)])
            ids = torch.from_numpy(ids).to(self.device)
            mask = torch.from_numpy(mask).to(self.device)
            if self.num_beams > 1:
                gen = beam_generate(self.model, ids, mask, max_len=self.decode_max_len,
                                    eos_id=self.cfg.text_end_id, num_beams=self.num_beams)
            else:
                gen = greedy_generate(self.model, ids, mask, max_len=self.decode_max_len,
                                      eos_id=self.cfg.text_end_id)
            token_rows = extract_text_tokens(gen.cpu().numpy(), self.cfg)
            hyps.extend(self.detokenize_fn(r) for r in token_rows)
        hyps = hyps[:n]
        return {
            "wer": wer_fn(hyps, self.eval_texts),
            "cer": cer_fn(hyps, self.eval_texts),
        }

    def _save(self, epoch: int, metrics: Dict[str, float]):
        """Write ``<checkpoint_dir>/<epoch>`` (params.msgpack and
        metrics.json) and keep the two best by ``metric_for_best`` (lower is
        better; among equals the later), as JAX's Orbax manager with
        ``max_to_keep=2`` and ``best_fn`` does."""
        if not self.checkpoint_dir:
            return
        from spokennlp_tpu_torch.models import checkpoint_io

        path = os.path.join(os.path.abspath(self.checkpoint_dir), str(epoch))
        checkpoint_io.save_checkpoint(
            path, checkpoint_io.params_from_state_dict(self.model.state_dict()))
        with open(os.path.join(path, "metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f)
        self._kept.append((metrics, epoch))
        key = lambda e: -e[0].get(self.metric_for_best, float("inf"))
        ranked = sorted(self._kept, key=key)  # stable: equals stay in epoch order
        for _, old in ranked[:-2]:
            shutil.rmtree(os.path.join(os.path.abspath(self.checkpoint_dir), str(old)))
        self._kept = [e for e in self._kept if e in ranked[-2:]]

    def train(self) -> Dict:
        data_rng = np.random.default_rng(self.seed)
        history = []
        for epoch in range(1, self.num_epochs + 1):
            losses = []
            for batch in self._batches(data_rng):
                tb = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
                metrics = self.step_fn(tb)
                losses.append(float(metrics["loss"]))
            eval_metrics = self.decode_eval()
            row = {
                "epoch": epoch,
                "train_loss": float(np.mean(losses)),
                **eval_metrics,
            }
            history.append(row)
            self._save(epoch, eval_metrics)
        return {"history": history, "final": history[-1]}
