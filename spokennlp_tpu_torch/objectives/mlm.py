"""Masked-LM + NSP further pretraining (the AID recipe's).

Counterpart of ``spokennlp_tpu/objectives/mlm.py``. The host side
(``create_masked_lm_predictions``, ``build_pretraining_batch``,
``PretrainDataConfig``) is the port's copy: the same numpy generator draws
give the same arrays. The device side is ``BertForPreTraining`` on the
port's ``Encoder`` and ``pretraining_loss``:

- 15 % of the tokens are picked (at most ``max_predictions_per_seq``, at
  least 1), special tokens never; whole words together with subword flags;
- a picked token becomes [MASK] 80 % of the time, stays 10 %, and is
  replaced by a random id 10 % (create_pretraining_data.py:391-401);
- the MLM head is Dense(H) + the activation + LayerNorm, its logits a
  float32 product with the word embeddings (tied) plus an output bias;
- the NSP head is a 2-way classifier on the pooled [CLS];
- total = MLM loss + NSP loss (run_pretraining.py:148).

The parameter names are the Flax tree's (``encoder``, ``mlm_transform``,
``mlm_ln``, ``mlm_output_bias``, ``nsp_pool`` when the trunk has no pooler,
``nsp_classifier``), so JAX's parameters load through
``models/convert.py`` with ``strict=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spokennlp_tpu_torch.configs import EncoderConfig
from spokennlp_tpu_torch.models.encoder import ACT2FN, Dense, Encoder, LayerNorm

IGNORE = -100


# ------------------------------------------------------------------ host side


def create_masked_lm_predictions(
    token_ids: Sequence[int],
    special_ids: Sequence[int],
    vocab_size: int,
    rng: np.random.Generator,
    mask_token_id: int,
    masked_lm_prob: float = 0.15,
    max_predictions_per_seq: int = 20,
    subword_flags: Optional[Sequence[bool]] = None,
):
    """Reference masking walk (create_pretraining_data.py:342-415).

    ``subword_flags[i]`` True marks a ##-continuation piece (whole-word
    masking groups it with its predecessor); None = per-token masking.
    Returns (masked_ids, positions, labels) with positions sorted ascending.
    """
    specials = set(int(s) for s in special_ids)
    cand_indexes: List[List[int]] = []
    for i, t in enumerate(token_ids):
        if int(t) in specials:
            continue
        if subword_flags is not None and subword_flags[i] and cand_indexes:
            cand_indexes[-1].append(i)
        else:
            cand_indexes.append([i])

    order = rng.permutation(len(cand_indexes))
    num_to_predict = min(
        max_predictions_per_seq, max(1, int(round(len(token_ids) * masked_lm_prob)))
    )
    out = list(int(t) for t in token_ids)
    picked: List[int] = []
    covered = set()
    for oi in order:
        index_set = cand_indexes[oi]
        if len(picked) >= num_to_predict:
            break
        if len(picked) + len(index_set) > num_to_predict:
            continue
        if any(i in covered for i in index_set):
            continue
        for i in index_set:
            covered.add(i)
            r = rng.random()
            if r < 0.8:
                out[i] = mask_token_id
            elif rng.random() < 0.5:
                pass  # keep original
            else:
                out[i] = int(rng.integers(0, vocab_size))
            picked.append(i)
    picked.sort()
    labels = [int(token_ids[i]) for i in picked]
    return out, picked, labels


def build_pretraining_batch(
    docs: Sequence[Sequence[Sequence[int]]],
    cfg,
    rng: np.random.Generator,
    max_seq_length: int = 128,
    max_predictions_per_seq: int = 20,
    masked_lm_prob: float = 0.15,
    vocab_size: int = 30522,
):
    """Documents (lists of per-sentence token-id lists) -> MLM+NSP examples.

    Pairs consecutive sentences as [CLS] A [SEP] B [SEP]; with p=0.5 B is a
    random sentence from another document (next_sentence_label 1, the
    reference's is_random_next). Returns stacked np arrays.
    """
    ex = {k: [] for k in (
        "input_ids", "attention_mask", "token_type_ids",
        "mlm_positions", "mlm_labels", "mlm_weights", "nsp_labels",
    )}
    all_sents = [s for d in docs for s in d if len(s) > 0]
    L, P = max_seq_length, max_predictions_per_seq
    for doc in docs:
        for si in range(len(doc) - 1):
            a = list(doc[si])
            if rng.random() < 0.5 and len(all_sents) > 1:
                b = list(all_sents[int(rng.integers(0, len(all_sents)))])
                nsp = 1
            else:
                b = list(doc[si + 1])
                nsp = 0
            # truncate longest-first to fit [CLS] a [SEP] b [SEP]
            while len(a) + len(b) > L - 3:
                (a if len(a) >= len(b) else b).pop()
            ids = [cfg.cls_token_id] + a + [cfg.sep_token_id] + b + [cfg.sep_token_id]
            tt = [0] * (len(a) + 2) + [1] * (len(b) + 1)
            specials = (cfg.cls_token_id, cfg.sep_token_id, cfg.pad_token_id)
            masked, pos, labels = create_masked_lm_predictions(
                ids, specials, vocab_size, rng, cfg.mask_token_id, masked_lm_prob, P,
            )
            n = len(ids)
            row = np.full(L, cfg.pad_token_id, np.int32)
            row[:n] = masked
            am = np.zeros(L, np.int32)
            am[:n] = 1
            ttr = np.zeros(L, np.int32)
            ttr[:n] = tt
            pr = np.zeros(P, np.int32)
            lr = np.zeros(P, np.int32)
            wr = np.zeros(P, np.float32)
            k = min(len(pos), P)
            pr[:k], lr[:k], wr[:k] = pos[:k], labels[:k], 1.0
            ex["input_ids"].append(row)
            ex["attention_mask"].append(am)
            ex["token_type_ids"].append(ttr)
            ex["mlm_positions"].append(pr)
            ex["mlm_labels"].append(lr)
            ex["mlm_weights"].append(wr)
            ex["nsp_labels"].append(nsp)
    return {k: np.stack(v) if k != "nsp_labels" else np.asarray(v, np.int32)
            for k, v in ex.items()}


@dataclasses.dataclass(frozen=True)
class PretrainDataConfig:
    cls_token_id: int = 101
    sep_token_id: int = 102
    pad_token_id: int = 0
    mask_token_id: int = 103


# ---------------------------------------------------------------- device side


class BertForPreTraining(nn.Module):
    """Encoder trunk + MLM head (tied word embeddings) + NSP head. Parameters
    float32, ``dtype`` the compute dtype, as in the Flax module: the MLM
    logits and the NSP classifier run in float32."""

    def __init__(self, enc_cfg: EncoderConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc_cfg = enc_cfg
        H = enc_cfg.hidden_size
        self.encoder = Encoder(enc_cfg, dtype, generator)
        self.mlm_transform = Dense(H, H, generator)
        self.mlm_ln = LayerNorm(H, enc_cfg.layer_norm_eps)
        self.mlm_output_bias = nn.Parameter(torch.zeros(enc_cfg.vocab_size))
        self.nsp_pool = Dense(H, H, generator) if not enc_cfg.add_pooler else None
        self.nsp_classifier = Dense(H, 2, generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor, mlm_positions: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """mlm_positions (B, P) -> {"mlm_logits" (B, P, V), "nsp_logits"
        (B, 2)}, both float32. ``generator`` draws the trunk's dropout masks
        and kernel seeds in training mode."""
        enc = self.encoder(input_ids, attention_mask=attention_mask,
                           token_type_ids=token_type_ids, generator=generator)
        seq = enc.last_hidden_state  # (B, L, H)
        gathered = torch.take_along_dim(seq, mlm_positions.long()[..., None], dim=1)
        h = self.mlm_ln(ACT2FN[self.enc_cfg.hidden_act](self.mlm_transform(gathered)))
        emb = self.encoder.embeddings.word_embeddings.embedding
        mlm_logits = h.float() @ emb.float().T + self.mlm_output_bias
        pooled = enc.pooled_output
        if pooled is None:  # a trunk without a pooler: CLS + tanh
            pooled = torch.tanh(self.nsp_pool(seq[:, 0]))
        nsp_logits = self.nsp_classifier(pooled.float())
        return {"mlm_logits": mlm_logits, "nsp_logits": nsp_logits}


def pretraining_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
    """total = weighted-mean MLM CE + mean NSP CE (run_pretraining.py:148).
    Returns (total, {"mlm_loss", "nsp_loss"})."""
    mlm_logp = F.log_softmax(outputs["mlm_logits"].float(), dim=-1)
    lm = -torch.take_along_dim(mlm_logp, batch["mlm_labels"].long()[..., None], dim=-1)[..., 0]
    w = batch["mlm_weights"].float()
    mlm_loss = (lm * w).sum() / w.sum().clamp_min(1e-5)
    nsp_logp = F.log_softmax(outputs["nsp_logits"].float(), dim=-1)
    nsp_loss = -torch.take_along_dim(nsp_logp, batch["nsp_labels"].long()[:, None],
                                     dim=-1).mean()
    return mlm_loss + nsp_loss, {"mlm_loss": mlm_loss, "nsp_loss": nsp_loss}
