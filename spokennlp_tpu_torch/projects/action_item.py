"""Action-item detection: sentence classification with Context-Drop and
R-Drop, on PyTorch.

Counterpart of ``spokennlp_tpu/projects/action_item.py`` (the reference's
TF1 Estimator stack, action-item-detection/script/run_classifier.py):

- context assembly: [CLS] sentence [SEP] ctx1 [SEP] ctx2 [SEP] ...; the
  focus sentence's tokens carry token type 0, context tokens 1;
- example pairing for the consistency objective (``build_paired_examples``,
  the port's copy: the same ``np.random.Generator`` draws in the same
  order): "none" (one example), "r-drop" (two identical copies),
  "context-drop-fix" (with and without context), "context-drop-dynamic"
  (two random context subsets, keep-prob 0.5); a kept context sentence that
  is itself positive is handled by ``noisy_type`` skip | update | remain;
- classifier inputs: cls (the pooler) | sep | token_avg | token_max
  (``token_max`` masks with -1e4, as JAX does);
- loss: CE (optional label smoothing, or focal loss) + alpha * mean(KL(p1 ||
  p2) + KL(p2 || p1)) / 2 between the rows 2i and 2i + 1 of a batch.

Parameter names follow the Flax tree (``encoder``, ``classifier``), so a
JAX tree loads with ``load_state_dict(..., strict=True)``. The head's
dropout, like the trunk's, draws from the step's explicit generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spokennlp_tpu_torch.configs import EncoderConfig
from spokennlp_tpu_torch.models.encoder import Dense, Encoder, dropout

NEG_INF = -1e4


@dataclasses.dataclass(frozen=True)
class AidConfig:
    num_labels: int = 2
    classifier_input: str = "cls"  # cls | sep | token_avg | token_max
    loss_type: str = "ce"  # ce | focal_loss
    focal_gamma: float = 2.0
    do_label_smoothing: bool = False
    label_smoothing_eps: float = 0.1
    kl_alpha: float = 1.0
    drop_type: str = "context-drop-dynamic"  # none | r-drop | context-drop-fix
    #                                          | context-drop-dynamic
    noisy_type: str = "update"  # skip | update | remain
    context_keep_prob: float = 0.5
    max_seq_length: int = 128
    dropout_rate: float = 0.1


# ------------------------------------------------------------------ pairing


def build_paired_examples(
    sentences: Sequence[Dict],
    cfg: AidConfig,
    rng: np.random.Generator,
    context_width: int = 2,
    use_global: bool = False,
) -> List[Dict]:
    """Assemble (possibly paired) classification examples from a meeting.

    ``sentences``: [{"text": str, "label": 0/1}] in order. Returns examples
    {"sentence", "contexts": [str], "label", "pair"} where consecutive rows
    with the same ``pair`` id form a consistency pair.
    """
    out: List[Dict] = []
    pair_id = 0
    for i, sent in enumerate(sentences):
        left = sentences[max(0, i - context_width) : i]
        right = sentences[i + 1 : i + 1 + context_width]
        glob = []
        if use_global:
            glob = [sentences[0]] if i != 0 else []
        base_ctx = left + right + glob

        def ctx_label(ctx: Sequence[Dict]) -> int:
            return 1 if any(c["label"] == 1 for c in ctx) else 0

        def resolve(label: int, ctx: Sequence[Dict]) -> Optional[int]:
            if ctx_label(ctx) and label == 0:
                if cfg.noisy_type == "skip":
                    return None
                if cfg.noisy_type == "update":
                    return 1
            return label

        def make(ctx: Sequence[Dict], label: int) -> Dict:
            return {
                "sentence": sent["text"],
                "contexts": [c["text"] for c in ctx],
                "label": label,
                "pair": pair_id,
            }

        if cfg.drop_type == "none":
            lab = resolve(sent["label"], base_ctx)
            if lab is None:
                continue
            out.append(make(base_ctx, lab))
        elif cfg.drop_type == "r-drop":
            lab = resolve(sent["label"], base_ctx)
            if lab is None:
                continue
            out.append(make(base_ctx, lab))
            out.append(make(base_ctx, lab))
        elif cfg.drop_type == "context-drop-fix":
            lab = resolve(sent["label"], base_ctx)
            if lab is None:
                continue
            out.append(make(base_ctx, lab))
            out.append(make([], sent["label"]))
        elif cfg.drop_type == "context-drop-dynamic":
            first = [c for c in base_ctx if rng.random() < cfg.context_keep_prob]
            second = [c for c in base_ctx if rng.random() < cfg.context_keep_prob]
            lab1 = resolve(sent["label"], first)
            lab2 = resolve(sent["label"], second)
            if lab1 is None or lab2 is None:
                continue
            if cfg.noisy_type == "remain":
                lab1 = lab2 = sent["label"]
            out.append(make(first, lab1))
            out.append(make(second, lab2))
        else:
            raise ValueError(cfg.drop_type)
        pair_id += 1
    return out


def featurize_example(
    example: Dict,
    tokenize_fn,
    cfg: AidConfig,
    cls_id: int,
    sep_id: int,
    pad_id: int = 0,
) -> Dict[str, np.ndarray]:
    """[CLS] sentence [SEP] ctx1 [SEP] ctx2 [SEP] ...; sentence = type 0."""
    L = cfg.max_seq_length
    sent_tokens = list(tokenize_fn(example["sentence"]))
    ids = [cls_id] + sent_tokens + [sep_id]
    types = [0] * len(ids)
    sep_positions = [len(ids) - 1]
    for ctx in example["contexts"]:
        ctx_tokens = list(tokenize_fn(ctx))
        ids.extend(ctx_tokens + [sep_id])
        types.extend([1] * (len(ctx_tokens) + 1))
        sep_positions.append(len(ids) - 1)
    ids = ids[:L]
    types = types[:L]
    n = len(ids)
    input_ids = np.full(L, pad_id, np.int32)
    input_ids[:n] = ids
    token_type_ids = np.zeros(L, np.int32)
    token_type_ids[:n] = types
    attention_mask = np.zeros(L, np.int32)
    attention_mask[:n] = 1
    sent_sep = min(sep_positions[0], L - 1)
    return {
        "input_ids": input_ids,
        "token_type_ids": token_type_ids,
        "attention_mask": attention_mask,
        "sep_position": np.asarray(sent_sep, np.int32),
        "label": np.asarray(example["label"], np.int32),
    }


def collate_examples(
    examples: Sequence[Dict], tokenize_fn, cfg: AidConfig, cls_id: int, sep_id: int
) -> Dict[str, np.ndarray]:
    feats = [featurize_example(e, tokenize_fn, cfg, cls_id, sep_id) for e in examples]
    return {k: np.stack([f[k] for f in feats]) for k in feats[0]}


# -------------------------------------------------------------------- model


class AidModel(nn.Module):
    """Encoder + pooling-variant classifier head. ``cls`` reads the trunk's
    pooler, so it needs ``add_pooler=True``."""

    def __init__(self, enc_cfg: EncoderConfig, cfg: AidConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.classifier_input == "cls" and not enc_cfg.add_pooler:
            raise ValueError("classifier_input='cls' reads the pooler: add_pooler=True")
        self.enc_cfg, self.cfg = enc_cfg, cfg
        self.encoder = Encoder(enc_cfg, dtype, generator)
        self.classifier = Dense(enc_cfg.hidden_size, cfg.num_labels, generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor, sep_position: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """-> logits (B, num_labels) in the compute dtype. ``generator`` draws
        every dropout mask and kernel seed in training mode."""
        out = self.encoder(input_ids, attention_mask=attention_mask,
                           token_type_ids=token_type_ids, generator=generator)
        seq = out.last_hidden_state
        c = self.cfg
        if c.classifier_input == "cls":
            pooled = out.pooled_output
        elif c.classifier_input == "sep":
            idx = sep_position.long()[:, None, None].expand(-1, 1, seq.shape[-1])
            pooled = torch.gather(seq, 1, idx)[:, 0]
        elif c.classifier_input in ("token_avg", "token_max"):
            # focus tokens: type 0, excluding CLS, valid
            positions = torch.arange(seq.shape[1], device=seq.device)[None, :]
            focus = (token_type_ids == 0) & attention_mask.bool() & (positions > 0)
            if c.classifier_input == "token_avg":
                maskf = focus.to(seq.dtype)[..., None]
                pooled = (seq * maskf).sum(1) / maskf.sum(1).clamp_min(1.0)
            else:
                # amax spreads the gradient over tied maxima, as JAX's max does
                pooled = torch.where(focus[..., None], seq,
                                     torch.tensor(NEG_INF, dtype=seq.dtype,
                                                  device=seq.device)).amax(1)
        else:
            raise ValueError(c.classifier_input)
        pooled = dropout(pooled, c.dropout_rate, self.training, generator)
        return self.classifier(pooled)


def aid_loss(logits: torch.Tensor, labels: torch.Tensor, cfg: AidConfig, training: bool = True):
    """CE/focal (+ smoothing) + symmetric KL between paired rows.

    Rows 2i and 2i+1 are a pair (the batch must interleave pairs). Returns
    (loss, {"ce", and in training with pairs "kl"}).
    """
    logits = logits.float()
    num_labels = logits.shape[-1]
    one_hot = F.one_hot(labels.long(), num_labels).float()
    if cfg.do_label_smoothing:
        eps = cfg.label_smoothing_eps
        one_hot = (1 - eps) * one_hot + eps / num_labels
    log_probs = F.log_softmax(logits, dim=-1)
    probs = F.softmax(logits, dim=-1)
    if cfg.loss_type == "focal_loss":
        per_ex = -(one_hot * (1 - probs) ** cfg.focal_gamma * log_probs).sum(-1)
    else:
        per_ex = -(one_hot * log_probs).sum(-1)
    loss_ce = per_ex.mean()
    aux = {"ce": loss_ce}
    if not training or cfg.drop_type == "none":
        return loss_ce, aux

    pair = logits.reshape(-1, 2, num_labels)
    p1 = F.softmax(pair[:, 0], -1)
    p2 = F.softmax(pair[:, 1], -1)
    kl12 = (p1 * (torch.log(p1 + 1e-12) - torch.log(p2 + 1e-12))).sum(-1)
    kl21 = (p2 * (torch.log(p2 + 1e-12) - torch.log(p1 + 1e-12))).sum(-1)
    loss_kl = (kl12 + kl21).mean() / 2.0
    aux["kl"] = loss_kl
    return loss_ce + cfg.kl_alpha * loss_kl, aux


def make_aid_train_step(model: AidModel, cfg: AidConfig, optimizer,
                        generator: Optional[torch.Generator] = None):
    """``step(batch) -> {"loss", "ce"[, "kl"]}``: one optimizer step on a dict
    of tensors (input_ids, attention_mask, token_type_ids, sep_position,
    label) on the model's device; the batch's rows must interleave
    consistency pairs. Dropout masks come from ``generator``."""

    def step(batch):
        model.train()
        logits = model(batch["input_ids"], batch["attention_mask"], batch["token_type_ids"],
                       batch["sep_position"], generator=generator)
        loss, aux = aid_loss(logits, batch["label"], cfg, training=True)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    return step
