"""Topic-segmentation model and its composite training objective.

Counterpart of ``spokennlp_tpu/models/topic_seg.py``: an encoder trunk, a
token-classification head and a TSSP (topic-structure sentence-pair) head,
and the loss of the reference's ``LossCalculator``:

    total = ts_w * CE(anchor token logits)       [ts_score_predictor=lt]
          + cl_w * CSSL(anchor eop features)     [anchor view only]
          + ts_w * CE(DA token logits)           [when the DA view runs]
          + tssp_w * CE(DA sentence-pair logits) [DA view only]

The reference multiplies the TSSP weight twice; this applies it once, as
the JAX package does. Under data parallel (``dp``, parallel/dist.py) the
loss is this rank's share of the whole batch's: the cross-entropies divide
by global counts, and CSSL, whose indices span the batch, runs on every
rank's gathered eop features and counts 1 / world_size on each.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from spokennlp_tpu_torch.configs import EncoderConfig, TopicSegConfig
from spokennlp_tpu_torch.models.encoder import Dense, Encoder, dropout
from spokennlp_tpu_torch.objectives import cssl as cssl_ops
from spokennlp_tpu_torch.ops import losses as loss_ops

IGNORE = -100


class TopicSegModel(nn.Module):
    """Encoder trunk + token-classification head + TSSP head; dropout on the
    trunk's output (``classifier_dropout``) in training mode."""

    def __init__(
        self,
        enc_cfg: EncoderConfig,
        task_cfg: TopicSegConfig,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.enc_cfg, self.task_cfg = enc_cfg, task_cfg
        H = enc_cfg.hidden_size
        self.encoder = Encoder(enc_cfg, dtype, generator)
        self.classifier = Dense(H, task_cfg.num_labels, generator)
        self.tssp_classifier = Dense(H, task_cfg.num_tssp_labels, generator)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
        sent_positions: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        pack_segment_ids: Optional[torch.Tensor] = None,
        output_hidden_states: bool = False,
        generator: Optional[torch.Generator] = None,
        global_attention_mask: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """``generator`` draws every dropout mask and kernel seed of the
        forward in training mode. A sliding-window trunk without a
        ``global_attention_mask`` makes CLS the one global token, as the
        reference's Longformer model does; with the right-padding
        featurizers that keeps the kernels' contract (``prefix_globals=1``).
        A BigBird trunk gets ``prefix_globals=0``: the featurizers right-pad,
        and its globals are its first blocks."""
        prefix_globals = 0 if self.enc_cfg.attention_type == "bigbird" else None
        if global_attention_mask is None and self.enc_cfg.attention_type == "sliding_window":
            global_attention_mask = torch.zeros_like(attention_mask)
            global_attention_mask[:, 0] = 1
            prefix_globals = 1
        out = self.encoder(
            input_ids,
            attention_mask=attention_mask,
            token_type_ids=token_type_ids,
            position_ids=position_ids,
            pack_segment_ids=pack_segment_ids,
            output_hidden_states=output_hidden_states,
            generator=generator,
            global_attention_mask=global_attention_mask,
            prefix_globals=prefix_globals,
        )
        seq = dropout(out.last_hidden_state, self.task_cfg.classifier_dropout, self.training,
                      generator)
        result = {"seq_output": seq, "token_logits": self.classifier(seq)}
        if output_hidden_states:
            result["hidden_states"] = out.hidden_states
        if sent_positions is not None:
            sent_feats = cssl_ops.gather_sentence_features(seq, sent_positions)
            result["sent_features"] = sent_feats
            result["tssp_logits"] = self.tssp_classifier(sent_feats)
        return result


def _view(batch: Dict[str, torch.Tensor], key: str, view: int) -> torch.Tensor:
    """The anchor (0) or DA (1) view of a (B, 2, ...) batch tensor."""
    return batch[key][:, view]


def ts_view_loss(task_cfg: TopicSegConfig, outputs, labels, eop_positions, eop_mask, dp=None):
    """The boundary loss of one view and its logits for prediction.

    Returns (ts_loss, logits, eop_pair_cos_sim).
    """
    eop_positions = eop_positions.long()
    eop_feats = cssl_ops.gather_sentence_features(outputs["seq_output"], eop_positions)
    eop_labels = torch.take_along_dim(labels, eop_positions, dim=1)
    sims, sim_labels = cssl_ops.eop_pair_cosine_similarity(
        eop_feats, eop_labels, eop_mask, task_cfg.ts_score_predictor_cos_temp
    )
    if task_cfg.ts_score_predictor == "lt":
        logits = outputs["token_logits"]
        ts = loss_ops.cross_entropy_with_ignore(
            logits,
            labels,
            class_weights=loss_ops.ts_class_weights(task_cfg.weight_label_zero),
            focal_gamma=task_cfg.focal_loss_gamma,
            dp=dp,
        )
    elif task_cfg.ts_score_predictor == "cos":
        # BCE on the adjacent-eop cosine: label 1 (O, same topic) -> similar
        ts = loss_ops.bce_with_logits_ignore(sims, sim_labels, dp=dp)
        logits = torch.sigmoid(sims)
    else:
        raise ValueError(f"unsupported ts_score_predictor {task_cfg.ts_score_predictor}")
    return ts, logits, sims


def compute_topic_seg_loss(
    task_cfg: TopicSegConfig,
    anchor_out: Dict[str, torch.Tensor],
    da_out: Optional[Dict[str, torch.Tensor]],
    batch: Dict[str, torch.Tensor],
    cssl_indices: Optional[Dict[str, torch.Tensor]] = None,
    dp=None,
):
    """The composite training loss. Returns (loss, aux dict); with ``dp``
    both are this rank's shares."""
    aux: Dict[str, torch.Tensor] = {}
    anchor_labels = _view(batch, "labels", 0)
    anchor_eop_pos = _view(batch, "sent_positions", 0).long()
    anchor_eop_mask = _view(batch, "eop_mask", 0)

    ts_loss, anchor_logits, _ = ts_view_loss(
        task_cfg, anchor_out, anchor_labels, anchor_eop_pos, anchor_eop_mask, dp
    )
    loss = task_cfg.ts_loss_weight * ts_loss
    aux["ts_loss"] = ts_loss
    aux["anchor_logits"] = anchor_logits

    if task_cfg.cl_loss_weight != 0.0:
        eop_feats = cssl_ops.gather_sentence_features(anchor_out["seq_output"], anchor_eop_pos)
        eop_labels = torch.take_along_dim(anchor_labels, anchor_eop_pos, dim=1)
        eop_mask = anchor_eop_mask
        if dp is not None:  # the indices and topic ids span the whole batch
            eop_feats = dp.gather(eop_feats)
            eop_labels, eop_mask = dp.gather_const(eop_labels), dp.gather_const(eop_mask)
        if task_cfg.cl_anchor_level == "eop_matrix":
            cl = cssl_ops.eop_matrix_cl_loss(eop_feats, eop_labels, eop_mask, task_cfg.cl_temp)
        elif task_cfg.cl_anchor_level in ("eop_list", "eot_list"):
            if cssl_indices is None:
                raise ValueError("list-mode CSSL needs the host-side indices")
            cl = cssl_ops.list_cl_loss(
                eop_feats,
                cssl_indices["anchor_indices"],
                cssl_indices["positive_indices"],
                cssl_indices["negative_indices"],
                cssl_indices["anchor_valid"],
                task_cfg.cl_temp,
            )
        else:
            raise ValueError(f"unsupported cl_anchor_level {task_cfg.cl_anchor_level}")
        if dp is not None:
            cl = cl / dp.world_size
        loss = loss + task_cfg.cl_loss_weight * cl
        aux["cl_loss"] = cl

    if da_out is not None:
        da_ts_loss, da_logits, _ = ts_view_loss(
            task_cfg,
            da_out,
            _view(batch, "labels", 1),
            _view(batch, "sent_positions", 1),
            _view(batch, "eop_mask", 1),
            dp,
        )
        loss = loss + task_cfg.ts_loss_weight * da_ts_loss
        aux["da_ts_loss"] = da_ts_loss
        aux["da_logits"] = da_logits

        if task_cfg.tssp_loss_weight != 0.0 and task_cfg.do_tssp:
            sent_mask = _view(batch, "sent_mask", 1).bool()
            tssp_labels = torch.where(sent_mask, _view(batch, "pair_orders", 1), IGNORE)
            tssp = loss_ops.cross_entropy_with_ignore(da_out["tssp_logits"], tssp_labels, dp=dp)
            loss = loss + task_cfg.tssp_loss_weight * tssp
            aux["tssp_loss"] = tssp

    aux["loss"] = loss
    return loss, aux
