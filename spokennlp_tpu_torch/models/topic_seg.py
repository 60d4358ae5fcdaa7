"""Topic-segmentation model: encoder trunk, token-classification head and
TSSP head (inference).

Counterpart of ``TopicSegModel`` in ``spokennlp_tpu/models/topic_seg.py``;
the composite training objective belongs to the training port.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from spokennlp_tpu.configs import EncoderConfig, TopicSegConfig
from spokennlp_tpu_torch.models.encoder import Dense, Encoder
from spokennlp_tpu_torch.objectives.cssl import gather_sentence_features


class TopicSegModel(nn.Module):
    """Encoder trunk + token-classification head + TSSP head."""

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
    ) -> Dict[str, torch.Tensor]:
        out = self.encoder(
            input_ids,
            attention_mask=attention_mask,
            token_type_ids=token_type_ids,
            position_ids=position_ids,
            pack_segment_ids=pack_segment_ids,
            output_hidden_states=output_hidden_states,
        )
        seq = out.last_hidden_state
        result = {"seq_output": seq, "token_logits": self.classifier(seq)}
        if output_hidden_states:
            result["hidden_states"] = out.hidden_states
        if sent_positions is not None:
            sent_feats = gather_sentence_features(seq, sent_positions)
            result["sent_features"] = sent_feats
            result["tssp_logits"] = self.tssp_classifier(sent_feats)
        return result
