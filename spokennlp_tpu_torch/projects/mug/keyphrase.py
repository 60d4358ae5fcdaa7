"""MUG Track 4: keyphrase extraction by BERT-CRF BIO tagging, on PyTorch.

Counterpart of ``spokennlp_tpu/projects/mug/keyphrase.py``: encoder
emissions -> linear-chain CRF (ops/crf.py) over BIO tags -> span decoding ->
a frequency-ranked keyphrase list for the @10/@15/@20 challenge metric. The
host helpers (``spans_from_bio``, ``bio_tags_from_keyphrases``,
``extract_keyphrases``) are the port's own copies of the JAX module's.

``BertCrfTagger`` names its parameters as the Flax tree does (``encoder``,
``emissions`` with ``kernel``/``bias``, ``transitions``), so a JAX tree
loads with ``load_state_dict(jax_params_to_state_dict(tree), strict=True)``.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from spokennlp_tpu_torch.configs import EncoderConfig
from spokennlp_tpu_torch.models.encoder import Dense, Encoder
from spokennlp_tpu_torch.ops.crf import crf_log_likelihood, crf_viterbi_decode

TAG_O, TAG_B, TAG_I = 0, 1, 2
NUM_TAGS = 3


class BertCrfTagger(nn.Module):
    """Encoder + float32 emission head + CRF transition matrix (zeros at
    init, as Flax's ``nn.initializers.zeros``)."""

    def __init__(self, enc_cfg: EncoderConfig, num_tags: int = NUM_TAGS,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc_cfg = enc_cfg
        self.encoder = Encoder(enc_cfg, dtype, generator)
        self.emissions = Dense(enc_cfg.hidden_size, num_tags, generator)
        self.transitions = nn.Parameter(torch.zeros(num_tags, num_tags))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                tags: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """-> {"emissions" (B, L, T) float32, "transitions", and with
        ``tags`` "loss": the negative mean CRF log-likelihood}. ``generator``
        draws the trunk's dropout masks and kernel seeds in training mode."""
        out = self.encoder(input_ids, attention_mask=attention_mask, generator=generator)
        emissions = self.emissions(out.last_hidden_state.float())
        result = {"emissions": emissions, "transitions": self.transitions}
        if tags is not None:
            result["loss"] = -crf_log_likelihood(emissions, tags, attention_mask,
                                                 self.transitions)
        return result


def decode_tags(model: BertCrfTagger, input_ids, attention_mask) -> np.ndarray:
    """Viterbi tags (B, L) of numpy (or tensor) ids and mask, in eval mode on
    the model's device."""
    device = next(model.parameters()).device
    ids = torch.as_tensor(np.asarray(input_ids), device=device)
    mask = torch.as_tensor(np.asarray(attention_mask), device=device)
    model.eval()
    with torch.no_grad():
        out = model(ids, mask)
        tags, _ = crf_viterbi_decode(out["emissions"], mask, out["transitions"])
    return tags.cpu().numpy()


def spans_from_bio(tags: Sequence[int], mask: Sequence[int]) -> List[Tuple[int, int]]:
    """BIO tag sequence -> [start, end) spans."""
    spans = []
    start = None
    for i, (t, m) in enumerate(zip(tags, mask)):
        if not m:
            break
        if t == TAG_B:
            if start is not None:
                spans.append((start, i))
            start = i
        elif t == TAG_I:
            if start is None:
                start = i  # tolerate I without B
        else:
            if start is not None:
                spans.append((start, i))
                start = None
    if start is not None:
        spans.append((start, int(np.sum(mask))))
    return spans


def bio_tags_from_keyphrases(
    tokens: Sequence[str], keyphrases: Sequence[Sequence[str]]
) -> List[int]:
    """Label token sequence with BIO tags via exact sub-sequence match."""
    tags = [TAG_O] * len(tokens)
    for kp in keyphrases:
        k = len(kp)
        if k == 0:
            continue
        for i in range(len(tokens) - k + 1):
            if tokens[i : i + k] == list(kp):
                tags[i] = TAG_B
                for j in range(i + 1, i + k):
                    tags[j] = TAG_I
    return tags


def extract_keyphrases(
    token_lists: Sequence[Sequence[str]],
    tag_lists: Sequence[Sequence[int]],
    mask_lists: Sequence[Sequence[int]],
    top_k: int = 20,
) -> List[str]:
    """Collect tagged spans across a meeting and rank by frequency
    (the AdaSeq recipe's aggregation for the @k metric)."""
    counter: collections.Counter = collections.Counter()
    for tokens, tags, mask in zip(token_lists, tag_lists, mask_lists):
        for s, e in spans_from_bio(tags, mask):
            phrase = "".join(tokens[s:e])
            if phrase:
                counter[phrase] += 1
    return [p for p, _ in counter.most_common(top_k)]


def featurize_kpe(meetings: Sequence[Dict], tokenize_fn, pad_id: int, max_len: int,
                  with_tags: bool) -> List[Dict]:
    """One row a sentence of each meeting (``parse_keyphrases``): one id per
    character (the first id of the character's tokens, ``pad_id`` when it has
    none), so the BIO tags stay aligned; padded to ``max_len``. An empty
    sentence gives an all-padding row."""
    from spokennlp_tpu_torch.projects.mug import data as mug_data

    L = max_len
    rows = []
    for m in meetings:
        parsed = mug_data.parse_keyphrases(m)
        kps = [list(k) for k in parsed["key_words"]]
        for sent in parsed["sentences"]:
            chars = list(sent)[:L]
            char_toks = [tokenize_fn(c) for c in chars]
            ids = [t[0] if t else pad_id for t in char_toks]
            tags = bio_tags_from_keyphrases(chars, kps) if with_tags else [0] * len(chars)
            n = len(ids)
            rows.append({
                "input_ids": np.pad(np.asarray(ids, np.int32), (0, L - n)),
                "attention_mask": np.pad(np.ones(n, np.int32), (0, L - n)),
                "tags": np.pad(np.asarray(tags, np.int32), (0, L - n)),
                "tokens": chars,
                "meeting_key": parsed["meeting_key"],
            })
    return rows


def build_tagger(enc_cfg: EncoderConfig, ckpt_params, seed: int, device) -> BertCrfTagger:
    """BertCrfTagger on ``device``, its weights drawn from
    ``torch.Generator().manual_seed(seed)``, then a checkpoint tree loaded
    over it: the whole tagger (``"encoder"`` at its top), or a bare trunk
    (``hf_convert.bert_to_encoder_params``'s output), which keeps the fresh
    emissions head and transitions."""
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict

    model = BertCrfTagger(enc_cfg, generator=torch.Generator().manual_seed(seed))
    if ckpt_params is not None:
        target = model if "encoder" in ckpt_params else model.encoder
        target.load_state_dict(jax_params_to_state_dict(ckpt_params), strict=True)
    return model.to(device)


def make_kpe_train_step(model: BertCrfTagger, optimizer, generator=None):
    """``step(batch) -> {"loss"}``: the tagger's CRF loss on a dict of (B, L)
    tensors (input_ids, attention_mask, tags) on the model's device, one
    optimizer step; dropout masks come from ``generator``."""

    def step(batch):
        model.train()
        out = model(batch["input_ids"], batch["attention_mask"], tags=batch["tags"],
                    generator=generator)
        loss = out["loss"]
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step
