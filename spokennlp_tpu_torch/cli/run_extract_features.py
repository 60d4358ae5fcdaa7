"""Dump per-layer token feature vectors from an encoder checkpoint, on
PyTorch.

Counterpart of ``spokennlp_tpu/cli/run_extract_features.py`` (the
reference's BERT feature extractor, action-item-detection/script/
extract_features.py:319-412), with the same flags plus ``--device``: reads a
text file (one example a line, ``text_a ||| text_b`` for pairs), runs the
trunk with every hidden state, and writes the same JSONL schema (``{"linex_index":
i, "features": [{"token": t, "layers": [{"index": -1, "values": [...]},
...]}, ...]}``, the reference's spelling). On the card the trunk runs the
fused path, kernels 1 and 2 (``output_hidden_states`` keeps it off the
stack kernel). Tokens come from the checkpoint's ``vocab.txt`` or
``--vocab_file`` through the port's WordPiece copy, else from whitespace
words hashed with ``zlib.crc32`` (the JAX package hashes with the salted
``hash()``).

    python -m spokennlp_tpu_torch.cli.run_extract_features --input_file in.txt \
        --output_file features.jsonl --model_name_or_path <checkpoint dir>
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
import zlib
from typing import List, Optional, Tuple

import numpy as np


def read_examples(path: str) -> List[Tuple[str, Optional[str]]]:
    """Reference read_examples (extract_features.py:319-340): ``a ||| b``."""
    examples = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            m = re.match(r"^(.*) \|\|\| (.*)$", line)
            if m is None:
                examples.append((line, None))
            else:
                examples.append((m.group(1), m.group(2)))
    return examples


def truncate_seq_pair(tokens_a: List[str], tokens_b: List[str], max_length: int):
    """Pop from the longer side (extract_features.py:302-316)."""
    while len(tokens_a) + len(tokens_b) > max_length:
        if len(tokens_a) > len(tokens_b):
            tokens_a.pop()
        else:
            tokens_b.pop()


def convert_example(
    text_a: str,
    text_b: Optional[str],
    tokenize,
    to_ids,
    seq_length: int,
    cls: str = "[CLS]",
    sep: str = "[SEP]",
):
    """-> (tokens, input_ids, input_mask, type_ids), reference :210-299."""
    tokens_a = tokenize(text_a)
    tokens_b = tokenize(text_b) if text_b else None
    if tokens_b is not None:
        truncate_seq_pair(tokens_a, tokens_b, seq_length - 3)
    else:
        tokens_a = tokens_a[: seq_length - 2]
    tokens = [cls] + tokens_a + [sep]
    type_ids = [0] * len(tokens)
    if tokens_b is not None:
        tokens += tokens_b + [sep]
        type_ids += [1] * (len(tokens_b) + 1)
    ids = to_ids(tokens)
    mask = [1] * len(ids)
    pad = seq_length - len(ids)
    return tokens, ids + [0] * pad, mask + [0] * pad, type_ids + [0] * pad


def resolve_string_tokenizer(args):
    """(tokenize -> List[str], to_ids -> List[int]), token strings kept: the
    schema writes each token's text."""
    from spokennlp_tpu_torch.utils.tokenization import FullTokenizer

    path = args.model_name_or_path
    if path and os.path.isfile(os.path.join(path, "vocab.txt")):
        lower = True
        tok_cfg = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(tok_cfg):
            with open(tok_cfg) as f:
                lower = bool(json.load(f).get("do_lower_case", True))
        tok = FullTokenizer.from_vocab_file(os.path.join(path, "vocab.txt"), do_lower_case=lower)
        return tok.tokenize, tok.convert_tokens_to_ids
    if args.vocab_file:
        tok = FullTokenizer.from_vocab_file(args.vocab_file)
        return tok.tokenize, tok.convert_tokens_to_ids
    # hash fallback (smoke runs without vocabulary files): whitespace tokens
    V = 30522

    def tokenize(s: str) -> List[str]:
        return s.split()

    def to_ids(tokens: List[str]) -> List[int]:
        return [zlib.crc32(t.encode()) % (V - 10) + 10 for t in tokens]

    return tokenize, to_ids


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_file", required=True)
    p.add_argument("--output_file", required=True)
    p.add_argument("--layers", default="-1,-2,-3,-4",
                   help="comma-separated encoder-layer indices (-1 = last)")
    p.add_argument("--max_seq_length", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--model_name_or_path", default=None)
    p.add_argument("--vocab_file", default=None)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_hidden_layers", type=int, default=12)
    p.add_argument("--num_attention_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=3072)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; cuda raises when no card is present")
    return p


def build_encoder(args):
    """The trunk on ``args.device``, without its pooler: the checkpoint's
    (a task checkpoint's trunk) or, without one, weights drawn from seed 0."""
    import dataclasses

    import torch

    from spokennlp_tpu_torch.cli import common
    from spokennlp_tpu_torch.cli.run_inference import resolve_device
    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.models.encoder import Encoder

    device = resolve_device(args.device)
    enc_cfg = EncoderConfig(
        vocab_size=30522,
        hidden_size=args.hidden_size,
        num_layers=args.num_hidden_layers,
        num_heads=args.num_attention_heads,
        intermediate_size=args.intermediate_size,
        add_pooler=False,
    )
    params = None
    loaded = common.maybe_load_pretrained(args, enc_cfg)
    if loaded is not None:
        enc_cfg, params = loaded
        params = dict(params.get("encoder", params))
        params.pop("pooler", None)  # the feature dump never reads the pooler
        enc_cfg = dataclasses.replace(enc_cfg, add_pooler=False)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = Encoder(enc_cfg, dtype, generator=torch.Generator().manual_seed(0))
    if params is not None:
        model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.to(device).eval()


def extract(model, feats, layer_indexes, batch_size: int, writer) -> dict:
    """Run the trunk over ``feats`` (``convert_example``'s tuples) in batches
    (the last one padded with empty rows) and write one JSONL line an
    example. Returns {"examples", "seconds"}: the loop's host time."""
    import torch

    device = next(model.parameters()).device
    B = batch_size
    L = len(feats[0][1]) if feats else 0
    t0 = time.perf_counter()
    for start in range(0, len(feats), B):
        chunk = feats[start:start + B]
        pad_n = B - len(chunk)
        ids, mask, types = (torch.from_numpy(np.array(
            [c[i] for c in chunk] + [[0] * L] * pad_n, np.int32)).to(device) for i in (1, 2, 3))
        with torch.inference_mode():
            out = model(ids, attention_mask=mask, token_type_ids=types,
                        output_hidden_states=True)
            # hidden_states[0] is the embedding output; the layers follow
            # (the reference indexes model.get_all_encoder_layers())
            layers = torch.stack(out.hidden_states[1:], 0).float().cpu().numpy()
        for bi, (tokens, _, _, _) in enumerate(chunk):
            all_features = []
            for ti, token in enumerate(tokens):
                all_layers = [{"index": li,
                               "values": [round(float(x), 6) for x in layers[li, bi, ti]]}
                              for li in layer_indexes]
                all_features.append({"token": token, "layers": all_layers})
            writer.write(json.dumps({"linex_index": start + bi, "features": all_features},
                                    ensure_ascii=False) + "\n")
    return {"examples": len(feats), "seconds": time.perf_counter() - t0}


def run(args) -> dict:
    """One dump of the parsed flags; returns ``extract``'s {"examples",
    "seconds"}."""
    layer_indexes = [int(x) for x in args.layers.split(",")]
    tokenize, to_ids = resolve_string_tokenizer(args)
    model = build_encoder(args)
    feats = [convert_example(a, b, tokenize, to_ids, args.max_seq_length)
             for a, b in read_examples(args.input_file)]
    os.makedirs(os.path.dirname(os.path.abspath(args.output_file)), exist_ok=True)
    with open(args.output_file, "w", encoding="utf-8") as writer:
        return extract(model, feats, layer_indexes, args.batch_size, writer)


def main(argv=None):
    out = run(build_parser().parse_args(argv))
    print(f"wrote {out['examples']} examples to the output file in {out['seconds']:.3f} s")
    return out["examples"]


if __name__ == "__main__":
    main()
