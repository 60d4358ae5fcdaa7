"""BERT-style tokenization (BasicTokenizer + WordPiece), self-contained.

The port's own copy of ``spokennlp_tpu/utils/tokenization.py`` (same behaviour; imports
only the port, numpy and the standard library).

The reference vendors Google's BERT tokenizer in three places (emnlp2023-
topic_segmentation/src/analysis/tokenizer.py, alimeeting4mug/src/utils/
tokenizer.py, action-item-detection/script/tokenization.py). This is a
fresh implementation of the same published algorithm (WordPiece greedy
longest-match-first; basic tokenizer with lowercase/accent-strip/punctuation
and CJK-character splitting) so the framework tokenizes offline — used for
rouge tokenization of Chinese text and as a fallback when HF tokenizers'
vocab files are unavailable.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional


def _is_whitespace(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting with optional lowercasing."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._split_cjk(text)
        tokens = text.strip().split()
        out: List[str] = []
        for tok in tokens:
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            out.extend(self._split_punct(tok))
        return " ".join(out).split()

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _split_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(text: str) -> List[str]:
        out: List[List[str]] = []
        new_word = True
        for ch in text:
            if _is_punctuation(ch):
                out.append([ch])
                new_word = True
            else:
                if new_word:
                    out.append([])
                new_word = False
                out[-1].append(ch)
        return ["".join(w) for w in out if w]


class WordpieceTokenizer:
    """Greedy longest-match-first subword tokenization."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]", max_chars: int = 200):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars = max_chars

    def tokenize(self, token: str) -> List[str]:
        if len(token) > self.max_chars:
            return [self.unk_token]
        out: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            out.append(cur)
            start = end
        return out


class FullTokenizer:
    """BasicTokenizer + WordPiece + id conversion, BERT vocab format."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordpieceTokenizer(vocab)

    @classmethod
    def from_vocab_file(cls, path: str, do_lower_case: bool = True):
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, do_lower_case)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(tok))
        return out

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        unk = self.vocab.get("[UNK]", 0)
        return [self.vocab.get(t, unk) for t in tokens]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))
