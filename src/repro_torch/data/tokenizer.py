"""Hashing tokenizer (offline-friendly; no external vocab files).

Whitespace/punct word split → stable FNV-1a hash → [n_special, vocab).  Not a
linguistic tokenizer — it's the data-pipeline stand-in so the end-to-end
training examples run hermetically."""
from __future__ import annotations

import re

import numpy as np

PAD, BOS, EOS = 0, 1, 2
N_SPECIAL = 3
_WORD = re.compile(r"\w+|[^\w\s]")


def _fnv1a(s: str) -> int:
    h = 0xCBF29CE484222325
    for ch in s.encode():
        h ^= ch
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class HashTokenizer:
    def __init__(self, vocab_size: int):
        assert vocab_size > N_SPECIAL + 1
        self.vocab_size = vocab_size

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [BOS] if add_bos else []
        for w in _WORD.findall(text.lower()):
            ids.append(N_SPECIAL + _fnv1a(w) % (self.vocab_size - N_SPECIAL))
        return ids

    def encode_batch(self, texts: list[str]) -> list[list[int]]:
        return [self.encode(t) for t in texts]
