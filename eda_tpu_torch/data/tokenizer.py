"""Deterministic word-level tokenizer with stable hashed ids.

Token ids come from an FNV-1a hash into the vocabulary. Special ids match
RoBERTa (<s>=0, <pad>=1, </s>=2). Batches have a fixed shape (``max_len``), so
every text tensor the model sees has the same length.
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

import numpy as np

BOS_ID = 0
PAD_ID = 1
EOS_ID = 2
_NUM_SPECIAL = 4  # bos, pad, eos, unk-reserve

_WORD_RE = re.compile(r"\w+|[^\w\s]")


def _fnv1a(s: str) -> int:
    h = 0xCBF29CE484222325
    for ch in s.encode("utf-8"):
        h = ((h ^ ch) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class SimpleTokenizer:
    """Word-level tokenizer: ``encode_batch`` gives (ids, mask) arrays."""

    def __init__(self, vocab_size: int = 50265, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase

    def token_id(self, word: str) -> int:
        if self.lowercase:
            word = word.lower()
        return _NUM_SPECIAL + _fnv1a(word) % (self.vocab_size - _NUM_SPECIAL)

    def encode_batch(
        self, texts: Sequence[str], max_len: int = 256
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, max_len) int32 ids and (B, max_len) bool mask (True = real token)."""
        B = len(texts)
        ids = np.full((B, max_len), PAD_ID, np.int32)
        mask = np.zeros((B, max_len), bool)
        for b, text in enumerate(texts):
            words = [m.group() for m in _WORD_RE.finditer(text)][: max_len - 2]
            ids[b, 0] = BOS_ID
            for t, w in enumerate(words):
                ids[b, t + 1] = self.token_id(w)
            ids[b, len(words) + 1] = EOS_ID
            mask[b, : len(words) + 2] = True
        return ids, mask


def not_mentioned_suffix(utterance: str) -> str:
    """Append the ' . not mentioned' tail (joint_det_dataset.py:988-991)."""
    return utterance.rstrip() + " . not mentioned"
