"""Tokenizers with character offsets, in fixed-shape batches.

The port's own copy of ``eda_tpu/models/tokenizer.py``:

* ``SimpleTokenizer``: word-level, ids from an FNV-1a hash into the
  vocabulary, for synthetic scenes;
* ``BPETokenizer`` (``data/bpe.py``): RoBERTa's byte-level BPE from
  ``vocab.json`` + ``merges.txt``, in plain Python;
* ``HFTokenizer``: a local HuggingFace fast tokenizer, which imports
  ``transformers`` only when it is built.

Special ids match RoBERTa (<s>=0, <pad>=1, </s>=2). ``encode_batch`` pads to
``max_len``, so every text tensor has one length, and returns a
``TokenBatch`` that carries each token's character offsets, which the positive
maps of the training targets need.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence, Tuple

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


@dataclasses.dataclass
class TokenBatch:
    """Fixed-shape token batch.

    input_ids: (B, L) int32; attention_mask: (B, L) bool (True = real token);
    offsets: per sequence, (char_start, char_end) of each token, (0, 0) for
    the specials and the padding; lengths: (B,) real tokens, specials included.
    """

    input_ids: np.ndarray
    attention_mask: np.ndarray
    offsets: List[List[Tuple[int, int]]]
    lengths: np.ndarray

    def char_to_token(self, b: int, char_idx: int) -> Optional[int]:
        """Index of the token of sequence ``b`` that covers character ``char_idx``, or None."""
        for t, (s, e) in enumerate(self.offsets[b]):
            if s <= char_idx < e:
                return t
        return None


class SimpleTokenizer:
    """Word-level tokenizer with stable hashed ids and character offsets."""

    def __init__(self, vocab_size: int = 50265, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase

    def token_id(self, word: str) -> int:
        if self.lowercase:
            word = word.lower()
        return _NUM_SPECIAL + _fnv1a(word) % (self.vocab_size - _NUM_SPECIAL)

    def encode_batch(self, texts: Sequence[str], max_len: int = 256) -> TokenBatch:
        B = len(texts)
        ids = np.full((B, max_len), PAD_ID, np.int32)
        mask = np.zeros((B, max_len), bool)
        offsets: List[List[Tuple[int, int]]] = []
        lengths = np.zeros((B,), np.int32)
        for b, text in enumerate(texts):
            toks = [(m.group(), m.start(), m.end()) for m in _WORD_RE.finditer(text)]
            toks = toks[: max_len - 2]
            ids[b, 0] = BOS_ID
            offs = [(0, 0)]
            for t, (w, start, end) in enumerate(toks):
                ids[b, t + 1] = self.token_id(w)
                offs.append((start, end))
            ids[b, len(toks) + 1] = EOS_ID
            offs.append((0, 0))
            n = len(toks) + 2
            mask[b, :n] = True
            lengths[b] = n
            offsets.append(offs + [(0, 0)] * (max_len - len(offs)))
        return TokenBatch(ids, mask, offsets, lengths)


class HFTokenizer:
    """Adapter over a local HuggingFace fast tokenizer directory."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = self._tok.vocab_size

    def encode_batch(self, texts: Sequence[str], max_len: int = 256) -> TokenBatch:
        enc = self._tok(list(texts), padding="max_length", truncation=True, max_length=max_len,
                        return_offsets_mapping=True, return_tensors="np")
        offsets = [[tuple(pair) for pair in seq] for seq in enc["offset_mapping"].tolist()]
        mask = enc["attention_mask"].astype(bool)
        return TokenBatch(enc["input_ids"].astype(np.int32), mask, offsets,
                          mask.sum(-1).astype(np.int32))


def make_tokenizer(path: Optional[str] = None, vocab_size: int = 50265):
    """The best tokenizer for the directory ``path``: the byte-level BPE where
    it holds ``vocab.json`` + ``merges.txt`` or ``tokenizer.json``, else a
    HuggingFace tokenizer where ``transformers`` can read it, else
    ``SimpleTokenizer`` (which ``GroundingDataset.from_args`` refuses for real
    data)."""
    if path is not None:
        from eda_tpu_torch.data.bpe import load_bpe

        tok = load_bpe(path)
        if tok is not None:
            return tok
        try:
            return HFTokenizer(path)
        except Exception:  # noqa: BLE001 - transformers raises many types for an unusable dir
            pass
    return SimpleTokenizer(vocab_size)
