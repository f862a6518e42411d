"""RoBERTa's byte-level BPE with character offsets, in plain Python.

The port's own copy of ``eda_tpu/models/bpe.py``. It reads an HF-format
vocabulary (``vocab.json`` + ``merges.txt``, or ``tokenizer.json``) and gives
the ids, masks and character offsets of ``RobertaTokenizerFast``, with neither
``transformers`` nor ``tokenizers``:

* GPT-2's byte-to-unicode table (printable bytes map to themselves, the rest
  to U+0100 onwards, so a space is 'Ġ');
* GPT-2's pre-tokenizer: contractions, letter runs, number runs and runs of
  other characters, each with one optional leading space, then runs of white
  space;
* the lowest-rank-first merge loop per piece (memoized);
* offsets in characters of the original string (all byte tokens of a
  multi-byte character carry its span), each token's span trimmed past its
  leading and trailing 'Ġ', so that a token of spaces has an empty span and
  ``char_to_token`` of a space is None.

The JAX package splits text with the ``regex`` module's pattern
``_GPT2_PAT``, whose ``\\p{L}`` and ``\\p{N}`` Python's ``re`` lacks. This
module compiles the same pattern for ``re`` with those classes, and ``\\s``,
spelled out as code-point ranges (``data/unicode_classes.py``), so it splits
every string as ``regex`` does without importing it.
"""

from __future__ import annotations

import functools
import json
import os.path as osp
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from eda_tpu_torch.data.tokenizer import BOS_ID, EOS_ID, PAD_ID, TokenBatch
from eda_tpu_torch.data.unicode_classes import LETTER, NUMBER, SPACE

# The JAX package's pattern, for the regex module; ``pre_tokenizer`` is its
# translation for ``re``.
_GPT2_PAT = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


def _char_class(ranges) -> str:
    return "".join(re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                   for a, b in ranges)


@functools.lru_cache(maxsize=1)
def pre_tokenizer() -> re.Pattern:
    """``_GPT2_PAT`` for ``re``: ``\\p{L}``, ``\\p{N}`` and ``\\s`` as explicit
    classes, ``(?!\\S)`` as a lookahead for anything but white space."""
    letter, number, space = _char_class(LETTER), _char_class(NUMBER), _char_class(SPACE)
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{letter}]+| ?[{number}]+| ?[^{space}{letter}{number}]+"
        rf"|[{space}]+(?![^{space}])|[{space}]+"
    )


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> unicode character table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class BPETokenizer:
    """Byte-level BPE with RoBERTa's special tokens.

    ``encode_batch`` gives ``<s>`` + content + ``</s>``, padded with ``<pad>``
    to ``max_len`` and truncated content-first, as HF's
    ``padding="max_length", truncation=True``.
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        bos_token: str = "<s>",
        eos_token: str = "</s>",
        pad_token: str = "<pad>",
        unk_token: str = "<unk>",
    ):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.bos_id = self.encoder.get(bos_token, BOS_ID)
        self.eos_id = self.encoder.get(eos_token, EOS_ID)
        self.pad_id = self.encoder.get(pad_token, PAD_ID)
        self.unk_id = self.encoder.get(unk_token, 3)
        self.vocab_size = len(self.encoder)
        self._pat = pre_tokenizer()
        self._cache: Dict[str, Tuple[str, ...]] = {}

    @classmethod
    def from_pretrained(cls, path: str) -> "BPETokenizer":
        """From an HF-format directory: ``vocab.json`` + ``merges.txt`` (the
        roberta-base layout), or ``tokenizer.json``."""
        vj, mt = osp.join(path, "vocab.json"), osp.join(path, "merges.txt")
        if osp.isfile(vj) and osp.isfile(mt):
            with open(vj, encoding="utf-8") as f:
                vocab = json.load(f)
            merges: List[Tuple[str, str]] = []
            with open(mt, encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#version"):
                        continue
                    a, _, b = line.partition(" ")
                    merges.append((a, b))
            return cls(vocab, merges)
        tj = osp.join(path, "tokenizer.json")
        if osp.isfile(tj):
            with open(tj, encoding="utf-8") as f:
                blob = json.load(f)
            model = blob["model"]
            merges = [tuple(m) if isinstance(m, list) else tuple(m.split(" ", 1))
                      for m in model["merges"]]
            return cls(model["vocab"], merges)
        raise FileNotFoundError(f"no vocab.json+merges.txt or tokenizer.json under {path}")

    def _bpe(self, token: str) -> Tuple[str, ...]:
        """Fuse the lowest-ranked adjacent pair of one piece until none ranks."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if word[i] == a and i + 1 < len(word) and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        self._cache[token] = word
        return word

    def _encode_text(self, text: str) -> Tuple[List[int], List[Tuple[int, int]]]:
        """(ids, character offsets) of one text, without specials or truncation."""
        ids: List[int] = []
        offsets: List[Tuple[int, int]] = []
        be = self.byte_encoder
        for m in self._pat.finditer(text):
            piece = m.group()
            # the byte-level string, and each of its characters' source character
            chars: List[str] = []
            origin: List[int] = []
            for ci, ch in enumerate(piece, start=m.start()):
                for byte in ch.encode("utf-8"):
                    chars.append(be[byte])
                    origin.append(ci)
            pos = 0
            for tok in self._bpe("".join(chars)):
                n = len(tok)
                start = origin[pos]
                end = origin[pos + n - 1] + 1
                # trim past leading and trailing 'Ġ' (only the space byte
                # trims: tab 'ĉ' and newline 'Ċ' keep their spans)
                lead = 0
                while lead < n and tok[lead] == "Ġ":
                    lead += 1
                trail = 0
                while trail < n - lead and tok[n - 1 - trail] == "Ġ":
                    trail += 1
                if lead:
                    start = min(start + lead, end)
                if trail:
                    end = max(end - trail, start)
                ids.append(self.encoder.get(tok, self.unk_id))
                offsets.append((start, end))
                pos += n
        return ids, offsets

    def encode_batch(self, texts: Sequence[str], max_len: int = 256) -> TokenBatch:
        B = len(texts)
        ids = np.full((B, max_len), self.pad_id, np.int32)
        mask = np.zeros((B, max_len), bool)
        offsets: List[List[Tuple[int, int]]] = []
        lengths = np.zeros((B,), np.int32)
        for b, text in enumerate(texts):
            tids, toffs = self._encode_text(text)
            tids, toffs = tids[: max_len - 2], toffs[: max_len - 2]
            n = len(tids) + 2
            ids[b, 0] = self.bos_id
            ids[b, 1:n - 1] = tids
            ids[b, n - 1] = self.eos_id
            mask[b, :n] = True
            lengths[b] = n
            offs = [(0, 0)] + toffs + [(0, 0)]
            offs += [(0, 0)] * (max_len - len(offs))
            offsets.append(offs)
        return TokenBatch(ids, mask, offsets, lengths)


def load_bpe(path: str) -> Optional[BPETokenizer]:
    """``BPETokenizer.from_pretrained(path)``, or None where its files are missing or unreadable."""
    try:
        return BPETokenizer.from_pretrained(path)
    except (FileNotFoundError, KeyError, json.JSONDecodeError):
        return None
