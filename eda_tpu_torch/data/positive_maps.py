"""Character spans -> token-level positive maps.

The port's own copy of ``eda_tpu/data/positive_maps.py``: each span becomes a
row over ``MAX_TOKENS`` token positions normalized to mass 1, with the
+1/+2 (begin) and -1/-2 (end) character fallbacks when a span boundary lands
on whitespace; a component's map is the sum of its spans' rows.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from eda_tpu_torch.data.tokenizer import TokenBatch

MAX_TOKENS = 256

Span = Tuple[int, int]


def _char_to_token_with_fallback(batch: TokenBatch, b: int, char_idx: int, probes):
    for delta in probes:
        tok = batch.char_to_token(b, char_idx + delta)
        if tok is not None:
            return tok
    return None


def spans_to_map(batch: TokenBatch, b: int, spans: Sequence[Span]) -> np.ndarray:
    """Sum of per-span row-normalized (MAX_TOKENS,) maps; unresolvable spans add nothing."""
    out = np.zeros((MAX_TOKENS,), np.float32)
    for start, end in spans:
        if end <= start:
            continue
        beg_tok = _char_to_token_with_fallback(batch, b, start, (0, 1, 2))
        end_tok = _char_to_token_with_fallback(batch, b, end - 1, (0, -1, -2))
        if beg_tok is None or end_tok is None or end_tok < beg_tok:
            continue
        row = np.zeros((MAX_TOKENS,), np.float32)
        row[beg_tok : end_tok + 1] = 1.0
        out += row / (row.sum() + 1e-12)
    return out


def build_positive_maps(batch: TokenBatch, b: int, decoupled: dict) -> dict:
    """The maps of one caption, keyed main/modifiers/pronouns/relations/others/auxi."""
    return {
        key: spans_to_map(batch, b, decoupled[key])
        for key in ("main", "modifiers", "pronouns", "relations", "others", "auxi")
    }


def not_mentioned_suffix(utterance: str) -> str:
    """Append the ' . not mentioned' tail every caption carries."""
    return utterance.rstrip() + " . not mentioned"
