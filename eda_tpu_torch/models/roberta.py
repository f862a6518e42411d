"""RoBERTa-architecture text encoder (counterpart of ``eda_tpu/models/roberta.py``).

Learned word and position embeddings, post-LN transformer blocks, exact-GELU
FFN, all in f32. Position ids are ``arange(L) + 2`` (after RoBERTa's padding
id), and attention masks the padding keys only. ``fused_qkv`` computes each
layer's q, k and v as one (hidden, 3 hidden) product of the same parameters.
With ``tp`` (a mesh, ``parallel.shard_params``) a layer runs its share of the
heads and of the intermediate units (``intermediate`` column-, ``output``
row-parallel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eda_tpu_torch.models.layers import Dense, MultiHeadAttention, row_parallel
from eda_tpu_torch.parallel.mesh import copy_to_model

LAYER_NORM_EPS = 1e-5  # roberta-base config
PAD_TOKEN_ID = 1


class RobertaEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden: int, max_len: int = 514):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden)
        self.position_embeddings = nn.Embedding(max_len, hidden)
        self.layer_norm = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device) + PAD_TOKEN_ID + 1
        h = self.word_embeddings(input_ids.long()) + self.position_embeddings(positions)[None]
        return self.layer_norm(h)


class RobertaLayer(nn.Module):
    tp = None

    def __init__(self, hidden: int, heads: int, intermediate: int, fused_qkv: bool = False):
        super().__init__()
        self.attention = MultiHeadAttention(hidden, heads, fuse=fused_qkv)
        self.attention_norm = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)
        self.intermediate = Dense(hidden, intermediate)
        self.output = Dense(intermediate, hidden)
        self.output_norm = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)

    def forward(self, h: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        h = self.attention_norm(h + self.attention(h, h, h, valid))
        if self.tp is None:
            f = self.output(F.gelu(self.intermediate(h), approximate="none"))
        else:
            (hs,) = copy_to_model(self.tp, h)
            f = row_parallel(self.output, F.gelu(self.intermediate(hs), approximate="none"),
                             self.tp)
        return self.output_norm(h + f)


class RobertaEncoder(nn.Module):
    """Token ids (B, L) and validity mask (B, L) -> last hidden state (B, L, hidden)."""

    def __init__(self, vocab_size: int = 50265, hidden: int = 768, num_layers: int = 12,
                 heads: int = 12, intermediate: int = 3072, fused_qkv: bool = False):
        super().__init__()
        self.embeddings = RobertaEmbeddings(vocab_size, hidden)
        self.layer = nn.ModuleList(
            [RobertaLayer(hidden, heads, intermediate, fused_qkv) for _ in range(num_layers)]
        )

    def forward(self, input_ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        h = self.embeddings(input_ids)
        for layer in self.layer:
            h = layer(h, valid)
        return h
