"""Cross-modal transformer layers, position embeddings and prediction heads.

Counterparts of ``eda_tpu/models/layers.py`` (the detected-box branch waits).
Conventions kept from the JAX package:

* batch-first ``(B, L, F)`` throughout;
* masks are validity masks: True = real token;
* post-norm residual blocks;
* each module computes in the dtype it was declared with: a ``Dense`` with
  ``dtype=bfloat16`` casts its input, kernel and bias to bf16 and returns bf16
  (as flax's ``Dense(dtype=...)`` does), while the parameters stay f32;
* LayerNorm epsilons are explicit: 1e-6 in the residual blocks (flax's
  default), 1e-12 for the text projector, 1e-5 in RoBERTa.

The modules are the serving forward: dropout is off and BatchNorm uses its
running statistics.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
ATTN_LN_EPS = 1e-6  # flax nn.LayerNorm default


class Dense(nn.Module):
    """``y = x @ W^T + b`` computed in ``dtype`` (flax ``Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class BatchNorm(nn.Module):
    """Inference BatchNorm over the last axis, in f32, with running statistics."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x.float() - self.running_mean) * mul + self.bias


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` with a key validity mask."""

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_heads = n_heads
        self.dtype = dtype
        self.query = Dense(d_model, d_model, dtype=dtype)
        self.key = Dense(d_model, d_model, dtype=dtype)
        self.value = Dense(d_model, d_model, dtype=dtype)
        self.out = Dense(d_model, d_model, dtype=dtype)

    def forward(self, q, k, v, key_valid: Optional[torch.Tensor] = None):
        B, Lq, d = q.shape
        h = self.n_heads
        dh = d // h
        qh = self.query(q).view(B, Lq, h, dh).transpose(1, 2)
        kh = self.key(k).view(B, k.shape[1], h, dh).transpose(1, 2)
        vh = self.value(v).view(B, v.shape[1], h, dh).transpose(1, 2)
        # flax divides the queries by sqrt(depth) in the compute dtype
        qh = qh / torch.tensor(math.sqrt(dh), dtype=torch.float32).to(self.dtype)
        mask = None if key_valid is None else key_valid[:, None, None, :].bool()
        x = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=1.0)
        return self.out(x.transpose(1, 2).reshape(B, Lq, d))


class ResidualAttn(nn.Module):
    """``LayerNorm(x + attn(q, k, v))`` with ``q = x + q_pos``.

    ``k=None`` means the keys are the queries (position embedding on both).
    """

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype):
        super().__init__()
        self.attn = MultiHeadAttention(d_model, n_heads, dtype)
        self.norm = nn.LayerNorm(d_model, eps=ATTN_LN_EPS)

    def forward(self, x, k, v, valid, q_pos=None):
        q = x if q_pos is None else x + q_pos
        k = q if k is None else k
        v = k if v is None else v
        return self.norm(x + self.attn(q, k, v, valid))


class FFN(nn.Module):
    """``LayerNorm(x + Dense(relu(Dense(x))))``."""

    def __init__(self, d_model: int, dim_feedforward: int, dtype: torch.dtype):
        super().__init__()
        self.dense = nn.ModuleList([
            Dense(d_model, dim_feedforward, dtype=dtype),
            Dense(dim_feedforward, d_model, dtype=dtype),
        ])
        self.norm = nn.LayerNorm(d_model, eps=ATTN_LN_EPS)

    def forward(self, x):
        return self.norm(x + self.dense[1](torch.relu(self.dense[0](x))))


class PositionEmbeddingLearned(nn.Module):
    """Dense + BN + ReLU + Dense over xyz (3) or xyz+size (6) coordinates."""

    def __init__(self, in_dim: int, num_pos_feats: int, dtype: torch.dtype):
        super().__init__()
        self.dense = nn.ModuleList([
            Dense(in_dim, num_pos_feats, dtype=dtype),
            Dense(num_pos_feats, num_pos_feats, dtype=dtype),
        ])
        self.bn = nn.ModuleList([BatchNorm(num_pos_feats)])

    def forward(self, coords):
        return self.dense[1](torch.relu(self.bn[0](self.dense[0](coords))))


class BiEncoderLayer(nn.Module):
    """Self-attention per modality, then bidirectional cross-attention.

    Vision self-attention (position embedding on q and k), language
    self-attention, then lang->vis attention + FFN and vis->lang attention
    + FFN, where both directions read the other modality's pre-cross features.
    """

    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int,
                 self_attend: bool, dtype: torch.dtype):
        super().__init__()
        self.self_attend = self_attend
        if self_attend:
            self.self_vis = ResidualAttn(d_model, n_heads, dtype)
            self.self_lang = ResidualAttn(d_model, n_heads, dtype)
        self.cross_lv = ResidualAttn(d_model, n_heads, dtype)
        self.ffn_lv = FFN(d_model, dim_feedforward, dtype)
        self.cross_vl = ResidualAttn(d_model, n_heads, dtype)
        self.ffn_vl = FFN(d_model, dim_feedforward, dtype)

    def forward(self, vis_feats, pos_feats, vis_valid, text_feats, text_valid):
        if self.self_attend:
            vis_feats = self.self_vis(vis_feats, None, vis_feats, vis_valid, q_pos=pos_feats)
            text_feats = self.self_lang(text_feats, text_feats, text_feats, text_valid)
        text_kv = text_feats
        text_feats = self.ffn_lv(self.cross_lv(text_feats, vis_feats, vis_feats, vis_valid))
        vis_feats = self.cross_vl(vis_feats, text_kv, text_kv, text_valid, q_pos=pos_feats)
        return self.ffn_vl(vis_feats), text_feats


class BiDecoderLayer(nn.Module):
    """Query self-attention -> cross(text) -> cross(vision) -> FFN.

    The learned embedding of the query location is added to q (and to k in
    self-attention) at every attention call.
    """

    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int,
                 self_position_embedding: str, dtype: torch.dtype):
        super().__init__()
        loc_dim = {"xyz_learned": 3, "loc_learned": 6}.get(self_position_embedding)
        if loc_dim is not None:
            self.self_posembed = PositionEmbeddingLearned(loc_dim, d_model, dtype)
        self.self_attn = ResidualAttn(d_model, n_heads, dtype)
        self.cross_l = ResidualAttn(d_model, n_heads, dtype)
        self.cross_v = ResidualAttn(d_model, n_heads, dtype)
        self.ffn = FFN(d_model, dim_feedforward, dtype)

    def forward(self, query, vis_feats, text_feats, query_loc, text_valid):
        q_pos = self.self_posembed(query_loc) if hasattr(self, "self_posembed") else None
        query = self.self_attn(query, None, query, None, q_pos=q_pos)
        query = self.cross_l(query, text_feats, text_feats, text_valid, q_pos=q_pos)
        query = self.cross_v(query, vis_feats, vis_feats, None, q_pos=q_pos)
        return self.ffn(query)


class PointsObjClsModule(nn.Module):
    """Seed objectness head: (Dense + BN + ReLU) x 2 + Dense(1), f32 logits (B, K)."""

    def __init__(self, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.dense = nn.ModuleList([
            Dense(d_model, d_model, dtype=dtype),
            Dense(d_model, d_model, dtype=dtype),
            Dense(d_model, 1, dtype=torch.float32),
        ])
        self.bn = nn.ModuleList([BatchNorm(d_model), BatchNorm(d_model)])

    def forward(self, x):
        for dense, bn in zip(self.dense[:2], self.bn):
            x = torch.relu(bn(dense(x)))
        return self.dense[2](x)[..., 0]


class ThreeLayerMLP(nn.Module):
    """(Dense without bias + BN + ReLU) x 2 + Dense(out) in f32."""

    def __init__(self, dim: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dense = nn.ModuleList([
            Dense(dim, dim, bias=False, dtype=dtype),
            Dense(dim, dim, bias=False, dtype=dtype),
            Dense(dim, out_dim, dtype=torch.float32),
        ])
        self.bn = nn.ModuleList([BatchNorm(dim), BatchNorm(dim)])

    def forward(self, x):
        for dense, bn in zip(self.dense[:2], self.bn):
            x = torch.relu(bn(dense(x)))
        return self.dense[2](x)


class ClsAgnosticPredictHead(nn.Module):
    """Center, size and soft-token class heads: (base_xyz + residual, size, sem_cls)."""

    def __init__(self, num_class: int, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.center_head = ThreeLayerMLP(d_model, 3, dtype)
        self.size_head = ThreeLayerMLP(d_model, 3, dtype)
        self.sem_cls_head = ThreeLayerMLP(d_model, num_class, dtype)

    def forward(self, features, base_xyz):
        return (
            base_xyz + self.center_head(features),
            self.size_head(features),
            self.sem_cls_head(features),
        )


class ContrastiveProjection(nn.Module):
    """Three-layer MLP into the shared contrastive space, L2-normalized."""

    def __init__(self, d_model: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dense = nn.ModuleList([
            Dense(d_model, d_model, dtype=dtype),
            Dense(d_model, d_model, dtype=dtype),
            Dense(d_model, out_dim, dtype=torch.float32),
        ])

    def forward(self, x):
        h = torch.relu(self.dense[1](torch.relu(self.dense[0](x))))
        h = self.dense[2](h)
        return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-12)


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's default kernel init: truncated normal with variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)
