"""Batched Hungarian matching on the device by the auction algorithm.

Counterpart of ``eda_tpu/losses/matcher.py``: a parallel (Jacobi) forward
auction in which targets bid for queries with increment ``best - second +
eps``; the highest bid per query wins (ties to the lowest target index) and
prices only rise. Same ``eps`` (1e-4), same cap (512 rounds), same tie rules
(``argmax`` picks the first maximum), same cost.

The stopping test depends on the data. The JAX package runs it inside a
``while_loop``; here the rounds run in groups of ``CHECK_EVERY`` and the host
reads the "any target unassigned" flag once per group. A round with no
unassigned target changes nothing, so the extra rounds of the last group
leave the result as it was. ``HOST_SYNCS`` counts those reads; a run sets it
to 0 before the work it wants to account for.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eda_tpu_torch.ops.boxes import generalized_box_iou_3d

NEG = -1e9
CHECK_EVERY = 8
HOST_SYNCS = 0


class MatchResult(NamedTuple):
    """Dense match. match_q (B, G): the query of each target (garbage where
    ``target_valid`` is False); target_valid (B, G); query_matched (B, Q);
    query_target (B, Q): the target of each query (garbage where not
    matched); iters (B,): auction rounds in which some target was unassigned."""

    match_q: torch.Tensor
    target_valid: torch.Tensor
    query_matched: torch.Tensor
    query_target: torch.Tensor
    iters: torch.Tensor


@torch.no_grad()
def auction_assign(cost: torch.Tensor, target_valid: torch.Tensor, eps: float = 1e-4,
                   max_iters: int = 512) -> MatchResult:
    """Minimize sum of cost[b, match_q[b, g], g] over one-to-one assignments.

    cost: (B, Q, G) f32, only columns with ``target_valid`` (B, G) count.
    """
    global HOST_SYNCS
    B, Q, G = cost.shape
    dev = cost.device
    value = -cost.transpose(1, 2).float()  # (B, G, Q), maximize
    value = torch.where(target_valid[:, :, None], value, torch.tensor(NEG, device=dev))
    owner = torch.full((B, Q), -1, dtype=torch.long, device=dev)
    prices = torch.zeros((B, Q), dtype=torch.float32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    targets = torch.arange(G, device=dev)
    queries = torch.arange(Q, device=dev)
    neg = torch.tensor(NEG, device=dev)

    def unassigned_of(owner):
        owned = (owner[:, :, None] == targets).any(1)  # (B, G)
        return target_valid & ~owned

    rounds = 0
    while rounds < max_iters:
        for _ in range(min(CHECK_EVERY, max_iters - rounds)):
            unassigned = unassigned_of(owner)
            iters = iters + unassigned.any().int()
            v = value - prices[:, None, :]
            w1, i1 = v.max(-1)  # first maximum, as argmax
            top = i1[:, :, None] == queries  # (B, G, Q)
            w2 = torch.where(top, neg, v).amax(-1)
            bids = prices.gather(1, i1) + (w1 - w2) + eps
            bid_mat = torch.where(top & unassigned[:, :, None], bids[:, :, None], neg)
            win_bid, win_t = bid_mat.max(1)  # ties -> lowest target index
            has_bid = win_bid > NEG / 2
            prices = torch.where(has_bid, win_bid, prices)
            owner = torch.where(has_bid, win_t, owner)
            rounds += 1
        HOST_SYNCS += 1
        if not bool(unassigned_of(owner).any()):
            break

    own = owner[:, :, None] == targets  # (B, Q, G)
    match_q = own.int().argmax(1)
    valid_pad = torch.cat([target_valid, target_valid.new_zeros(B, 1)], 1)
    query_matched = (owner >= 0) & valid_pad.gather(1, owner.clamp(0, G))
    return MatchResult(match_q.int(), target_valid, query_matched,
                       owner.clamp(0, G - 1).int(), iters.expand(B))


@torch.no_grad()
def hungarian_match(pred_logits, pred_boxes_xyzxyz, pred_boxes, gt_boxes, gt_boxes_xyzxyz,
                    positive_map, target_valid, cost_class: float = 1.0,
                    cost_bbox: float = 0.0, cost_giou: float = 2.0) -> MatchResult:
    """EDA matching cost and auction (``eda_tpu/losses/matcher.py:142-178``).

    cost = cost_class * (-softmax(logits) . positive_map)
         + cost_bbox * L1(pred, gt) + cost_giou * (-GIoU(pred, gt)),
    computed on detached predictions.
    """
    prob = torch.softmax(pred_logits.detach().float(), -1)
    c_class = -torch.einsum("bqc,bgc->bqg", prob, positive_map.float())
    c_giou = -generalized_box_iou_3d(pred_boxes_xyzxyz.detach().float(), gt_boxes_xyzxyz)
    cost = cost_class * c_class + cost_giou * c_giou
    if cost_bbox:
        c_bbox = (pred_boxes.detach()[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
        cost = cost + cost_bbox * c_bbox
    return auction_assign(cost, target_valid)
