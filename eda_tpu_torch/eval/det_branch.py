"""ScanNet detection evaluation branch (the port's copy of ``eda_tpu/eval/det_branch.py``).

Run the grounder on the fixed 18-class detection prompt, project each query's
soft-token scores onto the token spans of the class names (the reference's
wordidx / tokenidx tables, ``train_dist_mod.py:248-279``), then class-aware
NMS and VOC AP (``eval/detection.py``). The end points are read from the
device with ``.float().cpu().numpy()``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from eda_tpu_torch.data.detection_prompt import PROMPT_NAMES
from eda_tpu_torch.data.tokenizer import TokenBatch
from eda_tpu_torch.eval.detection import (
    APCalculator,
    parse_groundtruths,
    parse_predictions_from_probs,
)


def class_token_spans(
    batch: TokenBatch, b: int, caption: str, names: Sequence[str] = PROMPT_NAMES
) -> List[List[int]]:
    """Token indices of each class name inside the detection prompt."""
    padded = " " + caption + " "
    spans: List[List[int]] = []
    for name in names:
        start = padded.find(" " + name + " ")
        toks: List[int] = []
        if start >= 0:
            for offset in range(len(name)):
                t = batch.char_to_token(b, start + offset)
                if t is not None and t not in toks:
                    toks.append(t)
        spans.append(toks)
    return spans


def project_soft_tokens(
    sem_cls_scores: np.ndarray, spans: List[List[int]]
) -> Tuple[np.ndarray, np.ndarray]:
    """Soft-token scores (B, Q, 256) -> (class_probs (B, Q, 18), obj (B, Q)).

    objectness = 1 - P(not mentioned) with 'not mentioned' the final token
    slot (``models/ap_helper.py:146-150``); class prob = summed probability
    over the class-name token positions, renormalized by objectness.
    """
    x = sem_cls_scores - sem_cls_scores.max(-1, keepdims=True)
    probs = np.exp(x)
    probs /= probs.sum(-1, keepdims=True)
    obj = 1.0 - probs[..., -1]
    cls = np.zeros(probs.shape[:2] + (len(spans),), np.float32)
    for c, toks in enumerate(spans):
        if toks:
            cls[..., c] = probs[..., toks].sum(-1)
    cls /= np.maximum(obj[..., None], 1e-9)
    return cls, obj


def _host(x) -> np.ndarray:
    return x.float().cpu().numpy()


def evaluate_detection_batch(
    calc: "APCalculator | list[APCalculator]",
    end_points: Dict,
    targets: Dict,
    gt_classes: np.ndarray,
    token_batch: TokenBatch,
    caption: str,
    prefix: str = "last_",
    valid: np.ndarray = None,
):
    """Accumulate one batch into the APCalculator(s).

    ``calc`` may be a single APCalculator or a list (one per IoU threshold,
    like the reference's ap_calculator_list, train_dist_mod.py:234-241 —
    predictions are parsed once and stepped into each). ``end_points`` are
    the model's tensors, ``targets`` numpy arrays. ``valid`` (B,) bool marks
    real rows; padded tail rows are dropped before scoring.
    """
    sem = _host(end_points[f"{prefix}sem_cls_scores"])
    spans = class_token_spans(token_batch, 0, caption)
    cls_probs, obj = project_soft_tokens(sem, spans)
    preds = parse_predictions_from_probs(
        _host(end_points[f"{prefix}center"]),
        _host(end_points[f"{prefix}pred_size"]),
        cls_probs,
        obj,
    )
    gt_boxes = np.concatenate(
        [np.asarray(targets["center_label"]), np.asarray(targets["size_gts"])],
        -1,
    )
    gts = parse_groundtruths(
        gt_boxes, gt_classes, np.asarray(targets["box_label_mask"]) > 0
    )
    if valid is not None:
        preds = [p for p, v in zip(preds, valid) if v]
        gts = [g for g, v in zip(gts, valid) if v]
    for c in (calc if isinstance(calc, (list, tuple)) else [calc]):
        c.step(preds, gts)
