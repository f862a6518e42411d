"""The port's detection evaluation (``ops/oriented_boxes.py``, ``eval/nms.py``,
``eval/detection.py``, ``eval/det_branch.py``) against the JAX package's.

Host-side numpy on both sides, so everything is held exactly (``==`` on
floats, arrays bit for bit), on seeded random boxes and scores with exact
ties: scores rounded to one decimal (many equal values, so sort order and tie
order decide), duplicated boxes, boxes of zero extent, classes drawn from few
values. Covered: polygon clipping, areas, ``get_3d_box`` and ``box3d_iou``;
2D NMS (both overlap types), 3D NMS plain and class-aware;
``parse_predictions`` and ``parse_predictions_from_probs``;
``parse_groundtruths``; ``voc_ap``; ``APCalculator`` (per-class AP, recall,
mAP, AR, the GIoU accuracy); the token spans of the 18-class prompt with
``not mentioned`` under the hash tokenizer and the fabricated byte-level BPE;
``project_soft_tokens``; and ``evaluate_detection_batch`` from torch end
points against JAX's from the same arrays.
"""

import numpy as np
import pytest
import torch

import real_data_fixtures
from eda_tpu.data.detection_prompt import PROMPT_NAMES as JAX_PROMPT_NAMES
from eda_tpu.eval import det_branch as jax_det_branch
from eda_tpu.eval import detection as jax_detection
from eda_tpu.eval import nms as jax_nms
from eda_tpu.models.tokenizer import make_tokenizer as jax_make_tokenizer
from eda_tpu.ops import oriented_boxes as jax_oriented
from eda_tpu_torch.data.detection_prompt import PROMPT_NAMES
from eda_tpu_torch.data.tokenizer import make_tokenizer
from eda_tpu_torch.eval import det_branch, detection, nms
from eda_tpu_torch.ops import oriented_boxes

SEEDS = [0, 1, 2]
CAPTION = " . ".join(PROMPT_NAMES) + " . not mentioned"


def corner_boxes(rng, n: int, dims: int = 3) -> np.ndarray:
    """(n, 2 * dims) corner boxes, some duplicated and some of zero extent."""
    lo = np.round(rng.uniform(-2, 2, (n, dims)), 1)
    boxes = np.concatenate([lo, lo + np.round(rng.uniform(0, 1.5, (n, dims)), 1)], 1)
    boxes[n // 2] = boxes[0]
    return boxes.astype(np.float32)


def assert_same_detections(got, want):
    assert len(got) == len(want)
    for g_scene, w_scene in zip(got, want):
        assert len(g_scene) == len(w_scene)
        for g, w in zip(g_scene, w_scene):
            assert g[0] == w[0] and np.array_equal(g[1], w[1]) and g[2:] == w[2:]


@pytest.mark.parametrize("seed", SEEDS)
def test_oriented_boxes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        size, center = rng.uniform(0.2, 2, 3), rng.uniform(-1, 1, 3)
        heading = rng.choice([0.0, np.pi / 4, rng.uniform(-np.pi, np.pi)])
        a = oriented_boxes.get_3d_box(size, heading, center)
        assert np.array_equal(a, jax_oriented.get_3d_box(size, heading, center))
        b = jax_oriented.get_3d_box(rng.uniform(0.2, 2, 3), rng.uniform(-np.pi, np.pi),
                                    center + rng.uniform(-0.5, 0.5, 3))
        for other in (a, b):
            assert oriented_boxes.box3d_iou(a, other) == jax_oriented.box3d_iou(a, other)
        poly = oriented_boxes.polygon_clip(a[:4, :2], b[:4, :2][::-1])
        assert np.array_equal(poly, jax_oriented.polygon_clip(a[:4, :2], b[:4, :2][::-1]))
        assert oriented_boxes.polygon_area(poly) == jax_oriented.polygon_area(poly)
    assert oriented_boxes.polygon_area(np.zeros((2, 2))) == 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_nms_equals_jax(seed):
    rng = np.random.default_rng(seed)
    boxes3, boxes2 = corner_boxes(rng, 40), corner_boxes(rng, 40, dims=2)
    scores = np.round(rng.uniform(0, 1, 40), 1)  # many exact ties
    classes = rng.integers(0, 3, 40)
    for thresh in (0.0, 0.25, 0.5):
        for old_type in (False, True):
            got = nms.nms_2d(boxes2, scores, thresh, old_type)
            assert np.array_equal(got, jax_nms.nms_2d(boxes2, scores, thresh, old_type))
        for cls in (None, classes):
            got = nms.nms_3d(boxes3, scores, thresh, cls)
            want = jax_nms.nms_3d(boxes3, scores, thresh, cls)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(nms.nms_3d(boxes3[:0], scores[:0], 0.25)) == 0


def predictions(rng, B=3, Q=24, C=6):
    center = np.round(rng.uniform(-2, 2, (B, Q, 3)), 1).astype(np.float32)
    size = np.round(rng.uniform(-1, 1.5, (B, Q, 3)), 1).astype(np.float32)  # negatives: abs
    center[:, Q // 2] = center[:, 0]
    size[:, Q // 2] = size[:, 0]
    logits = np.round(rng.normal(size=(B, Q, C + 1)), 1).astype(np.float32)
    return center, size, logits


@pytest.mark.parametrize("seed", SEEDS)
def test_parse_predictions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    center, size, logits = predictions(rng)
    for kw in ({}, {"per_class_proposal": False}, {"conf_thresh": 0.5},
               {"num_classes": 4, "nms_iou": 0.1}):
        assert_same_detections(detection.parse_predictions(center, size, logits, **kw),
                               jax_detection.parse_predictions(center, size, logits, **kw))
    cls = np.round(rng.uniform(0, 1, (3, 24, 5)), 1).astype(np.float32)
    obj = np.round(rng.uniform(0, 1, (3, 24)), 1).astype(np.float32)
    for kw in ({}, {"per_class_proposal": False, "conf_thresh": 0.3}):
        assert_same_detections(
            detection.parse_predictions_from_probs(center, size, cls, obj, **kw),
            jax_detection.parse_predictions_from_probs(center, size, cls, obj, **kw))


@pytest.mark.parametrize("seed", SEEDS)
def test_voc_ap_and_ap_calculator_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(5):
        recall = np.sort(np.round(rng.uniform(0, 1, 12), 1))
        precision = np.round(rng.uniform(0, 1, 12), 1)
        assert detection.voc_ap(recall, precision) == jax_detection.voc_ap(recall, precision)
    calcs = {t: (detection.APCalculator(t), jax_detection.APCalculator(t)) for t in (0.25, 0.5)}
    for _ in range(4):  # batches
        center, size, logits = predictions(rng)
        preds = jax_detection.parse_predictions(center, size, logits)
        gt_boxes = np.concatenate([center[:, :8] + np.round(rng.uniform(-0.2, 0.2, (3, 8, 3)), 1),
                                   np.abs(size[:, :8]) + 0.1], -1)
        gt_classes = rng.integers(0, 7, (3, 8))
        gt_mask = rng.uniform(size=(3, 8)) < 0.7
        gts = detection.parse_groundtruths(gt_boxes, gt_classes, gt_mask)
        jax_gts = jax_detection.parse_groundtruths(gt_boxes, gt_classes, gt_mask)
        assert len(gts) == len(jax_gts) and all(
            [c for c, _ in g] == [c for c, _ in w] and all(
                np.array_equal(a, b) for (_, a), (_, b) in zip(g, w))
            for g, w in zip(gts, jax_gts))
        for port, ref in calcs.values():
            port.step(preds, gts)
            ref.step(preds, jax_gts)
    for port, ref in calcs.values():
        got, want = port.compute_metrics(), ref.compute_metrics()
        assert got == want and 0.0 < got["mAP"] < 1.0
        assert port.compute_accuracy() == ref.compute_accuracy()


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("bpe") / "roberta-base"
    real_data_fixtures.write_bpe_vocab(out, real_data_fixtures.fixture_corpus()
                                       + [CAPTION])
    return out


@pytest.mark.parametrize("tokenizer", ["hash", "bpe"])
def test_class_token_spans_and_projection_equal_jax(tokenizer, bpe_dir):
    assert PROMPT_NAMES == JAX_PROMPT_NAMES
    path = str(bpe_dir) if tokenizer == "bpe" else None
    tok = make_tokenizer(path).encode_batch([CAPTION], max_len=256)
    jax_tok = jax_make_tokenizer(path).encode_batch([CAPTION], max_len=256)
    assert type(make_tokenizer(path)).__name__ == ("BPETokenizer" if path else "SimpleTokenizer")
    spans = det_branch.class_token_spans(tok, 0, CAPTION)
    assert spans == jax_det_branch.class_token_spans(jax_tok, 0, CAPTION)
    assert len(spans) == 18 and all(spans)
    sem = np.round(np.random.default_rng(3).normal(size=(2, 16, 256)), 1).astype(np.float32)
    got = det_branch.project_soft_tokens(sem, spans)
    want = jax_det_branch.project_soft_tokens(sem, spans)
    assert all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want))


def test_evaluate_detection_batch_equals_jax():
    """Torch end points (bf16 scores included) and the numpy arrays JAX's
    branch reads from the same values give the same AP calculators."""
    rng = np.random.default_rng(7)
    center, size, _ = predictions(rng, B=2, Q=16)
    sem = torch.from_numpy(rng.normal(size=(2, 16, 256)).astype(np.float32)).bfloat16()
    ends = {"last_center": torch.from_numpy(center), "last_pred_size": torch.from_numpy(size),
            "last_sem_cls_scores": sem}
    jax_ends = {k: v.float().numpy() for k, v in ends.items()}
    targets = {"center_label": center[:, :4] + 0.05, "size_gts": np.abs(size[:, :4]) + 0.2,
               "box_label_mask": np.array([[1, 1, 1, 0], [1, 0, 0, 0]], np.float32)}
    gt_classes = rng.integers(0, 18, (2, 4))
    tok = make_tokenizer().encode_batch([CAPTION], max_len=256)
    jax_tok = jax_make_tokenizer().encode_batch([CAPTION], max_len=256)
    calcs = [detection.APCalculator(t) for t in (0.25, 0.5)]
    jax_calcs = [jax_detection.APCalculator(t) for t in (0.25, 0.5)]
    for valid in (None, np.array([True, False])):
        det_branch.evaluate_detection_batch(calcs, ends, targets, gt_classes, tok, CAPTION,
                                            valid=valid)
        jax_det_branch.evaluate_detection_batch(jax_calcs, jax_ends, targets, gt_classes,
                                                jax_tok, CAPTION, valid=valid)
    for c, j in zip(calcs, jax_calcs):
        assert c.compute_metrics() == j.compute_metrics()
