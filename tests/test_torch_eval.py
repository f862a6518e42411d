"""The port's grounding scoring and evaluator vs ``eda_tpu.eval.grounding``.

Both get the same seeded numpy end points and targets. Predicted boxes sit
near the GT root box, so IoUs are large and differ from rank to rank. Query 3
copies query 0 (an exact score tie, decided lowest index first), and under
the ``__det_boxes`` filter every prediction that overlaps no detected box
scores exactly 0, negative scores included: +0 in the jitted reference, whose
``scores * is_correct`` XLA compiles to a select (eager JAX would give -0,
which ``lax.top_k`` ranks below +0).

Tolerances: IoU stacks within 1e-6 absolute (f32 scores summed in other
orders rank alike here: the smallest gap between distinct scores is far above
their rounding); counters, accuracies and the printout exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_tpu.eval import grounding as jax_eval
from eda_tpu_torch.eval import grounding as port_eval
from eda_tpu_torch.eval.grounding import GroundingEvaluator

PREFIXES = ("last_", "proposal_")
MODES = ("bbs", "bbf")
MAPS = ("positive_map", "modify_positive_map", "pron_positive_map", "rel_positive_map",
        "other_entity_map")


def _batch(seed, B=4, Q=12, C=32, L=16, n_obj=3, D=5):
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    gt_center = rng.uniform(-2, 2, (B, n_obj, 3))
    gt_size = rng.uniform(0.3, 1.5, (B, n_obj, 3))
    ends = {"proj_tokens": f32(rng.normal(size=(B, L, 8)))}
    for p in PREFIXES:
        ends[p + "center"] = f32(gt_center[:, :1] + rng.normal(scale=0.3, size=(B, Q, 3)))
        ends[p + "pred_size"] = f32(gt_size[:, :1] * rng.uniform(0.6, 1.4, (B, Q, 3)))
        ends[p + "sem_cls_scores"] = f32(rng.normal(scale=2, size=(B, Q, C)))
        q = rng.normal(size=(B, Q, 8))
        ends[p + "proj_queries"] = f32(q / np.linalg.norm(q, axis=-1, keepdims=True))
        for key in (p + "center", p + "pred_size", p + "sem_cls_scores", p + "proj_queries"):
            ends[key][:, 3] = ends[key][:, 0]  # an exact tie
    targets = {"center_label": f32(gt_center), "size_gts": f32(gt_size)}
    for key in MAPS:
        m = rng.uniform(0, 1, (B, n_obj, C)) * (rng.uniform(size=(B, n_obj, C)) < 0.3)
        targets[key] = f32(m * (4.0 if key == "other_entity_map" else 1.0))
    # detected boxes: near some of the predictions, and elsewhere
    det = np.concatenate([gt_center[:, :1] + rng.normal(scale=0.8, size=(B, D, 3)),
                          rng.uniform(0.3, 1.0, (B, D, 3))], -1)
    for d, q in enumerate((1, 4, 5)):
        det[:, d, :3] = ends["last_center"][:, q] + rng.normal(scale=0.05, size=(B, 3))
        det[:, d, 3:] = ends["last_pred_size"][:, q]
    inputs = {"det_boxes": f32(det), "det_mask": rng.uniform(size=(B, D)) < 0.7}
    hardness = {k: rng.uniform(size=B) < 0.5 for k in ("is_view_dep", "is_hard", "is_unique")}
    return ends, targets, inputs, hardness


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _filtered(targets, inputs):
    return {**targets, "__det_boxes": inputs["det_boxes"], "__det_mask": inputs["det_mask"]}


@pytest.mark.parametrize("Q", [12, 6])
@pytest.mark.parametrize("det_filter", [False, True], ids=["plain", "det_filter"])
def test_score_and_iou_multi_matches_jax(Q, det_filter):
    ends, plain_targets, inputs, _ = _batch(Q + det_filter, Q=Q)
    targets = _filtered(plain_targets, inputs) if det_filter else plain_targets
    want = np.asarray(jax_eval._score_and_iou_multi(
        {k: jnp.asarray(v) for k, v in ends.items()},
        {k: jnp.asarray(v) for k, v in targets.items()}, prefixes=PREFIXES, modes=MODES))
    got = port_eval.score_and_iou_multi(_torch(ends), _torch(targets), prefixes=PREFIXES,
                                        modes=MODES).numpy()
    assert got.shape == want.shape == (2, 2, 4, 10)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (want > 0.25).any(), "IoUs must be large enough to count"
    if Q < 10:
        assert (want[..., Q:] == 0).all()
    if det_filter:
        plain, _ = port_eval.grounding_scores(_torch(ends), _torch(plain_targets),
                                              prefix="last_", mode="bbs")
        scores, _ = port_eval.grounding_scores(_torch(ends), _torch(targets), prefix="last_",
                                               mode="bbs")
        assert ((scores == 0) & (plain < 0)).any(), "negative scores must be filtered too"
        assert (scores == 0).any() and (scores > 0).any()
        assert not torch.signbit(scores[scores == 0]).any()


def test_evaluator_matches_jax():
    """Counters of several batches (``valid``, ``hardness``, precomputed
    ``ious`` and end points under the det filter), ``merge``, ``accuracy`` and
    ``print_stats``, all equal."""
    kw = dict(prefixes=PREFIXES, filter_non_gt_boxes=True)
    port_a, port_b = GroundingEvaluator(**kw), GroundingEvaluator(**kw)
    jax_a, jax_b = jax_eval.GroundingEvaluator(**kw), jax_eval.GroundingEvaluator(**kw)
    for seed in range(4):
        ends, targets, inputs, hardness = _batch(10 + seed)
        valid = np.array([True, True, seed % 2 == 0, True])
        port, ref = (port_a, jax_a) if seed < 2 else (port_b, jax_b)
        if seed % 2:  # end points, scored inside evaluate (det filter from the inputs)
            ref.evaluate({k: jnp.asarray(v) for k, v in ends.items()},
                         {k: jnp.asarray(v) for k, v in targets.items()}, hardness,
                         valid=valid, inputs={k: jnp.asarray(v) for k, v in inputs.items()})
            port.evaluate(_torch(ends), _torch(targets), hardness, valid=valid,
                          inputs=_torch(inputs))
        else:  # a precomputed IoU stack, as the fused score step gives it
            ious = port_eval.score_and_iou_multi(_torch(ends), _torch(targets),
                                                 prefixes=PREFIXES, modes=MODES)
            ref.evaluate(None, None, hardness, valid=valid, ious=ious.numpy())
            port.evaluate(None, None, hardness, valid=valid, ious=ious)
    assert port_a.dets == jax_a.dets and port_a.gts == jax_a.gts
    port_a.merge(port_b)
    jax_a.merge(jax_b)
    assert port_a.dets == jax_a.dets and port_a.gts == jax_a.gts
    assert 0 < port_a.gts["vd"] and 0 < sum(v for k, v in port_a.dets.items() if k[0] == "last_")
    for t in (0.25, 0.5):
        for k in (1, 5, 10):
            for mode in MODES:
                assert port_a.accuracy("last_", t, k, mode) == jax_a.accuracy("last_", t, k, mode)
    assert port_a.print_stats() == jax_a.print_stats()
    assert port_eval.TEMPERATURE == jax_eval.TEMPERATURE
