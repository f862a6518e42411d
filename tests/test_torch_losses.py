"""Port boxes, matcher and criterion vs the JAX package, on identical f32 inputs.

* box conversion, pairwise IoU and GIoU, degenerate boxes included: rtol 1e-5;
* the auction: identical assignments, on costs with many exact ties (lowest
  target index per query, first argmax), and through the full matching cost;
* ``compute_hungarian_loss`` on identical ``end_points`` and targets: every
  metric rtol 1e-5, and its gradient with respect to every end point rtol
  1e-4 of the leaf's largest value (f32 throughout; the sums run in another
  order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_tpu.losses import criterion as jax_criterion
from eda_tpu.losses import matcher as jax_matcher
from eda_tpu.ops import boxes as jax_boxes
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.losses import criterion as port_criterion
from eda_tpu_torch.losses import matcher as port_matcher
from eda_tpu_torch.models.grounder import decoder_prefixes
from eda_tpu_torch.ops import boxes as port_boxes

T = torch.from_numpy


def _boxes(rng, shape):
    b = np.concatenate([rng.uniform(-2, 2, shape + (3,)), rng.uniform(0, 1.5, shape + (3,))], -1)
    b[..., 0, 3:] = 0.0  # a degenerate box in every row
    return b.astype(np.float32)


def test_boxes_match_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, (3, 7)), _boxes(rng, (3, 5))
    xa, xb = jax_boxes.box_cxcyczwhd_to_xyzxyz(a), jax_boxes.box_cxcyczwhd_to_xyzxyz(b)
    pa, pb = port_boxes.box_cxcyczwhd_to_xyzxyz(T(a)), port_boxes.box_cxcyczwhd_to_xyzxyz(T(b))
    np.testing.assert_allclose(pa.numpy(), np.asarray(xa), rtol=1e-5, atol=1e-7)
    iou_j, union_j = jax_boxes.pairwise_box_iou_3d(xa, xb)
    iou_p, union_p = port_boxes.pairwise_box_iou_3d(pa, pb)
    np.testing.assert_allclose(iou_p.numpy(), np.asarray(iou_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(union_p.numpy(), np.asarray(union_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port_boxes.generalized_box_iou_3d(pa, pb).numpy(),
                               np.asarray(jax_boxes.generalized_box_iou_3d(xa, xb)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,decimals", [(0, 1), (1, 0), (2, 4)])
def test_auction_matches_jax_with_ties(seed, decimals):
    rng = np.random.default_rng(seed)
    B, Q, G = 3, 32, 6
    cost = np.round(rng.normal(size=(B, Q, G)), decimals).astype(np.float32)
    valid = rng.uniform(size=(B, G)) < 0.7
    valid[:, 0] = True
    want = jax_matcher.auction_assign(jnp.asarray(cost), jnp.asarray(valid))
    got = port_matcher.auction_assign(T(cost), T(valid))
    np.testing.assert_array_equal(got.query_matched.numpy(), np.asarray(want.query_matched))
    np.testing.assert_array_equal(np.where(valid, got.match_q.numpy(), -1),
                                  np.where(valid, np.asarray(want.match_q), -1))
    matched = np.asarray(want.query_matched)
    np.testing.assert_array_equal(got.query_target.numpy()[matched],
                                  np.asarray(want.query_target)[matched])
    assert int(got.iters[0]) == int(want.iters)


def test_auction_checks_the_host_once_per_group_of_rounds():
    cost = np.random.default_rng(3).normal(size=(2, 16, 4)).astype(np.float32)
    valid = np.ones((2, 4), bool)
    port_matcher.HOST_SYNCS = 0
    got = port_matcher.auction_assign(T(cost), T(valid))
    rounds = int(got.iters[0])
    assert port_matcher.HOST_SYNCS == -(-rounds // port_matcher.CHECK_EVERY)


def _loss_inputs(seed=0, B=2, K=64, Q=16, C=256, D=16, L=16, layers=2):
    rng = np.random.default_rng(seed)
    batch = SyntheticScenes(SyntheticConfig(num_points=512, num_objects=4, text_len=L),
                            vocab_size=512).train_batch(range(B))
    targets = batch["targets"]
    xyz = batch["inputs"]["point_clouds"][..., :3]
    seed_inds = np.stack([np.sort(rng.permutation(512)[:K]) for _ in range(B)]).astype(np.int32)
    ep = {
        "seed_inds": seed_inds,
        "seed_xyz": np.take_along_axis(xyz, seed_inds[..., None].astype(np.int64), 1),
        "seeds_obj_cls_logits": rng.normal(size=(B, K)).astype(np.float32),
        "proj_tokens": rng.normal(size=(B, L, D)).astype(np.float32),
    }
    for p in decoder_prefixes(layers):
        ep[f"{p}center"] = rng.uniform(-2, 2, (B, Q, 3)).astype(np.float32)
        ep[f"{p}pred_size"] = rng.uniform(0.1, 1.2, (B, Q, 3)).astype(np.float32)
        ep[f"{p}sem_cls_scores"] = rng.normal(size=(B, Q, C)).astype(np.float32)
        proj = rng.normal(size=(B, Q, D)).astype(np.float32)
        ep[f"{p}proj_queries"] = proj / np.linalg.norm(proj, axis=-1, keepdims=True)
    ep["proj_tokens"] /= np.linalg.norm(ep["proj_tokens"], axis=-1, keepdims=True)
    return ep, targets


def test_hungarian_match_cost_matches_jax():
    ep, targets = _loss_inputs(seed=4)
    gt = np.concatenate([targets["center_label"], targets["size_gts"]], -1)
    boxes = np.concatenate([ep["last_center"], ep["last_pred_size"]], -1)
    args = [ep["last_sem_cls_scores"], None, boxes, gt, None,
            targets["positive_map"], targets["box_label_mask"] > 0]
    for conv, mod, wrap in ((jax_boxes.box_cxcyczwhd_to_xyzxyz, jax_matcher, jnp.asarray),
                            (port_boxes.box_cxcyczwhd_to_xyzxyz, port_matcher, T)):
        a = [wrap(v) if v is not None else None for v in args]
        a[1], a[4] = conv(a[2]), conv(a[3])
        res = mod.hungarian_match(*a, cost_bbox=0.5)
        if mod is jax_matcher:
            want = res
        else:
            got = res
    np.testing.assert_array_equal(got.match_q.numpy()[:, 0], np.asarray(want.match_q)[:, 0])
    np.testing.assert_array_equal(got.query_matched.numpy(), np.asarray(want.query_matched))


def test_criterion_matches_jax():
    ep, targets = _loss_inputs()
    float_keys = [k for k, v in ep.items() if v.dtype == np.float32]
    jcfg = jax_criterion.SetCriterionConfig(num_decoder_layers=2)
    pcfg = port_criterion.SetCriterionConfig(num_decoder_layers=2)

    def jax_loss(floats):
        loss, metrics = jax_criterion.compute_hungarian_loss(
            jcfg, {**ep, **floats}, jax.tree_util.tree_map(jnp.asarray, targets))
        return loss, metrics

    (_, want), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        {k: jnp.asarray(ep[k]) for k in float_keys})
    floats = {k: T(ep[k]).requires_grad_() for k in float_keys}
    loss, got = port_criterion.compute_hungarian_loss(
        pcfg, {**{k: T(v) for k, v in ep.items()}, **floats},
        {k: T(np.asarray(v)) for k, v in targets.items()})
    loss.backward()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    for key in float_keys:
        g = floats[key].grad  # None where no path leads (seed_xyz only picks the top k)
        g = np.zeros_like(ep[key]) if g is None else g.numpy()
        w = np.asarray(grads[key])
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-9, key
