"""The whole slice: the port's EDAGrounder vs the JAX grounder, serving forward.

``ModelConfig(use_bf16=True).tiny()``, synthetic scenes, the JAX model's own
(perturbed) weights carried over with ``weights.load_flax``, eval mode. The JAX
side runs its TPU serving path with every Pallas kernel interpreted
(``jax_tpu_serving_path``), so both sides use the same 16-center windows.

KPS runs with the config's own ``num_queries`` (tiny: 32 of 128 seeds), and
both models must select the same set of seeds. The port's attention rounds
where flax's bf16 attention rounds (the core is bit-identical), but the
backbone's bf16 MLPs still differ by a few bf16 steps (``fp2_features``
within 0.05), which moves the objectness logits by up to ~0.008. Scene 1 has
near-ties below that: seeds 12 and 14 have JAX logits -0.52539 and -0.52587
(gap 4.8e-4), and seeds 54, 56, 60, 70 lie within 3.8e-3 of each other, so
the port orders those queries differently. The test therefore holds the
port's order against the JAX logits (descending within ``LOGIT_ATOL``) and
compares the per-query outputs after aligning the port's queries to the JAX
order by seed index. The decoder is equivariant under a permutation of its
queries, so aligned outputs must agree. KPS's selection and tie order are
checked against ``lax.top_k`` below.

Tolerances, all absolute: the backbone as in ``test_torch_backbone.py``;
after it, 0.03 for centers, sizes and class scores (magnitude up to ~3.5,
measured max 0.014), 0.02 for the unit-norm contrastive projections
(measured max 0.006), ``LOGIT_ATOL`` 0.03 for the objectness logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import compiled, jax_tpu_serving_path, perturb, to_numpy  # noqa: F401

from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.models import EDAGrounder as JaxGrounder
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.models.grounder import EDAGrounder, decoder_prefixes, top_k_indices
from eda_tpu_torch.weights import load_flax

HEAD_ATOL = 0.03
PROJ_ATOL = 0.02
LOGIT_ATOL = 0.03


@pytest.fixture(scope="module")
def inputs():
    gen = SyntheticScenes(SyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                          vocab_size=512)
    return gen.batch(range(2))


def test_grounder_matches_jax_serving_path(jax_tpu_serving_path, inputs):  # noqa: F811
    cfg = ModelConfig(use_bf16=True).tiny()
    jcfg = JaxConfig(use_bf16=True).tiny()
    assert cfg.num_queries == jcfg.num_queries < cfg.sa_npoints[1]
    jax_model = JaxGrounder(jcfg)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    variables = jax.jit(lambda x: jax_model.init(jax.random.key(0), x, train=False))(jin)
    variables = perturb(to_numpy(variables), seed=2)
    want = compiled(lambda v, x: jax_model.apply(v, x, train=False), variables, jin)
    want = {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
            for k, v in want.items()}

    port = EDAGrounder(cfg)
    load_flax(port, variables)
    with torch.inference_mode():
        got = port.eval()({k: torch.from_numpy(v) for k, v in inputs.items()})
    got = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
           for k, v in got.items()}
    assert set(got) == set(want)

    # backbone and seeds
    for key in ("sa1_inds", "sa2_inds", "sa3_inds", "sa4_inds", "seed_inds", "seed_xyz"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["seed_features"], want["seed_features"], atol=HEAD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got["text_feats_prepro"], want["text_feats_prepro"],
                               atol=1e-4, rtol=0)  # all f32: RoBERTa + projector
    np.testing.assert_allclose(got["seeds_obj_cls_logits"], want["seeds_obj_cls_logits"],
                               atol=LOGIT_ATOL, rtol=0)

    # KPS: the same set of seeds; the port's order is descending in the JAX
    # logits up to the logit tolerance
    g_inds, w_inds = got["query_points_sample_inds"], want["query_points_sample_inds"]
    for g_row, w_row, logit_row in zip(g_inds, w_inds, want["seeds_obj_cls_logits"]):
        assert sorted(g_row) == sorted(w_row)
        assert (np.diff(logit_row[g_row]) <= 2 * LOGIT_ATOL).all()
    # align the port's queries to the JAX order
    perm = np.stack([np.argsort(g)[np.argsort(np.argsort(w))] for g, w in zip(g_inds, w_inds)])
    align = lambda x: np.take_along_axis(x, perm.reshape(perm.shape + (1,) * (x.ndim - 2)), 1)  # noqa: E731
    np.testing.assert_array_equal(align(g_inds), w_inds)
    np.testing.assert_array_equal(align(got["query_points_xyz"]), want["query_points_xyz"])

    for prefix in decoder_prefixes(cfg.num_decoder_layers):
        for name, atol in (("center", HEAD_ATOL), ("pred_size", HEAD_ATOL),
                           ("sem_cls_scores", HEAD_ATOL), ("proj_queries", PROJ_ATOL)):
            key = prefix + name
            np.testing.assert_allclose(align(got[key]), want[key], atol=atol, rtol=0,
                                       err_msg=key)
    assert got["last_center"].shape == (2, cfg.num_queries, 3)


@pytest.mark.parametrize("k", [1, 7, 32])
def test_kps_top_k_matches_lax_top_k_with_ties(k):
    """Objectness logits with many exact ties: same indices, same tie order."""
    rng = np.random.default_rng(k)
    logits = np.round(rng.normal(size=(3, 128)), 1).astype(np.float32)
    _, want = jax.lax.top_k(jnp.asarray(logits), k)
    got = top_k_indices(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
