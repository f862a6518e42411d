"""The whole slice: the port's EDAGrounder vs the JAX grounder, serving forward.

``ModelConfig(use_bf16=True).tiny()``, synthetic scenes, the JAX model's own
(perturbed) weights carried over with ``weights.load_flax``, eval mode. The JAX
side runs its TPU serving path with every Pallas kernel interpreted
(``jax_tpu_serving_path``), so both sides use the same 16-center windows.

KPS runs with the config's own ``num_queries`` (tiny: 32 of 128 seeds), and
both models must select the same set of seeds. The port's attention rounds
where flax's bf16 attention rounds (the core is bit-identical), but the
backbone's bf16 MLPs still differ by a few bf16 steps (``fp2_features``
within 0.05): f32 sums taken in other orders flip single bf16 roundings, no
rounding point is skipped (ROADMAP Queue 3). That moves the objectness
logits by up to ~0.008. Scene 1 has
near-ties below that: seeds 12 and 14 have JAX logits -0.52539 and -0.52587
(gap 4.8e-4), and seeds 54, 56, 60, 70 lie within 3.8e-3 of each other, so
the port orders those queries differently. The test therefore holds the
port's order against the JAX logits (descending within ``LOGIT_ATOL``) and
compares the per-query outputs after aligning the port's queries to the JAX
order by seed index. The decoder is equivariant under a permutation of its
queries, so aligned outputs must agree. KPS's selection and tie order are
checked against ``lax.top_k`` below.

Tolerances (``torch_parity.HEAD_ATOL`` etc.), all absolute: the backbone as
in ``test_torch_backbone.py``; after it, 0.03 for centers, sizes and class scores (magnitude up to ~3.5,
measured max 0.014), 0.02 for the unit-norm contrastive projections
(measured max 0.006), ``LOGIT_ATOL`` 0.03 for the objectness logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    assert_grounder_outputs_match,
    grounder_forwards,
    jax_tpu_serving_path,
)

from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.models.grounder import top_k_indices


@pytest.fixture(scope="module")
def inputs():
    gen = SyntheticScenes(SyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                          vocab_size=512)
    return gen.batch(range(2))


def test_grounder_matches_jax_serving_path(jax_tpu_serving_path, inputs):  # noqa: F811
    cfg = ModelConfig(use_bf16=True).tiny()
    jcfg = JaxConfig(use_bf16=True).tiny()
    assert cfg.num_queries == jcfg.num_queries < cfg.sa_npoints[1]
    got, want = grounder_forwards(jcfg, cfg, inputs)
    assert_grounder_outputs_match(got, want, cfg)
    assert got["last_center"].shape == (2, cfg.num_queries, 3)


@pytest.mark.parametrize("k", [1, 7, 32])
def test_kps_top_k_matches_lax_top_k_with_ties(k):
    """Objectness logits with many exact ties: same indices, same tie order."""
    rng = np.random.default_rng(k)
    logits = np.round(rng.normal(size=(3, 128)), 1).astype(np.float32)
    _, want = jax.lax.top_k(jnp.asarray(logits), k)
    got = top_k_indices(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
