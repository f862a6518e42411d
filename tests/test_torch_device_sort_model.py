"""The tiny grounder with ``points_presorted=False`` (each fused SA layer sorts on the device), port vs ``eda_tpu``.

The synthetic scenes arrive Morton-sorted at cell 0.2 (the data pipeline's
host presort), which makes SA1's device sort at r = 0.2 the identity. So the
clouds here are permuted per scene (and the training targets' per-point
``point_instance_label`` alike): every layer then sorts for real. SA2-4 sort
anyway, their inputs arriving in FPS order (SA4 of the tiny config is dense).

* Serving: the port's ``EDAGrounder`` against the JAX grounder on its TPU
  serving path (``jax_tpu_serving_path``), through
  ``torch_parity.grounder_forwards`` and ``assert_grounder_outputs_match``
  (``tests/test_torch_grounder.py``'s tolerances; KPS as in
  ``test_torch_butd_model.py``: the port's decoder runs on JAX's query
  indices, and its own seed set must be JAX's but for seeds whose JAX logit
  lies within ``2 * LOGIT_ATOL`` of the boundary): every layer's indices and
  ``fp2_inds`` exactly JAX's, which for an unchained backbone is
  ``sa1_inds[:, :num_seed]`` (``eda_tpu/models/pointnet2.py:319-323``).
* Training: one step against JAX's, bf16 in ``test_torch_device_sort_step.py``,
  f32 in ``test_torch_device_sort_f32_step.py``.
"""

import dataclasses

import numpy as np
from torch_parity import (  # noqa: F401
    assert_grounder_outputs_match,
    assert_kps_matches_up_to_boundary_ties,
    grounder_forwards,
    jax_tpu_serving_path,
)

from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from eda_tpu.data.synthetic import SyntheticScenes as JaxSyntheticScenes
from eda_tpu_torch.config import ModelConfig

UNSORTED = {"points_presorted": False}


def permuted(batch: dict, seed: int = 0) -> dict:
    """A training batch with each scene's points in a random order, the
    per-point labels permuted alike."""
    rng = np.random.default_rng(seed)
    out = {group: dict(arrays) for group, arrays in batch.items()}
    pcs = out["inputs"]["point_clouds"]
    perms = np.stack([rng.permutation(pcs.shape[1]) for _ in range(pcs.shape[0])])
    out["inputs"]["point_clouds"] = np.take_along_axis(pcs, perms[..., None], 1)
    if "point_instance_label" in out.get("targets", {}):
        out["targets"]["point_instance_label"] = np.take_along_axis(
            out["targets"]["point_instance_label"], perms, 1)
    return out


def tiny_batch(text_len: int = 16) -> dict:
    gen = JaxSyntheticScenes(JaxSyntheticConfig(num_points=1024, num_objects=4,
                                                text_len=text_len), vocab_size=512)
    return gen.batch(range(2))


def test_unsorted_grounder_matches_jax_serving_path(jax_tpu_serving_path):  # noqa: F811
    cfg = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), **UNSORTED)
    jcfg = dataclasses.replace(JaxConfig(use_bf16=True).tiny(), **UNSORTED)
    inputs = permuted(tiny_batch())["inputs"]
    got, want = grounder_forwards(jcfg, cfg, inputs, jax_kps=True)
    assert_grounder_outputs_match(got, want, cfg)
    excused = assert_kps_matches_up_to_boundary_ties(got, want, cfg.num_queries)
    print(f"unsorted forward: boundary seeds excused per scene {excused}")
    num_seed = cfg.sa_npoints[1]
    np.testing.assert_array_equal(got["seed_inds"], want["sa1_inds"][:, :num_seed])
    # SA2's centers come back in FPS order, not ascending
    assert (np.diff(got["sa2_inds"], axis=1) < 0).any()
