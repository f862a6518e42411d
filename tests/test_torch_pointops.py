"""Port point ops vs the JAX package: FPS bit for bit, FP-layer ops to rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_tpu.ops import pointops as jax_ops
from eda_tpu.ops.pallas.fps import furthest_point_sample_pallas
from eda_tpu_torch.ops import pointops


def _cloud(seed, B, N, pad=None):
    xyz = np.random.default_rng(seed).uniform(-1, 1, (B, N, 3)).astype(np.float32)
    if pad is not None:
        xyz[:, pad[0]:pad[1]] = 0.0  # zero padding of a short scene
    return xyz


@pytest.mark.parametrize("B,N,M,pad", [
    (3, 256, 32, None),
    (1, 200, 32, None),      # B=1
    (2, 150, 40, (50, 100)),  # padding points
    (2, 1024, 256, (900, 1024)),
])
def test_fps_bit_exact_against_jax(B, N, M, pad):
    xyz = _cloud(B * N + M, B, N, pad)
    got = pointops.furthest_point_sample(torch.from_numpy(xyz), M).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ops.furthest_point_sample(jnp.asarray(xyz), M)))
    np.testing.assert_array_equal(
        got, np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), M, interpret=True))
    )
    assert got.dtype == np.int32 and (got[:, 0] == 0).all()
    if pad is not None:
        assert not np.isin(got[:, 1:], np.arange(*pad)).any()


def test_two_stage_presample_matches_jax():
    """FusedSetAbstraction's Morton-stride presample + FPS picks the same centers."""
    import jax

    from eda_tpu.models.pointnet2 import FusedSetAbstraction as JaxSA
    from eda_tpu_torch.data.presort import morton_sort
    from eda_tpu_torch.models.pointnet2 import FusedSetAbstraction

    rng = np.random.default_rng(3)
    xyz = np.stack([morton_sort(rng.uniform(-2, 2, (1024, 3)).astype(np.float32))[0]
                    for _ in range(2)])
    feats = rng.normal(size=(2, 1024, 3)).astype(np.float32)
    jax_sa = JaxSA(npoint=64, radius=0.4, window=256, mlp_channels=(8, 8, 16),
                   presorted=True, rank_order_out=True, fps_presample=256)
    variables = jax_sa.init(jax.random.key(0), jnp.asarray(xyz), jnp.asarray(feats), train=False)
    _, _, want = jax_sa.apply(variables, jnp.asarray(xyz), jnp.asarray(feats), train=False)

    port = FusedSetAbstraction(64, 0.4, 256, 3, (8, 8, 16), fps_presample=256)
    inds = port.sample(torch.from_numpy(xyz))
    np.testing.assert_array_equal(torch.sort(inds, 1).values.numpy(), np.asarray(want))
    # the presample really ran: every pick lies on the 4-point stride
    assert (inds.numpy() % 4 == 0).all()


def test_three_nn_interpolation_match_jax():
    rng = np.random.default_rng(5)
    unknown = rng.uniform(-1, 1, (2, 128, 3)).astype(np.float32)
    known = rng.uniform(-1, 1, (2, 32, 3)).astype(np.float32)
    known[:, 5] = known[:, 4]  # an exact tie: the lowest index comes first
    feats = rng.normal(size=(2, 32, 16)).astype(np.float32)

    d_j, i_j = jax_ops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    w_j = jax_ops.interpolation_weights(d_j)
    f_j = jax_ops.three_interpolate(jnp.asarray(feats), i_j, w_j)

    d_t, i_t = pointops.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    w_t = pointops.interpolation_weights(d_t)
    f_t = pointops.three_interpolate(torch.from_numpy(feats), i_t, w_t)

    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5)
    # sums of three weighted features can cancel to near zero: atol at f32 level
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-5, atol=1e-5)


def test_gather_points_matches_jax():
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(2, 50, 7)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 20)).astype(np.int32)
    got = pointops.gather_points(torch.from_numpy(pts), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ops.gather_points(jnp.asarray(pts), jnp.asarray(idx))))
