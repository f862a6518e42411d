"""Port SA pair pool (K3's plain version) and fused SA vs the JAX Pallas path.

Coordinates sit on a 0.05 grid and r^2 = 0.4113 is off the grid's d2 values,
so no pair lies within rounding of the radius and the masks agree exactly.
Tolerance 0.03 abs (``tests/test_sa_kernel_interpret.py:57``); -1e9 rows (no
point of the window in range) must be the same rows.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import bf16, compiled, jax_tpu_serving_path  # noqa: F401

from eda_tpu.ops import fused_sa as jax_fsa
from eda_tpu.ops.pallas import sa_kernel as SK
from eda_tpu_torch.data.presort import morton_sort
from eda_tpu_torch.ops import fused_sa as port_fsa
from eda_tpu_torch.ops.cuda import sa_kernel as port_pool

R2 = 0.4113


def _grid_cloud(rng, B, N, extent=30):
    return np.sort((rng.integers(-extent, extent, (B, N, 3)) * 0.05).astype(np.float32), axis=1)


@pytest.mark.parametrize("N,M,W,widths,extent", [
    (512, 32, 256, (16, 16, 32), 30),   # windowed
    (256, 32, 256, (32, 32, 64), 30),   # dense (window = N)
    (512, 64, 64, (16, 16, 32), 200),   # sparse: centers with nothing in range
])
def test_pool_plain_matches_pallas(N, M, W, widths, extent):
    rng = np.random.default_rng(N + M + W)
    B = 2
    c1, c2, c3 = widths
    xyz = _grid_cloud(rng, B, N, extent)
    A = bf16(rng.normal(size=(B, N, c1)))
    ranks = np.stack([np.sort(rng.permutation(N)[:M]) for _ in range(B)])
    cen = np.take_along_axis(xyz, ranks[..., None], 1)
    b_c = bf16(rng.normal(size=(B, M, c1)))
    k1 = (rng.normal(size=(c1, c2)) * 0.4).astype(np.float32)
    b1 = (rng.normal(size=c2) * 0.1).astype(np.float32)
    s1 = (1 + 0.1 * rng.normal(size=c2)).astype(np.float32)
    l1 = (0.1 * rng.normal(size=c2)).astype(np.float32)
    k2 = (rng.normal(size=(c2, c3)) * 0.4).astype(np.float32)
    b2 = (rng.normal(size=c3) * 0.1).astype(np.float32)
    mids = ranks.reshape(B, M // 16, 16)[:, :, 8]
    starts = np.clip(mids - W // 2, 0, N - W).astype(np.int32)
    radius = float(np.sqrt(R2))
    layer_params = [
        (jnp.zeros((1, 1)), jnp.zeros(c1), jnp.ones(c1), jnp.zeros(c1)),
        (k1, b1, s1, l1),
        (k2, b2, jnp.ones(c3), jnp.zeros(c3)),
    ]
    want = np.asarray(compiled(
        functools.partial(SK._sa_pair_pool_impl, layer_params=layer_params, radius=radius,
                          window=W, block=16, wc=min(128, W), interpret=True, d2_mode="pair"),
        *(jnp.asarray(v) for v in (A, xyz, b_c, cen, starts)),
    ))
    T = torch.from_numpy
    got = port_pool.sa_pair_pool(
        T(A).bfloat16(), T(xyz), T(b_c).bfloat16(), T(cen), T(starts),
        *(T(v) for v in (k1, b1, s1, l1, k2, b2)), radius=radius, window=W,
    ).numpy()
    np.testing.assert_array_equal(got < -1e8, want < -1e8)
    np.testing.assert_allclose(got, want, atol=0.03, rtol=0)
    if extent == 200:
        assert (want < -1e8).any(), "the sparse case must leave some centers empty"


def _fused_setup(seed, N, M, C, widths):
    rng = np.random.default_rng(seed)
    xyz = np.stack([morton_sort(rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32),
                                cell_size=0.3)[0] for _ in range(2)])
    feats = rng.normal(size=(2, N, C)).astype(np.float32)
    kernels, biases, scales, lbias = [], [], [], []
    prev = 3 + C
    for c in widths:
        kernels.append((rng.normal(size=(prev, c)) * prev ** -0.5).astype(np.float32))
        biases.append((rng.normal(size=c) * 0.1).astype(np.float32))
        scales.append((1 + 0.1 * rng.normal(size=c)).astype(np.float32))
        lbias.append((0.1 * rng.normal(size=c)).astype(np.float32))
        prev = c
    cidx = np.stack([rng.permutation(N)[:M] for _ in range(2)]).astype(np.int32)
    return xyz, feats, cidx, (kernels, biases, scales, lbias)


@pytest.mark.parametrize("N,M,window", [(1024, 128, 256), (512, 56, 128), (256, 64, 256)])
def test_fused_sa_matches_jax_pallas_path(jax_tpu_serving_path, N, M, window):  # noqa: F811
    """Presorted windowed (and, at window >= N, dense) layers in rank order;
    M=56 exercises the edge padding of the last center block."""
    xyz, feats, cidx, p = _fused_setup(N + M, N, M, 4, (16, 16, 32))
    params = jax_fsa.SAParams(*(tuple(jnp.asarray(v) for v in group) for group in p))
    want, want_ranks = compiled(
        functools.partial(jax_fsa.fused_set_abstraction, radius=0.3, window=window,
                          block=64, compute_dtype=jnp.bfloat16, presorted=True,
                          impl="pallas", return_rank_order=True),
        jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(cidx), params,
    )
    port_params = port_fsa.SAParams(*(tuple(torch.from_numpy(v) for v in g) for g in p))
    got, ranks = port_fsa.fused_set_abstraction(
        torch.from_numpy(xyz), torch.from_numpy(feats), torch.from_numpy(cidx),
        port_params, radius=0.3, window=window, block=64,
    )
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(want_ranks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.03, rtol=0)
