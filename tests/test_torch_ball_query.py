"""The gather SA's point ops: ``ball_query``, ``ball_query_nearest`` and ``group_points`` vs ``eda_tpu``.

Indices are held bit for bit to ``eda_tpu/ops/pointops.py`` (its own tests,
``tests/test_pointops.py:70-133``, hold them to the reference's CUDA
semantics), with one excuse: both packages test ``d2 < r^2`` on the
``|a|^2 + |b|^2 - 2ab`` expansion, whose f32 sums XLA and PyTorch take in
other orders, so a point within ``BOUNDARY`` of the radius may fall on either
side. A center with such a point is excused (its indices are not compared)
and the test counts them; it must be a small share of the centers.

Ties are part of the inputs: every center is a point of the cloud (d2 = 0),
and duplicated points sit at equal distances; ``ball_query_nearest`` must
order them as ``lax.top_k`` does (lower index first). A center with no point
in radius gets index 0 in every slot (``ball_query_gpu.cu``'s zero init, and
``eda_tpu/ops/pointops.py:204``, ``:229``). The chunked ``ball_query_nearest``
equals the unchunked one. ``group_points`` (``pointops.gather_shared``, whose
backward sums repeated rows in a fixed order on the card) gives gather's
values and gradients.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401

from eda_tpu.ops import pointops as jax_ops
from eda_tpu_torch.ops import pointops

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BOUNDARY = 1e-5  # |d2 - r^2| within which the two packages may test a pair otherwise
MAX_EXCUSED = 0.02  # share of centers that may be excused


def _cloud(seed, B=2, N=600, M=48, dup=40, far=4):
    """A cloud with duplicated points, centers taken from it (some duplicated
    centers among them), and ``far`` centers far from every point."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    src = rng.integers(0, N, (B, dup))
    dst = rng.integers(0, N, (B, dup))
    for b in range(B):
        xyz[b, dst[b]] = xyz[b, src[b]]
    centers = np.stack([xyz[b, rng.permutation(N)[:M]] for b in range(B)])
    centers[:, :far] = 50.0 + rng.uniform(0, 1, (B, far, 3))
    return xyz, centers


def _boundary(xyz, centers, radius):
    d2 = ((centers[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    return (np.abs(d2 - radius * radius) <= BOUNDARY).any(-1)


def _compare(got, want, excused):
    assert got.shape == want.shape and got.dtype == np.int32
    np.testing.assert_array_equal(got[~excused], want[~excused])
    assert excused.mean() <= MAX_EXCUSED, excused.mean()


@pytest.mark.parametrize("radius,nsample", [(0.3, 16), (0.6, 8), (0.05, 4)])
def test_ball_query_first_matches_jax(radius, nsample):
    xyz, centers = _cloud(int(radius * 100) + nsample)
    want = np.asarray(jax_ops.ball_query(jnp.asarray(xyz), jnp.asarray(centers), radius,
                                         nsample))
    got = pointops.ball_query(torch.from_numpy(xyz), torch.from_numpy(centers), radius,
                              nsample).numpy()
    _compare(got, want, _boundary(xyz, centers, radius))
    assert (got[:, :4] == 0).all()  # the far centers: no hit, index 0 throughout


@pytest.mark.parametrize("radius,nsample", [(0.3, 16), (0.6, 8), (0.05, 4)])
def test_ball_query_nearest_matches_jax_with_ties(radius, nsample):
    xyz, centers = _cloud(int(radius * 100) + nsample + 7)
    want = np.asarray(jax_ops.ball_query_nearest(jnp.asarray(xyz), jnp.asarray(centers),
                                                 radius, nsample))
    got = pointops.ball_query_nearest(torch.from_numpy(xyz), torch.from_numpy(centers),
                                      radius, nsample).numpy()
    excused = _boundary(xyz, centers, radius)
    # equal squared distances on both sides decide between tied points: hold the
    # port's order to the (d2, index) order of JAX's own distances
    _compare(got, want, excused)
    assert (got[:, :4] == 0).all()
    d2 = ((centers[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    ties = sum(len(row) - len(set(np.round(d2[b, m, row], 12)))
               for b in range(xyz.shape[0]) for m, row in enumerate(got[b]))
    assert ties > 0  # the inputs hold ties (duplicates, repeated fill)


@pytest.mark.parametrize("chunk", [64, 100, 1000])
def test_ball_query_nearest_chunked_equals_unchunked(chunk):
    xyz, centers = _cloud(11, N=700)
    args = (torch.from_numpy(xyz), torch.from_numpy(centers), 0.4, 12)
    whole = pointops.ball_query_nearest(*args, chunk=4096)
    assert torch.equal(pointops.ball_query_nearest(*args, chunk=chunk), whole)
    # JAX's chunked scan gives the same indices as the port's
    want = np.asarray(jax_ops.ball_query_nearest(jnp.asarray(xyz), jnp.asarray(centers), 0.4,
                                                 12, chunk=chunk))
    _compare(whole.numpy(), want, _boundary(xyz, centers, 0.4))


def test_ball_query_nearest_fewer_points_than_nsample():
    xyz, centers = _cloud(2, N=10, M=6, dup=2, far=1)
    got = pointops.ball_query_nearest(torch.from_numpy(xyz), torch.from_numpy(centers), 0.8,
                                      16).numpy()
    assert got.shape == (2, 6, 16) and (got[:, 0] == 0).all()
    d2 = ((centers[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    for b in range(2):
        for m in range(1, 6):
            hits = np.flatnonzero(d2[b, m] < 0.64)
            order = hits[np.lexsort((hits, d2[b, m, hits]))]
            np.testing.assert_array_equal(got[b, m, :len(order)], order)
            assert (got[b, m, len(order):] == order[0]).all()


def test_group_points_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(2, 50, 5)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 7, 6)).astype(np.int32)
    want = np.asarray(jax_ops.group_points(jnp.asarray(pts), jnp.asarray(idx)))
    got = pointops.group_points(torch.from_numpy(pts), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_group_points_gradient_adds_repeated_rows_as_gather_does():
    """``group_points`` (``gather_shared``) gives gather's values, and its fixed-order
    backward adds each repeated row's cotangents as gather's backward does."""
    rng = np.random.default_rng(5)
    pts = torch.tensor(rng.normal(size=(2, 20, 4)), dtype=torch.float32, requires_grad=True)
    idx = torch.from_numpy(rng.integers(0, 20, (2, 9, 6)).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(2, 9, 6, 4)).astype(np.float32))
    got = pointops.group_points(pts, idx)
    (d_got,) = torch.autograd.grad(got, pts, g)
    want = pts.gather(1, idx.long().reshape(2, -1, 1).expand(-1, -1, 4)).view(2, 9, 6, 4)
    (d_want,) = torch.autograd.grad(want, pts, g)
    assert torch.equal(got, want)
    torch.testing.assert_close(d_got, d_want, rtol=1e-6, atol=1e-6)
    assert (torch.bincount(idx.reshape(-1)) > 1).any()  # the rows repeat
