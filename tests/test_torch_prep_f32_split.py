"""The arithmetic of the f32 prep kernels' tensor-core route (3xTF32) vs the JAX prep kernels.

``csrc/sa_prep_f32.cu`` runs the f32 prep's three products (X = P W1, dpts =
dx W1^T, dW1 = P^T dx) on the tensor cores in 3xTF32: each f32 operand v is
split into hi = tf32(v) and lo = tf32(v - hi), both rounded to nearest with
ties away from zero as ``cvt.rna.tf32.f32`` does (10 mantissa bits), and a
product is taken as hi lo + lo hi + hi hi with f32 sums, lo lo dropped. Here
that arithmetic is emulated in plain PyTorch (it is not a plain version of a
kernel: nothing on a path calls it) and the prep forward and backward computed
with it are held against the interpreted Pallas kernels (``_prep_fwd`` /
``_prep_bwd`` at ``dtype=float32``) at the flagship's, the width-2 backbone's
and the tiny config's layer widths, with ``tests/test_sa_prep.py``'s f32 tolerances (``:59`` A within
2e-5 abs, ``:79`` each gradient within 1e-4 of its largest value). One TF32
product (1xTF32) misses them at SA3's widths, so a shortcut to it fails here.
The tensor cores' own accumulation rounding is not emulated: the card's check
(``chip_smoke.py``, ``prep_f32_edge_check``) measures it.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import compiled, one_torch_thread  # noqa: F401

from eda_tpu.ops.pallas import sa_prep as jax_prep
from eda_tpu.ops.pallas.sa_kernel import _ceil_lane, _pad_lanes

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL, GRAD_REL = 2e-5, 1e-4
EPS = 1e-5

# (in_dim, c1, rows, radius): the flagship's SA1-SA4 widths, the tiny config's,
# the width-2 backbone's SA2 and SA3/SA4 (c1 256: two column halves of the products)
CASES = [
    (6, 64, 2000, 0.2),
    (131, 128, 1000, 0.4),
    (259, 128, 700, 0.8),
    (259, 128, 300, 1.2),
    (6, 16, 500, 0.2),
    (35, 32, 500, 0.4),
    (67, 32, 500, 0.8),
    (259, 256, 300, 0.4),
    (515, 256, 300, 0.8),
]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to 10 mantissa bits, to nearest with ties away from zero (cvt.rna)."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return (sign | mag).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: hi lo + lo hi + hi hi, f32 sums (each TF32 product is exact in f32)."""
    (ah, al), (bh, bl) = split(a), split(b)
    return ah @ bl + al @ bh + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 product."""
    return tf32(a) @ tf32(b)


def prep(pts, w1, b1, scale, lnb, dA, radius, mm):
    """The f32 prep forward and backward with the products taken by ``mm``."""
    c1 = w1.shape[1]
    x_in = torch.cat([pts[:, :3] / torch.tensor(radius), pts[:, 3:]], -1)
    x = mm(x_in, w1) + b1
    mean = x.sum(-1, keepdim=True) / c1
    var = torch.clamp((x * x).sum(-1, keepdim=True) / c1 - mean * mean, min=0.0)
    rstd = 1.0 / torch.sqrt(var + EPS)
    xhat = (x - mean) * rstd
    A = xhat * scale + lnb
    dxh = dA * scale
    m1 = dxh.sum(-1, keepdim=True) / c1
    m2 = (dxh * xhat).sum(-1, keepdim=True) / c1
    dx = rstd * (dxh - m1 - xhat * m2)
    dp = mm(dx, w1.T)
    dpts = torch.cat([dp[:, :3] / torch.tensor(radius), dp[:, 3:]], -1)
    grads = (dpts, mm(x_in.T, dx), dx.sum(0), (dA * xhat).sum(0), dA.sum(0))
    return A, grads


def _inputs(seed, rows, in_dim, c1):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-2, 2, (rows, 3)),
                          rng.normal(size=(rows, in_dim - 3))], -1).astype(np.float32)
    w1 = (rng.normal(size=(in_dim, c1)) * in_dim ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=c1) * 0.1).astype(np.float32)
    s1 = (1 + 0.1 * rng.normal(size=c1)).astype(np.float32)
    l1 = (0.1 * rng.normal(size=c1)).astype(np.float32)
    dA = rng.normal(size=(rows, c1)).astype(np.float32)
    return pts, w1, b1, s1, l1, dA


@functools.lru_cache(maxsize=None)
def _jax(in_dim, c1, rows, radius):
    """(inputs, A, gradients) of the interpreted Pallas kernels at dtype=float32."""
    pts, w1, b1, s1, l1, dA = _inputs(in_dim + rows, rows, in_dim, c1)
    c1p = _ceil_lane(c1)
    pad = lambda v: _pad_lanes(jnp.asarray(v).reshape(1, -1), c1p)  # noqa: E731
    w_pad = _pad_lanes(jnp.asarray(w1), c1p)
    A, _ = compiled(functools.partial(jax_prep._prep_fwd, c_real=c1, dtype=jnp.float32,
                                      radius=radius, interpret=True),
                    jnp.asarray(pts[None]), w_pad, pad(b1), pad(s1), pad(l1))
    g = compiled(functools.partial(jax_prep._prep_bwd, c_real=c1, dtype=jnp.float32,
                                   radius=radius, interpret=True),
                 jnp.asarray(pts[None]), jnp.asarray(np.pad(dA, ((0, 0), (0, c1p - c1))))[None],
                 w_pad, pad(b1), pad(s1))
    grads = [np.asarray(g[0])[0], np.asarray(g[1])[:in_dim, :c1]] + [
        np.asarray(v)[0, :c1] for v in g[2:]]
    return (pts, w1, b1, s1, l1, dA), np.asarray(A)[0, :, :c1], grads


def _errors(in_dim, c1, rows, radius, mm):
    """(max |A - A_jax|, each gradient's max error over its largest value)."""
    inputs, A_jax, grads_jax = _jax(in_dim, c1, rows, radius)
    A, grads = prep(*(torch.from_numpy(v) for v in inputs), radius, mm)
    err = np.abs(A.numpy() - A_jax).max()
    rel = [np.abs(g.numpy() - w).max() / (np.abs(w).max() + 1e-30)
           for g, w in zip(grads, grads_jax)]
    return err, rel


@pytest.mark.parametrize("in_dim,c1,rows,radius", CASES,
                         ids=[f"{c[0]}x{c[1]}-r{c[3]}" for c in CASES])
def test_3xtf32_prep_matches_jax_kernels(in_dim, c1, rows, radius):
    err, rel = _errors(in_dim, c1, rows, radius, mm3)
    assert err < ATOL, err
    assert max(rel) < GRAD_REL, rel


def test_1xtf32_prep_misses_the_f32_tolerances_at_sa3():
    err, rel = _errors(259, 128, 700, 0.8, mm1)
    assert err > 10 * ATOL, err
    assert rel[1] > GRAD_REL, rel  # dW1


def test_tf32_rounds_to_nearest_ties_away_to_ten_bits():
    one = 1.0 + 2.0 ** -10  # the next TF32 value above 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, one,
                      1.0 + 3 * 2.0 ** -12], dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got, torch.tensor([one, -one, 1.0, one, one], dtype=torch.float32))
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()  # the low 13 bits clear
    hi, lo = split(x)
    assert torch.equal(hi + lo, x) and torch.equal(tf32(lo), lo)
