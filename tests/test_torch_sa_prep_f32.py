"""The f32 prep (K2f / K7f's plain versions) vs the JAX prep kernels at dtype=float32, interpreted.

``ModelConfig(use_bf16=False)`` runs layer 0 as ``_prep_fwd`` / ``_prep_bwd``
with ``dtype=float32`` (``eda_tpu/ops/pallas/sa_prep.py:142``, ``:178``). The
port's plain versions take ``compute_dtype=torch.float32`` and are held to
the interpreted Pallas kernels at each flagship layer's (in_dim, c1) and the
tiny config's, at row counts that are no multiple of 16 and, above 2048
points, no multiple of the kernels' row block. Tolerances as
``tests/test_sa_prep.py`` holds the f32 kernel (``:59`` A within 2e-5 abs,
``:79`` each gradient within 1e-4 of its largest value).

The f32 backward takes dA unrounded (the JAX wrapper casts it to the compute
dtype, a no-op in f32): the port's plain backward on dA and on bf16(dA)
differ, and the first matches JAX's on dA. In the fused layer, the pool
backward's f32 dA reaches the prep backward as it came (``_Pool`` rounds A to
bf16 for the kernel only).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import compiled, one_torch_thread  # noqa: F401

from eda_tpu.ops.pallas import sa_prep as jax_prep
from eda_tpu.ops.pallas.sa_kernel import _ceil_lane, _pad_lanes
from eda_tpu_torch.data.presort import morton_sort
from eda_tpu_torch.ops import fused_sa as port_fsa
from eda_tpu_torch.ops.cuda import build
from eda_tpu_torch.ops.cuda import sa_prep as port_prep

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL, GRAD_REL = 2e-5, 1e-4
F32 = dict(compute_dtype=torch.float32)

# (in_dim, c1, B, N, radius): the flagship's SA1-SA4 widths, the tiny config's,
# the width-2 backbone's SA2 and SA3/SA4 (c1 256)
CASES = [
    (6, 64, 2, 1000, 0.2),     # SA1; N no multiple of 16
    (131, 128, 1, 2050, 0.4),  # SA2; N above the 2048-row block: one block of 2050 rows
    (259, 128, 1, 4112, 0.8),  # SA3/SA4; 4112 = 257 x 16 rows, blocks of 16
    (35, 32, 2, 77, 0.4),      # tiny SA2
    (259, 256, 1, 300, 0.4),   # W2X SA2; 300 rows, no multiple of a 64-row tile
    (515, 256, 2, 130, 0.8),   # W2X SA3/SA4; 2 x 130 rows
]


def _setup(seed, B, N, in_dim, c1):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-2, 2, (B, N, 3)),
                          rng.normal(size=(B, N, in_dim - 3))], -1).astype(np.float32)
    w1 = (rng.normal(size=(in_dim, c1)) * in_dim ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=c1) * 0.1).astype(np.float32)
    s1 = (1 + 0.1 * rng.normal(size=c1)).astype(np.float32)
    l1 = (0.1 * rng.normal(size=c1)).astype(np.float32)
    dA = rng.normal(size=(B, N, c1)).astype(np.float32)
    return pts, w1, b1, s1, l1, dA


def _jax_padded(w1, b1, s1, l1):
    c1p = _ceil_lane(w1.shape[1])
    pad = lambda v: _pad_lanes(jnp.asarray(v).reshape(1, -1), c1p)  # noqa: E731
    return _pad_lanes(jnp.asarray(w1), c1p), pad(b1), pad(s1), pad(l1)


@pytest.mark.parametrize("in_dim,c1,B,N,radius", CASES,
                         ids=[f"{c[0]}x{c[1]}-N{c[3]}" for c in CASES])
def test_prep_f32_plain_matches_jax_kernel(in_dim, c1, B, N, radius):
    pts, w1, b1, s1, l1, dA = _setup(in_dim + N, B, N, in_dim, c1)
    w_pad, b_pad, s_pad, l_pad = _jax_padded(w1, b1, s1, l1)
    A, _ = compiled(functools.partial(jax_prep._prep_fwd, c_real=c1, dtype=jnp.float32,
                                      radius=radius, interpret=True),
                    jnp.asarray(pts), w_pad, b_pad, s_pad, l_pad)
    tp = [torch.from_numpy(v) for v in (pts, w1, b1, s1, l1)]
    got = port_prep.sa_prep(*tp, radius=radius, **F32)
    assert got.dtype == torch.float32 and got.shape == (B, N, c1)
    np.testing.assert_allclose(got.numpy(), np.asarray(A)[..., :c1], atol=ATOL, rtol=0)

    want = compiled(functools.partial(jax_prep._prep_bwd, c_real=c1, dtype=jnp.float32,
                                      radius=radius, interpret=True),
                    jnp.asarray(pts), jnp.asarray(np.pad(dA, ((0, 0), (0, 0),
                                                              (0, w_pad.shape[1] - c1)))),
                    w_pad, b_pad, s_pad)
    want = [np.asarray(want[0]), np.asarray(want[1])[:, :c1]] + [
        np.asarray(v)[0, :c1] for v in want[2:]]
    got = port_prep.sa_prep_bwd(tp[0], torch.from_numpy(dA), *tp[1:4], radius=radius, **F32)
    for name, g, w in zip(("dpts", "dW1", "db1", "dscale", "dlnb"), got, want):
        assert g.shape == w.shape, name
        rel = np.abs(g.numpy() - w).max() / (np.abs(w).max() + 1e-30)
        assert rel < GRAD_REL, (name, rel)
    assert build.KERNELS["sa_prep_f32_launch"].launches == 0  # the CPU runs the plain version
    assert build.KERNELS["sa_prep_bwd_f32_launch"].launches == 0


def test_prep_f32_backward_reads_da_unrounded():
    pts, w1, b1, s1, l1, dA = (torch.from_numpy(v) for v in _setup(5, 1, 300, 6, 64))
    exact = port_prep.sa_prep_bwd(pts, dA, w1, b1, s1, radius=0.2, **F32)
    rounded = port_prep.sa_prep_bwd(pts, dA.bfloat16().float(), w1, b1, s1, radius=0.2, **F32)
    assert not torch.equal(exact[1], rounded[1])
    # in bf16 the cotangent is rounded first: both give the same gradients
    bf = [port_prep.sa_prep_bwd(pts, d, w1, b1, s1, radius=0.2)
          for d in (dA, dA.bfloat16().float())]
    assert all(torch.equal(a, b) for a, b in zip(*bf))


def test_fused_layer_hands_the_pools_f32_da_to_the_prep_backward(monkeypatch):
    """The f32 layer on the kernel windows: the pools take A rounded to bf16,
    the prep backward gets the pool backward's dA in f32, as computed."""
    rng = np.random.default_rng(3)
    N, M, C, widths = 512, 64, 4, (16, 16, 32)
    xyz = morton_sort(rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32), cell_size=0.3)[0][None]
    feats = rng.normal(size=(1, N, C)).astype(np.float32)
    groups, prev = ([], [], [], []), 3 + C
    for c in widths:
        groups[0].append(torch.tensor(rng.normal(size=(prev, c)) * prev ** -0.5,
                                      dtype=torch.float32, requires_grad=True))
        groups[1].append(torch.tensor(rng.normal(size=c) * 0.1, dtype=torch.float32,
                                      requires_grad=True))
        groups[2].append(torch.ones(c, requires_grad=True))
        groups[3].append(torch.zeros(c, requires_grad=True))
        prev = c
    seen = {}

    pool_kernel = port_fsa.sa_pool_bwd

    def pool_bwd(A, b_c, *a, **k):
        seen["pool_A"], seen["pool_bc"] = A.dtype, b_c.dtype
        seen["pool_dA"] = out = pool_kernel(A, b_c, *a, **k)
        return out

    def prep_bwd(pts, dA, *a, **k):
        seen["prep_dA"], seen["dtype"] = dA, k["compute_dtype"]
        return port_prep.sa_prep_bwd(pts, dA, *a, **k)

    monkeypatch.setattr(port_fsa, "sa_pool_bwd", pool_bwd)
    monkeypatch.setattr(port_fsa, "sa_prep_bwd", prep_bwd)
    out, _ = port_fsa.fused_set_abstraction(
        torch.from_numpy(xyz), torch.from_numpy(feats),
        torch.from_numpy(rng.permutation(N)[:M][None].astype(np.int32)),
        port_fsa.SAParams(*(tuple(g) for g in groups)), radius=0.3, window=128,
        compute_dtype=torch.float32)
    out.sum().backward()
    assert seen["pool_A"] == seen["pool_bc"] == torch.bfloat16
    assert seen["dtype"] == torch.float32 and seen["prep_dA"].dtype == torch.float32
    assert torch.equal(seen["prep_dA"], seen["pool_dA"][0])
    dA = seen["prep_dA"][seen["prep_dA"] != 0]
    assert dA.numel() and not torch.equal(dA, dA.bfloat16().float())  # windowed: exact f32
