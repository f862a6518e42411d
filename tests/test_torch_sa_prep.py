"""Port SA prep (K2's plain version) vs the JAX prep kernel in interpret mode.

Tolerance 0.02 abs in bf16, as ``tests/test_sa_prep.py`` holds the Pallas
kernel to the XLA formulation. The JAX side is compiled without excess
precision (``torch_parity``), so both round where the kernel source says.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import compiled

from eda_tpu.ops.pallas import sa_prep as jax_prep
from eda_tpu.ops.pallas.sa_kernel import _ceil_lane, _pad_lanes
from eda_tpu_torch.ops.cuda import sa_prep as port_prep


def _setup(seed, B, N, in_dim, c1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (B, N, in_dim)).astype(np.float32)
    w1 = (rng.normal(size=(in_dim, c1)) * in_dim ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=c1) * 0.1).astype(np.float32)
    s1 = (1 + 0.1 * rng.normal(size=c1)).astype(np.float32)
    l1 = (0.1 * rng.normal(size=c1)).astype(np.float32)
    return pts, w1, b1, s1, l1


@pytest.mark.parametrize("c1,in_dim", [(8, 7), (64, 7), (8, 131), (64, 131)])
def test_prep_plain_matches_jax_kernel(c1, in_dim):
    radius = 0.4
    pts, w1, b1, s1, l1 = _setup(c1 + in_dim, 2, 512, in_dim, c1)
    c1p = _ceil_lane(c1)
    pad = lambda v: _pad_lanes(jnp.asarray(v).reshape(1, -1), c1p)  # noqa: E731
    A, _ = compiled(
        functools.partial(jax_prep._prep_fwd, c_real=c1, dtype=jnp.bfloat16,
                          radius=radius, interpret=True),
        jnp.asarray(pts), _pad_lanes(jnp.asarray(w1), c1p), pad(b1), pad(s1), pad(l1),
    )
    want = np.asarray(A.astype(jnp.float32))[..., :c1]
    got = port_prep.sa_prep(*(torch.from_numpy(v) for v in (pts, w1, b1, s1, l1)),
                            radius=radius)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 512, c1)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.02, rtol=0)


def test_prep_cpu_tensor_takes_plain_version():
    pts, w1, b1, s1, l1 = (torch.from_numpy(v) for v in _setup(0, 1, 64, 6, 16))
    got = port_prep.sa_prep(pts, w1, b1, s1, l1, radius=0.2)
    want = port_prep.sa_prep_plain(pts, w1, b1, s1, l1, radius=0.2)
    assert torch.equal(got, want)
    assert port_prep.KERNEL.launches == 0
