"""The port's fused SA layer under the ``mxu`` and ``pre`` radius tests vs the JAX layer.

``EDA_SA_D2`` selects the radius test in both packages. The JAX layer is a
``jax.jit`` that does not key on the mode, so each JAX run clears the caches
first and the test asserts the mode JAX resolved (a stale trace would run
another mode). The port resolves the mode on every call.

* Serving (``impl="pallas"``, interpreted) and training (``impl="pallas_train"``:
  the pool with winner export and its backward, interpreted), the latter
  through ``jax.grad`` against ``torch.autograd`` with the same cotangent.
  Tolerances as ``test_torch_sa_pool.py`` and ``test_torch_fused_sa_train.py``:
  pooled features 0.03 absolute, each gradient leaf within 2% of its largest
  value. M = 56 pads the last center block by repeating the last center,
  whose first center is then the ``mxu``/``pre`` origin of a padded block.
  Coordinates sit on a 0.05 grid and r^2 = 0.0913 lies off the grid's d2
  values, so no pair is within rounding of the radius.
* The port's routing: ``pre`` runs the mask kernel and hands the mask to the
  pool, ``mxu`` runs no mask, and a changed ``EDA_SA_D2`` takes effect on the
  next call in the same process.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import compiled, tpu_path

from eda_tpu.ops import fused_sa as jax_fsa
from eda_tpu.ops.pallas import sa_kernel as SK
from eda_tpu_torch.data.presort import morton_sort
from eda_tpu_torch.ops import fused_sa as port_fsa

RADIUS = float(np.sqrt(0.0913))
REL = 0.02


def _setup(seed, N=512, M=56, C=4, widths=(16, 16, 32)):
    rng = np.random.default_rng(seed)
    xyz = np.stack([morton_sort((rng.integers(-30, 30, (N, 3)) * 0.05).astype(np.float32),
                                cell_size=0.3)[0] for _ in range(2)])
    feats = rng.normal(size=(2, N, C)).astype(np.float32)
    groups = ([], [], [], [])
    prev = 3 + C
    for c in widths:
        groups[0].append((rng.normal(size=(prev, c)) * prev ** -0.5).astype(np.float32))
        groups[1].append((rng.normal(size=c) * 0.1).astype(np.float32))
        groups[2].append((1 + 0.1 * rng.normal(size=c)).astype(np.float32))
        groups[3].append((0.1 * rng.normal(size=c)).astype(np.float32))
        prev = c
    cidx = np.stack([rng.permutation(N)[:M] for _ in range(2)]).astype(np.int32)
    G = rng.normal(size=(2, M, widths[-1])).astype(np.float32)
    return xyz, feats, cidx, groups, G


@pytest.fixture
def jax_mode(monkeypatch):
    """Sets ``EDA_SA_D2`` for both packages; returns the modes JAX resolved."""
    resolved = []
    resolve = SK._resolve_d2_mode
    monkeypatch.setattr(SK, "_resolve_d2_mode",
                        lambda m: resolved.append(resolve(m)) or resolved[-1])

    def set_mode(mode):
        monkeypatch.setenv("EDA_SA_D2", mode)
        jax.clear_caches()
        return resolved

    return set_mode


@pytest.mark.parametrize("training", [False, True], ids=["serving", "training"])
@pytest.mark.parametrize("mode", ["mxu", "pre"])
def test_fused_sa_mode_matches_jax(monkeypatch, jax_mode, mode, training):
    tpu_path(monkeypatch, training=training)
    resolved = jax_mode(mode)
    window = 128
    xyz, feats, cidx, groups, G = _setup(7)
    kw = dict(radius=RADIUS, window=window, block=64, compute_dtype=jnp.bfloat16,
              presorted=True, impl="pallas_train" if training else "pallas",
              return_rank_order=True)

    def loss(feats_, params):
        out, _ = jax_fsa.fused_set_abstraction(jnp.asarray(xyz), feats_, jnp.asarray(cidx),
                                               params, **kw)
        return jnp.sum(out * G), out

    params = jax_fsa.SAParams(*(tuple(jnp.asarray(v) for v in g) for g in groups))
    if training:
        (_, want), (want_df, want_dp) = compiled(
            lambda f, p: jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(f, p),
            jnp.asarray(feats), params)
    else:
        _, want = compiled(loss, jnp.asarray(feats), params)
    assert resolved and set(resolved) == {mode}, resolved

    port_params = port_fsa.SAParams(*(tuple(torch.tensor(v, requires_grad=training)
                                            for v in g) for g in groups))
    f = torch.tensor(feats, requires_grad=training)
    with torch.set_grad_enabled(training):
        got, _ = port_fsa.fused_set_abstraction(torch.from_numpy(xyz), f,
                                                torch.from_numpy(cidx), port_params,
                                                radius=RADIUS, window=window, block=64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=0.03, rtol=0)
    if not training:
        return
    (got * torch.from_numpy(G)).sum().backward()
    pairs = [("features", f.grad, want_df)]
    for gi, name in enumerate(("kernels", "biases", "ln_scales", "ln_biases")):
        for i, (p, w) in enumerate(zip(port_params[gi], getattr(want_dp, name))):
            pairs.append((f"{name}[{i}]", p.grad, w))
    for name, g, w in pairs:
        w = np.asarray(w)
        assert g is not None and g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max() / (np.abs(w).max() + 1e-6)
        assert err < REL, (name, err)


def _record(calls, tag, fn, *a, **k):
    calls.append((tag, k.get("d2_mode"), k.get("mask") is not None))
    return fn(*a, **k)


@pytest.mark.parametrize("training", [False, True], ids=["serving", "training"])
def test_mode_routing_is_read_on_every_call(monkeypatch, training):
    xyz, feats, cidx, groups, _ = _setup(0, N=256, M=32)
    params = port_fsa.SAParams(*(tuple(torch.tensor(v, requires_grad=training) for v in g)
                                 for g in groups))
    calls = []
    pool = "sa_pair_pool_winners" if training else "sa_pair_pool"
    monkeypatch.setattr(port_fsa, pool,
                        functools.partial(_record, calls, "pool", getattr(port_fsa, pool)))
    monkeypatch.setattr(port_fsa, "sa_radius_mask", functools.partial(
        _record, calls, "mask", port_fsa.sa_radius_mask))
    for mode in ("pre", "mxu", "pair"):
        monkeypatch.setenv("EDA_SA_D2", mode)
        with torch.set_grad_enabled(training):
            out, _ = port_fsa.fused_set_abstraction(
                torch.from_numpy(xyz), torch.from_numpy(feats), torch.from_numpy(cidx), params,
                radius=RADIUS, window=128)
        if training:
            out.sum().backward()
    assert calls == [("mask", None, False), ("pool", "pre", True), ("pool", "mxu", False),
                     ("pool", "pair", False)]
    monkeypatch.setenv("EDA_SA_D2", "bogus")
    with pytest.raises(ValueError, match="EDA_SA_D2"):
        port_fsa.fused_set_abstraction(torch.from_numpy(xyz), torch.from_numpy(feats),
                                       torch.from_numpy(cidx), params, radius=RADIUS,
                                       window=128)
