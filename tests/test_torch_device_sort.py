"""The fused SA's device sort (``presorted=False``) and ``morton_keys``, port vs ``eda_tpu``.

``morton_keys`` must equal ``eda_tpu.ops.fused_sa.morton_keys`` bit for bit
as the JAX fused SA runs it, under ``jax.jit``, on random coordinates and on
the edges of its arithmetic: points below the origin (saturated to cell 0),
past cell 1023 (clipped), and exactly on cell boundaries. Compiled, XLA
divides by the cell size as a product with its f32 reciprocal; run eagerly,
the JAX function divides, and the two differ on some boundary points (the
test shows that it has such points).

One layer at each tiny layer's shape (``ModelConfig.tiny()``: SA1-3 sort, SA4
is dense), on clouds in random order, ``presorted=False`` and
``return_rank_order=False`` on both sides, bf16 and f32: the JAX side at
``impl="pallas"`` (serving), ``"pallas_train"`` (gradients) and ``"xla"``,
every Pallas kernel interpreted; the port at ``impl=None`` (its kernels'
plain versions) and ``"xla"``. The outputs are in ``center_idx`` order.
Both get the same cotangent.

Precondition, asserted on each input: JAX's ``lax.sort`` keeps the order of
equal keys (it is called without ``is_stable``; the port sorts stably), so
both sides put the points in the same order.

Tolerances, those of the presorted tests: the kernel paths as
``test_torch_fused_sa_train.py`` (features 0.03 abs, each gradient leaf within
2% of its largest value); the XLA path in bf16 as
``test_torch_fused_sa_windows.py`` (the same), in f32 as
``test_torch_fused_sa_f32.py`` (1e-5 abs + 1e-4 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_sa_train import REL
from torch_parity import (  # noqa: F401
    compiled, jax_tpu_serving_path, jax_tpu_training_path, one_torch_thread,
)

from eda_tpu.ops import fused_sa as jax_fsa
from eda_tpu_torch.ops import fused_sa as port_fsa
from eda_tpu_torch.ops.cuda import build

pytestmark = pytest.mark.usefixtures("one_torch_thread")

XLA_ATOL, XLA_RTOL = 1e-5, 1e-4
# the tiny config's layers: (N, M, radius, window, C, widths)
LAYERS = {
    "SA1": (1024, 256, 0.2, 256, 3, (16, 16, 32)),
    "SA2": (256, 128, 0.4, 128, 32, (32, 32, 64)),
    "SA3": (128, 64, 0.8, 64, 64, (32, 32, 64)),
    "SA4": (64, 32, 1.2, 64, 64, (32, 32, 64)),
}
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def edge_coordinates() -> np.ndarray:
    """Points below the origin, past cell 1023 and on cell boundaries."""
    cell = 0.2
    on = (np.arange(-3, 5) * cell).astype(np.float32)  # k * 0.2 in f32
    grid = np.stack(np.meshgrid(on, on[::-1], on, indexing="ij"), -1).reshape(-1, 3)
    extremes = np.array([[-50.0, -50.0, -50.0], [-50.5, 0, 0], [-1e6, 1e6, 0],
                         [-50 + 1023 * cell, 0, 0], [-50 + 1024 * cell, 0, 0],
                         [154.6, 154.7, 154.8], [1e6, 1e6, 1e6],
                         [0.1999999, 0.2000001, -0.2]], np.float32)
    nudged = np.nextafter(grid, np.float32(np.inf)).astype(np.float32)
    return np.concatenate([grid, nudged, extremes])


@pytest.mark.parametrize("cell", [0.2, 0.4, 1.2])
def test_morton_keys_bit_equal(cell):
    rng = np.random.default_rng(0)
    xyz = np.concatenate([rng.uniform(-60, 160, (2000, 3)).astype(np.float32),
                          rng.uniform(-2, 2, (2000, 3)).astype(np.float32),
                          edge_coordinates()])
    got = port_fsa.morton_keys(torch.from_numpy(xyz), cell)
    assert got.dtype == torch.int32
    want = np.asarray(jax.jit(lambda x: jax_fsa.morton_keys(x, cell))(jnp.asarray(xyz)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 500 and (want == 0).any()  # cell 0 reached by saturation
    assert (want == 1073741823).any()  # all three cells clipped to 1023
    if cell == 0.2:  # on-boundary points that an eager division puts in the cell below
        assert (np.asarray(jax_fsa.morton_keys(jnp.asarray(xyz), cell)) != want).any()


def _layer_inputs(layer: str, seed: int):
    """A cloud in random order dense enough for ~8 points a ball, features,
    FPS-like distinct centers, the MLP and a cotangent."""
    N, M, radius, window, C, widths = LAYERS[layer]
    rng = np.random.default_rng(seed)
    extent = (N * 4.19 * radius ** 3 / 8) ** (1 / 3)
    xyz = rng.uniform(0, extent, (2, N, 3)).astype(np.float32)
    feats = rng.normal(size=(2, N, C)).astype(np.float32)
    cidx = np.stack([rng.permutation(N)[:M] for _ in range(2)]).astype(np.int32)
    groups = ([], [], [], [])
    prev = 3 + C
    for c in widths:
        groups[0].append((rng.normal(size=(prev, c)) * prev ** -0.5).astype(np.float32))
        groups[1].append((rng.normal(size=c) * 0.1).astype(np.float32))
        groups[2].append((1 + 0.1 * rng.normal(size=c)).astype(np.float32))
        groups[3].append((0.1 * rng.normal(size=c)).astype(np.float32))
        prev = c
    G = rng.normal(size=(2, M, widths[-1])).astype(np.float32)
    return xyz, feats, cidx, groups, G


def assert_jax_sort_is_stable(xyz, radius):
    """JAX's multi-operand sort (as its device-sort branch calls it) keeps
    the order of equal keys on these inputs, and there are such keys."""
    keys = jax_fsa.morton_keys(jnp.asarray(xyz), radius)
    iota = jnp.broadcast_to(jnp.arange(xyz.shape[1], dtype=jnp.int32), keys.shape)
    order = np.asarray(jax.jit(lambda k, i: jax.lax.sort([k, i], dimension=1, num_keys=1)[1])(
        keys, iota))
    keys = np.asarray(keys)
    np.testing.assert_array_equal(order, np.argsort(keys, axis=1, kind="stable"))
    assert any(len(np.unique(k)) < len(k) for k in keys)


def _jax_run(data, layer, jax_dtype, impl, grads):
    xyz, feats, cidx, groups, G = data
    N, M, radius, window, C, widths = LAYERS[layer]
    kw = dict(radius=radius, window=window, block=64, compute_dtype=jax_dtype,
              presorted=False, impl=impl, return_rank_order=False)

    def loss(feats_, params):
        out = jax_fsa.fused_set_abstraction(jnp.asarray(xyz), feats_, jnp.asarray(cidx),
                                            params, **kw)
        return jnp.sum(out * G), out

    params = jax_fsa.SAParams(*(tuple(jnp.asarray(v) for v in g) for g in groups))
    if not grads:
        return np.asarray(compiled(lambda f, p: loss(f, p)[1], jnp.asarray(feats), params)), None
    (_, out), (df, dp) = compiled(
        lambda f, p: jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(f, p),
        jnp.asarray(feats), params)
    return np.asarray(out), [np.asarray(df)] + [np.asarray(w) for w in jax.tree_util.tree_leaves(
        (dp.kernels, dp.biases, dp.ln_scales, dp.ln_biases))]


def _port_run(data, layer, dtype, impl, grads):
    xyz, feats, cidx, groups, G = data
    N, M, radius, window, C, widths = LAYERS[layer]
    params = port_fsa.SAParams(*(tuple(torch.tensor(v, requires_grad=grads) for v in g)
                                 for g in groups))
    f = torch.tensor(feats, requires_grad=grads)
    launches = {s: k.launches for s, k in build.KERNELS.items()}
    with torch.set_grad_enabled(grads):
        out = port_fsa.fused_set_abstraction(
            torch.from_numpy(xyz), f, torch.from_numpy(cidx), params, radius=radius,
            window=window, block=64, compute_dtype=dtype, presorted=False, impl=impl,
            return_rank_order=False)
    assert {s: k.launches for s, k in build.KERNELS.items()} == launches  # CPU: plain only
    assert out.shape == (2, M, widths[-1]) and out.dtype == torch.float32
    if not grads:
        return out.numpy(), None
    (out * torch.from_numpy(G)).sum().backward()
    return out.detach().numpy(), [f.grad.numpy()] + [p.grad.numpy() for g in params for p in g]


def _assert_grads(got, want, exact_f32):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        if exact_f32:
            np.testing.assert_allclose(g, w, atol=XLA_ATOL, rtol=XLA_RTOL, err_msg=str(i))
        else:
            err = np.abs(g - w).max() / (np.abs(w).max() + 1e-6)
            assert err < REL, (i, err)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("layer", list(LAYERS))
def test_serving_layer_matches_jax_pallas(jax_tpu_serving_path, layer, dtype):  # noqa: F811
    data = _layer_inputs(layer, seed=1)
    assert_jax_sort_is_stable(data[0], LAYERS[layer][2])
    want, _ = _jax_run(data, layer, DTYPES[dtype][0], "pallas", grads=False)
    with torch.inference_mode():
        got, _ = _port_run(data, layer, DTYPES[dtype][1], None, grads=False)
    np.testing.assert_allclose(got, want, atol=0.03, rtol=0)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("layer", ["SA1", "SA2", "SA3"])
def test_training_layer_matches_jax_pallas_train(jax_tpu_training_path, layer,  # noqa: F811
                                                 dtype):
    data = _layer_inputs(layer, seed=2)
    assert_jax_sort_is_stable(data[0], LAYERS[layer][2])
    want, want_g = _jax_run(data, layer, DTYPES[dtype][0], "pallas_train", grads=True)
    got, got_g = _port_run(data, layer, DTYPES[dtype][1], None, grads=True)
    np.testing.assert_allclose(got, want, atol=0.03, rtol=0)
    _assert_grads(got_g, want_g, exact_f32=False)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("layer", ["SA1", "SA3"])
def test_xla_layer_matches_jax_xla(layer, dtype):
    data = _layer_inputs(layer, seed=3)
    want, want_g = _jax_run(data, layer, DTYPES[dtype][0], "xla", grads=True)
    got, got_g = _port_run(data, layer, DTYPES[dtype][1], "xla", grads=True)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=XLA_ATOL, rtol=XLA_RTOL)
    else:
        np.testing.assert_allclose(got, want, atol=0.03, rtol=0)
    _assert_grads(got_g, want_g, exact_f32=dtype == "f32")


def test_outputs_follow_center_idx_and_the_sort_is_a_permutation():
    """A cloud in random order gives what its Morton-sorted copy gives with
    the centers renamed: the sort is the only thing ``presorted`` changes."""
    N, M, radius, window, C, widths = LAYERS["SA1"]
    xyz, feats, cidx, groups, _ = _layer_inputs("SA1", seed=4)
    params = port_fsa.SAParams(*(tuple(torch.tensor(v) for v in g) for g in groups))
    t = torch.from_numpy
    keys = port_fsa.morton_keys(t(xyz), radius)
    order = torch.sort(keys, dim=1, stable=True).indices
    rank = torch.argsort(order, dim=1)
    kw = dict(radius=radius, window=window, compute_dtype=torch.float32)
    with torch.inference_mode():
        got = port_fsa.fused_set_abstraction(t(xyz), t(feats), t(cidx), params, presorted=False,
                                             return_rank_order=False, **kw)
        sorted_out, ranks = port_fsa.fused_set_abstraction(
            t(xyz).gather(1, order[..., None].expand(-1, -1, 3)),
            t(feats).gather(1, order[..., None].expand(-1, -1, C)),
            rank.gather(1, t(cidx).long()), params, **kw)
    want = sorted_out.gather(1, torch.argsort(torch.argsort(rank.gather(1, t(cidx).long()), 1),
                                              1)[..., None].expand(-1, -1, widths[-1]))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="return_rank_order"):
        port_fsa.fused_set_abstraction(t(xyz), t(feats), t(cidx), params, presorted=False, **kw)
