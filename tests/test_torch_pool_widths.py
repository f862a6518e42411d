"""The pair pool and its backward at layer widths outside the kernels' instantiations.

On CUDA a triple (c1, c2, c3) outside ``sa_kernel.WIDTHS`` runs zero-padded on
the smallest instantiated triple that covers it (``kernel_widths``,
``pad_widths``), with the real c2 as the interior LayerNorm's divisor, and the
outputs are sliced back; a triple above (128, 128, 256) raises. These tests
hold that on the CPU through the plain versions, which the kernels are held
to on the card:

* the plain pool (every radius test, with winners) and the plain pool
  backward (compact and windowed) on the padded operands with the real c2,
  sliced back, against the same plain functions on the real widths. Padding
  adds exact zeros to every sum, but the CPU's matmuls block a padded K
  otherwise and may round a sum's last bit elsewhere. The pooled values
  agree to 1e-5 of their largest value, and the winners wherever the best
  two values are further apart than twice the largest value error. Each
  backward output agrees to 1e-3 of its largest value: there such a last
  bit can carry a bf16 rounding of h1 or dx to the other side (1.4e-4 at most
  in these cases);
* the fused SA layer's forward and backward at widths outside ``WIDTHS`` on
  each layer of the tiny config against ``eda_tpu`` on its interpreted Pallas
  training path, which pads to 128 lanes, under the tolerances of
  ``tests/test_torch_fused_sa_train.py`` (0.03 abs on the features, 2% of each
  gradient leaf's largest value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import compiled, jax_tpu_training_path  # noqa: F401

import chip_smoke
from eda_tpu.ops import fused_sa as jax_fsa
from eda_tpu_torch.data.presort import morton_sort
from eda_tpu_torch.ops import fused_sa as port_fsa
from eda_tpu_torch.ops.cuda import sa_kernel, sa_pool_bwd

PAD_REL, PAD_BWD_REL = 1e-5, 1e-3
REL = 0.02
# widths outside WIDTHS, one a layer of the tiny config
ODD_MLPS = ((24, 24, 40), (48, 40, 80), (40, 56, 72), (40, 40, 96))


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / (want.float().abs().max() + 1e-30))


def test_kernel_widths_picks_the_smallest_cover():
    assert sa_kernel.kernel_widths(16, 16, 32) == (16, 16, 32)
    assert sa_kernel.kernel_widths(24, 24, 40) == (32, 32, 64)
    assert sa_kernel.kernel_widths(48, 40, 80) == (64, 64, 128)
    assert sa_kernel.kernel_widths(40, 56, 72) == (64, 64, 128)
    assert sa_kernel.kernel_widths(96, 80, 200) == (128, 128, 256)
    assert sa_kernel.kernel_widths(8, 100, 8) == (128, 128, 256)
    for widths in chip_smoke.TOO_WIDE:
        with pytest.raises(ValueError, match="widths up to"):
            sa_kernel.kernel_widths(*widths)


def test_pad_widths_keeps_the_real_values_and_pads_zeros():
    args, _ = chip_smoke.bwd_edge_inputs(B=1, N=512, M=32, window=128, widths=(24, 40, 72))
    A, b_c, g, win, _, w2, b2, s2, lb2, w3 = args
    b3 = torch.randn(72)
    padded = sa_kernel.pad_widths((32, 64, 128), A, b_c, w2, b2, s2, lb2, w3, b3, g, win)
    real = (A, b_c, w2, b2, s2, lb2, w3, b3, g, win)
    shapes = ((1, 512, 32), (1, 32, 32), (32, 64), (64,), (64,), (64,), (64, 128), (128,),
              (1, 32, 128), (1, 32, 128))
    for p, r, shape in zip(padded, real, shapes):
        assert p.shape == shape and p.dtype == r.dtype
        inner = p[tuple(slice(0, n) for n in r.shape)]
        assert torch.equal(inner, r)
        assert int((p != 0).sum()) == int((r != 0).sum())  # zeros elsewhere
    assert sa_kernel.pad_widths((24, 40, 72), A, b_c, w2, b2, s2, lb2, w3)[-3:] == (None,) * 3


@pytest.mark.parametrize("mode", sa_kernel.D2_MODES)
@pytest.mark.parametrize("widths,window", [((24, 24, 40), 128), ((48, 40, 80), 64),
                                           ((96, 80, 200), 128)])
def test_padded_pool_equals_the_real_widths(mode, widths, window):
    args, kw = chip_smoke.tie_inputs(B=2, N=512, M=64, window=window, widths=widths, seed=3)
    args = chip_smoke.random_w3(args, seed=4)
    kw["d2_mode"] = mode
    if mode == "pre":
        from eda_tpu_torch.ops.cuda import sa_mask
        kw["mask"] = sa_mask.sa_radius_mask_plain(args[1], args[3], args[4],
                                                  radius=kw["radius"], window=window)
    A, xyz, b_c, cen, starts, w2, b2, s2, lb2, w3, b3 = args
    big = sa_kernel.kernel_widths(*widths)
    assert big != widths
    pA, pbc, pw2, pb2, ps2, plb2, pw3, pb3, _, _ = sa_kernel.pad_widths(
        big, A, b_c, w2, b2, s2, lb2, w3, b3)
    want, want_win, second = sa_kernel.sa_pair_pool_winners_plain(*args, **kw, runner_up=True)
    got, got_win = sa_kernel.sa_pair_pool_winners_plain(
        pA, xyz, pbc, cen, starts, pw2, pb2, ps2, plb2, pw3, pb3, **kw, c2_real=widths[1])
    serve = sa_kernel.sa_pair_pool_plain(
        pA, xyz, pbc, cen, starts, pw2, pb2, ps2, plb2, pw3, pb3, **kw, c2_real=widths[1])
    c3 = widths[2]
    assert got.shape == (2, 64, big[2])
    assert torch.equal(serve, got)
    got, got_win = got[..., :c3], got_win[..., :c3]
    assert torch.equal(got < -1e8, want < -1e8)
    err = (got - want).abs().max().item()
    assert err <= PAD_REL * want.abs().max().item()
    separated = (want - second) > 2 * err + 1e-6
    assert separated[want > -1e8].float().mean() > 0.9  # centers with a pair in radius
    assert torch.equal(got_win[separated], want_win[separated])


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "windowed"])
@pytest.mark.parametrize("widths,window", [((24, 24, 40), 128), ((48, 40, 80), 256),
                                           ((96, 80, 200), 256)])
def test_padded_pool_backward_equals_the_real_widths(compact, widths, window):
    args, kw = chip_smoke.bwd_edge_inputs(B=2, N=1024, M=64, window=window, widths=widths,
                                          seed=5)
    A, b_c, g, win, starts, w2, b2, s2, lb2, w3 = args
    big = sa_kernel.kernel_widths(*widths)
    pA, pbc, pw2, pb2, ps2, plb2, pw3, _, pg, pwin = sa_kernel.pad_widths(
        big, A, b_c, w2, b2, s2, lb2, w3, g=g, winners=win)
    want = sa_pool_bwd.sa_pool_bwd_plain(*args, **kw, compact=compact)
    got = sa_pool_bwd.sa_pool_bwd_plain(pA, pbc, pg, pwin, starts, pw2, pb2, ps2, plb2, pw3,
                                        **kw, compact=compact, c2_real=widths[1])
    c1, c2, c3 = widths
    real = (lambda t: t[..., :c1], lambda t: t[..., :c1], lambda t: t[:c1, :c2],
            lambda t: t[:c2], lambda t: t[:c2], lambda t: t[:c2], lambda t: t[:c2, :c3],
            lambda t: t[:c3])
    for i, (cut, got_i, want_i) in enumerate(zip(real, got, want)):
        sliced = cut(got_i)
        assert sliced.shape == want_i.shape, i
        assert _rel(sliced, want_i) <= PAD_BWD_REL, (i, _rel(sliced, want_i))


def _layer_setup(seed, N, M, C, widths):
    rng = np.random.default_rng(seed)
    xyz = np.stack([morton_sort(rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32),
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


# the tiny config's SA layers (ModelConfig.tiny(): 1024 points, npoints 256 /
# 128 / 64 / 32, windows 256 / 128 / 64 / 64, radii 0.2 / 0.4 / 0.8 / 1.2, 3
# input features) at the ODD_MLPS widths; each layer's input features are the
# previous layer's c3
TINY_LAYERS = [(1024, 256, 256, 0.2, 3, ODD_MLPS[0]), (256, 128, 128, 0.4, 40, ODD_MLPS[1]),
               (128, 64, 64, 0.8, 80, ODD_MLPS[2]), (64, 32, 64, 1.2, 72, ODD_MLPS[3])]


@pytest.mark.parametrize("N,M,window,radius,C,widths", TINY_LAYERS,
                         ids=["SA1", "SA2", "SA3", "SA4"])
def test_fused_sa_at_odd_widths_matches_jax_pallas_train(
        jax_tpu_training_path, N, M, window, radius, C, widths):  # noqa: F811
    assert sa_kernel.kernel_widths(*widths) != widths
    xyz, feats, cidx, groups, G = _layer_setup(N + M + C, N, M, C, widths)
    kw = dict(radius=radius, window=window, block=64, compute_dtype=jnp.bfloat16,
              presorted=True, impl="pallas_train", return_rank_order=True)

    def loss(feats_, params):
        out, _ = jax_fsa.fused_set_abstraction(jnp.asarray(xyz), feats_, jnp.asarray(cidx),
                                               params, **kw)
        return jnp.sum(out * G), out

    params = jax_fsa.SAParams(*(tuple(jnp.asarray(v) for v in g) for g in groups))
    (_, want), (want_df, want_dp) = compiled(
        lambda f, p: jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(f, p),
        jnp.asarray(feats), params)

    port_params = port_fsa.SAParams(*(tuple(torch.tensor(v, requires_grad=True) for v in g)
                                      for g in groups))
    f = torch.tensor(feats, requires_grad=True)
    got, _ = port_fsa.fused_set_abstraction(torch.from_numpy(xyz), f, torch.from_numpy(cidx),
                                            port_params, radius=radius, window=window, block=64)
    (got * torch.from_numpy(G)).sum().backward()

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=0.03, rtol=0)
    pairs = [("features", f.grad, want_df)]
    for gi, name in enumerate(("kernels", "biases", "ln_scales", "ln_biases")):
        for i, (p, w) in enumerate(zip(port_params[gi], getattr(want_dp, name))):
            pairs.append((f"{name}[{i}]", p.grad, w))
    for name, g, w in pairs:
        w = np.asarray(w)
        assert g is not None and g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max() / (np.abs(w).max() + 1e-6)
        assert err < REL, (name, err)
