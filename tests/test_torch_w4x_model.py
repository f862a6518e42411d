"""The width-4 backbone ("W4X") of the port against ``eda_tpu`` on the CPU: widths, model, ceilings.

W4X (``chip_smoke.w4x_configs``) runs its SA2-4 on the (512, 512, 1024) pool
(``sa_kernel.XL``, with winners for training), its backward
(``csrc/sa_pair_pool_bwd_512.cu``) and the c1-512 prep (``csrc/sa_prep_512.cu``,
``csrc/sa_prep_bwd_512.cu``); its layers are held to ``eda_tpu`` in
``test_torch_w4x.py``, its training step in ``test_torch_w4x_train_step.py``. Here, on the
plain versions that the card holds those kernels to:

* the fused SA layer at the odd widths (384, 384, 768) and (300, 300, 600),
  which run zero-padded on XL, on the tiny config's SA2 and SA3 shapes
  against ``eda_tpu``'s interpreted Pallas training path, as the W4X layers
  are held (``torch_parity.fused_sa_layer_vs_jax_on_its_winners``);
* the W4X configs: the flagship's fields with every SA and FP width times 4;
* the plain prep at c1 384 and 512 against the JAX prep kernel (interpreted),
  within 0.02 in bf16 as ``tests/test_torch_sa_prep.py``;
* the tiny bf16 W4X grounder's serving forward against ``eda_tpu`` on the same
  weights, under ``torch_parity``'s grounder tolerances, the decoder on the
  JAX run's seeds and the port's own KPS keeping them but for boundary
  near-ties (as ``tests/test_torch_gather_backbone.py``: the 1024-channel
  backbone's bf16 differences move the objectness logits across such ties);
  the f32 grounder is a case of ``tests/test_torch_f32_model.py``;
* the training kernels' ceilings: the winners pool, the pool backward and the
  prep backward (K7, K7f) take every triple up to XL and c1 up to 512 on a
  non-CPU tensor (meta tensors stand in for CUDA ones: they reach the CUDA
  requirement) and refuse wider layers with the message naming ROADMAP item
  8.3 before they touch them; the forward prep takes c1 up to 512; every W4X
  layer passes ``fused_sa.check_trainable`` (which the backbone calls before
  its first launch), as the flagship's and W2X's do, and a layer above XL is
  refused;
* ``sa_kernel.pack_xl``, the weight stream of the XL pool with and without
  winners, against a plain reordering; ``tools/step_noise.py``'s tiny step
  on the CPU (the recorded decisions replayed, wrappers swapped).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    assert_grounder_outputs_match,
    assert_kps_matches_up_to_boundary_ties,
    compiled,
    fused_sa_layer_vs_jax_on_its_winners,
    grounder_forwards,
    jax_tpu_serving_path,
    jax_tpu_training_path,
    one_torch_thread,
)

import chip_smoke
from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.ops.pallas import sa_prep as jax_prep
from eda_tpu.ops.pallas.sa_kernel import _ceil_lane, _pad_lanes
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.models.pointnet2 import PointNetPPBackbone
from eda_tpu_torch.ops import fused_sa
from eda_tpu_torch.ops.cuda import sa_kernel, sa_pool_bwd, sa_prep

pytestmark = pytest.mark.usefixtures("one_torch_thread")

XL = (512, 512, 1024)
# widths between (256, 256, 512) and XL, which run zero-padded on XL, at the
# tiny config's SA2 and SA3 shapes
ODD_LAYERS = [(256, 128, 128, 0.4, 384, (384, 384, 768)),
              (128, 64, 64, 0.8, 600, (300, 300, 600))]


@pytest.mark.parametrize("N,M,window,radius,C,widths", ODD_LAYERS,
                         ids=["384-384-768", "300-300-600"])
def test_w4x_odd_widths_fused_sa_layer_matches_jax_pallas_train(
        jax_tpu_training_path, N, M, window, radius, C, widths):  # noqa: F811
    assert sa_kernel.kernel_widths(*widths) == XL != widths  # padded on XL
    fused_sa_layer_vs_jax_on_its_winners(N, M, window, radius, C, widths)


def test_w4x_configs_are_the_flagship_at_width_4():
    cfg, tiny = chip_smoke.w4x_configs(ModelConfig(use_bf16=True))
    base = ModelConfig(use_bf16=True)
    assert cfg.sa_mlps == tuple(tuple(4 * c for c in m) for m in base.sa_mlps)
    assert cfg.fp_mlps == ((1024, 1024), (1024, 288)) and cfg.fp_mlps[-1][-1] == base.d_model
    assert dataclasses.replace(cfg, sa_mlps=base.sa_mlps, fp_mlps=base.fp_mlps) == base
    assert tiny.sa_mlps == cfg.sa_mlps and tiny.fp_mlps[-1][-1] == tiny.d_model == 96
    assert dataclasses.replace(tiny, sa_mlps=base.tiny().sa_mlps,
                               fp_mlps=base.tiny().fp_mlps) == base.tiny()
    in_dims = [3 + (cfg.input_feature_dim if i == 0 else cfg.sa_mlps[i - 1][-1])
               for i in range(4)]
    assert in_dims == [6, 515, 1027, 1027]
    assert [sa_kernel.kernel_widths(*m) for m in cfg.sa_mlps] == list(cfg.sa_mlps)
    assert cfg.sa_mlps[0] in sa_kernel.WIDTHS
    assert all(m == sa_kernel.XL for m in cfg.sa_mlps[1:])


@pytest.mark.parametrize("c1,in_dim", [(384, 515), (512, 1027)])
def test_w4x_prep_plain_matches_jax_kernel(c1, in_dim):
    radius = 0.8
    rng = np.random.default_rng(c1)
    pts = rng.uniform(-2, 2, (1, 200, in_dim)).astype(np.float32)
    w1 = (rng.normal(size=(in_dim, c1)) * in_dim ** -0.5).astype(np.float32)
    b1, l1 = (0.1 * rng.normal(size=(2, c1))).astype(np.float32)
    s1 = (1 + 0.1 * rng.normal(size=c1)).astype(np.float32)
    c1p = _ceil_lane(c1)
    pad = lambda v: _pad_lanes(jnp.asarray(v).reshape(1, -1), c1p)  # noqa: E731
    A, _ = compiled(
        functools.partial(jax_prep._prep_fwd, c_real=c1, dtype=jnp.bfloat16,
                          radius=radius, interpret=True),
        jnp.asarray(pts), _pad_lanes(jnp.asarray(w1), c1p), pad(b1), pad(s1), pad(l1),
    )
    want = np.asarray(A.astype(jnp.float32))[..., :c1]
    got = sa_prep.sa_prep(*(torch.from_numpy(v) for v in (pts, w1, b1, s1, l1)),
                          radius=radius)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 200, c1)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.02, rtol=0)


def test_w4x_grounder_matches_jax_serving_path(jax_tpu_serving_path):  # noqa: F811
    _, cfg = chip_smoke.w4x_configs(ModelConfig(use_bf16=True))
    over = dict(sa_mlps=cfg.sa_mlps, fp_mlps=cfg.fp_mlps)
    jcfg = dataclasses.replace(JaxConfig(use_bf16=True).tiny(), **over)
    gen = SyntheticScenes(SyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                          vocab_size=512)
    got, want = grounder_forwards(jcfg, cfg, gen.batch(range(2)), jax_kps=True)
    assert_grounder_outputs_match(got, want, cfg)
    assert_kps_matches_up_to_boundary_ties(got, want, cfg.num_queries)
    assert got["last_center"].shape == (2, cfg.num_queries, 3)
    assert np.isfinite(got["last_center"]).all()


def _meta(*shapes, dtype=torch.float32):
    return tuple(torch.empty(s, dtype=dtype, device="meta") for s in shapes)


def _refused(fn) -> bool:
    """Whether ``fn()`` raises the ValueError naming ROADMAP item 8.3 (True) or
    fails past the width checks, at the CUDA requirement (False): meta tensors
    lie on no card."""
    try:
        fn()
    except ValueError as err:
        if "ROADMAP item 8.3" in str(err):
            return True
        assert "expected a CUDA tensor" in str(err), err
        return False
    raise AssertionError("a kernel wrapper ran on meta tensors")


@pytest.mark.parametrize("widths,named", [((256, 256, 512), False), ((288, 256, 512), False),
                                          ((384, 384, 768), False), (XL, False)]
                         + [(w, True) for w in chip_smoke.TOO_WIDE])
def test_training_pool_kernels_refuse_widths_above_their_ceiling(widths, named):
    c1, c2, c3 = widths
    B, N, M, W = 1, 512, 32, 256
    bf16 = dict(dtype=torch.bfloat16)
    A, b_c = _meta((B, N, c1), (B, M, c1), **bf16)
    xyz, cen, w2, b2, s2, lb2, w3, b3 = _meta((B, N, 3), (B, M, 3), (c1, c2), (c2,), (c2,),
                                              (c2,), (c2, c3), (c3,))
    starts, = _meta((B, M // 16), dtype=torch.int32)
    g, = _meta((B, M, c3))
    win, = _meta((B, M, c3), dtype=torch.int32)
    assert _refused(lambda: sa_kernel.sa_pair_pool_winners(
        A, xyz, b_c, cen, starts, w2, b2, s2, lb2, w3, b3, radius=0.4, window=W)) == named
    for compact in (True, False):
        assert _refused(lambda: sa_pool_bwd.sa_pool_bwd(
            A, b_c, g, win, starts, w2, b2, s2, lb2, w3, window=W, compact=compact)) == named
    # the serving pool takes the same widths
    assert _refused(lambda: sa_kernel.sa_pair_pool(
        A, xyz, b_c, cen, starts, w2, b2, s2, lb2, w3, b3, radius=0.4, window=W)) == named
    assert sa_kernel.WIDTHS[-1] == XL
    assert sa_pool_bwd.WIDE == (256, 256, 512) != sa_kernel.XL


@pytest.mark.parametrize("c1,named", [(256, False), (257, False), (512, False), (513, True)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["K7", "K7f"])
def test_prep_backward_refuses_c1_above_256(dtype, c1, named):
    pts, dA, w1, b1, scale = _meta((1, 100, 515), (1, 100, c1), (515, c1), (c1,), (c1,))
    assert _refused(lambda: sa_prep.sa_prep_bwd(pts, dA, w1, b1, scale, radius=0.4,
                                                compute_dtype=dtype)) == named


def test_prep_forward_takes_c1_up_to_512_on_cuda():
    """c1 512 and 300 pass the width check (and fail at the CUDA requirement on
    meta tensors); c1 513 is refused by it."""
    for c1, ok in ((512, True), (300, True), (513, False)):
        pts, w1, b1, scale, lnb = _meta((1, 100, 515), (515, c1), (c1,), (c1,), (c1,))
        with pytest.raises(ValueError) as err:
            sa_prep.sa_prep(pts, w1, b1, scale, lnb, radius=0.4)
        assert ("expected a CUDA tensor" if ok else "c1 from 1 to 512") in str(err.value)


def test_w4x_training_is_refused_layer_by_layer_before_any_launch():
    cfg, _ = chip_smoke.w4x_configs(ModelConfig(use_bf16=True))
    backbone = PointNetPPBackbone(input_feature_dim=cfg.input_feature_dim,
                                  npoints=cfg.sa_npoints, mlps=cfg.sa_mlps,
                                  fp_mlps=cfg.fp_mlps, sa_windows=cfg.sa_windows)
    n = cfg.num_points
    for i in range(4):  # every W4X layer trains
        sa = getattr(backbone, f"sa{i + 1}")
        assert fused_sa.runs_kernels(sa.window, n)
        fused_sa.check_trainable(sa.params(), window=sa.window, n_points=n)
        n = sa.npoint
    # the flagship and the width-2 backbone train
    for mlps in (ModelConfig().sa_mlps, chip_smoke.W2X_SA_MLPS):
        for m in mlps:
            sa_kernel.kernel_widths(*m)
    # a layer above XL is refused before any launch, naming the item
    for c1, c2, c3 in chip_smoke.TOO_WIDE:
        kernels = _meta((3 + 1027, c1), (c1, c2), (c2, c3))
        params = fused_sa.SAParams(kernels, *(_meta((c1,), (c2,), (c3,)),) * 3)
        with pytest.raises(ValueError, match="ROADMAP item 8.3"):
            fused_sa.check_trainable(params, window=256, n_points=1024)


def test_pack_xl_lays_the_weights_out_as_the_xl_pool_reads_them():
    """``sa_kernel.pack_xl``, the weight stream of the XL pool with and without
    winners, against a plain reordering: W2, then W3 in four passes of 256
    columns, each matrix in the no-swizzle core layout with rows = K, element
    (k, n) of a matrix of C columns at ((k // 8) * (C // 8) + n // 8) * 64 +
    (k % 8) * 8 + n % 8; a chunk (32 rows of W2, 64 of a W3 pass) 32 KiB."""
    g = torch.Generator().manual_seed(0)
    w2 = torch.randn(512, 512, generator=g).bfloat16()
    w3 = torch.randn(512, 1024, generator=g).bfloat16()
    packed = sa_kernel.pack_xl(w2, w3)
    assert packed.dtype == torch.bfloat16 and packed.shape == (3 * 512 * 512,)

    def cores(m):
        K, C = m.shape
        k, n = torch.meshgrid(torch.arange(K), torch.arange(C), indexing="ij")
        at = ((k // 8) * (C // 8) + n // 8) * 64 + (k % 8) * 8 + n % 8
        out = torch.empty(K * C, dtype=m.dtype)
        out[at.flatten()] = m.flatten()
        return out

    passes = [w3[:, n:n + sa_kernel.XL_PASS_COLS] for n in range(0, 1024, sa_kernel.XL_PASS_COLS)]
    want = torch.cat([cores(w2)] + [cores(p) for p in passes])
    assert torch.equal(packed, want)
    # a W2 chunk of 32 K rows and a W3 pass chunk of 64 are 32 KiB each, contiguous
    assert 32 * 512 * 2 == 64 * sa_kernel.XL_PASS_COLS * 2 == 32768
    assert torch.equal(packed[:32 * 512], cores(w2[:32]))


def test_step_noise_tool_replays_the_decisions_and_swaps_wrappers(monkeypatch, capsys):
    """``tools/step_noise.py`` on the CPU: the tiny step replayed on the
    recorded KPS indices and matches, with the pools swapped for their plain
    versions (which the CPU runs anyway), gives the recorded step's moments bit
    for bit; the pools moved by 2^-8 move them; without a card the tool exits
    non-zero, printing nothing."""
    from eda_tpu_torch.ops import fused_sa
    from eda_tpu_torch.tools import step_noise

    cfg = step_noise.tiny_config("flagship", f32=True)
    assert not cfg.use_bf16 and cfg.dropout == 0.0
    _, tiny = chip_smoke.w4x_configs(ModelConfig(use_bf16=True))
    assert step_noise.tiny_config("w4x", f32=False) == dataclasses.replace(tiny, dropout=0.0)
    chosen = {}
    want, want_m = step_noise.step_moments(cfg, "cpu", {}, chosen)
    assert set(chosen) == {"kps", "match"}
    got, got_m = step_noise.step_moments(
        cfg, "cpu", {"sa_pair_pool_winners": sa_kernel.sa_pair_pool_winners_plain}, chosen)
    assert step_noise.global_cos(got, want) == pytest.approx(1.0, abs=1e-12)
    assert all(torch.equal(got[k], want[k]) for k in want) and got_m == want_m
    assert fused_sa.sa_pair_pool_winners is sa_kernel.sa_pair_pool_winners  # restored
    gen = torch.Generator().manual_seed(0)

    def moved(*a, **k):
        v, w = sa_kernel.sa_pair_pool_winners(*a, **k)
        return v * (1 + (torch.rand(v.shape, generator=gen) * 2 - 1) * 2.0 ** -8), w

    got, _ = step_noise.step_moments(cfg, "cpu", {"sa_pair_pool_winners": moved}, chosen)
    assert step_noise.global_cos(got, want) < 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert step_noise.main([]) != 0 and capsys.readouterr().out == ""
