"""The compact pool backward at (256, 256, 512), on the CPU: what runs here of its CUDA route.

The width-4 backbone's SA1 (``sa_mlps[0]`` (256, 256, 512), W = 1024) takes the
compact backward (``sa_pool_bwd.compact_backward``); on the card its rows run
``csrc/sa_pair_pool_bwd_wide_compact.cu`` (``chip_smoke.py`` holds it to its
plain version). Here:

* its plain version against ``eda_tpu``'s compact Pallas backward in interpret
  mode at these widths (a window of 640, where the TPU rule picks compact),
  on ``chip_smoke.bwd_edge_inputs`` (a center whose channels one point wins
  all, one whose 512 channels 512 points win, winners outside the window, a
  clamped window), under the smoke's tolerances;
* its scratch plan: one CTA an SM with one record, a buffer of position rows
  (h1, h0, and S, a position's sum of bf16(dx)) and a map a CTA, a window's
  dA a block, nothing staged; the same for a narrower triple padded onto it,
  none for an empty call;
* ``chip_smoke.center_positions``, the distinct (center, position) pairs the
  kernel groups rows by (one for all winners outside the window), against a
  count in numpy, and the kernel's bound from them;
* the kernel's dW2: the rows of a position summed first (f32) and split into
  three bf16 parts, exactly, so that H0^T (hi + mid + lo) equals the rows'
  h0^T bf16(dx) products up to the order of f32 sums;
* the symbols the smoke and the timer give its calls.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import compiled

import chip_smoke
from eda_tpu.ops.pallas import sa_kernel as SK
from eda_tpu_torch.ops.cuda import build, sa_kernel, sa_pool_bwd

WIDE = (256, 256, 512)
RECORD = 256 * 256 + 256 * 512 + 3 * 256 + 512
H100_SMS = 132
T = torch.from_numpy


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-6)


def test_wide_compact_plain_matches_pallas():
    """(256, 256, 512) at W = 640 over 1280 points, one block of 16 centers,
    against the interpreted TPU kernel: dA and db_c within 0.5%, the weight
    and vector gradients within 1% of each output's largest value."""
    args, kw = chip_smoke.bwd_edge_inputs(B=1, N=1280, M=16, window=640, widths=WIDE)
    A, b_c, g, win, raw_starts, w2, b2, s2, lb2, w3 = (v.float().numpy() for v in args)
    win, raw_starts = win.astype(np.int32), raw_starts.astype(np.int32)
    W = kw["window"]
    assert sa_pool_bwd.compact_backward(W, WIDE[2])
    # the TPU kernel floors the starts but does not clamp them: hand it N - W
    starts = np.clip(raw_starts // 16 * 16, 0, A.shape[1] - W)
    assert (starts < raw_starts).any()
    layer_params = [(jnp.zeros((1, 1)), jnp.zeros(256), jnp.ones(256), jnp.zeros(256)),
                    (w2, b2, s2, lb2), (w3, jnp.zeros(512), jnp.ones(512), jnp.zeros(512))]
    want = compiled(
        functools.partial(SK.sa_pair_pool_bwd_pallas, layer_params=layer_params,
                          window=W, block=16, wc=128, interpret=True, compact=True),
        *(jnp.asarray(v) for v in (A, b_c, g, win, starts)),
    )
    dA, dbc, (dw2, dw3), (db2, db3), (ds2,), (dlb2,) = jax.tree_util.tree_map(np.asarray, want)
    got = sa_pool_bwd.sa_pool_bwd(
        T(A).bfloat16(), T(b_c).bfloat16(), T(g), T(win), T(raw_starts),
        T(w2), T(b2), T(s2), T(lb2), T(w3), window=W, compact=True)
    got = [v.numpy() for v in got]
    assert _rel(got[0], dA) < chip_smoke.POOL_BWD_A_REL
    assert _rel(got[1], dbc) < chip_smoke.POOL_BWD_A_REL
    for name, a, b in zip(("dW2", "db2", "ds2", "dlb2", "dW3", "db3"), got[2:],
                          (dw2, db2, ds2, dlb2, dw3, db3)):
        assert a.shape == b.shape, name
        assert _rel(a, b) < chip_smoke.POOL_BWD_W_REL, name


@pytest.mark.parametrize("widths,B,M,W,ctas", [
    (WIDE, 8, 2048, 1024, 132),        # W4X's SA1 at batch 8: 1024 blocks
    (WIDE, 1, 16, 640, 1),             # one block
    ((192, 160, 384), 2, 1024, 256, 128),   # padded onto WIDE
    ((160, 144, 272), 1, 4096, 1024, 132)])
def test_wide_compact_plan(widths, B, M, W, ctas):
    """A CTA an SM over every ctas-th block, one record a CTA, a window's dA a
    block; a buffer of ``WIDE_COMPACT_BUF_ROWS`` position rows (2 KiB each)
    and a (center, channel) map a CTA; nothing staged."""
    kernel = sa_kernel.kernel_widths(*widths)
    assert kernel == WIDE
    plan = sa_pool_bwd.scratch_plan(kernel, B, M, W, H100_SMS, compact=True)
    assert plan == {"ctas": ctas, "records": (ctas, RECORD), "da_records": (B * M // 16, W, 256),
                    "stage": None, "buf": (ctas, sa_pool_bwd.WIDE_COMPACT_BUF_ROWS, 1024),
                    "map": (ctas, 16, 512)}
    # the buffer's rows are the kernel's own constant, which holds a center's
    # 512 positions
    source = (build.CSRC / "sa_pair_pool_bwd_wide_compact.cu").read_text()
    assert f"constexpr int kMaxBufRows = {sa_pool_bwd.WIDE_COMPACT_BUF_ROWS};" in source
    assert sa_pool_bwd.WIDE_COMPACT_BUF_ROWS >= 512
    # the windowed rows at WIDE keep the staged fold (pool_bwd_wide)
    windowed = sa_pool_bwd.scratch_plan(kernel, B, M, W, H100_SMS, compact=False)
    assert windowed["stage"] == (ctas, sa_pool_bwd.WIDE_STAGE_ELEMS) and "buf" not in windowed


def test_wide_compact_plan_at_w4x_sa1_within_the_da_records():
    """W4X's SA1 at batch 8: the position buffers and maps (281 MB) take more
    than the staged tiles of the fold they replace (203 MB), but no more than
    the dA records a block (1 GiB) that both keep."""
    plan = sa_pool_bwd.scratch_plan(WIDE, 8, 2048, 1024, H100_SMS, compact=True)
    buffers = 2 * int(np.prod(plan["buf"])) + 4 * int(np.prod(plan["map"]))
    assert buffers < 4 * int(np.prod(plan["da_records"]))
    assert plan["records"] == (H100_SMS, RECORD)


def test_wide_compact_plan_with_no_block():
    plan = sa_pool_bwd.scratch_plan(WIDE, 0, 2048, 1024, H100_SMS, compact=True)
    assert plan["ctas"] == 0 and plan["stage"] is None and "buf" not in plan


@pytest.mark.parametrize("tie", [None, 4])
def test_center_positions_against_numpy(tie):
    """The distinct window offsets of each center's live channels, one for all
    winners outside the window."""
    args, kw = chip_smoke.bwd_edge_inputs(B=2, N=2048, M=64, window=640, widths=WIDE,
                                          tie_pool=tie)
    g, win, starts = args[2].numpy(), args[3].numpy(), args[4].numpy()
    W, N = kw["window"], args[0].shape[1]
    got = chip_smoke.center_positions(args, dict(kw, compact=True)).numpy()
    assert got.shape == g.shape[:2]
    start = np.clip(starts // 16 * 16, 0, N - W)
    for b in range(g.shape[0]):
        for m in range(g.shape[1]):
            rel = win[b, m] - start[b, m // 16]
            key = np.where((rel >= 0) & (rel < W), rel, W)
            assert got[b, m] == len(set(key[g[b, m] != 0].tolist()))
    # the edge kinds: one position (kind 0), 512 (kind 1), half outside (kind 2)
    assert got[0, 0] == 1 and got[0, 1] == 512 and got.min() == 0
    rows = chip_smoke.center_rows(args, dict(kw, compact=True)).numpy()
    assert (got <= rows).all() and got.sum() < rows.sum()


def test_position_bound_counts_the_work_a_position_shares():
    """The compact backward's bound at WIDE: dh0 a live row, h0 @ W2 and dW2 a
    distinct (center, position), a W3^T row and a dW3 column a won channel
    (counted in numpy); below the live-row count, whose h0 @ W2 and dW2 come
    a row."""
    args, kw = chip_smoke.bwd_edge_inputs(B=2, N=2048, M=64, window=640, widths=WIDE,
                                          tie_pool=4)
    kw = dict(kw, compact=True)
    g, win, starts = args[2].numpy(), args[3].numpy(), args[4].numpy()
    start = np.clip(starts // 16 * 16, 0, args[0].shape[1] - 640)
    rel = win - np.repeat(start, 16, axis=1)[..., None]
    key = np.where((rel >= 0) & (rel < 640), rel, 640)
    positions = sum(len(set(key[b, m][g[b, m] != 0].tolist()))
                    for b in range(g.shape[0]) for m in range(g.shape[1]))
    rows = int((g != 0).sum())
    c = 256 * 256
    want = rows * 2 * c + positions * 4 * c + rows * 4 * 256
    assert chip_smoke.pool_bwd_position_ops(args, kw) == want
    assert want < chip_smoke.pool_bwd_ops(args, kw) == rows * 6 * c + rows * 4 * 256
    spec = chip_smoke.kernel_specs()[chip_smoke.POOL_BWD_WC][2]
    ms, by = spec(args, kw)
    assert by == "operations" and ms == pytest.approx(1e3 * want / chip_smoke.PEAK_BF16)
    assert ms < chip_smoke.pool_bwd_bound(args, kw)[0]


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def test_three_bf16_parts_hold_an_f32_sum_exactly():
    """S = f32 sum of bf16 values; hi = bf16(S), mid = bf16(S - hi), lo =
    S - hi - mid (a bf16 value): hi + mid + lo == S, every part bf16."""
    rng = np.random.default_rng(0)
    rows = _bf16(rng.normal(size=(4096, 9)) * np.exp2(rng.integers(-30, 30, (4096, 1))))
    s = np.zeros(4096, np.float32)
    for k in range(rows.shape[1]):
        s = (s + rows[:, k]).astype(np.float32)
    hi = _bf16(s)
    r1 = (s - hi).astype(np.float32)
    mid = _bf16(r1)
    lo = (r1 - mid).astype(np.float32)
    np.testing.assert_array_equal(_bf16(lo), lo)
    np.testing.assert_array_equal(hi.astype(np.float64) + mid + lo, s.astype(np.float64))


def test_position_sums_give_the_rows_dw2():
    """dW2 as the kernel forms it, H0_p^T (hi + mid + lo)(sum of the position's
    bf16(dx) rows) in exact products and f32 sums, against the rows' own
    h0^T bf16(dx) products (f64): within f32 rounding."""
    rng = np.random.default_rng(1)
    positions, rows_a_position, c1, c2 = 32, 9, 256, 256
    h0 = _bf16(np.maximum(rng.normal(size=(positions, c1)), 0))
    dx = _bf16(rng.normal(size=(positions, rows_a_position, c2)) * 1e-3)
    want = np.einsum("pk,prc->kc", h0.astype(np.float64), dx.astype(np.float64))
    s = np.zeros((positions, c2), np.float32)
    for r in range(rows_a_position):
        s = (s + dx[:, r]).astype(np.float32)
    hi = _bf16(s)
    mid = _bf16(s - hi)
    lo = (s - hi - mid).astype(np.float32)
    got = np.zeros((c1, c2), np.float32)
    for part in (hi, mid, lo):
        got = (got + (h0.T @ part).astype(np.float32)).astype(np.float32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_wide_compact_symbols():
    """The compact rows at WIDE are their own kernel (symbol, source, replaced
    TPU kernel); the windowed rows there and the compact rows at (128, 128,
    256) and below keep theirs."""
    kernel = sa_pool_bwd.WIDE_COMPACT_KERNEL
    assert kernel.symbol == chip_smoke.POOL_BWD_WC == "sa_pool_bwd_wide_compact_launch"
    assert kernel.source == "sa_pair_pool_bwd_wide_compact" in build.SOURCES
    assert build.KERNELS[kernel.symbol] is kernel
    assert kernel.replaces == sa_pool_bwd.COMPACT_KERNEL.replaces
    assert (build.CSRC / f"{kernel.source}.cu").exists()
    g = torch.zeros(1, 16, 512)
    wide = (torch.zeros(1, 32, 256), None, g, None, None, None, None, None, None,
            torch.zeros(256, 512))
    narrow = (torch.zeros(1, 32, 128), None, g, None, None, None, None, None, None,
              torch.zeros(128, 256))
    xl = (torch.zeros(1, 32, 512), None, g, None, None, None, None, None, None,
          torch.zeros(512, 1024))
    assert chip_smoke.pool_bwd_symbol({"compact": True}, wide) == chip_smoke.POOL_BWD_WC
    assert chip_smoke.pool_bwd_symbol({"compact": False}, wide) == chip_smoke.POOL_BWD[1]
    assert chip_smoke.pool_bwd_symbol({"compact": True}, narrow) == chip_smoke.POOL_BWD[0]
    assert chip_smoke.pool_bwd_symbol({"compact": True}, xl) == chip_smoke.POOL_BWD_XL[0]
    steps = chip_smoke.w4x_step_launches("pair")
    assert steps[chip_smoke.POOL_BWD_WC] == 1 and chip_smoke.POOL_BWD[0] not in steps
    # the kernel must be among the build check's tensor-core kernels
    assert ("sa_pair_pool_bwd_wide_compact", "pool_bwd_compact_wide") in chip_smoke.REQUIRED_KERNELS
    assert any(case[1] == WIDE and case[4] >= 640 for case in chip_smoke.BWD_EDGE_CASES)
