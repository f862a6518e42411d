"""The radius-mode checks of ``chip_smoke.py``, run on the CPU with the plain versions.

The smoke holds the ``mxu`` and ``pre`` kernels against the ``pair`` kernel
and excuses only centers with a window point on the radius boundary; it
counts launches per forward and step from tables. Those checks must catch a
wrong mask and accept a right one, so they run here on small CPU inputs
(where every wrapper runs its plain version):

* the launch tables are the ones the port's layers produce;
* ``boundary_centers`` flags exactly the centers with a window point within
  1e-5 of the radius;
* ``against_pair`` passes the true mask and raises on a mask that drops a
  pair far from the boundary; ``check_kernel`` accepts only a bit-exact mask;
* ``pool_bound`` counts the mask's pairs under ``pre``; ``mask_bound`` reads
  xyz once, however much the windows overlap;
* the eval phase compares a radius test's IoU stack with the ``pair`` stack
  at every scene whose end points equal pair's, and accepts another forward
  only where an SA layer's output moved;
* ``empty_tiles`` counts the (center, 64-point) tiles the pool kernel skips;
  the pool tie check's input makes every in-radius pair of a center tie, so
  that the plain winners are the tie rule's, with -1e9 rows and clamped
  windows, also at a window wider than 128 points; ``check_pool_build``
  refuses spills and a GEMM kernel without HGMMA in the pool's library, in
  its backward's and in the prep backward's;
* ``bwd_edge_inputs`` holds the pool backward's edge cases: centers with one
  live row carrying all c3 channels and with c3 rows, blocks with no live
  row, compact winners outside the window, windows clamped at N - W; and
  ``center_rows`` counts the rows the kernel packs;
* ``fps_edge_inputs`` and ``prep_bwd_edge_inputs`` hold the edge cases their
  checks name, and the plain versions give defined results on them;
* the pool widths phase's triples lie outside the instantiated widths and
  below the widest (``TOO_WIDE`` above it), on inputs of the shapes it names;
  ``prep_edge_inputs`` and ``mask_edge_inputs`` hold the edge cases their
  checks name (ragged row counts and windows, the widths and in_dims, clamped
  and unaligned windows, points on the radius); ``prep_bound`` reads the
  points once and writes A once;
* the width-4 backbone's training phase: its launch table, the symbols its
  recorder files each call under by widths and dtype, the XL backward's edge
  cases, the c1-512 prep backward's edge cases and the build check of the
  ``mma.sync`` libraries (no spill, HMMA in every GEMM kernel);
* the device-sort phase's ``permuted`` puts each scene's points in its own
  random order and the per-point labels with them, and leaves the rest;
  ``_leaf_rel_errs`` holds each gradient leaf to the largest value of all.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.entry import build_evaluator
from eda_tpu_torch.eval.grounding import score_and_iou_multi
from eda_tpu_torch.ops.cuda import fps, sa_kernel, sa_mask, sa_pool_bwd, sa_prep

RADIUS = float(np.sqrt(0.0913))  # r^2 off the 0.05 grid's d2 values
T = torch.from_numpy


def _pool_args(seed=0, N=256, M=32, W=128, c1=16, c2=16, c3=32):
    rng = np.random.default_rng(seed)
    xyz = np.sort((rng.integers(-20, 20, (2, N, 3)) * 0.05).astype(np.float32), axis=1)
    ranks = np.stack([np.sort(rng.permutation(N)[:M]) for _ in range(2)])
    cen = np.take_along_axis(xyz, ranks[..., None], 1)
    starts = np.clip(ranks.reshape(2, M // 16, 16)[:, :, 8] - W // 2, 0, N - W).astype(np.int32)
    args = (T(rng.normal(size=(2, N, c1)).astype(np.float32)).bfloat16(), T(xyz),
            T(rng.normal(size=(2, M, c1)).astype(np.float32)).bfloat16(), T(cen), T(starts),
            T((rng.normal(size=(c1, c2)) * 0.4).astype(np.float32)), torch.zeros(c2),
            torch.ones(c2), torch.zeros(c2),
            T((rng.normal(size=(c2, c3)) * 0.4).astype(np.float32)), torch.zeros(c3))
    return args, W


def test_launch_tables():
    assert chip_smoke.forward_launches("pair") == {
        "fps_launch": 4, "sa_prep_launch": 4, "sa_pair_pool_launch": 4}
    assert chip_smoke.forward_launches("pre") == {
        "fps_launch": 4, "sa_prep_launch": 4, "sa_pair_pool_pre_launch": 4,
        "sa_radius_mask_launch": 4}
    assert chip_smoke.step_launches("mxu") == {
        "fps_launch": 4, "sa_prep_launch": 4, "sa_pair_pool_mxu_winners_launch": 4,
        "sa_pool_bwd_compact_launch": 1, "sa_pool_bwd_window_launch": 3,
        "sa_prep_bwd_launch": 4}


def test_boundary_centers_flags_points_on_the_radius():
    xyz = torch.zeros(1, 32, 3)
    xyz[0, :, 0] = torch.arange(32) * 0.5  # spaced far beyond 1e-5 of any radius
    cen = xyz[:, :16].clone()
    xyz[0, 20, 0] = 3.5 + RADIUS  # on center 7's radius (3.5 + r)
    r2 = torch.tensor(RADIUS * RADIUS).item()
    assert abs(((xyz[0, 20] - cen[0, 7]) ** 2).sum().item() - r2) <= 1e-5
    near = chip_smoke.boundary_centers(xyz, cen, torch.zeros(1, 1, dtype=torch.int32),
                                       RADIUS, 32)
    assert near[0].nonzero().flatten().tolist() == [7]


def test_against_pair_catches_a_wrong_mask(capsys):
    args, W = _pool_args()
    kw = {"radius": RADIUS, "window": W, "d2_mode": "pre"}
    mask = sa_mask.sa_radius_mask(args[1], args[3], args[4], radius=RADIUS, window=W)
    got = chip_smoke.kernel_specs()["sa_pair_pool_pre_launch"][0](*args, **kw, mask=mask)
    chip_smoke.against_pair("sa_pair_pool_pre_launch", args, {**kw, "mask": mask}, got, 1)
    assert "0 of" in capsys.readouterr().out
    assert chip_smoke.check_kernel(chip_smoke.MASK, mask, mask.clone(), 1) == 0.0

    wrong = mask.clone()
    wrong[0, 0] = 0  # every pair of the first block dropped, none near the boundary
    got = chip_smoke.kernel_specs()["sa_pair_pool_pre_launch"][0](*args, **kw, mask=wrong)
    with pytest.raises(AssertionError, match="boundary"):
        chip_smoke.against_pair("sa_pair_pool_pre_launch", args, {**kw, "mask": wrong}, got, 1)
    with pytest.raises(AssertionError, match="mask kernel"):
        chip_smoke.check_kernel(chip_smoke.MASK, wrong, mask, 1)


def test_pool_bound_counts_the_mask_pairs():
    args, W = _pool_args()
    mask = sa_mask.sa_radius_mask(args[1], args[3], args[4], radius=RADIUS, window=W)
    pre = chip_smoke.pool_bound(args, {"radius": RADIUS, "window": W, "d2_mode": "pre",
                                       "mask": mask})
    # grid coordinates, r^2 off the grid: the same pairs either way
    pairs = chip_smoke.in_radius_pairs(args[1], args[3], args[4], RADIUS, W)
    assert pairs == int(mask.sum()) > 0
    A, xyz, b_c, cen, starts, w2, b2, s2, lb2, w3, b3 = args
    ops = pairs * 2 * (16 * 16 + 16 * 32)
    nb = (chip_smoke.nbytes(A, b_c, starts, b2, s2, lb2, b3, mask)
          + (w2.numel() + w3.numel()) * 2 + b_c.shape[0] * b_c.shape[1] * 32 * 4)
    assert pre == chip_smoke.bound(ops, chip_smoke.PEAK_BF16, nb)  # the mask, not xyz


def test_mask_bound_reads_xyz_once():
    args, W = _pool_args()
    xyz, cen, starts = args[1], args[3], args[4]
    rows = 2 * 2 * W  # batch 2, two 16-center blocks, W rows each: the windows overlap
    got = chip_smoke.mask_bound((xyz, cen, starts), {"window": W})
    nb = rows * 16 + chip_smoke.nbytes(xyz, cen, starts)
    assert got == chip_smoke.bound(rows * (8 + 16 * 8), chip_smoke.PEAK_F32, nb)
    assert got[1] == "bytes"


def test_eval_stack_check_compares_scenes_with_pair_end_points(monkeypatch):
    model, _, evaluator, batch = build_evaluator(ModelConfig(use_bf16=True).tiny(),
                                                 batch_size=2, device="cpu", seed=1)
    chip_smoke.positive_sizes(model)
    monkeypatch.setattr(chip_smoke, "BATCH", 2)
    with torch.inference_mode():
        ends = model(batch["inputs"])
        pair = score_and_iou_multi(ends, batch["targets"], prefixes=evaluator.prefixes,
                                   modes=evaluator.modes)
    assert pair.shape == chip_smoke.IOU_SHAPE[:2] + (2, 10) and (pair > 0).any()
    same = {"pair": ends, "mxu": dict(ends)}
    assert chip_smoke.against_pair_stack("mxu", {"pair": pair, "mxu": pair.clone()}, same, 0) == 2
    wrong = pair.clone()
    wrong[0, 0, 1, 0] += 0.1
    with pytest.raises(AssertionError, match="another IoU stack"):
        chip_smoke.against_pair_stack("mxu", {"pair": pair, "mxu": wrong}, same, 0)

    # scene 1's forward moved at SA2: compared no more, whatever its stack
    moved = dict(ends)
    moved["sa2_features"] = ends["sa2_features"].clone()
    moved["sa2_features"][1, 0, 0] += 1.0
    moved["last_center"] = ends["last_center"].clone()
    moved["last_center"][1] += 1.0
    assert chip_smoke.against_pair_stack("mxu", {"pair": pair, "mxu": wrong},
                                         {"pair": ends, "mxu": moved}, 0) == 1
    # a scene that differs with equal SA outputs is an error
    moved["sa2_features"] = ends["sa2_features"]
    with pytest.raises(AssertionError, match="equal SA outputs"):
        chip_smoke.against_pair_stack("mxu", {"pair": pair, "mxu": pair}, {"pair": ends,
                                                                          "mxu": moved}, 0)


@pytest.mark.parametrize("mode", ["pair", "pre"])
def test_empty_tiles_counts_the_skipped_tiles(mode):
    args, W = _pool_args(W=96)  # a ragged window: its second tile is padded
    xyz, cen, starts = args[1], args[3], args[4]
    mask = sa_mask.sa_radius_mask(xyz, cen, starts, radius=RADIUS, window=W)
    kw = {"radius": RADIUS, "window": W, "d2_mode": mode, "mask": mask}
    empty, total = chip_smoke.empty_tiles(args, kw)
    want = 0
    for b in range(mask.shape[0]):
        for j in range(mask.shape[1]):
            for c in range(16):
                for k0 in range(0, W, 64):
                    want += int(not mask[b, j, k0:k0 + 64, c].any())
    assert total == 2 * 2 * 16 * 2 and empty == want and 0 < empty < total
    far = (args[0], xyz, args[2], cen + 100.0) + args[4:]
    far_mask = torch.zeros_like(mask)
    assert chip_smoke.empty_tiles(far, {**kw, "mask": far_mask}) == (total, total)


@pytest.mark.parametrize("window", [128, 64, 384])
def test_tie_input_plain_winners_are_the_rule(window):
    args, kw = chip_smoke.tie_inputs(B=2, N=512, M=128, window=window, widths=(16, 16, 32))
    assert not chip_smoke.boundary_centers(args[1], args[3], args[4], kw["radius"], window).any()
    rule, none = chip_smoke.rule_winners(args, kw)
    assert none[:, 16:32].all() and none[:, 80:96].all()  # blocks 1 and 5 out of reach
    starts = sa_kernel.window_starts(args[4].long(), 512, window)
    assert (starts == 512 - window).any() and (starts == 0).any()
    mask = sa_mask.sa_radius_mask(args[1], args[3], args[4], **kw)
    for mode in ("pair", "mxu", "pre"):
        v, w = sa_kernel.sa_pair_pool_winners_plain(
            *args, **kw, d2_mode=mode, mask=mask if mode == "pre" else None)
        assert torch.equal(w, rule[..., None].expand_as(w).int())
        assert torch.equal((v == -1e9).all(-1), none) and not w[none].any()
        assert torch.equal(v[~none], args[10].expand_as(v)[~none])  # every value is b3


# the compact wide backward's kernel and its dA reduction as cuobjdump names them: the
# file's anonymous namespace carries the file's name into every function's name
WC_KERNEL = ("_ZN65_GLOBAL__N__353943cc_32_sa_pair_pool_bwd_wide_compact_cu_ec332461"
             "21pool_bwd_compact_wideEPKtS1_PKfPKiS5_S1_S3_S3_S3_S1_iiiiffPfS6_S6_PtiPi")
WC_REDUCE = ("_ZN65_GLOBAL__N__353943cc_32_sa_pair_pool_bwd_wide_compact_cu_ec332461"
             "9reduce_dAEPKfPKiiiiPf")


def test_check_pool_build_refuses_spills_and_missing_hgmma(monkeypatch, capsys):
    class FakeBuild:
        @staticmethod
        def _target(name):
            return name

    ok_log = ("ptxas info    : Used 178 registers\n"
              "   8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
    spill_log = "   8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads"
    ok = {"sa_pair_pool": ok_log, "sa_pair_pool_bwd": ok_log, "sa_prep_bwd": ok_log,
          "sa_prep": ok_log, "sa_prep_f32": ok_log, "sa_pair_pool_512": ok_log,
          "sa_prep_512": ok_log, "sa_pair_pool_bwd_wide_compact": ok_log, "fps": spill_log}
    monkeypatch.setattr(chip_smoke, "hgmma_counts", lambda lib: None)
    chip_smoke.check_pool_build(ok, FakeBuild)
    assert capsys.readouterr().out.count("not checked") == 8
    for source in ("sa_pair_pool", "sa_pair_pool_bwd", "sa_prep_bwd", "sa_prep",
                   "sa_prep_f32", "sa_pair_pool_512", "sa_prep_512",
                   "sa_pair_pool_bwd_wide_compact"):  # any spill
        with pytest.raises(AssertionError, match="spill"):
            chip_smoke.check_pool_build({**ok, source: spill_log}, FakeBuild)
    sass = {"sa_pair_pool": {"_Z19sa_pair_pool_kernelILi16E": 24, "_Z3fps": 0,
                             "_Z17sa_pair_pool_wideILb1ELi0ELb0E": 48},
            "sa_pair_pool_bwd": {"_Z14pool_bwd_tilesILi16E": 12, "_Z14pool_bwd_tilesILi32E": 0,
                                 "_Z14reduce_records": 0, "_Z13pool_bwd_wide": 40,
                                 "_Z16pool_bwd_compact": 30},
            # the compact rows at (256, 256, 512); its reductions hold none
            "sa_pair_pool_bwd_wide_compact": {WC_KERNEL: 54, WC_REDUCE: 0,
                                              "_Z14reduce_records": 0},
            "sa_prep_bwd": {"_Z14prep_bwd_tilesILi64ELb1E": 6, "_Z14reduce_records": 0,
                            "_Z16prep_bwd_cluster": 10},
            "sa_prep": {"_Z14sa_prep_kernelILi64EE": 1, "_Z15sa_prep_cluster": 33},
            # the f32 prep's tensor-core kernels; its CUDA-core route holds none
            "sa_prep_f32": {"_Z7prep_tcILi128ELb1E": 36, "_Z8prep_fmaILi64ELb1E": 0,
                            "_Z8split_w1": 0, "_Z15prep_tc_cluster": 72,
                            "_Z17split_w1_cluster": 0, "_Z16prep_fwd_clusterILi2EE": 24},
            # the forward-only kernels above (256, 256, 512) and c1 256
            "sa_pair_pool_512": {"_Z16sa_pair_pool_512ILi0ELb0EEv": 40,
                                 "_Z16sa_pair_pool_512ILi2ELb1EEv": 40},
            "sa_prep_512": {"_Z11sa_prep_512ILb0EEv": 4, "_Z11sa_prep_512ILb1EEv": 12}}
    monkeypatch.setattr(chip_smoke, "hgmma_counts", lambda lib: sass[lib])
    with pytest.raises(AssertionError, match="sa_pair_pool_bwd GEMM kernel has no HGMMA"):
        chip_smoke.check_pool_build(ok, FakeBuild)
    sass["sa_pair_pool_bwd"]["_Z14pool_bwd_tilesILi32E"] = 16
    chip_smoke.check_pool_build(ok, FakeBuild)
    out = capsys.readouterr().out
    assert "72 HGMMA instructions in 2" in out and "98 HGMMA instructions in 4" in out
    assert "pool_bwd_compact: 30 HGMMA" in out and "prep_bwd_cluster: 10 HGMMA" in out
    assert "sa_prep_cluster: 33 HGMMA" in out and "prep_tc_cluster: 72 HGMMA" in out
    assert "prep_fwd_cluster: 24 HGMMA" in out and "pool_bwd_compact_wide: 54 HGMMA" in out
    assert "80 HGMMA instructions in 2" in out and "16 HGMMA instructions in 2" in out
    for source, name in (("sa_pair_pool_bwd", "_Z16pool_bwd_compact"),
                         ("sa_prep_bwd", "_Z16prep_bwd_cluster"),
                         ("sa_prep", "_Z15sa_prep_cluster"),
                         ("sa_prep_f32", "_Z15prep_tc_cluster"),
                         ("sa_prep_f32", "_Z16prep_fwd_clusterILi2EE")):  # each must be built
        n = sass[source].pop(name)
        with pytest.raises(AssertionError, match=f"{source} holds no"):
            chip_smoke.check_pool_build(ok, FakeBuild)
        sass[source][name] = n
    n = sass["sa_pair_pool_bwd_wide_compact"].pop(WC_KERNEL)  # it must be built
    with pytest.raises(AssertionError, match="sa_pair_pool_bwd_wide_compact GEMM kernel"):
        chip_smoke.check_pool_build(ok, FakeBuild)
    sass["sa_pair_pool_bwd_wide_compact"][WC_KERNEL] = n
    sass["sa_pair_pool"]["_Z17sa_pair_pool_wideILb1ELi0ELb0E"] = 0  # a wide kernel counts too
    with pytest.raises(AssertionError, match="sa_pair_pool GEMM kernel has no HGMMA"):
        chip_smoke.check_pool_build(ok, FakeBuild)
    sass["sa_pair_pool"]["_Z17sa_pair_pool_wideILb1ELi0ELb0E"] = 48
    sass["sa_pair_pool"]["_Z19sa_pair_pool_kernelILi16E"] = 0
    with pytest.raises(AssertionError, match="sa_pair_pool GEMM kernel has no HGMMA"):
        chip_smoke.check_pool_build(ok, FakeBuild)
    sass["sa_pair_pool"]["_Z19sa_pair_pool_kernelILi16E"] = 24
    sass["sa_prep_bwd"]["_Z14prep_bwd_tilesILi64ELb1E"] = 0
    with pytest.raises(AssertionError, match="sa_prep_bwd GEMM kernel has no HGMMA"):
        chip_smoke.check_pool_build(ok, FakeBuild)
    sass["sa_prep_bwd"]["_Z14prep_bwd_tilesILi64ELb1E"] = 6
    sass["sa_prep_f32"]["_Z7prep_tcILi128ELb1E"] = 0
    with pytest.raises(AssertionError, match="sa_prep_f32 GEMM kernel has no HGMMA"):
        chip_smoke.check_pool_build(ok, FakeBuild)
    sass["sa_prep_f32"]["_Z7prep_tcILi128ELb1E"] = 36
    for source, name in (("sa_pair_pool_512", "_Z16sa_pair_pool_512ILi2ELb1EEv"),
                         ("sa_prep_512", "_Z11sa_prep_512ILb1EEv")):  # the new kernels count
        sass[source][name] = 0
        with pytest.raises(AssertionError, match=f"{source} GEMM kernel has no HGMMA"):
            chip_smoke.check_pool_build(ok, FakeBuild)
        sass[source][name] = 40
    for source, name in (("sa_prep", "_Z15sa_prep_cluster"),
                         ("sa_prep_f32", "_Z15prep_tc_cluster"),
                         ("sa_prep_f32", "_Z16prep_fwd_clusterILi2EE")):  # cluster routes count
        sass[source][name] = 0
        with pytest.raises(AssertionError, match=f"{source} GEMM kernel has no HGMMA"):
            chip_smoke.check_pool_build(ok, FakeBuild)
        sass[source][name] = 1


@pytest.mark.parametrize("N,M,W,widths", [(256, 64, 128, (16, 16, 32)),
                                          (512, 128, 64, (16, 16, 32)),
                                          (640, 64, 256, (32, 32, 64)),
                                          (640, 64, 64, (32, 32, 128))])
def test_bwd_edge_inputs_hold_their_edge_cases(N, M, W, widths):
    args, kw = chip_smoke.bwd_edge_inputs(N=N, M=M, window=W, widths=widths)
    A, b_c, g, win, starts = args[:5]
    c3 = widths[2]
    assert ((win >= 0) & (win < N)).all()
    start = sa_kernel.window_starts(starts.long(), N, W)
    assert (start == N - W).any() and (starts > N - W).any()  # clamped windows
    rel = win.long() - start.repeat_interleave(16, dim=1)[..., None]
    outside = (g != 0) & ((rel < 0) | (rel >= W))
    assert outside.any()  # compact winners outside the window
    for compact in (True, False):
        ckw = {**kw, "compact": compact}
        rows = chip_smoke.center_rows(args, ckw)
        # brute force: distinct live winners (windowed) or live channels (compact)
        for b, m in ((0, 0), (0, 1), (1, 2), (1, 5), (0, 3 * 16)):
            live = (g[b, m] != 0) & (compact | ((rel[b, m] >= 0) & (rel[b, m] < W)))
            want = int(live.sum()) if compact else len(set(win[b, m][live].tolist()))
            assert rows[b, m] == want
        # kind 1: c3 rows, or (windowed, a window narrower than c3) one a point
        assert rows.max() == (c3 if compact else min(c3, W))
        blocks = rows.view(2, -1, 16).sum(-1)
        assert (blocks == 0).any() and (blocks > 0).any()  # blocks with no live row
        if not compact:
            one = rows == 1  # one row carrying all c3 channels
            assert one.any()
            assert chip_smoke.live_channels(args, ckw).sum(-1)[one].max() == c3
    assert chip_smoke.live_rows(args, {**kw, "compact": True})[0] == int((g != 0).sum())


def test_fps_edge_inputs_hold_their_edge_cases():
    cases = chip_smoke.fps_edge_inputs()
    sizes = {xyz.shape[1] for xyz, _ in cases.values()}
    assert 20000 in sizes  # past the 8192 points the kernel keeps in registers
    assert any(n % 32 and n % 8 for n in sizes)  # no multiple of 32 or of a cluster size
    (dup, n_dup), = [v for k, v in cases.items() if k.startswith("duplicates")]
    for row in dup:
        assert len(torch.unique(row, dim=0)) < row.shape[0] // 2  # every point twice
        d = ((row - row[0]) ** 2).sum(-1)
        assert len(torch.unique(d)) <= 28  # 1000 points at 28 distances at most: ties
    (pad, n_pad), = [v for k, v in cases.items() if k.startswith("zero-padded")]
    mag = (pad ** 2).sum(-1)
    assert (mag[1] == 0).all() and (mag[0, 1200:] == 0).all() and (mag[0, :1200] > 1e-3).all()
    idx = fps.fps_plain(pad, n_pad)
    assert (idx[1] == 0).all()  # an all-padding row gives index 0s
    assert (idx[0] < 1200).all() and len(torch.unique(idx[0])) == n_pad  # padding never picked
    picked = fps.fps_plain(dup, n_dup)
    assert (picked[:, 0] == 0).all() and (picked < dup.shape[1]).all()


def test_prep_bwd_edge_inputs_hold_their_edge_cases():
    cases = chip_smoke.prep_bwd_edge_inputs()
    widths = {(args[2].shape[0], args[2].shape[1]) for args, _ in cases.values()}
    assert {(6, 16), (35, 32), (67, 32), (6, 64), (259, 128), (131, 128), (6, 128)} <= widths
    assert {(259, 256), (515, 256)} <= widths  # the cluster kernel's (c1 256)
    (held, _), = [v for k, v in cases.items() if k.startswith("W2X SA1")]
    assert held[0].shape[1] > 64 * 132 * 8  # more 64-row tiles than the held kernel's CTAs
    # more 64-row tiles than the cluster kernel's clusters (at most one an SM)
    assert any(args[2].shape[1] == 256 and args[0].shape[:2].numel() > 64 * 132 * 4
               for args, _ in cases.values())
    assert (6, 127) in widths  # an odd c1 above 64 at K = 16: the record path
    rows = [args[0].shape[0] * args[0].shape[1] for args, _ in cases.values()]
    assert sum(r % 64 != 0 for r in rows) >= 5  # ragged last tiles
    (zero, _), = [v for k, v in cases.items() if k.startswith("zero dA")]
    assert not zero[1].float().any()
    (big, _), = [v for k, v in cases.items() if k.startswith("large")]
    assert big[0][..., :3].abs().max() > 100
    for args, radius in cases.values():
        out = sa_prep.sa_prep_bwd_plain(*args, radius=radius)
        assert all(torch.isfinite(o).all() for o in out)
    assert all(not o.any() for o in sa_prep.sa_prep_bwd_plain(*zero, radius=0.4))


def test_pool_widths_cases_lie_between_the_instantiations():
    from eda_tpu_torch.ops.cuda import sa_pool_bwd

    for layer, widths, N, M, W in chip_smoke.WIDTH_CASES:
        big = sa_kernel.kernel_widths(*widths)
        assert all(c <= b for c, b in zip(widths, big))
        assert (big != widths) == (widths not in sa_kernel.WIDTHS)
        assert N - W >= widths[2]  # as bwd_edge_inputs needs
    assert {w for _, w, *_ in chip_smoke.WIDTH_CASES} == {(48, 48, 96), (96, 80, 200),
                                                           (192, 160, 384), (256, 256, 512)}
    # padded on each of the three widest instantiations below XL; the widest of
    # them itself at a window where the model's backward is the compact one
    train_top = sa_pool_bwd.WIDE
    assert {sa_kernel.kernel_widths(*w) for _, w, *_ in chip_smoke.WIDTH_CASES} == set(
        sa_kernel.WIDTHS[2:-1])
    wide = [(N, W) for _, w, N, _, W in chip_smoke.WIDTH_CASES if w == train_top]
    assert wide == [(8192, 1024)] and sa_pool_bwd.compact_backward(1024, 512)
    assert {(N, W) for _, _, N, _, W in chip_smoke.WIDTH_CASES} == {(8192, 1024), (2048, 256)}
    assert train_top == (256, 256, 512) and sa_kernel.WIDTHS[-1] == sa_kernel.XL
    # XL: padded cases above the wide kernels' triple, under XL
    assert sa_kernel.XL == (512, 512, 1024)
    for layer, widths, N, M, W in chip_smoke.XL_WIDTH_CASES:
        assert sa_kernel.kernel_widths(*widths) == sa_kernel.XL != widths
        assert any(c > t for c, t in zip(widths, train_top))
        assert N - 512 >= widths[2]  # the backward's inputs (W = 512) as bwd_edge_inputs needs
    assert {w for _, w, *_ in chip_smoke.XL_WIDTH_CASES} == {(384, 384, 768), (300, 300, 600),
                                                              (288, 256, 512)}
    for widths in chip_smoke.TOO_WIDE:
        assert any(c > m for c, m in zip(widths, sa_kernel.WIDTHS[-1]))
        with pytest.raises(ValueError):
            sa_kernel.kernel_widths(*widths)
    # the check's inputs: a random W3 in place of tie_inputs' zeros; the
    # backward's widths as asked
    args, _ = chip_smoke.tie_inputs(B=1, N=256, M=32, window=64, widths=(24, 24, 40))
    mixed = chip_smoke.random_w3(args, seed=1)
    assert not args[9].any() and mixed[9].shape == (24, 40) and mixed[9].std() > 0.05
    assert all(a is b for i, (a, b) in enumerate(zip(args, mixed)) if i != 9)
    bargs, kw = chip_smoke.bwd_edge_inputs(B=1, N=512, M=32, window=128, widths=(24, 24, 40))
    out = sa_pool_bwd.sa_pool_bwd_plain(*bargs, **kw, compact=False)
    assert [tuple(o.shape) for o in out] == [(1, 512, 24), (1, 32, 24), (24, 24), (24,), (24,),
                                             (24,), (24, 40), (40,)]


def test_prep_edge_inputs_hold_their_edge_cases():
    top = {16: 7192, 48: 1752, 64: 1752, 128: 876, 256: 432}
    cases = chip_smoke.prep_edge_inputs(lambda c1: top[c1] if c1 in top else 0)
    widths = {(args[1].shape[0], args[1].shape[1]) for args, _ in cases.values()}
    for c1 in chip_smoke.PREP_EDGE_C1:
        assert (3, c1) in widths and (top[c1], c1) in widths
    assert {(6, 64), (131, 128), (259, 128)} <= widths
    rows = {name: args[0].shape[0] * args[0].shape[1] for name, (args, _) in cases.items()}
    # ragged, and less than a tile; SA4's 4 096 rows of the width-2 backbone whole
    assert all(r % 64 for name, r in rows.items() if "SA4" not in name)
    assert min(rows.values()) < 64
    large = [args for name, (args, _) in cases.items() if name.startswith("large")]
    assert len(large) == 2 and all(a[0][..., :3].abs().max() > 100 for a in large)
    for name in ("SA3 widths (259, 128), 2 x 77 rows", "SA2 widths (131, 128), 1 x 40 rows",
                 "W2X SA3 widths (515, 256), 8 x 1001 rows"):
        assert name in cases
    for args, radius in cases.values():  # every case, the W2X ones too (~0.2 s in all)
        out = sa_prep.sa_prep_plain(*args, radius=radius)
        assert out.shape == args[0].shape[:2] + (args[1].shape[1],)
        assert torch.isfinite(out.float()).all()
    # the cluster route at c1 256: fewer tiles than the clusters a card holds
    # (33 of four CTAs), more (the persistent clusters wrapping, a ragged last
    # tile), SA4's rows, the route's largest in_dim and one past it; all of them,
    # and only the c1-256 widths from in_dim 256, in the "w2x" phase
    cases = chip_smoke.prep_edge_inputs(lambda c1: top[c1], cluster_max=lambda c1: 576)
    shapes = {(args[0].shape[0] * args[0].shape[1], *args[1].shape) for args, _ in cases.values()}
    wrap = chip_smoke.W2X_WRAP_ROWS
    assert wrap // 64 + 1 > 132 // 4 and wrap % 64 and (1001 * 8) // 64 + 1 > 132 // 4
    for in_dim in (259, 515):
        assert {(3, in_dim, 256), (130, in_dim, 256), (wrap, in_dim, 256)} <= shapes
    assert {(4096, 515, 256), (130, 576, 256), (130, 577, 256)} <= shapes
    w2x = {(r, i, c) for r, i, c in shapes if chip_smoke.w2x_prep(i, c)}
    assert {(i, c) for _, i, c in w2x} == {(259, 256), (515, 256), (576, 256), (577, 256),
                                           (top[256], 256)}
    assert not chip_smoke.w2x_prep(3, 256) and not chip_smoke.w2x_prep(876, 128)
    assert not chip_smoke.w2x_prep(255, 256) and chip_smoke.w2x_prep(256, 256)


def test_mask_edge_inputs_hold_their_edge_cases():
    cases = chip_smoke.mask_edge_inputs()
    windows = [w for _, _, w in cases.values()]
    assert 1100 in windows and 1100 % 1024 and any(w < 1024 and w % 256 for w in windows)
    clamped = unaligned = single = near = 0
    for (xyz, cen, starts), radius, window in cases.values():
        B, N, _ = xyz.shape
        start = sa_kernel.window_starts(starts.long(), N, window)
        clamped += int((starts > N - window).any())
        # windows whose points do not start on a 16-byte boundary
        unaligned += int(((torch.arange(B)[:, None] * N + start) % 4 != 0).any())
        single += int(cen.shape[1] == 16)
        near += int(chip_smoke.boundary_centers(xyz, cen, starts, radius, window).any())
        mask = sa_mask.sa_radius_mask_plain(xyz, cen, starts, radius=radius, window=window)
        assert mask.shape == (B, cen.shape[1] // 16, window, 16) and mask.any()
    assert clamped >= 2 and unaligned >= 1 and single == 1 and near >= 1


def test_prep_bound_reads_points_once_and_writes_a_once():
    pts, w1 = torch.zeros(2, 100, 6), torch.zeros(6, 64)
    got = chip_smoke.prep_bound((pts, w1), {})
    nb = 2 * 100 * 6 * 4 + 2 * 100 * 64 * 2 + 9 * 64 * 4
    assert got == chip_smoke.bound(2 * 2 * 100 * 6 * 64, chip_smoke.PEAK_BF16, nb)
    assert got[1] == "bytes"


def test_prep_bounds_count_the_f32_bytes():
    """K2f writes A in f32 and K7f reads dA in f32; their true-f32 products at a
    third of the TF32 tensor-core peak (3xTF32, the fastest f32 product)."""
    f32 = {"compute_dtype": torch.float32}
    pts, w1 = torch.zeros(2, 100, 6), torch.zeros(6, 64)
    nb = 2 * 100 * 6 * 4 + 2 * 100 * 64 * 4 + 9 * 64 * 4
    assert chip_smoke.PEAK_TF32 == 495e12
    assert chip_smoke.prep_bound((pts, w1), f32) == chip_smoke.bound(
        2 * 2 * 100 * 6 * 64, chip_smoke.PEAK_TF32 / 3, nb)
    dA = torch.zeros(2, 100, 64)
    nb = 2 * 2 * 100 * 6 * 4 + 2 * 100 * 64 * 4 + (3 * 6 + 5) * 64 * 4
    assert chip_smoke.prep_bwd_bound((pts, dA, w1), f32) == chip_smoke.bound(
        6 * 2 * 100 * 6 * 64, chip_smoke.PEAK_TF32 / 3, nb)
    assert chip_smoke.prep_bwd_bound((pts, dA, w1), {})[0] < chip_smoke.prep_bwd_bound(
        (pts, dA, w1), f32)[0]


def test_prep_f32_edge_inputs_hold_their_edge_cases():
    """The f32 prep's edge cases: the flagship's, the width-2 backbone's and the
    tiny config's widths, the 64-row tile boundaries, several tiles a CTA with a
    one-row last tile, widths off the kernels' 8- and 4-column steps on each
    route, c1 above 128 on each route."""
    cases = chip_smoke.prep_f32_edge_inputs()
    shapes = [(args[0].shape[0] * args[0].shape[1], *args[1].shape) for args, _ in cases.values()]
    widths = {(i, c) for _, i, c in shapes}
    assert set(chip_smoke.F32_PREP_WIDTHS) | set(chip_smoke.TINY_PREP_WIDTHS) <= widths
    assert set(chip_smoke.W2X_F32_PREP_WIDTHS[1:]) <= widths
    # SA1 (CUDA-core route), SA2 (tensor route), W2X SA2 (tensor route at c1 256)
    for in_dim, c1 in ((6, 64), (131, 128), (259, 256)):
        rows = {r for r, i, c in shapes if (i, c) == (in_dim, c1)}
        assert set(chip_smoke.TILE_EDGE_ROWS) <= rows
    assert chip_smoke.MANY_TILE_ROWS[2] in {r for r, i, c in shapes if (i, c) == (259, 256)}
    assert any(r % 64 and r > 64 for r, i, c in shapes if (i, c) == (515, 256))
    many = chip_smoke.MANY_TILE_ROWS
    assert many[1] % 64 == many[2] % 64 == 1  # a last tile of one row
    assert (many[1] // 64 > 132 * 4) and (many[2] // 64 > 132 * 2)  # tiles > the grid's CTAs
    for in_dim, c1 in chip_smoke.TINY_PREP_WIDTHS:  # within one tile too
        assert any(r < 64 for r, i, c in shapes if (i, c) == (in_dim, c1))
    # around the backward's cluster route at c1 256 (no more tiles than the
    # 66 clusters of two a card holds): 3 and 129 rows and SA4's rows on it,
    # more tiles with a one-row last tile (the direct backward)
    assert {(3, 515, 256), (129, 259, 256), (many[2], 259, 256), (4096, 515, 256)} <= set(shapes)
    assert many[2] // 64 + 1 > 132 // 2 and 4096 // 64 <= 132 // 2
    # the route's most tiles (the last ragged) and one tile more (the direct backward)
    tiles = chip_smoke.prep_f32_edge_inputs(cluster_tiles=66)
    extra = {(args[0].shape[1], *args[1].shape) for name, (args, _) in tiles.items()
             if name not in cases}
    assert extra == {(66 * 64 - 5, 515, 256), (66 * 64 + 1, 515, 256)}
    # the wrapping check caps the clusters below those 66 tiles: each takes three
    # or four in turn, the last of them ragged
    wrap = chip_smoke.PREP_F32_WRAP_CLUSTERS
    assert 66 // wrap == 3 and 66 % wrap and (66 * 64 - 5) % 64
    assert [n for n in tiles if "the cluster route's most tiles" in n]
    odd = chip_smoke.ODD_PREP_WIDTHS
    assert set(odd) <= widths
    assert any(i > 8 and c % 8 and c % 2 for i, c in odd)  # tensor route, odd c1
    assert any(i <= 8 and c % 4 and c <= 128 for i, c in odd)  # CUDA-core route
    assert any(i <= 8 and c > 128 for i, c in odd)  # c1 above 128 on the CUDA-core route
    assert any(i > 8 and c > 128 and c % 8 for i, c in odd)  # and on the tensor route
    assert any(i > 8 and c > 128 and c % 2 for i, c in odd)  # odd c1 on the tensor route
    assert chip_smoke.PREP_F32_MIN_LIMITS == {128: (358, 333), 256: (515, 515)}
    f32 = dict(compute_dtype=torch.float32)
    for name, (args, radius) in cases.items():
        if args[0].shape[1] > 5000:
            continue
        A = sa_prep.sa_prep_plain(*args[:5], radius=radius, **f32)
        grads = sa_prep.sa_prep_bwd_plain(args[0], args[5], *args[1:4], radius=radius, **f32)
        assert A.shape == args[5].shape and torch.isfinite(A).all(), name
        assert all(torch.isfinite(g).all() for g in grads), name


def test_prep_f32_edge_inputs_hold_the_cluster_forward_cases():
    """The forward's cluster route at c1 256 (2-CTA clusters, a warpgroup a CTA up
    to 66 tiles, else two a set): W2X SA3's widths at the tile edges and at batch
    8's rows (128 tiles: 64 sets of two), SA4's 4 096 rows (64 tiles, one a
    warpgroup), an odd tile count above 66 (its last set one tile), many sets a
    cluster; c1 129 puts one column in the second CTA."""
    cases = chip_smoke.prep_f32_edge_inputs(cluster_tiles=66)
    shapes = {(args[0].shape[0] * args[0].shape[1], *args[1].shape) for args, _ in cases.values()}
    sa3 = chip_smoke.W2X_F32_PREP_WIDTHS[2]
    assert chip_smoke.W2X_SA3_ROWS == chip_smoke.BATCH * 1024
    for rows in chip_smoke.TILE_EDGE_ROWS + (chip_smoke.W2X_SA3_ROWS, 4096):
        assert (rows, *sa3) in shapes
    tiles = {-(-r // 64) for r, i, c in shapes if c > 128 and i > 8}
    assert any(t <= 66 for t in tiles) and any(t > 66 and t % 2 for t in tiles)
    assert any(t // 2 > 2 * 66 for t in tiles)  # several sets a cluster
    assert (154, 259, 129) in shapes and chip_smoke.wide_prep(259, 129)


def test_permuted_batches_move_points_and_labels_together():
    from eda_tpu_torch.entry import make_train_batch

    cfg = ModelConfig(use_bf16=True).tiny()
    batch = make_train_batch(cfg, range(2), "cpu")
    batch["targets"]["point_instance_label"] = torch.arange(2 * cfg.num_points).view(2, -1)
    out = chip_smoke.permuted(batch, seed=1)
    pcs, labels = out["inputs"]["point_clouds"], out["targets"]["point_instance_label"]
    for b in range(2):
        perm = labels[b] - b * cfg.num_points  # each point's original index
        assert sorted(perm.tolist()) == list(range(cfg.num_points))
        assert not torch.equal(perm, torch.arange(cfg.num_points))
        assert torch.equal(pcs[b], batch["inputs"]["point_clouds"][b][perm])
    assert not torch.equal(labels[0], labels[1] - cfg.num_points)  # each scene its own order
    assert torch.equal(out["inputs"]["text_ids"], batch["inputs"]["text_ids"])
    assert torch.equal(out["targets"]["center_label"], batch["targets"]["center_label"])
    serving = chip_smoke.permuted(batch["inputs"], seed=1)
    assert torch.equal(serving["point_clouds"], pcs)


def test_leaf_errors_take_the_largest_gradient_as_their_scale():
    want = {"a": torch.tensor([100.0, -50.0]), "attn.key.bias": torch.tensor([1e-6])}
    got = {"a": torch.tensor([100.5, -50.0]), "attn.key.bias": torch.tensor([0.1])}
    errs = chip_smoke._leaf_rel_errs(got, want)
    assert errs == pytest.approx({"a": 0.005, "attn.key.bias": 0.001}, rel=1e-4)


def test_w2x_phase_inputs_hold_their_edge_cases():
    """The w2x phase's inputs: the tie inputs at the wide widths make every
    in-radius pair of a center tie (the plain winners are the rule's under
    every radius test), at SA2's shape and window, at W = 1024, at a window
    no multiple of the 64-row tile with an odd count of blocks, and in one
    cluster of the forward's grid (one block in all); the backward's edge
    inputs at a window narrower than c3 give a center one row for each of
    its W points, and the cases hold blocks of more than 16 tiles (several
    folds), CTAs of fewer rows than one tile and more blocks than SMs (a CTA
    takes several in turn); the phase's configs."""
    widths = sa_pool_bwd.WIDE  # the wide kernels' (256, 256, 512)
    cases = chip_smoke.W2X_TIE_CASES
    assert all(c[1] == widths for c in cases)
    assert (2, widths, 2048, 1024, 256) in cases  # SA2's shape, four 64-row stages
    batch = {c: c[5] if len(c) > 5 else chip_smoke.BATCH for c in cases}
    assert any(c[4] == 1024 for c in cases)  # sixteen stages
    assert any(c[4] % 64 and (c[3] // 16) % 2 for c in cases)  # ragged stage, odd blocks
    assert any(batch[c] * c[3] // 16 == 1 for c in cases)  # one cluster in the grid
    for layer, _, N, M, W, *_ in cases:
        assert M % 16 == 0 and 0 < W <= N
        args, kw = chip_smoke.tie_inputs(B=1, N=N, M=M, window=W, widths=(16, 16, 32))
        assert not chip_smoke.boundary_centers(args[1], args[3], args[4], kw["radius"], W).any()
    W = 256
    args, kw = chip_smoke.tie_inputs(B=1, N=512, M=32, window=W, widths=widths)
    rule, none = chip_smoke.rule_winners(args, kw)
    mask = sa_mask.sa_radius_mask(args[1], args[3], args[4], **kw)
    for mode in ("pair", "mxu", "pre"):
        v, w = sa_kernel.sa_pair_pool_winners_plain(
            *args, **kw, d2_mode=mode, mask=mask if mode == "pre" else None)
        assert torch.equal(w, rule[..., None].expand_as(w).int())
        assert torch.equal((v == -1e9).all(-1), none) and none.any() and not none.all()
    bwd = [c for c in chip_smoke.W2X_BWD_EDGE_CASES if c[1] == widths]
    assert {c[4] for c in bwd} == {4, 256, 512}
    assert all(N - W >= widths[2] for _, _, N, _, W in bwd)  # as bwd_edge_inputs needs
    assert max(2 * M // 16 for _, _, _, M, _ in bwd) > 132  # more blocks than an H100's SMs
    for _, _, N, M, W in bwd:
        if W == 256:
            continue
        bargs, bkw = chip_smoke.bwd_edge_inputs(B=2, N=N, M=M, window=W, widths=widths)
        blocks = chip_smoke.center_rows(bargs, {**bkw, "compact": False}).view(2, -1, 16).sum(-1)
        if W == 4:  # every block (a CTA's) fewer live rows than one 64-row tile
            assert blocks.max() < 64 and blocks.max() > 0
        else:  # blocks of more than 16 tiles: the record folded several times
            assert blocks.max() > 16 * 64
    bargs, bkw = chip_smoke.bwd_edge_inputs(B=1, N=1024, M=32, window=256, widths=widths)
    rows = chip_smoke.center_rows(bargs, {**bkw, "compact": False})
    assert rows.max() == 256 and (rows == 1).any()  # W rows for kind 1; one row for kind 0
    assert chip_smoke.center_rows(bargs, {**bkw, "compact": True}).max() == 512
    # SA1's own shape for the compact kernel at (128, 128, 256): winners
    # outside the window, centers with every channel live, and the random
    # winners of a block tied on a window's first points
    (sa1,) = [c for c in chip_smoke.W2X_BWD_EDGE_CASES if c[1] != widths]
    layer, w1, N, M, W, tie = sa1
    cfg, tiny = chip_smoke.w2x_configs(ModelConfig(use_bf16=True))
    assert layer == 1 and w1 == cfg.sa_mlps[0] == (128, 128, 256) and (M, W) == (2048, 1024)
    assert N == 50000 and sa_pool_bwd.compact_backward(W, w1[2]) and N - W >= w1[2]
    bargs, bkw = chip_smoke.bwd_edge_inputs(B=1, N=N, M=M, window=W, widths=w1, tie_pool=tie)
    g, win, starts = bargs[2], bargs[3].long(), bargs[4]
    start = sa_kernel.window_starts(starts.long(), N, W).repeat_interleave(16, dim=1)[..., None]
    rel = win - start
    assert ((g != 0) & ((rel < 0) | (rel >= W))).any()  # compact winners outside the window
    assert ((g != 0).all(-1)).any()  # centers with every channel live
    kind = torch.arange(M) % 16
    tied = win[0, kind > 2] - start[0, kind > 2]
    assert tied.max() < tie and (g[0, kind > 2] != 0).sum() > 100 * tie  # many rows, 4 points
    compact_rows = chip_smoke.center_rows(bargs, {**bkw, "compact": True})
    assert compact_rows.max() == w1[2] and (compact_rows.view(-1, 16).sum(-1) == 0).any()
    assert cfg.sa_mlps[1:] == (widths,) * 3 and cfg.use_bf16 and tiny.use_bf16
    assert chip_smoke.TinyOf(tiny).tiny() is tiny


def test_prep_f32_edge_cases_split_between_the_f32_phases():
    """Each f32 prep edge case runs in one phase: the tensor route above c1 128
    (the width-2 backbone's widths, the odd ones above 128) in "w2x f32", the
    rest (the CUDA-core route at c1 150 too) in "f32"; each phase checks the
    in_dim limits of its widest c1 against their least values."""
    wide = {(i, c) for args, _ in chip_smoke.prep_f32_edge_inputs().values()
            for i, c in [tuple(args[1].shape)] if chip_smoke.wide_prep(i, c)}
    assert wide == {(259, 256), (515, 256), (131, 250), (35, 201), (259, 129)}
    # the cluster route's tile-count cases, in "w2x f32" too
    rows = {args[0].shape[1] for args, _ in chip_smoke.prep_f32_edge_inputs(
        cluster_tiles=66).values() if chip_smoke.wide_prep(*args[1].shape)}
    assert {66 * 64 - 5, 66 * 64 + 1} <= rows
    assert not chip_smoke.wide_prep(6, 150) and not chip_smoke.wide_prep(259, 128)
    least = chip_smoke.PREP_F32_MIN_LIMITS
    assert least[256] >= (max(i for i, _ in chip_smoke.W2X_F32_PREP_WIDTHS),) * 2
    assert least[128][0] >= max(i for i, _ in chip_smoke.F32_PREP_WIDTHS)


def test_w2x_f32_phase_configs_and_gates():
    """The "w2x f32" phase runs the width-2 backbone in f32 (the JAX default),
    its SA2-4 prep at the widths the edge cases hold, launching K2f and K7f
    where the bf16 model launches K2 and K7, under the f32 step's gates."""
    cfg, tiny = chip_smoke.w2x_configs(ModelConfig())
    assert not cfg.use_bf16 and not tiny.use_bf16
    assert cfg.sa_mlps == tiny.sa_mlps == chip_smoke.W2X_SA_MLPS
    prev = 3 + cfg.input_feature_dim
    widths = []
    for mlp in cfg.sa_mlps:
        widths.append((prev, mlp[0]))
        prev = 3 + mlp[-1]
    assert tuple(widths) == chip_smoke.W2X_F32_PREP_WIDTHS
    f32 = chip_smoke.forward_launches("pair", f32=True)
    assert f32 == {"fps_launch": 4, chip_smoke.F32_PREP: 4, "sa_pair_pool_launch": 4}
    assert chip_smoke.step_launches("pair", f32=True) == {
        "fps_launch": 4, chip_smoke.F32_PREP: 4, "sa_pair_pool_winners_launch": 4,
        "sa_pool_bwd_compact_launch": 1, "sa_pool_bwd_window_launch": 3,
        chip_smoke.F32_PREP_BWD: 4}
    assert (chip_smoke.F32_GLOBAL_COS, chip_smoke.F32_GRAD_NORM_REL) == (0.98, 0.05)
    assert 2 <= chip_smoke.W2X_F32_REQUESTS <= chip_smoke.REQUESTS  # a median past the first
    assert chip_smoke.F32_GLOBAL_COS > chip_smoke.GLOBAL_COS
    assert chip_smoke.F32_GRAD_NORM_REL < chip_smoke.METRIC_REL


def test_pool_bounds_at_the_wide_widths():
    """``pool_bound`` and ``pool_bwd_bound`` at (256, 256, 512): the pair MLP's
    flops a pair, 4x those of (128, 128, 256) on the same pairs; the
    backward's flops from the live rows and won channels."""
    args, W = _pool_args(c1=256, c2=256, c3=512)
    kw = {"radius": RADIUS, "window": W, "d2_mode": "pair"}
    pairs = chip_smoke.in_radius_pairs(args[1], args[3], args[4], RADIUS, W)
    wide = chip_smoke.pool_bound(args, kw)
    A, xyz, b_c, cen, starts, w2, b2, s2, lb2, w3, b3 = args
    nb = (chip_smoke.nbytes(A, b_c, starts, b2, s2, lb2, b3, xyz, cen)
          + (w2.numel() + w3.numel()) * 2 + 2 * 32 * 512 * 4)
    assert wide == chip_smoke.bound(pairs * 2 * (256 * 256 + 256 * 512), chip_smoke.PEAK_BF16, nb)
    narrow_args, _ = _pool_args(c1=128, c2=128, c3=256)
    narrow = chip_smoke.pool_bound(narrow_args, kw)
    assert wide[1] == narrow[1] == "operations" and wide[0] == pytest.approx(4 * narrow[0])

    bargs, bkw = chip_smoke.bwd_edge_inputs(B=1, N=1024, M=32, window=256,
                                            widths=(256, 256, 512))
    for compact in (True, False):
        ckw = {**bkw, "compact": compact}
        rows, channels = chip_smoke.live_rows(bargs, ckw)
        assert chip_smoke.pool_bwd_ops(bargs, ckw) == rows * 6 * 256 * 256 + channels * 4 * 256
        ms, by = chip_smoke.pool_bwd_bound(bargs, ckw)
        assert by == "operations"
        assert ms == pytest.approx(1e3 * chip_smoke.pool_bwd_ops(bargs, ckw)
                                   / chip_smoke.PEAK_BF16)


def test_w4x_phase_inputs_hold_their_edge_cases():
    """The w4x phases' inputs: the XL tie cases at SA2's shape and window, at
    W = 2048 (two radius-test stages of 1024 points), at a ragged window with
    an odd count of blocks and in one block, none with a window point on the
    radius, and the plain XL pool giving b3 at every center in reach and -1e9
    at the others; the c1-512 prep's edge cases (ragged rows, the tile edges,
    in_dim 1027 and 2048, odd c1, large points, SA1's (6, 256)); the launch
    counts of a W4X forward and the symbols the recorder files calls under."""
    from eda_tpu_torch.ops.cuda import sa_prep

    xl = sa_kernel.XL
    cases = chip_smoke.W4X_TIE_CASES
    assert all(c[1] == xl for c in cases)
    assert (2, xl, 2048, 1024, 256, 2) in cases
    assert any(c[4] > 1024 for c in cases)  # two stages of the radius test
    assert any(c[4] % 64 and (c[3] // 16) % 2 for c in cases)  # ragged window, odd blocks
    assert any(c[5] * c[3] // 16 == 1 for c in cases)  # one block in all
    for layer, _, N, M, W, B in cases:
        assert M % 16 == 0 and 0 < W <= N
        args, kw = chip_smoke.tie_inputs(B=1, N=N, M=M, window=W, widths=(16, 16, 32))
        assert not chip_smoke.boundary_centers(args[1], args[3], args[4], kw["radius"], W).any()
    args, kw = chip_smoke.tie_inputs(B=1, N=512, M=32, window=256, widths=xl)
    _, none = chip_smoke.rule_winners(args, kw)
    out = sa_kernel.sa_pair_pool_plain(*args, **kw)
    assert torch.equal((out == -1e9).all(-1), none) and none.any() and not none.all()
    assert torch.equal(out[~none], args[10].expand(int((~none).sum()), -1))  # b3 exactly

    prep = chip_smoke.w4x_prep_edge_inputs()
    shapes = {(a[0].shape[0] * a[0].shape[1], *a[1].shape) for a, _ in prep.values()}
    assert {(3, 515, 512), (8008, 1027, 512), (4096, 1027, 512), (130, 2048, 512),
            (200, 3, 512), (4098, 6, 256)} <= shapes
    assert {r for r, i, c in shapes if (i, c) == (1027, 512)} >= {63, 65, 129}
    assert {c for _, _, c in shapes} >= {257, 300, 384, 512, 256}
    large = [a for name, (a, _) in prep.items() if name.startswith("large")]
    assert len(large) == 2 and all(a[0][..., :3].abs().max() > 100 for a in large)
    for args, radius in prep.values():
        if args[0].shape[1] < 1000:
            out = sa_prep.sa_prep_plain(*args, radius=radius)
            assert out.shape == args[0].shape[:2] + (args[1].shape[1],)
            assert torch.isfinite(out.float()).all()

    for f32 in (False, True):
        counts = chip_smoke.w4x_forward_launches("pre", f32)
        prep_syms = (chip_smoke.F32_PREP, chip_smoke.F32_PREP_XL) if f32 else (
            "sa_prep_launch", chip_smoke.PREP_XL)
        assert counts["fps_launch"] == counts[chip_smoke.MASK] == 4
        assert sum(counts[s] for s in prep_syms) == 4
        assert counts[chip_smoke.pool_symbol("pre", False)] == 1
        assert counts[chip_smoke.pool_symbol_xl("pre")] == 3
    kw = {"compute_dtype": torch.float32}
    assert chip_smoke.prep_symbol(kw, (None, torch.zeros(6, 256))) == chip_smoke.F32_PREP
    assert chip_smoke.prep_symbol(kw, (None, torch.zeros(515, 512))) == chip_smoke.F32_PREP_XL
    assert chip_smoke.prep_symbol({}, (None, torch.zeros(515, 300))) == chip_smoke.PREP_XL
    pool_args = lambda c1, c2, c3: (torch.zeros(1, 1, c1),) + (None,) * 8 + (  # noqa: E731
        torch.zeros(c2, c3),)
    assert chip_smoke.xl_symbol({"d2_mode": "mxu"}, pool_args(256, 256, 512)) == \
        "sa_pair_pool_mxu_launch"
    assert chip_smoke.xl_symbol({"d2_mode": "mxu"}, pool_args(512, 512, 1024)) == \
        "sa_pair_pool_512_mxu_launch"
    cfg, tiny = chip_smoke.w4x_configs(ModelConfig(use_bf16=True))
    assert cfg.sa_mlps == tiny.sa_mlps == chip_smoke.W4X_SA_MLPS and cfg.use_bf16


def test_prep_xl_tolerance_takes_flipped_roundings_not_wrong_sums():
    """``chip_smoke.prep_xl_tolerance`` (K2 at c1 512): the plain prep with X's
    sums perturbed by 3e-4 of their value (a hundredfold the tensor cores'
    difference in order, which flips bf16(X) at a few elements, some of them
    twice through the second rounding) stays within it everywhere, where the
    0.02 plus one bf16 step alone does not; a sum that drops one of its 1027
    products does not."""
    from eda_tpu_torch.ops.cuda import sa_prep

    rnd = sa_prep.bf16_round
    (pts, w1, b1, sc, lb), radius = chip_smoke.w4x_prep_edge_inputs()[
        "W4X SA3 widths (1027, 512), 8 x 1001 rows"]
    want = sa_prep.sa_prep_plain(pts, w1, b1, sc, lb, radius=radius).float()
    base = 0.02 + want.abs() * 2.0 ** -7
    tol = base + chip_smoke.prep_xl_tolerance(pts, w1, b1, sc, radius)
    x_in = rnd(torch.cat([pts[..., :3] / pts.new_tensor(radius), pts[..., 3:]], -1)).double()
    X = x_in @ rnd(w1.float()).double()
    gen = torch.Generator().manual_seed(0)

    def prep_of(Xv):
        x = rnd(rnd(Xv.float()) + rnd(b1.float()))
        return sa_prep.ln_one_pass(x, sc.float(), lb.float()).to(torch.bfloat16).float()

    noisy = prep_of(X * (1 + 3e-4 * torch.randn(X.shape, generator=gen, dtype=torch.float64)))
    assert ((noisy - want).abs() <= tol).all()
    assert ((noisy - want).abs() > base).any()
    dropped = prep_of(X - x_in[..., 700:701] * rnd(w1[700].float()).double())
    assert int(((dropped - want).abs() > tol).sum()) > 1000


def test_w4x_training_launch_table_and_inputs():
    """The W4X training step's launch table (SA1 on the flagship's kernels, its
    compact backward on the kernel of the compact rows at (256, 256, 512);
    SA2-4 on the XL winners pool, the XL windowed backward and the c1-512
    prep backward), the symbols the recorder files its calls under, and the
    XL backward's edge cases."""
    xl = sa_kernel.XL
    for mode in ("pair", "mxu", "pre"):
        for f32 in (False, True):
            got = chip_smoke.w4x_step_launches(mode, f32)
            want = {"fps_launch": 4,
                    chip_smoke.F32_PREP if f32 else "sa_prep_launch": 1,
                    chip_smoke.F32_PREP_XL if f32 else chip_smoke.PREP_XL: 3,
                    chip_smoke.pool_symbol(mode, True): 1,
                    chip_smoke.pool_symbol_xl(mode, True): 3,
                    "sa_pool_bwd_wide_compact_launch": 1, "sa_pool_bwd_512_window_launch": 3,
                    chip_smoke.F32_PREP_BWD if f32 else "sa_prep_bwd_launch": 1,
                    "sa_prep_bwd_f32_512_launch" if f32 else "sa_prep_bwd_512_launch": 3}
            if mode == "pre":
                want[chip_smoke.MASK] = 4
            assert got == want
    assert chip_smoke.pool_symbol_xl("mxu", True) == "sa_pair_pool_512_mxu_winners_launch"
    # the model's backward at W4X: compact at SA1 (c3 512 < W 1024), windowed at SA2-4
    cfg, _ = chip_smoke.w4x_configs(ModelConfig(use_bf16=True))
    assert sa_pool_bwd.compact_backward(cfg.sa_windows[0], cfg.sa_mlps[0][2])
    assert not any(sa_pool_bwd.compact_backward(w, m[2])
                   for w, m in zip(cfg.sa_windows[1:], cfg.sa_mlps[1:]))
    pool = lambda c1, c2, c3: (torch.zeros(1, 1, c1),) + (None,) * 8 + (  # noqa: E731
        torch.zeros(c2, c3),)
    assert chip_smoke.winners_symbol({"d2_mode": "pre"}, pool(*xl)) == \
        "sa_pair_pool_512_pre_winners_launch"
    assert chip_smoke.winners_symbol({}, pool(256, 256, 512)) == "sa_pair_pool_winners_launch"
    assert chip_smoke.pool_bwd_symbol({"compact": False}, pool(384, 384, 768)) == \
        "sa_pool_bwd_512_window_launch"
    assert chip_smoke.pool_bwd_symbol({"compact": True}, pool(*xl)) == \
        "sa_pool_bwd_512_compact_launch"
    assert chip_smoke.pool_bwd_symbol({"compact": True}, pool(256, 256, 512)) == \
        "sa_pool_bwd_wide_compact_launch"
    prep = lambda c1: (None, None, torch.zeros(515, c1))  # noqa: E731
    f32 = {"compute_dtype": torch.float32}
    assert chip_smoke.prep_bwd_symbol({}, prep(512)) == "sa_prep_bwd_512_launch"
    assert chip_smoke.prep_bwd_symbol(f32, prep(300)) == "sa_prep_bwd_f32_512_launch"
    assert chip_smoke.prep_bwd_symbol(f32, prep(256)) == chip_smoke.F32_PREP_BWD
    assert chip_smoke.prep_bwd_symbol({}, prep(128)) == "sa_prep_bwd_launch"
    for symbol in ("sa_pool_bwd_512_window_launch",) + chip_smoke.PREP_BWD:
        assert symbol in chip_smoke.BACKWARD_ORDER
    # the backward's edge cases: SA2's shape, a window where the compact rows
    # are the model's, rows tied on a few points; each as bwd_edge_inputs needs
    cases = chip_smoke.W4X_BWD_EDGE_CASES
    assert all(c[1] == xl and c[2] - c[4] >= xl[2] for c in cases)
    assert (2, xl, 2048, 1024, 256) in cases
    assert any(sa_pool_bwd.compact_backward(c[4], xl[2]) for c in cases)
    assert any(len(c) > 5 and c[5] < 16 for c in cases)
    assert chip_smoke.W4X_STEPS >= 2  # a step past the first
    specs = chip_smoke.kernel_specs()
    for symbol in ("sa_pool_bwd_512_window_launch", "sa_pool_bwd_512_compact_launch",
                   "sa_prep_bwd_512_launch", "sa_prep_bwd_f32_512_launch",
                   "sa_pair_pool_512_winners_launch", "sa_pair_pool_512_pre_winners_launch"):
        assert symbol in specs


def test_check_mma_build_refuses_spills_and_missing_hmma(monkeypatch, capsys):
    class FakeBuild:
        @staticmethod
        def _target(name):
            return name

    ok_log = ("ptxas info    : Used 139 registers\n"
              "   0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
    spill_log = "   8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads"
    logs = {source: ok_log for source in chip_smoke.MMA_KERNELS}
    monkeypatch.setattr(chip_smoke, "sass_counts", lambda lib, op: None)
    chip_smoke.check_mma_build(logs, FakeBuild)
    assert capsys.readouterr().out.count("not checked") == 2
    for source in chip_smoke.MMA_KERNELS:
        with pytest.raises(AssertionError, match="spill"):
            chip_smoke.check_mma_build({**logs, source: spill_log}, FakeBuild)
    sass = {"sa_pair_pool_bwd_512": {"_ZN2mg11gemm_kernelItLb1ELb0EEE": 64,
                                     "_ZN2mg11gemm_kernelItLb0ELb0EEE": 64, "_Z9h0_rows": 0},
            "sa_prep_bwd_512": {"_ZN2mg11gemm_kernelIfLb1ELb1EEE": 96, "_Z9build_xin": 0}}
    seen = []
    monkeypatch.setattr(chip_smoke, "sass_counts", lambda lib, op: seen.append(op) or sass[lib])
    chip_smoke.check_mma_build(logs, FakeBuild)
    assert set(seen) == {"HMMA"}
    out = capsys.readouterr().out
    assert "128 HMMA instructions in 2" in out and "96 HMMA instructions in 1" in out
    sass["sa_prep_bwd_512"]["_ZN2mg11gemm_kernelIfLb1ELb1EEE"] = 0
    with pytest.raises(AssertionError, match="sa_prep_bwd_512 GEMM kernel has no HMMA"):
        chip_smoke.check_mma_build(logs, FakeBuild)
    del sass["sa_prep_bwd_512"]["_ZN2mg11gemm_kernelIfLb1ELb1EEE"]
    with pytest.raises(AssertionError, match="sa_prep_bwd_512 GEMM kernel has no HMMA"):
        chip_smoke.check_mma_build(logs, FakeBuild)


def test_prep_bwd_edge_inputs_hold_the_c1_512_cases():
    """Above c1 256 the prep backward's edge cases hold the width-4 backbone's
    SA2 and SA3 / SA4 widths at ragged rows and an odd c1 (both dtypes run
    them on the card), and the plain version gives defined results there."""
    cases = chip_smoke.prep_bwd_edge_inputs()
    wide = {(a[2].shape[0], a[2].shape[1]): a for a, _ in cases.values()
            if a[2].shape[1] > sa_prep.WIDE_C1}
    assert set(wide) == {(515, 512), (1027, 512), (303, 300)}
    assert all(a[0].shape[0] * a[0].shape[1] % 64 for a in wide.values())  # ragged
    pts, dA, w1, b1, scale = wide[(303, 300)]
    for dtype in (torch.bfloat16, torch.float32):
        out = sa_prep.sa_prep_bwd_plain(pts, dA, w1, b1, scale, radius=0.4, compute_dtype=dtype)
        assert [tuple(o.shape) for o in out] == [tuple(pts.shape), (303, 300), (300,), (300,),
                                                 (300,)]
        assert all(torch.isfinite(o).all() for o in out)
