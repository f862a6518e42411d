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
  points once and writes A once.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.entry import build_evaluator
from eda_tpu_torch.eval.grounding import score_and_iou_multi
from eda_tpu_torch.ops.cuda import fps, sa_kernel, sa_mask, sa_prep

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


def test_check_pool_build_refuses_spills_and_missing_hgmma(monkeypatch, capsys):
    class FakeBuild:
        @staticmethod
        def _target(name):
            return name

    ok_log = ("ptxas info    : Used 178 registers\n"
              "   8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
    spill_log = "   8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads"
    ok = {"sa_pair_pool": ok_log, "sa_pair_pool_bwd": ok_log, "sa_prep_bwd": ok_log,
          "sa_prep": ok_log, "sa_prep_f32": ok_log, "fps": spill_log}
    monkeypatch.setattr(chip_smoke, "hgmma_counts", lambda lib: None)
    chip_smoke.check_pool_build(ok, FakeBuild)
    assert capsys.readouterr().out.count("not checked") == 5
    for source in ("sa_pair_pool", "sa_pair_pool_bwd", "sa_prep_bwd", "sa_prep",
                   "sa_prep_f32"):  # any spill
        with pytest.raises(AssertionError, match="spill"):
            chip_smoke.check_pool_build({**ok, source: spill_log}, FakeBuild)
    sass = {"sa_pair_pool": {"_Z19sa_pair_pool_kernelILi16E": 24, "_Z3fps": 0},
            "sa_pair_pool_bwd": {"_Z14pool_bwd_tilesILi16E": 12, "_Z14pool_bwd_tilesILi32E": 0,
                                 "_Z14reduce_records": 0},
            "sa_prep_bwd": {"_Z14prep_bwd_tilesILi64ELb1E": 6, "_Z14reduce_records": 0},
            "sa_prep": {"_Z14sa_prep_kernelILi64EE": 1},
            # the f32 prep's tensor-core kernels; its CUDA-core route holds none
            "sa_prep_f32": {"_Z7prep_tcILi128ELb1E": 36, "_Z8prep_fmaILi64ELb1E": 0,
                            "_Z8split_w1": 0}}
    monkeypatch.setattr(chip_smoke, "hgmma_counts", lambda lib: sass[lib])
    with pytest.raises(AssertionError, match="sa_pair_pool_bwd GEMM kernel has no HGMMA"):
        chip_smoke.check_pool_build(ok, FakeBuild)
    sass["sa_pair_pool_bwd"]["_Z14pool_bwd_tilesILi32E"] = 16
    chip_smoke.check_pool_build(ok, FakeBuild)
    out = capsys.readouterr().out
    assert "24 HGMMA instructions in 1" in out and "28 HGMMA instructions in 2" in out
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


@pytest.mark.parametrize("N,M,W,widths", [(256, 64, 128, (16, 16, 32)),
                                          (512, 128, 64, (16, 16, 32)),
                                          (640, 64, 256, (32, 32, 64))])
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
        assert rows.max() == c3
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
    assert {(6, 16), (35, 32), (67, 32), (6, 64), (259, 128), (131, 128)} <= widths
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
        assert widths not in sa_kernel.WIDTHS
        big = sa_kernel.kernel_widths(*widths)
        assert big != widths and all(c <= b for c, b in zip(widths, big))
        assert N - W >= widths[2] and W >= widths[2]  # as bwd_edge_inputs needs
    assert {w for _, w, *_ in chip_smoke.WIDTH_CASES} == {(48, 48, 96), (96, 80, 200)}
    assert {(N, W) for _, _, N, _, W in chip_smoke.WIDTH_CASES} == {(8192, 1024), (2048, 256)}
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
    rows = [args[0].shape[0] * args[0].shape[1] for args, _ in cases.values()]
    assert all(r % 64 for r in rows) and min(rows) < 64  # ragged, and less than a tile
    large = [args for name, (args, _) in cases.items() if name.startswith("large")]
    assert len(large) == 2 and all(a[0][..., :3].abs().max() > 100 for a in large)
    for args, radius in list(cases.values())[:4] + list(cases.values())[-5:]:
        out = sa_prep.sa_prep_plain(*args, radius=radius)
        assert out.shape == args[0].shape[:2] + (args[1].shape[1],)
        assert torch.isfinite(out.float()).all()


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
    """The f32 prep's edge cases: the flagship's and the tiny config's widths, the
    64-row tile boundaries, several tiles a CTA with a one-row last tile, widths
    off the kernels' 8- and 4-column steps on each route, c1 above 128."""
    cases = chip_smoke.prep_f32_edge_inputs()
    shapes = [(args[0].shape[0] * args[0].shape[1], *args[1].shape) for args, _ in cases.values()]
    widths = {(i, c) for _, i, c in shapes}
    assert set(chip_smoke.F32_PREP_WIDTHS) | set(chip_smoke.TINY_PREP_WIDTHS) <= widths
    for in_dim, c1 in ((6, 64), (131, 128)):  # SA1 (CUDA-core route), SA2 (tensor route)
        rows = {r for r, i, c in shapes if (i, c) == (in_dim, c1)}
        assert set(chip_smoke.TILE_EDGE_ROWS) <= rows
    many = chip_smoke.MANY_TILE_ROWS
    assert many[1] % 64 == many[2] % 64 == 1  # a last tile of one row
    assert (many[1] // 64 > 132 * 4) and (many[2] // 64 > 132 * 2)  # tiles > the grid's CTAs
    for in_dim, c1 in chip_smoke.TINY_PREP_WIDTHS:  # within one tile too
        assert any(r < 64 for r, i, c in shapes if (i, c) == (in_dim, c1))
    odd = chip_smoke.ODD_PREP_WIDTHS
    assert set(odd) <= widths
    assert any(i > 8 and c % 8 and c % 2 for i, c in odd)  # tensor route, odd c1
    assert any(i <= 8 and c % 4 and c <= 128 for i, c in odd)  # CUDA-core route
    assert any(i <= 8 and c > 128 for i, c in odd)  # c1 above 128 (CUDA-core route only)
    assert chip_smoke.PREP_F32_MIN_LIMITS == (358, 333)
    f32 = dict(compute_dtype=torch.float32)
    for name, (args, radius) in cases.items():
        if args[0].shape[1] > 5000:
            continue
        A = sa_prep.sa_prep_plain(*args[:5], radius=radius, **f32)
        grads = sa_prep.sa_prep_bwd_plain(args[0], args[5], *args[1:4], radius=radius, **f32)
        assert A.shape == args[5].shape and torch.isfinite(A).all(), name
        assert all(torch.isfinite(g).all() for g in grads), name
