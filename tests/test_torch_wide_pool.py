"""The width-2 backbone's kernels' host-side planning and their timer, on the CPU.

* ``ops/cuda/sa_pool_bwd.scratch_plan``: the wide backward (``pool_bwd_wide``,
  (256, 256, 512)) runs one CTA an SM, each over every ``ctas``-th block of 16
  centers with one record and the staged H0, H1 and bf16(dx) images of up to
  ``WIDE_STAGE`` tiles; so do the compact rows at (128, 128, 256)
  (``pool_bwd_compact``, the backbone's SA1), with nothing staged. The
  windowed rows at (128, 128, 256) and every narrower triple keep a record a
  block. At the backbone's SA2 and SA1 (batch 8) the persistent plans' scratch
  stays below the record a block they replace.
* ``tools/pool_bwd_times.py --kernels pool_w2x`` / ``prep_w2x`` /
  ``prep_f32_w2x`` time the width-2 backbone's pools and prep kernels (the
  last in f32): their widths are ``chip_smoke``'s, and without a card they
  fail, printing nothing.
* The backward at (512, 512, 1024) (``csrc/sa_pair_pool_bwd_512.cu``) splits
  the rows of its weight-gradient products into records (``scratch_plan``'s
  ``ctas`` at ``sa_kernel.XL``, ``xl_splits``); ``--kernels pool_w4x`` /
  ``step_f32_w4x`` time the width-4 backbone's training kernels.

The kernels themselves run on the card only (``chip_smoke.py``).
"""

import dataclasses

import pytest
import torch

import chip_smoke
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.ops.cuda import sa_kernel, sa_pool_bwd, sa_prep
from eda_tpu_torch.tools import pool_bwd_times

WIDE = (256, 256, 512)
RECORD = 256 * 256 + 256 * 512 + 3 * 256 + 512  # dW2, dW3, db2, ds2, dlb2, db3
RECORD_128 = 128 * 128 + 128 * 256 + 3 * 128 + 256
H100_SMS = 132


def plan_bytes(plan) -> int:
    """Device bytes of a plan's scratch: f32 records and dA records, bf16 stage."""
    n = lambda shape: 0 if shape is None else int(torch.tensor(shape).prod())  # noqa: E731
    return 4 * n(plan["records"]) + 4 * n(plan["da_records"]) + 2 * n(plan["stage"])


@pytest.mark.parametrize("B,M,W,ctas", [(8, 1024, 256, 132), (8, 512, 256, 132),
                                        (8, 256, 256, 128), (1, 16, 64, 1), (2, 4096, 256, 132)])
def test_wide_backward_takes_one_cta_an_sm(B, M, W, ctas):
    plan = sa_pool_bwd.scratch_plan(WIDE, B, M, W, H100_SMS)
    assert plan["ctas"] == ctas == min(B * M // 16, H100_SMS)
    assert plan["records"] == (ctas, RECORD)
    assert plan["stage"] == (ctas, sa_pool_bwd.WIDE_STAGE * 3 * 64 * 256)
    assert plan["da_records"] == (B * M // 16, W, 256)  # a window's dA a block, as before


def test_wide_backward_stages_sixteen_tiles_a_cta():
    """A fold takes up to 16 tiles of 64 rows (K = 1024): a CTA's H0, H1 and
    bf16(dx) images of 64 x 256 bf16, 96 KiB a tile, 1.5 MiB a CTA."""
    assert sa_pool_bwd.WIDE_STAGE == 16
    assert sa_pool_bwd.WIDE_STAGE_ELEMS * 2 == 16 * 96 * 1024
    # the staged-fold kernel's triple, the widest below XL (whose backward is
    # csrc/sa_pair_pool_bwd_512.cu)
    assert sa_pool_bwd.WIDE == sa_kernel.WIDTHS[-2] == WIDE != sa_kernel.WIDTHS[-1] == sa_kernel.XL


@pytest.mark.parametrize("widths,B,M,W", [((128, 128, 256), 8, 2048, 1024),
                                          ((64, 64, 128), 8, 512, 256),
                                          ((16, 16, 32), 2, 128, 64)])
def test_narrow_backward_keeps_a_record_a_block(widths, B, M, W):
    """The windowed rows at (128, 128, 256) (W2X's SA1 shape) and the narrower
    triples' windowed rows keep a record a block."""
    C1, C2, C3 = widths
    plan = sa_pool_bwd.scratch_plan(widths, B, M, W, H100_SMS, compact=False)
    assert plan == {"ctas": 0, "records": (B * M // 16, C1 * C2 + C2 * C3 + 3 * C2 + C3),
                    "da_records": (B * M // 16, W, C1), "stage": None}


@pytest.mark.parametrize("widths,B,M,W", [((64, 64, 128), 8, 2048, 1024),
                                          ((32, 32, 64), 2, 512, 256),
                                          ((16, 16, 32), 2, 128, 64)])
def test_narrow_compact_backward_keeps_a_record_a_block(widths, B, M, W):
    """Below (128, 128, 256) the compact rows run the tile kernel, a record a
    block, as the windowed rows do (the flagship's SA1 among them)."""
    assert (sa_pool_bwd.scratch_plan(widths, B, M, W, H100_SMS, compact=True)
            == sa_pool_bwd.scratch_plan(widths, B, M, W, H100_SMS, compact=False))
    assert sa_pool_bwd.scratch_plan(widths, B, M, W, H100_SMS, compact=True)["ctas"] == 0


@pytest.mark.parametrize("B,M,W,ctas", [(8, 2048, 1024, 132), (8, 512, 1024, 132),
                                        (1, 16, 64, 1), (2, 256, 256, 32)])
def test_compact_backward_at_128_takes_one_cta_an_sm(B, M, W, ctas):
    """pool_bwd_compact: one CTA an SM over every ctas-th block, one record a
    CTA, a window's dA a block as before, nothing staged."""
    plan = sa_pool_bwd.scratch_plan(sa_pool_bwd.PERSISTENT_COMPACT, B, M, W, H100_SMS,
                                    compact=True)
    assert plan == {"ctas": ctas, "records": (ctas, RECORD_128),
                    "da_records": (B * M // 16, W, 128), "stage": None}
    assert ctas == min(B * M // 16, H100_SMS)


def test_compact_backward_scratch_at_w2x_sa1_below_a_record_a_block():
    """W2X's SA1 at batch 8 (2048 centers, window 1024): 132 records in place
    of the 1024 a block (26 MB instead of 204 MB)."""
    args = ((128, 128, 256), 8, 2048, 1024, H100_SMS)
    plan = sa_pool_bwd.scratch_plan(*args, compact=True)
    per_block = sa_pool_bwd.scratch_plan(*args, compact=False)
    assert per_block["records"] == (1024, RECORD_128) and plan["records"] == (132, RECORD_128)
    assert plan["da_records"] == per_block["da_records"]
    assert plan_bytes(per_block) - plan_bytes(plan) == 4 * (1024 - 132) * RECORD_128


def test_wide_backward_scratch_at_w2x_sa2_below_a_record_a_block():
    """W2X's SA2 at batch 8 (1024 centers, window 256): 132 records and their
    staged tiles take less than the 512 records a block that they replace."""
    plan = sa_pool_bwd.scratch_plan(WIDE, 8, 1024, 256, H100_SMS)
    per_block = {"records": (512, RECORD), "da_records": (512, 256, 256), "stage": None}
    assert plan_bytes(plan) < plan_bytes(per_block)
    assert 2 * plan["stage"][0] * plan["stage"][1] <= 4 * (512 - plan["ctas"]) * RECORD


def test_wide_backward_plan_with_no_block():
    plan = sa_pool_bwd.scratch_plan(WIDE, 0, 1024, 256, H100_SMS)
    assert plan["ctas"] == 0 and plan["stage"] is None and plan["records"] == (0, RECORD)


def test_pool_w2x_timer_widths_are_the_smokes():
    assert pool_bwd_times.W2X_SA_MLPS == chip_smoke.W2X_SA_MLPS
    assert pool_bwd_times.W2X_FP_MLPS == chip_smoke.W2X_FP_MLPS
    cfg = pool_bwd_times.model_config("pool_w2x")
    assert cfg.use_bf16 and cfg.sa_mlps == chip_smoke.W2X_SA_MLPS
    assert cfg.fp_mlps == chip_smoke.W2X_FP_MLPS
    flagship = pool_bwd_times.model_config("pool")
    assert flagship.use_bf16 and flagship.sa_mlps != cfg.sa_mlps
    assert pool_bwd_times.KERNELS["pool_w2x"][2:] == pool_bwd_times.KERNELS["pool"][2:]


@pytest.mark.parametrize("argv", [["--kernels", "pool_w2x"], ["--kernels", "pool_w2x", "--busy"],
                                  ["--kernels", "pool"]])
def test_pool_w2x_timer_needs_a_card(argv, monkeypatch, capsys):
    """A device timing has no CPU counterpart: without CUDA the tool fails, printing nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pool_bwd_times.main(argv) != 0
    assert capsys.readouterr().out == ""


def test_prep_w2x_timer_widths_are_the_smokes():
    cfg = pool_bwd_times.model_config("prep_w2x")
    assert cfg.use_bf16 and cfg.sa_mlps == chip_smoke.W2X_SA_MLPS
    assert cfg.fp_mlps == chip_smoke.W2X_FP_MLPS
    assert pool_bwd_times.KERNELS["prep_w2x"][2:] == pool_bwd_times.KERNELS["prep_bf16"][2:]
    assert pool_bwd_times.model_config("prep_bf16").sa_mlps != cfg.sa_mlps


def test_prep_f32_w2x_timer_widths_are_the_smokes():
    """The f32 width-2 backbone: ``ModelConfig()`` (f32) at the smoke's W2X widths,
    timing K2f and K7f as ``prep_f32`` does for the flagship."""
    cfg = pool_bwd_times.model_config("prep_f32_w2x")
    assert not cfg.use_bf16 and cfg.sa_mlps == chip_smoke.W2X_SA_MLPS
    assert cfg.fp_mlps == chip_smoke.W2X_FP_MLPS
    assert dataclasses.replace(cfg, sa_mlps=ModelConfig().sa_mlps,
                               fp_mlps=ModelConfig().fp_mlps) == ModelConfig()
    assert pool_bwd_times.KERNELS["prep_f32_w2x"][2:] == pool_bwd_times.KERNELS["prep_f32"][2:]
    assert pool_bwd_times.model_config("prep_f32").sa_mlps != cfg.sa_mlps


@pytest.mark.parametrize("argv", [["--kernels", "prep_w2x"], ["--kernels", "prep_w2x", "--busy"],
                                  ["--kernels", "prep_f32_w2x"]])
def test_prep_w2x_timer_needs_a_card(argv, monkeypatch, capsys):
    """A device timing has no CPU counterpart: without CUDA the tool fails, printing nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pool_bwd_times.main(argv) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("rows,in_dim,c1,route", [
    (400_000, 6, 128, "fma"),             # W2X SA1, batch 8
    (16_384, 259, 256, "cluster x2"),     # SA2: 256 tiles, two a cluster at a time
    (8_192, 515, 256, "cluster x2"),      # SA3: 128 tiles on 64 clusters
    (4_096, 515, 256, "cluster x1"),      # SA4: 64 tiles, a cluster each
    (16_384, 131, 128, "tensor"),         # the flagship's SA2
    (66 * 64, 515, 256, "cluster x1"), (66 * 64 + 1, 515, 256, "cluster x2"),
    (3, 35, 201, "cluster x1"), (154, 6, 150, "fma")])
def test_f32_forward_route_at_the_w2x_batch8_shapes(rows, in_dim, c1, route):
    """The f32 forward's route, as ``csrc/sa_prep_f32.cu:make_plan`` picks it from the
    rows and widths: the cluster forward above c1 128, one warpgroup a CTA up to the
    66 tiles whose clusters an H100 holds, two past them."""
    assert sa_prep.f32_forward_route(rows, in_dim, c1) == route
    assert route in sa_prep.F32_FORWARD_ROUTES


def test_prep_f32_forward_timer_widths_are_the_w2x_models(monkeypatch, capsys):
    """The K2f timer's SA2-4 shapes are the f32 W2X model's at batch 8 (its SA
    widths, ``chip_smoke.W2X_F32_PREP_WIDTHS``); without CUDA it fails, printing nothing."""
    from eda_tpu_torch.tools import prep_f32_times

    cfg = pool_bwd_times.model_config("prep_f32_w2x")
    widths = [(in_dim, prep_f32_times.C1) for _, _, in_dim in prep_f32_times.W2X_F32_FORWARDS]
    assert widths == list(chip_smoke.W2X_F32_PREP_WIDTHS[1:])
    assert [r for _, r, _ in prep_f32_times.W2X_F32_FORWARDS] == [
        chip_smoke.BATCH * n for n in cfg.sa_npoints[:3]]
    in_dims = [i for _, _, i in prep_f32_times.W2X_F32_FORWARDS]
    assert [3 + m[-1] for m in cfg.sa_mlps[:3]] == in_dims
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert prep_f32_times.main([]) != 0
    assert capsys.readouterr().out == ""


def test_wgmma_rate_tool_needs_a_card(monkeypatch, capsys):
    """The wgmma rate probe times the f32 prep's product groups (12 TF32 wgmma of
    m64n128k8, as a K step of ``prep_fwd_cluster``); without CUDA it fails, printing nothing."""
    from eda_tpu_torch.tools import wgmma_rate

    assert "m64n128k8.f32.tf32.tf32" in wgmma_rate.SOURCE
    assert {n for _, n, _, _ in wgmma_rate.VARIANTS} == {128, 256}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert wgmma_rate.main([]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("kernels,use_bf16", [("serve_w4x", True), ("serve_f32_w4x", False)])
def test_w4x_timer_widths_are_the_smokes_and_serve_only(kernels, use_bf16, monkeypatch):
    """``--kernels serve_w4x`` / ``serve_f32_w4x``: the width-4 backbone of the
    smoke's "w4x" phases, recording a serving forward's calls only (its
    training step raises), the calls above c1 256 labelled " XL"."""
    assert pool_bwd_times.W4X_SA_MLPS == chip_smoke.W4X_SA_MLPS
    assert pool_bwd_times.W4X_FP_MLPS == chip_smoke.W4X_FP_MLPS
    cfg = pool_bwd_times.model_config(kernels)
    assert cfg.use_bf16 == use_bf16 and cfg.sa_mlps == chip_smoke.W4X_SA_MLPS
    assert pool_bwd_times.KERNELS[kernels][2] == {}  # no training step
    a_wide, a_xl = (torch.zeros(1, 8, c) for c in (256, 512))
    w1_wide, w1_xl = torch.zeros(6, 256), torch.zeros(515, 512)
    assert not pool_bwd_times.xl("sa_prep", (None, w1_wide))
    assert pool_bwd_times.xl("sa_prep", (None, w1_xl))
    assert not pool_bwd_times.xl("sa_pair_pool", (a_wide,))
    assert pool_bwd_times.xl("sa_pair_pool", (a_xl,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pool_bwd_times.main(["--kernels", kernels]) != 0


XL_RECORD = 512 * 512 + 512 * 1024  # dW2, dW3: the XL backward's split records


@pytest.mark.parametrize("rows,splits", [(0, 1), (1, 1), (2048, 1), (2049, 2), (106923, 53),
                                         (262144, 128), (2_000_000, 128)])
def test_xl_backward_splits_the_rows(rows, splits):
    """csrc/sa_pair_pool_bwd_512.cu: the weight gradients' partial products a
    record a split of the rows, at least 2048 rows a split, at most 128 splits;
    a window's dA a block as the other kernels; nothing staged."""
    B, M, W = 8, 1024, 256
    plan = sa_pool_bwd.scratch_plan(sa_kernel.XL, B, M, W, H100_SMS, rows=rows)
    assert plan == {"ctas": splits, "records": (splits, XL_RECORD),
                    "da_records": (B * M // 16, W, 512), "stage": None}
    assert sa_pool_bwd.xl_splits(rows) == splits
    # the same whatever the variant and the card's SM count
    assert sa_pool_bwd.scratch_plan(sa_kernel.XL, B, M, W, 78, compact=True, rows=rows) == plan
    # the split a row lies in: ceil(rows / splits) rows a split, each range whole
    if rows:
        per = -(-rows // splits)
        assert (splits - 1) * per < rows <= splits * per


def test_xl_backward_scratch_at_w4x_sa2():
    """W4X's SA2 at batch 8 (1024 centers, window 256, 188 610 live rows in a
    full-width step on the card): 93 split records (293 MB) and the 512 blocks'
    dA records (268 MB)."""
    plan = sa_pool_bwd.scratch_plan(sa_kernel.XL, 8, 1024, 256, H100_SMS, rows=188610)
    assert plan["ctas"] == 93 and 4 * plan["records"][0] * plan["records"][1] == 93 * 4 * XL_RECORD
    assert 4 * 512 * 256 * 512 == plan_bytes(dict(plan, records=None))


def test_w4x_training_timer_sets():
    """``--kernels pool_w4x`` / ``step_f32_w4x`` time a W4X step's K4, K5, K6
    and K7 / K7f (SA2-4 labelled " XL"); their widths are the smoke's."""
    assert pool_bwd_times.W4X_SA_MLPS == chip_smoke.W4X_SA_MLPS
    assert pool_bwd_times.W4X_FP_MLPS == chip_smoke.W4X_FP_MLPS
    for kernels, bf16, prep_bwd in (("pool_w4x", True, "K7"), ("step_f32_w4x", False, "K7f")):
        cfg = pool_bwd_times.model_config(kernels)
        assert cfg.use_bf16 == bf16 and cfg.sa_mlps == chip_smoke.W4X_SA_MLPS
        step = pool_bwd_times.KERNELS[kernels][2]
        assert step == {"sa_pair_pool_winners": "K4", "sa_pool_bwd": None,
                        "sa_prep_bwd": prep_bwd}
    assert pool_bwd_times.KERNELS["pool_w4x"][3] == {"sa_pair_pool": "K3"}
    assert pool_bwd_times.KERNELS["step_f32_w4x"][3] == {}
    xl = (torch.zeros(1, 1, 512),) + (None,) * 8 + (torch.zeros(512, 1024),)
    sa1 = (torch.zeros(1, 1, 256),) + (None,) * 8 + (torch.zeros(256, 512),)
    for name in ("sa_pair_pool", "sa_pair_pool_winners", "sa_pool_bwd"):
        assert pool_bwd_times.xl(name, xl) and not pool_bwd_times.xl(name, sa1)
    prep_bwd = lambda c1: (None, None, torch.zeros(515, c1))  # noqa: E731
    assert pool_bwd_times.xl("sa_prep_bwd", prep_bwd(512))
    assert not pool_bwd_times.xl("sa_prep_bwd", prep_bwd(256))
    assert pool_bwd_times.xl("sa_prep", (None, torch.zeros(515, 300)))
