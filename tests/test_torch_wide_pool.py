"""The wide pool kernels' host-side planning and their timer, on the CPU.

* ``ops/cuda/sa_pool_bwd.scratch_plan``: the wide backward (``pool_bwd_wide``,
  (256, 256, 512)) runs one CTA an SM, each over every ``ctas``-th block of 16
  centers with one record and the staged H0, H1 and bf16(dx) images of up to
  ``WIDE_STAGE`` tiles; the narrower triples keep a record a block. At the
  width-2 backbone's SA2 (batch 8) its scratch stays below the record a block
  it replaces.
* ``tools/pool_bwd_times.py --kernels pool_w2x`` times the width-2
  backbone's pools: its widths are ``chip_smoke``'s, and without a card it
  fails, printing nothing.

The kernels themselves run on the card only (``chip_smoke.py``).
"""

import pytest
import torch

import chip_smoke
from eda_tpu_torch.ops.cuda import sa_kernel, sa_pool_bwd
from eda_tpu_torch.tools import pool_bwd_times

WIDE = (256, 256, 512)
RECORD = 256 * 256 + 256 * 512 + 3 * 256 + 512  # dW2, dW3, db2, ds2, dlb2, db3
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
    assert sa_pool_bwd.WIDE == sa_kernel.WIDTHS[-1] == WIDE


@pytest.mark.parametrize("widths,B,M,W", [((128, 128, 256), 8, 2048, 1024),
                                          ((64, 64, 128), 8, 512, 256),
                                          ((16, 16, 32), 2, 128, 64)])
def test_narrow_backward_keeps_a_record_a_block(widths, B, M, W):
    C1, C2, C3 = widths
    plan = sa_pool_bwd.scratch_plan(widths, B, M, W, H100_SMS)
    assert plan == {"ctas": 0, "records": (B * M // 16, C1 * C2 + C2 * C3 + 3 * C2 + C3),
                    "da_records": (B * M // 16, W, C1), "stage": None}


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
