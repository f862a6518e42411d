"""The port's bench (``python -m eda_tpu_torch.bench``) and FLOP accounting (``utils/flops.py``).

* ``--dry --cpu --eval`` prints the JAX bench's four JSON lines in its order
  (``mfu_accounting`` first, the forward line last) with finite values; on
  the CPU no MFU share is printed, since a CPU time is no share of the card;
* ``forward_flops``, ``total_flops`` and ``train_flops`` equal
  ``eda_tpu/utils/flops.py``'s exactly on the flagship and the tiny config,
  the measured SA occupancy equals the JAX replay's (the port's FPS is
  bit-exact with JAX's), and the MFU shares are the JAX formulas' at one peak;
* what the bench does not port is refused.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.utils import flops as jax_flops
from eda_tpu_torch import bench
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.utils import flops
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CONFIGS = {
    "flagship": (ModelConfig(use_bf16=True), JaxConfig(use_bf16=True)),
    "tiny": (ModelConfig(use_bf16=True).tiny(), JaxConfig(use_bf16=True).tiny()),
    "tiny-odd": (dataclasses.replace(ModelConfig(use_bf16=True).tiny(), num_queries=17,
                                     contrastive_align=False, sa_windows=(2048, 64, 64, 64)),
                 dataclasses.replace(JaxConfig(use_bf16=True).tiny(), num_queries=17,
                                     contrastive_align=False, sa_windows=(2048, 64, 64, 64))),
}


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


def test_dry_cpu_prints_the_four_lines(capsys):
    assert bench.main(["--dry", "--cpu", "--eval", "--iters", "4"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line]
    assert [r["metric"] for r in lines] == [
        "mfu_accounting", "grounding_train_throughput", "grounding_eval_throughput",
        "grounding_forward_throughput"]
    for r in lines:
        assert _finite(r) and r["device"] == "cpu" and r["card"] is None
        assert not any(k.endswith("mfu") for k in r)  # no card, no share of its peak
    acct, *rates = lines
    assert acct["fwd_dense_window_flops_per_scene"] > acct["fwd_in_radius_flops_per_scene"] > 0
    assert len(acct["occupancy"]) == 4 and acct["peak_flops"] == flops.H100_PEAK_BF16_FLOPS
    for r in rates:
        assert r["unit"] == "scenes/sec/chip" and r["value"] > 0 and r["batch"] == 2
        spread = r["spread"]
        assert spread["min"] <= spread["median"] <= spread["max"] and spread["reps"] >= 3


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("text_len", [32, 64])
def test_flop_counts_equal_jax(name, text_len):
    cfg, jcfg = CONFIGS[name]
    got, want = flops.forward_flops(cfg, text_len), jax_flops.forward_flops(jcfg, text_len)
    assert got == want
    occupancy = [0.25, 0.5, 0.125, 1.0]
    for fn in ("total_flops", "train_flops"):
        assert getattr(flops, fn)(got) == getattr(jax_flops, fn)(want)
        assert getattr(flops, fn)(got, occupancy) == getattr(jax_flops, fn)(want, occupancy)
    assert ([dataclasses.asdict(g) for g in flops.sa_geometry(cfg)]
            == [dataclasses.asdict(g) for g in jax_flops.sa_geometry(jcfg)])


def test_occupancy_and_mfu_equal_jax():
    cfg, jcfg = CONFIGS["tiny"]
    gen = SyntheticScenes(SyntheticConfig(num_points=cfg.num_points, num_objects=8, text_len=32),
                          vocab_size=cfg.text_vocab_size)
    pcs = gen.batch(range(2))["point_clouds"]
    occ = flops.measure_sa_occupancy(pcs, cfg)
    assert occ == jax_flops.measure_sa_occupancy(pcs, jcfg)
    assert all(0 < o <= 1 for o in occ)
    kw = dict(batch_size=8, text_len=32, fwd_time_s=0.02, train_time_s=0.3, occupancy=occ,
              peak=123e12)
    got, want = flops.mfu_summary(cfg, **kw), jax_flops.mfu_summary(jcfg, **kw)
    for phase in ("fwd", "train"):
        assert got[f"{phase}_dense_window_flops_per_scene"] == want[f"{phase}_flops_per_scene"]
        assert (got[f"{phase}_in_radius_flops_per_scene"]
                == want[f"{phase}_useful_flops_per_scene"])
        assert got[f"{phase}_mfu"] == want[f"{phase}_mfu"]
        assert got[f"{phase}_useful_mfu"] == want[f"{phase}_useful_mfu"]
    assert np.isclose(got["fwd_mfu"], 8 * got["fwd_dense_window_flops_per_scene"] / 0.02 / 123e12)


@pytest.mark.parametrize("argv", [["--impl", "gather"], ["--fused_qkv", "1"]])
def test_bench_refuses_what_it_does_not_port(argv, capsys):
    with pytest.raises(SystemExit):
        bench.parse_args(["--dry", "--cpu"] + argv)
    assert "ROADMAP Queue 1 item 4" in capsys.readouterr().err
