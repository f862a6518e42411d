"""The port's bench (``python -m eda_tpu_torch.bench``) and FLOP accounting (``utils/flops.py``).

* ``--dry --cpu --eval`` builds ``ModelConfig().tiny()`` (f32) and prints the
  JAX bench's JSON lines in its order (the forward line last) with finite
  values and, as the JAX bench under ``--dry``, no MFU; ``--impl gather``
  runs the gather grounder;
* ``forward_flops``, ``total_flops`` and ``train_flops`` equal
  ``eda_tpu/utils/flops.py``'s exactly on the flagship and the tiny config,
  the measured SA occupancy equals the JAX replay's (the port's FPS is
  bit-exact with JAX's), and the MFU shares are the JAX formulas' at one peak;
* ``--fused_qkv 1``, refused until the fused projection was ported, builds
  the fused model (``test_bench_refuses_what_it_does_not_port`` keeps its name).
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


def _build_config(monkeypatch):
    """The config ``bench.main`` builds its model from."""
    seen = []
    build = bench.build
    monkeypatch.setattr(bench, "build", lambda cfg, *a: seen.append(cfg) or build(cfg, *a))
    return seen


def test_dry_cpu_prints_the_four_lines(capsys, monkeypatch):
    """``--dry`` builds the JAX bench's tiny config, ``ModelConfig().tiny()`` in
    f32, and prints the JAX bench's lines for it: the three rates, and (as the
    JAX bench, ``bench.py:316-321``) no ``mfu_accounting`` line."""
    seen = _build_config(monkeypatch)
    assert bench.main(["--dry", "--cpu", "--eval", "--iters", "4"]) == 0
    assert seen == [ModelConfig().tiny()] and not seen[0].use_bf16
    rates = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line]
    assert [r["metric"] for r in rates] == [
        "grounding_train_throughput", "grounding_eval_throughput",
        "grounding_forward_throughput"]
    for r in rates:
        assert _finite(r) and r["device"] == "cpu" and r["card"] is None
        assert not any(k.endswith("mfu") for k in r)
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


def test_bench_runs_the_gather_sa(capsys, monkeypatch):
    """``--impl gather`` builds the gather grounder and prints its rates, no MFU."""
    seen = _build_config(monkeypatch)
    assert bench.main(["--dry", "--cpu", "--impl", "gather", "--no-train", "--iters", "3"]) == 0
    assert [c.sa_impl for c in seen] == ["gather"]
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x]
    assert line["metric"] == "grounding_forward_throughput" and line["value"] > 0
    assert _finite(line) and not any(k.endswith("mfu") for k in line)


@pytest.mark.parametrize("argv", [["--fused_qkv", "1"]])
def test_bench_refuses_what_it_does_not_port(argv, capsys, monkeypatch):
    """The bench refused ``--fused_qkv 1`` until the fused projection was
    ported; a ``--dry`` run now builds the fused model and prints its rate."""
    seen = _build_config(monkeypatch)
    assert bench.main(["--dry", "--cpu", "--no-train", "--iters", "2"] + argv) == 0
    assert [c.fused_qkv for c in seen] == [True]
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x]
    assert line["metric"] == "grounding_forward_throughput" and line["value"] > 0
