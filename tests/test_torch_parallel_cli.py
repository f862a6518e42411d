"""The training CLI data-parallel: ``torchrun --nproc_per_node 2 -m eda_tpu_torch.train --cpu``.

Two gloo ranks restore the converged tiny weights (``tests/torch_tiny_overfit.npz``,
so that the accuracies are not all zero), train 3 steps of the synthetic
split (a global batch of 4, 2 rows a rank) and evaluate the 128-scene val
split, each rank scoring its rows and gathering the IoU stacks. Rank 0 alone writes the run directory:
one ``log.txt`` (with the mesh line), one ``metrics.jsonl`` with the 3
``train`` records and the ``val`` record, one checkpoint. A one-process
``--eval`` of that checkpoint must count the same accuracies exactly. Both
runs leave TensorBoard out (an unimportable ``tensorboard``), which only
drops ``tb/``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401

from eda_tpu_torch.config import ModelConfig, TrainConfig
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.train import cli
from eda_tpu_torch.train.checkpoint import save_state
from eda_tpu_torch.train.optim import AdamW
from eda_tpu_torch.train.step import TrainState

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--cpu", "--dataset", "synthetic", "--debug", "--use_color", "--batch_size", "4",
         "--num_workers", "0"]


def records(run: Path) -> list:
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def converged_checkpoint(directory: Path) -> None:
    """``directory/epoch_0.pt``: the converged tiny weights with fresh moments."""
    model = EDAGrounder(ModelConfig(use_bf16=True).tiny())
    with np.load(Path(__file__).with_name("torch_tiny_overfit.npz")) as f:
        model.load_state_dict({k: torch.from_numpy(f[k]) for k in f.files})
    directory.mkdir()
    save_state(str(directory / "epoch_0.pt"), TrainState(model, AdamW(model, TrainConfig(), 3)))


def test_two_rank_cli_trains_and_evaluates(tmp_path, monkeypatch, one_torch_thread):  # noqa: F811
    converged_checkpoint(tmp_path / "init")
    shadow = tmp_path / "shadow" / "tensorboard"
    shadow.mkdir(parents=True)
    (shadow / "__init__.py").write_text("raise ImportError('left out of this test')\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(shadow.parent), str(ROOT)]),
           "OMP_NUM_THREADS": "1"}
    env.pop("EDA_TPU_MULTIHOST", None)
    run = tmp_path / "dp"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "eda_tpu_torch.train", *FLAGS, "--checkpoint_path", str(tmp_path / "init"),
         "--max_epoch", "2", "--steps_per_epoch", "3",
         "--val_freq", "1", "--print_freq", "1", "--log_dir", str(run)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    log = (run / "log.txt").read_text()
    assert "mesh: data=2 model=1 (gloo)" in log
    assert log.count("Testing evaluation") == 0 and log.count("scored 128 scenes") == 1
    dp = records(run)
    assert [r["group"] for r in dp] == ["train"] * 3 + ["val"]
    assert [r["step"] for r in dp[:3]] == [1, 2, 3]
    assert "resumed from epoch 1" in log
    assert sorted(p.name for p in (run / "ckpt").iterdir()) == ["epoch_1.pt"]

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    one = tmp_path / "one"
    assert cli.main([*FLAGS, "--eval", "--checkpoint_path", str(run / "ckpt"),
                     "--log_dir", str(one)]) == 0
    (val,) = records(one)
    want = {k: v for k, v in val.items() if k not in ("step", "time")}
    got = {k: v for k, v in dp[-1].items() if k not in ("step", "time")}
    assert got == want
    assert any(v > 0 for k, v in want.items() if k.startswith("last_Acc"))


def test_round_to_data_is_train_py_s(monkeypatch):
    assert cli.round_to_data(12, None) == 12
    mesh = type("Mesh", (), {"data": 8})()
    assert [cli.round_to_data(b, mesh) for b in (1, 8, 12, 17)] == [8, 8, 8, 16]
    monkeypatch.setenv("EDA_TPU_MULTIHOST", "1")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node N"):
        cli.main(["--cpu"])
