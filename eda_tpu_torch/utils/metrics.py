"""Metric logging: ``metrics.jsonl`` always, TensorBoard when it imports.

Counterpart of ``eda_tpu/utils/metrics.py``: the same file names, the same
record keys (``step``, ``time``, ``group`` and the scalars) and the same
TensorBoard tags (``{group}/{name}`` under ``tb/``), so one parser reads the
run directories of both packages.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is not installed
            return
        self._tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def write(self, step: int, scalars: Dict[str, float], group: str = "train"):
        record = {"step": int(step), "time": time.time(), "group": group}
        record.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for key, value in scalars.items():
                self._tb.add_scalar(f"{group}/{key}", float(value), step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
