"""Checkpoint save and restore (counterpart of ``eda_tpu/train/checkpoint.py``).

The reference's semantics (``main_utils.py:126-166``): epoch-tagged entries
holding the model's ``state_dict`` (parameters and BatchNorm statistics), the
AdamW moments and update count, and the step; the optimizer restored or left
as it is (``--eval`` / ``--reduce_lr``); auto-resume from the newest entry of
a directory. Each entry is one ``torch.save`` file, ``epoch_{n}.pt``, written
under a temporary name and renamed into place, so a crash never leaves a
partial entry; it is read back with ``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

from eda_tpu_torch.train.step import TrainState

_ENTRY = re.compile(r"^epoch_(\d+)\.pt$")


class CheckpointManager:
    """Epoch-tagged checkpoints in ``directory``, the newest ``max_to_keep`` kept."""

    def __init__(self, directory: str, save_freq: int = 5, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.save_freq = save_freq
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def epochs(self) -> List[int]:
        """The epochs of the entries present, ascending."""
        return sorted(int(m.group(1)) for m in map(_ENTRY.match, os.listdir(self.directory))
                      if m)

    def save(self, epoch: int, state: TrainState, force: bool = False) -> bool:
        """Save {model, optimizer, step} at an epoch boundary: every ``save_freq``
        epochs (``(epoch + 1) % save_freq == 0``), or whenever ``force``."""
        if not force and self.save_freq > 0 and (epoch + 1) % self.save_freq != 0:
            return False
        save_state(self.path(epoch), state)
        for old in self.epochs()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return True

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, state: TrainState, epoch: Optional[int] = None,
                restore_optimizer: bool = True) -> Tuple[TrainState, int]:
        """Load the entry of ``epoch`` (default: the newest) into ``state``.

        Returns (state, start epoch): (state, 0) when there is no entry, else
        (state, epoch + 1). ``restore_optimizer=False`` leaves the optimizer
        as it is, the reference's ``--eval`` / ``--reduce_lr`` rule; the step
        is restored either way.
        """
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            return state, 0
        load_state(self.path(epoch), state, restore_optimizer)
        return state, epoch + 1


def save_state(path: str, state: TrainState, **extra) -> None:
    """Write {model, optimizer, step} and ``extra`` to ``path`` atomically."""
    payload = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "step": state.step, **extra}
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_state(path: str, state: TrainState, restore_optimizer: bool = True) -> dict:
    """Load ``path`` into ``state`` (the optimizer only if ``restore_optimizer``;
    the step always) and return the whole payload."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    if restore_optimizer:
        state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return payload
