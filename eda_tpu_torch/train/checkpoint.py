"""Checkpoint save and restore (counterpart of ``eda_tpu/train/checkpoint.py``),
and the reader of the reference's ``.pth`` files.

The reference's semantics (``main_utils.py:126-166``): epoch-tagged entries
holding the model's ``state_dict`` (parameters and BatchNorm statistics), the
AdamW moments and update count, and the step; the optimizer restored or left
as it is (``--eval`` / ``--reduce_lr``); auto-resume from the newest entry of
a directory. Each entry is one ``torch.save`` file, ``epoch_{n}.pt``, written
under a temporary name and renamed into place, so a crash never leaves a
partial entry; it is read back with ``torch.load(..., weights_only=True)``.

Under a ``mesh`` (``eda_tpu_torch.parallel``) an entry still holds full
tensors: the parts of parameters split over the model group are gathered,
their AdamW moments too, rank 0 writes and every rank waits at a barrier;
a restore on any mesh keeps each rank's part. So a checkpoint saved
data-parallel restores tensor-parallel and back. Every rank restores the
entry that rank 0 chose and checks that it read rank 0's file (its bytes'
digest): a rank on a host that does not share rank 0's directory finds no
entry, or a stale one, and the restore raises on every rank instead of
letting the ranks train from different states.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import os
import re
from typing import List, Optional, Tuple

import torch

from eda_tpu_torch.parallel.mesh import gather_shards, shard, sharded_names
from eda_tpu_torch.train.step import TrainState

_ENTRY = re.compile(r"^epoch_(\d+)\.pt$")


class CheckpointManager:
    """Epoch-tagged checkpoints in ``directory``, the newest ``max_to_keep`` kept."""

    def __init__(self, directory: str, save_freq: int = 5, max_to_keep: int = 5, mesh=None):
        self.directory = os.path.abspath(directory)
        self.save_freq = save_freq
        self.max_to_keep = max_to_keep
        self.mesh = mesh
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
        save_state(self.path(epoch), state, mesh=self.mesh)
        if self.mesh is None or self.mesh.rank == 0:
            for old in self.epochs()[:-self.max_to_keep]:
                os.remove(self.path(old))
        if self.mesh is not None:
            self.mesh.barrier()
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
        if self.mesh is not None:
            epoch = self.mesh.gather_object(epoch)[0]  # rank 0 wrote the entries
        if epoch is None:
            return state, 0
        load_state(self.path(epoch), state, restore_optimizer, mesh=self.mesh)
        return state, epoch + 1


def _trained_split(state: TrainState, split: dict) -> list:
    """The split dimension (or None) of each moment in ``optimizer.state_dict()``'s order."""
    names = {p: n for n, p in state.model.named_parameters()}
    opt = state.optimizer
    return [split.get(names[p]) for g in opt.trained for p in opt.groups[g]]


def save_state(path: str, state: TrainState, mesh=None, **extra) -> None:
    """Write {model, optimizer, step} and ``extra`` to ``path`` atomically, with
    full tensors; under a ``mesh`` every rank calls it and rank 0 writes."""
    model, optimizer = state.model.state_dict(), state.optimizer.state_dict()
    split = sharded_names(state.model, mesh)
    if split:
        model = {k: gather_shards(v, split[k], mesh) if k in split else v
                 for k, v in model.items()}
        dims = _trained_split(state, split)
        for key in ("mu", "nu"):
            optimizer[key] = [v if d is None else gather_shards(v, d, mesh)
                              for v, d in zip(optimizer[key], dims)]
    if mesh is None or mesh.rank == 0:
        torch.save({"model": model, "optimizer": optimizer, "step": state.step, **extra},
                   path + ".tmp")
        os.replace(path + ".tmp", path)
    if mesh is not None:
        mesh.barrier()


def load_state(path: str, state: TrainState, restore_optimizer: bool = True,
               mesh=None) -> dict:
    """Load ``path`` into ``state`` (the optimizer only if ``restore_optimizer``;
    the step always) and return the whole payload; under a ``mesh`` each rank
    keeps its part of every split tensor."""
    device = next(state.model.parameters()).device
    if mesh is None:
        payload = torch.load(path, map_location=device, weights_only=True)
    else:
        payload = _load_agreed(path, mesh, device)
    model = payload["model"]
    split = sharded_names(state.model, mesh)
    if split:
        model = {k: shard(v, split[k], mesh) if k in split else v for k, v in model.items()}
    state.model.load_state_dict(model, strict=True)
    if restore_optimizer:
        optimizer = payload["optimizer"]
        if split:
            dims = _trained_split(state, split)
            optimizer = {**optimizer, **{key: [v if d is None else shard(v, d, mesh)
                                               for v, d in zip(optimizer[key], dims)]
                                          for key in ("mu", "nu")}}
        state.optimizer.load_state_dict(optimizer)
    state.step = int(payload["step"])
    return payload


def _load_agreed(path: str, mesh, device) -> dict:
    """``path``'s payload, once every rank of ``mesh`` has read the same bytes."""
    data = None
    if os.path.exists(path):
        with open(path, "rb") as f:
            data = f.read()
    digests = mesh.gather_object(None if data is None else hashlib.sha256(data).hexdigest())
    if digests[0] is None or len(set(digests)) != 1:
        seen = ", ".join(f"rank {r}: {'absent' if d is None else d[:12]}"
                         for r, d in enumerate(digests))
        raise RuntimeError(f"{path}: the ranks do not read one checkpoint ({seen}); rank 0 "
                           "writes the checkpoints, so every host needs a log or checkpoint "
                           "directory that they share")
    return torch.load(io.BytesIO(data), map_location=device, weights_only=True)


def read_torch_checkpoint(path: str):
    """A reference ``.pth`` / ``.pt`` file's payload on the CPU.

    Read with ``weights_only=True``: tensors, numbers, strings and containers,
    plus the ``argparse.Namespace`` of the run's flags that the reference's
    checkpoints carry under ``config``; any other object is refused.
    """
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def torch_state(payload) -> dict:
    """A payload's state dict (its ``model`` entry where it has one) as numpy
    arrays, DDP ``module.`` prefixes stripped; entries that are no tensor are
    dropped. ``torch_state(read_torch_checkpoint(path))`` is the JAX package's
    ``load_torch_checkpoint(path)``."""
    out = {}
    for key, value in payload.get("model", payload).items():
        while key.startswith("module."):
            key = key[len("module."):]
        if torch.is_tensor(value):
            out[key] = value.detach().cpu().numpy()
    return out
