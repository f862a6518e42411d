"""Shared helpers of the ``test_torch_*`` parity tests (JAX reference vs PyTorch port).

The JAX side is compiled with ``xla_allow_excess_precision`` off: by default
XLA on the CPU keeps bf16 intermediates in f32 where a convert back to f32
follows (e.g. ``prod + bias`` in the prep kernel), so it skips roundings the
program asks for and that the port performs. With the option off, the JAX
reference rounds where its source says it does.
"""

from __future__ import annotations

import re

import jax
import numpy as np
import pytest
import torch

NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}


def compiled(fn, *args, **static):
    """Run ``fn(*args, **static)`` as one XLA program without excess precision."""
    jitted = jax.jit(lambda *a: fn(*a, **static))
    return jitted.lower(*args).compile(compiler_options=NO_EXCESS_PRECISION)(*args)


def bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 values to bf16 (nearest even) and back, in numpy."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def perturb(variables, seed: int = 0):
    """Random LayerNorm/BatchNorm parameters and statistics and random biases,
    so that no parameter sits at its identity init."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        if name == "scale" or re.fullmatch(r"ln_scale\d+", name):
            return (1.0 + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean") or re.fullmatch(r"b\d+|ln_bias\d+", name):
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def tpu_path(monkeypatch, training: bool = False):
    """Put the JAX model on its TPU path, every Pallas kernel interpreted on the CPU.

    ``jax.default_backend`` reads "tpu" (so FusedSetAbstraction picks the
    Pallas pair kernel, ``impl="pallas_train"`` when it trains, and pointops
    the Pallas FPS). With ``training`` the pair pool's backward kernel is
    interpreted too and dropout is the identity (``flax.linen.Dropout``
    returns its input). Nothing in ``eda_tpu`` is edited.
    """
    from flax import linen as nn

    from eda_tpu.ops.pallas import fps as pallas_fps
    from eda_tpu.ops.pallas import sa_kernel, sa_prep

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(sa_prep, "_INTERPRET", True)
    names = [(sa_kernel, "sa_pair_pool_pallas"), (pallas_fps, "furthest_point_sample_pallas")]
    if training:
        names.append((sa_kernel, "sa_pair_pool_bwd_pallas"))
        monkeypatch.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    for module, name in names:
        orig = getattr(module, name)

        def patched(*a, _orig=orig, **k):
            k["interpret"] = True
            return getattr(_orig, "__wrapped__", _orig)(*a, **k)

        monkeypatch.setattr(module, name, patched)


@pytest.fixture
def jax_tpu_serving_path(monkeypatch):
    """The JAX model on its TPU serving path, interpreted on the CPU."""
    tpu_path(monkeypatch)


@pytest.fixture
def jax_tpu_training_path(monkeypatch):
    """The JAX model on its TPU training path (``impl="pallas_train"``),
    interpreted on the CPU, with dropout off."""
    tpu_path(monkeypatch, training=True)
