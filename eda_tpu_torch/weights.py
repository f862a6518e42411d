"""Carry the JAX package's flax variables into the port's ``state_dict``.

``from_flax`` takes ``{"params": ..., "batch_stats": ...}`` as nested dicts of
numpy arrays (so the port needs no JAX) and renames every leaf to the port's
module path:

* flax auto-names become the port's attributes: ``Dense_i`` -> ``dense.i``,
  ``BatchNorm_i`` -> ``bn.i``, ``LayerNorm_0`` -> ``norm``, ``SharedMLP_0`` ->
  ``mlp``, ``MHA_0/MultiHeadDotProductAttention_0`` -> ``attn``, and numbered
  children (``decoder_3``) become list entries (``decoder.3``);
* ``Dense`` kernels (in, out) become ``Linear``-layout weights (out, in);
  attention kernels (d, h, dh) and (h, dh, d) are flattened first;
* LayerNorm / BatchNorm ``scale`` -> ``weight``, BatchNorm ``mean`` / ``var``
  -> ``running_mean`` / ``running_var``, ``Embed.embedding`` -> ``weight``
  (so the butd stream's ``box_embeddings``, ``butd_class_embeddings``,
  ``class_embeddings`` and each layer's ``cross_d`` need no rule of their own);
* the fused SA's ``w{i}``, ``b{i}``, ``ln_scale{i}``, ``ln_bias{i}`` ->
  ``kernels.i``, ``biases.i``, ``ln_scales.i``, ``ln_biases.i`` (layout kept).

``load_flax`` raises on a flax leaf with no port parameter and on a port
parameter or buffer that no flax leaf sets. ``to_flax`` is its inverse: a port
``state_dict`` back to flax variables, laid out as a given flax tree (its
leaves give the names and the shapes the renaming dropped).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_SEGMENT_RULES = (
    (re.compile(r"^Dense_(\d+)$"), r"dense.\1"),
    (re.compile(r"^BatchNorm_(\d+)$"), r"bn.\1"),
    (re.compile(r"^LayerNorm_0$"), "norm"),
    (re.compile(r"^SharedMLP_0$"), "mlp"),
    (re.compile(r"^MHA_0$"), "attn"),
    (re.compile(r"^(cross_encoder|decoder|prediction_head|layer)_(\d+)$"), r"\1.\2"),
)
_SA_LEAF = re.compile(r"^(w|b|ln_scale|ln_bias)(\d+)$")
_SA_LISTS = {"w": "kernels", "b": "biases", "ln_scale": "ln_scales", "ln_bias": "ln_biases"}
_LEAF_NAMES = {
    "scale": "weight", "embedding": "weight", "mean": "running_mean",
    "var": "running_var", "bias": "bias", "kernel": "weight",
}


def _leaves(tree: dict, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), np.asarray(value)


def _convert(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    segments = [s for s in path[:-1] if s != "MultiHeadDotProductAttention_0"]
    for i, seg in enumerate(segments):
        for pattern, repl in _SEGMENT_RULES:
            if pattern.match(seg):
                segments[i] = pattern.sub(repl, seg)
                break
    leaf = path[-1]
    sa = _SA_LEAF.match(leaf)
    if sa:  # fused SA parameters keep the (in, out) layout of the JAX package
        return ".".join(segments + [_SA_LISTS[sa.group(1)], sa.group(2)]), value
    if leaf not in _LEAF_NAMES:
        raise KeyError(f"no port parameter for flax leaf {'/'.join(path)}")
    if leaf == "kernel":
        if value.ndim == 3 and path[-2] == "out":  # (h, dh, d)
            value = value.reshape(-1, value.shape[-1])
        elif value.ndim == 3:  # (d, h, dh)
            value = value.reshape(value.shape[0], -1)
        value = value.T
    elif leaf == "bias":
        value = value.reshape(-1)
    return ".".join(segments + [_LEAF_NAMES[leaf]]), value


def from_flax(variables: Dict[str, dict]) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` (numpy leaves) -> the port's state dict."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            key, value = _convert(path, value)
            if key in state:
                raise KeyError(f"two flax leaves map to {key}")
            state[key] = torch.tensor(np.asarray(value, dtype=np.float32))
    return state


def load_flax(model: torch.nn.Module, variables: Dict[str, dict]) -> None:
    """Set every parameter and buffer of ``model`` from flax variables, strictly."""
    state = from_flax(variables)
    expected = model.state_dict()
    unknown = sorted(set(state) - set(expected))
    missing = sorted(set(expected) - set(state))
    if unknown or missing:
        raise KeyError(f"flax leaves without a port parameter: {unknown}; "
                       f"port parameters no flax leaf sets: {missing}")
    for key, value in state.items():
        if value.shape != expected[key].shape:
            raise ValueError(f"{key}: flax shape {tuple(value.shape)} != port "
                             f"shape {tuple(expected[key].shape)}")
    model.load_state_dict(state, strict=True)


def to_flax(state: Dict[str, torch.Tensor], like: Dict[str, dict]) -> Dict[str, dict]:
    """The port's state dict as flax ``{"params", "batch_stats"}`` of numpy f32
    leaves, with the names and shapes of ``like`` (flax variables, any leaves
    with a ``shape``). Strict both ways, as ``load_flax``."""

    def build(tree, path):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = build(value, path + (key,))
                continue
            shape = tuple(np.shape(value))
            name, converted = _convert(path + (key,), np.zeros(shape, np.float32))
            if name not in state:
                raise KeyError(f"no port tensor {name} for flax leaf {'/'.join(path + (key,))}")
            x = state[name].detach().cpu().float().numpy()
            if x.shape != converted.shape:
                raise ValueError(f"{name}: port shape {x.shape} != {converted.shape}")
            used.add(name)
            out[key] = np.ascontiguousarray((x.T if key == "kernel" else x).reshape(shape))
        return out

    used = set()
    variables = {c: build(like[c], ()) for c in ("params", "batch_stats") if c in like}
    unused = sorted(set(state) - used)
    if unused:
        raise KeyError(f"port tensors no flax leaf takes: {unused}")
    return variables
