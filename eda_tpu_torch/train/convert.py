"""Pretrained inputs of a training run: the RoBERTa warm start.

The port's counterpart of ``eda_tpu/train/convert.py:warm_start``. Where
``{data_root}/roberta-base`` holds ``pytorch_model.bin`` (or ``model.pt``), a
HuggingFace ``roberta-base`` state dict, its weights become the grounder's text
encoder. The HF names map onto ``models/roberta.py:RobertaEncoder``, whose
``Linear`` layout is HF's, so every tensor is copied as it is, except that the
token-type row 0 is folded into the position table: the grounder encodes
single-segment text only, so that row is a constant offset.
"""

from __future__ import annotations

import os.path as osp
import re
from typing import Callable, Dict

import torch

from eda_tpu_torch.config import ModelConfig

ROBERTA_FILES = ("pytorch_model.bin", "model.pt")

# HF roberta-base name -> RobertaEncoder name: the embeddings, then each layer's modules
_HF_NAMES = {
    "embeddings.word_embeddings.weight": "embeddings.word_embeddings.weight",
    "embeddings.position_embeddings.weight": "embeddings.position_embeddings.weight",
    "embeddings.LayerNorm.weight": "embeddings.layer_norm.weight",
    "embeddings.LayerNorm.bias": "embeddings.layer_norm.bias",
}
_HF_LAYER = {
    "attention.self.query": "attention.query",
    "attention.self.key": "attention.key",
    "attention.self.value": "attention.value",
    "attention.output.dense": "attention.out",
    "attention.output.LayerNorm": "attention_norm",
    "intermediate.dense": "intermediate",
    "output.dense": "output",
    "output.LayerNorm": "output_norm",
}
_LAYER_KEY = re.compile(r"^encoder\.layer\.(\d+)\.(.+)\.(weight|bias)$")


def load_torch_state(path: str) -> Dict[str, torch.Tensor]:
    """A torch state dict on the CPU (tensors only), without DDP's ``module.``
    prefixes; a ``{"model": ...}`` payload gives its ``model`` entry."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model", ckpt)
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items() if torch.is_tensor(v)}


def convert_hf_roberta(state: Dict[str, torch.Tensor], num_layers: int) -> Dict[str, torch.Tensor]:
    """A HF ``roberta-base`` state dict (``roberta.`` prefixes stripped) ->
    ``RobertaEncoder`` tensors of its first ``num_layers`` layers. The pooler
    and ``position_ids`` have no counterpart and are dropped."""
    out = {ours: state[hf] for hf, ours in _HF_NAMES.items()}
    tok_type = state.get("embeddings.token_type_embeddings.weight")
    if tok_type is not None:
        out["embeddings.position_embeddings.weight"] = (
            out["embeddings.position_embeddings.weight"] + tok_type[0])
    for key, value in state.items():
        m = _LAYER_KEY.match(key)
        if m and int(m.group(1)) < num_layers:
            out[f"layer.{m.group(1)}.{_HF_LAYER[m.group(2)]}.{m.group(3)}"] = value
    return out


def warm_start(model: torch.nn.Module, cfg: ModelConfig, *, data_root: str = None,
               pp_checkpoint: str = None, log: Callable[[str], None] = print) -> None:
    """Load the run's pretrained inputs into ``model`` in place.

    ``{data_root}/roberta-base/{pytorch_model.bin,model.pt}`` becomes the text
    encoder; where neither file exists the weights stay as they are and a line
    is logged. The GroupFree backbone (``pp_checkpoint``) is ROADMAP Queue 1
    item 4. The butd class-embedding table loads only into a butd model,
    which the port does not build yet (the same item).
    """
    if pp_checkpoint:
        raise NotImplementedError("pp_checkpoint: the GroupFree backbone converter is not "
                                  "ported (ROADMAP Queue 1 item 4)")
    if not data_root:
        return
    rb_dir = osp.join(data_root, "roberta-base")
    weights = next((osp.join(rb_dir, f) for f in ROBERTA_FILES
                    if osp.exists(osp.join(rb_dir, f))), None)
    if weights is None:
        log(f"text_encoder: no RoBERTa weights under {rb_dir}, skipping")
        return
    state = {(k[len("roberta."):] if k.startswith("roberta.") else k): v
             for k, v in load_torch_state(weights).items()}
    text = convert_hf_roberta(state, cfg.text_layers)
    target = model.text_encoder.state_dict()
    missing = sorted(set(target) - set(text))
    if missing:
        raise KeyError(f"{weights} sets no {missing}")
    with torch.no_grad():
        for key, value in text.items():
            if value.shape != target[key].shape:
                raise ValueError(f"{key}: {weights} has shape {tuple(value.shape)}, the text "
                                 f"encoder {tuple(target[key].shape)}")
            target[key].copy_(value)
    log(f"text_encoder: loaded {len(text)} RoBERTa leaves from {weights}")
