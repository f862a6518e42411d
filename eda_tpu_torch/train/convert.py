"""Pretrained inputs of a training run: the reference's ``.pth`` files, HF
RoBERTa weights and the butd class-name table (counterpart of
``eda_tpu/train/convert.py``).

Each converter builds the flax-layout numpy tree that the JAX package's
converter builds, and ``merge_into`` loads it through ``weights.from_flax``,
so the port keeps one name mapping (flax names to its own), not a second one
from the reference's names:

    torch nn.Linear(in,out).weight (out,in)      -> Dense kernel (in,out)
    torch nn.Conv1d(in,out,1).weight (out,in,1)  -> Dense kernel (in,out)
    torch nn.Conv2d(in,out,1,1) [SharedMLP]      -> Dense kernel (in,out)
    torch nn.BatchNorm*d                         -> BatchNorm {scale,bias} +
                                                    batch_stats {mean,var}
    torch nn.MultiheadAttention in_proj/out_proj -> MultiHeadDotProductAttention
        {query,key,value} kernels (d, heads, head_dim), out (heads, head_dim, d)
    torch nn.LayerNorm                           -> LayerNorm {scale,bias}

* ``warm_start`` — the run's external inputs (``models/bdetr.py:63-95``):
  ``--pp_checkpoint`` (the GroupFree PointNet++ backbone, strict=False),
  ``{data_root}/roberta-base/{pytorch_model.bin,model.pt}`` (the HF RoBERTa
  weights: the text encoder) and ``{data_root}/class_embeddings3d.npy`` (the
  frozen butd class-name table);
* ``load_eda_pth`` — a released EDA checkpoint (``--checkpoint_path foo.pth``).

Conversion is strict=False like the reference loader: only keys present in
the state dict are emitted, and ``merge_into`` overlays them onto the model,
raising on a leaf without a counterpart or of another shape.
"""

from __future__ import annotations

import os.path as osp
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.train.checkpoint import read_torch_checkpoint, torch_state
from eda_tpu_torch.weights import from_flax

ROBERTA_FILES = ("pytorch_model.bin", "model.pt")


def _t(sd, key):
    return np.asarray(sd[key])


def _linear(sd, key):
    out = {"kernel": _t(sd, key + ".weight").T}
    if key + ".bias" in sd:
        out["bias"] = _t(sd, key + ".bias")
    return out


def _conv1x1(sd, key):
    """Conv1d/Conv2d with kernel size 1 -> Dense."""
    w = _t(sd, key + ".weight")
    w = w.reshape(w.shape[0], w.shape[1])  # (out, in, 1[, 1]) -> (out, in)
    out = {"kernel": w.T}
    if key + ".bias" in sd:
        out["bias"] = _t(sd, key + ".bias")
    return out


def _ln(sd, key):
    return {"scale": _t(sd, key + ".weight"), "bias": _t(sd, key + ".bias")}


def _bn(sd, key):
    params = {"scale": _t(sd, key + ".weight"), "bias": _t(sd, key + ".bias")}
    stats = {"mean": _t(sd, key + ".running_mean"), "var": _t(sd, key + ".running_var")}
    return params, stats


def _mha(sd, key, heads):
    """torch nn.MultiheadAttention -> flax MultiHeadDotProductAttention."""
    w = _t(sd, key + ".in_proj_weight")  # (3d, d)
    b = _t(sd, key + ".in_proj_bias")  # (3d,)
    d = w.shape[1]
    hd = d // heads

    def proj(i):
        return {
            "kernel": w[i * d:(i + 1) * d].T.reshape(d, heads, hd),
            "bias": b[i * d:(i + 1) * d].reshape(heads, hd),
        }

    out_w = _t(sd, key + ".out_proj.weight").T  # (d, d)
    return {
        "query": proj(0),
        "key": proj(1),
        "value": proj(2),
        "out": {"kernel": out_w.reshape(heads, hd, d), "bias": _t(sd, key + ".out_proj.bias")},
    }


def _residual_attn(sd, attn_key, norm_key, heads):
    """ResidualAttn subtree (MHA + post-LayerNorm)."""
    return {
        "MHA_0": {"MultiHeadDotProductAttention_0": _mha(sd, attn_key, heads)},
        "LayerNorm_0": _ln(sd, norm_key),
    }


def _ffn(sd, ffn_key, norm_key):
    """FFN subtree (Linear-ReLU-Linear + post-LayerNorm); the reference's
    nn.Sequential indices 0/3 hold the Linears."""
    return {
        "Dense_0": _linear(sd, ffn_key + ".0"),
        "Dense_1": _linear(sd, ffn_key + ".3"),
        "LayerNorm_0": _ln(sd, norm_key),
    }


def _pos_embed(sd, key):
    """PositionEmbeddingLearned: Conv1d+BN1d+ReLU+Conv1d
    (``models/modules.py:52-67``, Sequential indices 0/1/3)."""
    head = key + ".position_embedding_head"
    bn_p, bn_s = _bn(sd, head + ".1")
    params = {
        "Dense_0": _conv1x1(sd, head + ".0"),
        "BatchNorm_0": bn_p,
        "Dense_1": _conv1x1(sd, head + ".3"),
    }
    return params, {"BatchNorm_0": bn_s}


def _three_mlp(sd, key):
    """ThreeLayerMLP: Sequential conv/bn/relu/drop x2 + conv
    (``models/modules.py:89-108``, indices 0/1/4/5/8)."""
    bn0_p, bn0_s = _bn(sd, key + ".net.1")
    bn1_p, bn1_s = _bn(sd, key + ".net.5")
    params = {
        "Dense_0": _conv1x1(sd, key + ".net.0"),
        "BatchNorm_0": bn0_p,
        "Dense_1": _conv1x1(sd, key + ".net.4"),
        "BatchNorm_1": bn1_p,
        "Dense_2": _conv1x1(sd, key + ".net.8"),
    }
    return params, {"BatchNorm_0": bn0_s, "BatchNorm_1": bn1_s}


def _predict_head(sd, key):
    """ClsAgnosticPredictHead (``models/modules.py:111-178``)."""
    params, stats = {}, {}
    for ours, theirs in (
        ("center_head", "center_residual_head"),
        ("size_head", "size_pred_head"),
        ("sem_cls_head", "sem_cls_scores_head"),
    ):
        params[ours], stats[ours] = _three_mlp(sd, f"{key}.{theirs}")
    return params, stats


def _shared_mlp(sd, key, num_layers):
    """pytorch_utils.SharedMLP: layer{i}.conv (no bias) + layer{i}.bn.bn."""
    params, stats = {}, {}
    for i in range(num_layers):
        params[f"Dense_{i}"] = _conv1x1(sd, f"{key}.layer{i}.conv")
        params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"] = _bn(sd, f"{key}.layer{i}.bn.bn")
    return params, stats


def convert_hf_roberta(state: Dict[str, np.ndarray], num_layers: int, heads: int) -> dict:
    """A HF ``roberta-base`` state dict (``roberta.`` prefixes stripped) -> the
    flax params of the text encoder's first ``num_layers`` layers.

    The token-type row 0 is folded into the position table: the grounder
    encodes single-segment text only, so that row is a constant offset. The
    pooler and ``position_ids`` have no counterpart and are dropped.
    """

    def lin(prefix):
        return {"kernel": _t(state, prefix + ".weight").T, "bias": _t(state, prefix + ".bias")}

    pos_table = _t(state, "embeddings.position_embeddings.weight")
    tok_type = state.get("embeddings.token_type_embeddings.weight")
    if tok_type is not None:
        pos_table = pos_table + np.asarray(tok_type)[0]
    params = {
        "embeddings": {
            "word_embeddings": {"embedding": _t(state, "embeddings.word_embeddings.weight")},
            "position_embeddings": {"embedding": pos_table},
            "layer_norm": _ln(state, "embeddings.LayerNorm"),
        }
    }
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        hidden = _t(state, f"{p}.attention.self.query.weight").shape[0]
        head_dim = hidden // heads

        def attn_proj(name):
            return {
                "kernel": _t(state, f"{p}.attention.self.{name}.weight").T.reshape(
                    hidden, heads, head_dim),
                "bias": _t(state, f"{p}.attention.self.{name}.bias").reshape(heads, head_dim),
            }

        out_w = _t(state, f"{p}.attention.output.dense.weight").T
        params[f"layer_{i}"] = {
            "attention": {
                "query": attn_proj("query"),
                "key": attn_proj("key"),
                "value": attn_proj("value"),
                "out": {"kernel": out_w.reshape(heads, head_dim, hidden),
                        "bias": _t(state, f"{p}.attention.output.dense.bias")},
            },
            "attention_norm": _ln(state, f"{p}.attention.output.LayerNorm"),
            "intermediate": lin(f"{p}.intermediate.dense"),
            "output": lin(f"{p}.output.dense"),
            "output_norm": _ln(state, f"{p}.output.LayerNorm"),
        }
    return params


def convert_backbone(sd: dict, cfg: ModelConfig) -> Tuple[dict, dict]:
    """Pointnet2Backbone state dict -> ``backbone_net`` flax subtrees (params, stats).

    Accepts bare keys (``sa1.mlp_module...``) or keys under a
    ``backbone_net.`` prefix (full-detector checkpoints like GroupFree's
    ``gf_detector_l6o256.pth``), DDP ``module.`` prefixes already stripped
    (``checkpoint.torch_state``). Exact for the gather SA; on the fused path
    only the SA conv kernels transfer (as ``w{i}``): the fused layer
    normalizes with LayerNorm, so the SA BatchNorms have no counterpart and
    the warm start is initialization-level only (the reference itself loads
    strict=False, ``models/bdetr.py:67-70``).
    """
    if not any(k.startswith("sa1.") for k in sd):
        sd = {k[len("backbone_net."):]: v for k, v in sd.items()
              if k.startswith("backbone_net.")}
    params: Dict = {}
    stats: Dict = {}
    for i in range(4):
        name = f"sa{i + 1}"
        if f"{name}.mlp_module.layer0.conv.weight" not in sd:
            continue
        n_layers = len(cfg.sa_mlps[i])
        if cfg.sa_impl == "gather":
            p, s = _shared_mlp(sd, f"{name}.mlp_module", n_layers)
            params[name] = {"SharedMLP_0": p}
            stats[name] = {"SharedMLP_0": s}
        else:  # fused: kernels only, see the docstring
            params[name] = {f"w{j}": _conv1x1(sd, f"{name}.mlp_module.layer{j}.conv")["kernel"]
                            for j in range(n_layers)}
    for i in range(2):
        name = f"fp{i + 1}"
        if f"{name}.mlp.layer0.conv.weight" not in sd:
            continue
        p, s = _shared_mlp(sd, f"{name}.mlp", len(cfg.fp_mlps[i]))
        params[name] = {"SharedMLP_0": p}
        stats[name] = {"SharedMLP_0": s}
    return params, stats


def convert_eda_checkpoint(sd: dict, cfg: ModelConfig) -> Tuple[dict, dict]:
    """A whole BeaUTyDETR state dict -> (params, batch_stats) flax trees.

    Covers every torch module of ``models/bdetr.py:46-157``; missing keys are
    skipped (strict=False), so partial checkpoints give partial trees. DDP
    ``module.`` prefixes are stripped by ``checkpoint.torch_state`` before.
    """
    params: Dict = {}
    stats: Dict = {}

    bp, bs = convert_backbone(sd, cfg)
    if bp:
        params["backbone_net"] = bp
        if bs:
            stats["backbone_net"] = bs

    text_sd = {k[len("text_encoder."):]: v for k, v in sd.items()
               if k.startswith("text_encoder.")}
    if text_sd:
        params["text_encoder"] = convert_hf_roberta(text_sd, cfg.text_layers, cfg.text_heads)

    if "text_projector.0.weight" in sd:
        params["text_projector_dense"] = _linear(sd, "text_projector.0")
        params["text_projector_norm"] = _ln(sd, "text_projector.1")

    # the butd box stream (bdetr.py:88-97)
    if "butd_class_embeddings.weight" in sd:
        params["butd_class_embeddings"] = {"embedding": _t(sd, "butd_class_embeddings.weight")}
    if "class_embeddings.weight" in sd:
        params["class_embeddings"] = _linear(sd, "class_embeddings")
    if "box_embeddings.position_embedding_head.0.weight" in sd:
        params["box_embeddings"], stats["box_embeddings"] = _pos_embed(sd, "box_embeddings")

    if "pos_embed.position_embedding_head.0.weight" in sd:
        params["pos_embed"], stats["pos_embed"] = _pos_embed(sd, "pos_embed")

    heads = cfg.n_heads
    for i in range(cfg.num_encoder_layers):
        key = f"cross_encoder.layers.{i}"
        cross = f"{key}.cross_layer"
        if f"{cross}.cross_lv.in_proj_weight" not in sd:
            continue
        layer = {
            "cross_lv": _residual_attn(sd, f"{cross}.cross_lv", f"{cross}.norm_lv", heads),
            "ffn_lv": _ffn(sd, f"{cross}.ffn_lv", f"{cross}.norm_lv2"),
            "cross_vl": _residual_attn(sd, f"{cross}.cross_vl", f"{cross}.norm_vl", heads),
            "ffn_vl": _ffn(sd, f"{cross}.ffn_vl", f"{cross}.norm_vl2"),
        }
        if f"{key}.self_attention_visual.self_attn.in_proj_weight" in sd:
            layer["self_vis"] = _residual_attn(
                sd, f"{key}.self_attention_visual.self_attn",
                f"{key}.self_attention_visual.norm1", heads)
            layer["self_lang"] = _residual_attn(
                sd, f"{key}.self_attention_lang.self_attn",
                f"{key}.self_attention_lang.norm1", heads)
        if f"{cross}.cross_d.in_proj_weight" in sd:
            layer["cross_d"] = _residual_attn(sd, f"{cross}.cross_d", f"{cross}.norm_d", heads)
        params[f"cross_encoder_{i}"] = layer

    if "points_obj_cls.conv1.weight" in sd:
        bn1_p, bn1_s = _bn(sd, "points_obj_cls.bn1")
        bn2_p, bn2_s = _bn(sd, "points_obj_cls.bn2")
        params["points_obj_cls"] = {
            "Dense_0": _conv1x1(sd, "points_obj_cls.conv1"),
            "BatchNorm_0": bn1_p,
            "Dense_1": _conv1x1(sd, "points_obj_cls.conv2"),
            "BatchNorm_1": bn2_p,
            "Dense_2": _conv1x1(sd, "points_obj_cls.conv3"),
        }
        stats["points_obj_cls"] = {"BatchNorm_0": bn1_s, "BatchNorm_1": bn2_s}

    if "decoder_query_proj.weight" in sd:
        params["decoder_query_proj"] = _conv1x1(sd, "decoder_query_proj")

    if "proposal_head.center_residual_head.net.0.weight" in sd:
        params["proposal_head"], stats["proposal_head"] = _predict_head(sd, "proposal_head")

    for i in range(cfg.num_decoder_layers):
        key = f"decoder.{i}"
        if f"{key}.self_attn.in_proj_weight" not in sd:
            continue
        layer = {
            "self_attn": _residual_attn(sd, f"{key}.self_attn", f"{key}.norm1", heads),
            "cross_l": _residual_attn(sd, f"{key}.cross_l", f"{key}.norm_l", heads),
            "cross_v": _residual_attn(sd, f"{key}.cross_v", f"{key}.norm_v", heads),
            "ffn": _ffn(sd, f"{key}.ffn", f"{key}.norm2"),
        }
        if f"{key}.self_posembed.position_embedding_head.0.weight" in sd:
            layer["self_posembed"], layer_stats = _pos_embed(sd, f"{key}.self_posembed")
            stats[f"decoder_{i}"] = {"self_posembed": layer_stats}
        if f"{key}.cross_d.in_proj_weight" in sd:
            layer["cross_d"] = _residual_attn(sd, f"{key}.cross_d", f"{key}.norm_d", heads)
        params[f"decoder_{i}"] = layer

        hkey = f"prediction_heads.{i}"
        if f"{hkey}.center_residual_head.net.0.weight" in sd:
            params[f"prediction_head_{i}"], stats[f"prediction_head_{i}"] = _predict_head(
                sd, hkey)

    for ours, theirs in (
        ("contrastive_proj_image", "contrastive_align_projection_image"),
        ("contrastive_proj_text", "contrastive_align_projection_text"),
    ):
        if f"{theirs}.0.weight" in sd:
            params[ours] = {
                "Dense_0": _linear(sd, f"{theirs}.0"),
                "Dense_1": _linear(sd, f"{theirs}.2"),
                "Dense_2": _linear(sd, f"{theirs}.4"),
            }

    return params, stats


def merge_into(module: torch.nn.Module, variables: Dict[str, dict]) -> int:
    """Overlay flax ``{"params", "batch_stats"}`` numpy trees (any subset of the
    module's leaves) onto ``module``'s parameters and buffers, strict=False.

    Returns the number of tensors replaced. A leaf without a counterpart in
    the module raises ``KeyError``, one of another shape ``ValueError``; both
    are checked before anything is written.
    """
    loaded = from_flax(variables)
    target = module.state_dict()
    for key, value in loaded.items():
        if key not in target:
            raise KeyError(f"checkpoint leaf has no port counterpart: {key}")
        if value.shape != target[key].shape:
            raise ValueError(f"shape mismatch at {key}: {tuple(target[key].shape)} vs "
                             f"{tuple(value.shape)}")
    with torch.no_grad():
        for key, value in loaded.items():
            target[key].copy_(value)
    return len(loaded)


def warm_start(model: torch.nn.Module, cfg: ModelConfig, *, data_root: str = None,
               pp_checkpoint: str = None, log: Callable[[str], None] = print) -> None:
    """Load the run's pretrained inputs into ``model`` in place (bdetr.py:63-95):

    1. ``pp_checkpoint`` — the GroupFree PointNet++ backbone, strict=False;
    2. ``{data_root}/roberta-base/{pytorch_model.bin,model.pt}`` — the HF
       RoBERTa weights of the frozen text encoder;
    3. ``{data_root}/class_embeddings3d.npy`` — the frozen butd class-name table
       (``python -m eda_tpu_torch.tools.gen_class_embeddings``), into a butd
       model; a table of another shape is skipped.

    A missing file is skipped with a log line, as the reference's inputs are optional.
    """
    if pp_checkpoint and osp.exists(pp_checkpoint):
        bb_params, bb_stats = convert_backbone(
            torch_state(read_torch_checkpoint(pp_checkpoint)), cfg)
        if bb_params:
            n = merge_into(model, {"params": {"backbone_net": bb_params},
                                   "batch_stats": {"backbone_net": bb_stats}})
            log(f"pp_checkpoint: warm-started {n} backbone leaves from {pp_checkpoint}")
    elif pp_checkpoint:
        log(f"pp_checkpoint not found, skipping: {pp_checkpoint}")

    if not data_root:
        return
    rb_dir = osp.join(data_root, "roberta-base")
    weights = next((osp.join(rb_dir, f) for f in ROBERTA_FILES
                    if osp.exists(osp.join(rb_dir, f))), None)
    if weights is None:
        log(f"text_encoder: no RoBERTa weights under {rb_dir}, skipping")
    else:
        n = load_roberta(model.text_encoder, weights, cfg)
        log(f"text_encoder: loaded {n} RoBERTa leaves from {weights}")

    emb_path = osp.join(data_root, "class_embeddings3d.npy")
    if osp.exists(emb_path) and hasattr(model, "butd_class_embeddings"):
        table = np.load(emb_path, allow_pickle=False)
        have = tuple(model.butd_class_embeddings.weight.shape)
        if table.shape == have:
            merge_into(model, {"params": {"butd_class_embeddings": {"embedding": table}}})
            log(f"butd_class_embeddings: loaded table {table.shape} from {emb_path}")
        else:
            log(f"class_embeddings3d.npy shape {table.shape} != model {have}, skipping")


def load_roberta(encoder: torch.nn.Module, path: str, cfg: ModelConfig) -> int:
    """HF ``roberta-base`` weights (``roberta.`` and DDP prefixes stripped) into a
    ``RobertaEncoder`` of ``cfg``'s geometry; returns the tensors loaded."""
    state = {(k[len("roberta."):] if k.startswith("roberta.") else k): v
             for k, v in torch_state(read_torch_checkpoint(path)).items()}
    return merge_into(encoder, {"params": convert_hf_roberta(state, cfg.text_layers,
                                                             cfg.text_heads)})


def load_eda_pth(path: str, model: torch.nn.Module, cfg: ModelConfig,
                 log: Callable[[str], None] = print) -> int:
    """A released EDA ``.pth`` checkpoint into ``model``; returns the start
    epoch, the checkpoint's ``epoch`` + 1 (0 without one), as the reference
    resumes (``main_utils.py:126-135``)."""
    payload = read_torch_checkpoint(path)
    try:
        start_epoch = int(payload.get("epoch", -1)) + 1
    except (TypeError, ValueError):
        start_epoch = 0
    params, stats = convert_eda_checkpoint(torch_state(payload), cfg)
    n_p = merge_into(model, {"params": params})
    n_s = merge_into(model, {"batch_stats": stats}) if stats else 0
    log(f"loaded EDA .pth: {n_p} param + {n_s} stat leaves from {path}")
    return start_epoch
