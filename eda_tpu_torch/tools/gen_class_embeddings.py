"""Generate the detected-box class-name embedding table (the port's
``eda_tpu/tools/gen_class_embeddings.py``).

Each of the 485 object-class names (``class485_names``, in class-rank order,
so row i lines up with ``det_class_ids`` == i) goes through the frozen text
encoder; the table holds each name's hidden states mean-pooled over its real
tokens, (485, hidden) f32, which the two-stage grounder's
``butd_class_embeddings`` loads (``train/convert.py:warm_start`` reads
``{data_root}/class_embeddings3d.npy``).

The JAX tool reads flax msgpack parameters; this one reads the HF RoBERTa
weights that the training run's warm start reads, ``pytorch_model.bin`` or
``model.pt`` in ``--roberta_dir``, and tokenizes with that directory's
byte-level BPE (``make_tokenizer``). Without a weights file the encoder is
random (seed 0), as the JAX tool's is without parameters. It runs on CUDA
unless ``--cpu`` is given, and raises without a card.

    python -m eda_tpu_torch.tools.gen_class_embeddings \\
        --roberta_dir data/roberta-base --out data/class_embeddings3d.npy [--cpu]
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Optional, Sequence

import numpy as np
import torch

from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.data.class_config import class485_names
from eda_tpu_torch.data.tokenizer import make_tokenizer
from eda_tpu_torch.entry import resolve_device
from eda_tpu_torch.models.grounder import init_weights
from eda_tpu_torch.models.roberta import RobertaEncoder
from eda_tpu_torch.train.convert import ROBERTA_FILES, load_roberta

NAME_TOKENS = 16


def generate(weights: Optional[str] = None, class_names: Optional[Sequence[str]] = None,
             tokenizer_dir: Optional[str] = None, cfg: Optional[ModelConfig] = None,
             device: Optional[str] = None) -> np.ndarray:
    """The (len(class_names), hidden) table of the class names (default: the
    485-class vocabulary) through the text encoder of ``cfg``'s geometry
    (default: roberta-base's) with the HF weights file ``weights`` (random from
    seed 0 without one), on ``device`` (default: CUDA)."""
    dev = resolve_device(device)
    cfg = cfg or ModelConfig()
    class_names = list(class_names or class485_names())
    tokenizer = make_tokenizer(tokenizer_dir, cfg.text_vocab_size)
    encoder = RobertaEncoder(cfg.text_vocab_size, cfg.text_hidden, cfg.text_layers,
                             cfg.text_heads, cfg.text_intermediate)
    if weights:
        load_roberta(encoder, weights, cfg)
    else:
        init_weights(encoder, 0)
    encoder = encoder.to(dev).eval()
    batch = tokenizer.encode_batch(class_names, max_len=NAME_TOKENS)
    with torch.inference_mode():
        hidden = encoder(torch.from_numpy(batch.input_ids).to(dev),
                         torch.from_numpy(batch.attention_mask).to(dev)).cpu().numpy()
    # masked mean over each name's real tokens (the reference mean-pools the
    # last hidden state per class name)
    m = np.asarray(batch.attention_mask)[..., None]
    pooled = (hidden * m).sum(1) / np.maximum(m.sum(1), 1)
    return pooled.astype(np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("the butd class-name embedding table")
    p.add_argument("--out", default="class_embeddings3d.npy")
    p.add_argument("--roberta_dir", default="data/roberta-base",
                   help="HF roberta-base directory: vocab.json + merges.txt and "
                        "pytorch_model.bin or model.pt")
    p.add_argument("--cpu", action="store_true", help="encode on the CPU (default: CUDA)")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    weights = next((osp.join(args.roberta_dir, f) for f in ROBERTA_FILES
                    if osp.exists(osp.join(args.roberta_dir, f))), None)
    if weights is None:
        print(f"no RoBERTa weights under {args.roberta_dir}: a random encoder (seed 0)")
    table = generate(weights, tokenizer_dir=args.roberta_dir if osp.isdir(args.roberta_dir)
                     else None, device=device)
    np.save(args.out, table)
    print(f"saved {table.shape} -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
