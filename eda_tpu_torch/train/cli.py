"""Training and evaluation entry point of the port: ``python -m eda_tpu_torch.train``.

The twin of the root ``train.py``: the same flags, defaults, aliases and
refusals, the same run directory (``config.json``, ``log.txt``,
``metrics.jsonl`` with the ``train`` and ``val`` groups, ``tb/``, ``ckpt/``),
the same epoch permutation and index chunks, checkpoint auto-resume from
``--log_dir/ckpt`` and the one-deep pipelined evaluation of the whole split.

    python -m eda_tpu_torch.train --dataset synthetic --debug --max_steps 3 \\
        --log_dir logs/smoke            # on the card
    python -m eda_tpu_torch.train ... --cpu   # on the CPU

Differences from ``train.py``, by design:

* it runs on CUDA unless ``--cpu`` is given, and raises without CUDA;
* one device, so the global batch is ``--batch_size``;
* checkpoints are the port's (``train/checkpoint.py``); orbax directories are
  not read;
* ``--profile N`` writes a ``torch.profiler`` trace to ``LOG_DIR/profile``;
* the model takes its per-point feature width from the first batch, as the
  flax model infers it at init (synthetic scenes always carry RGB);
* what the port does not have yet is refused with the ROADMAP item that
  brings it: ScanNet detection evaluation, the detected-box stream, the
  gather SA, the GroupFree backbone and ``.pth`` weights (Queue 1 item 4),
  several hosts (item 6).

Real data (``--dataset scanrefer|sr3d|sr3d+|nr3d``, ``--joint_det``) reads
the scan store that ``python -m eda_tpu_torch.tools.pack_scans`` writes under
``--data_root`` with the annotations beside it; ``{data_root}/roberta-base``
gives the byte-level BPE vocabulary and, where it holds ``pytorch_model.bin``
or ``model.pt``, the text encoder's weights (``train/convert.py``).
``--use_multiview`` needs ``h5py``; nothing else needs a package beyond
PyTorch and numpy.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from eda_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from eda_tpu_torch.data.dataset import GroundingDataset
from eda_tpu_torch.data.detection_prompt import DetectionPromptDataset, MixedDataset
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.entry import resolve_device, to_device
from eda_tpu_torch.eval.grounding import GroundingEvaluator
from eda_tpu_torch.losses.criterion import SetCriterionConfig
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.train.checkpoint import CheckpointManager
from eda_tpu_torch.train.convert import warm_start
from eda_tpu_torch.train.optim import AdamW
from eda_tpu_torch.train.step import TrainState, make_eval_score_step, make_train_step
from eda_tpu_torch.utils.logger import setup_logger
from eda_tpu_torch.utils.metrics import MetricWriter


def parse_args(argv=None):
    p = argparse.ArgumentParser("EDA-TPU trainer (PyTorch port)")
    # data
    p.add_argument("--data_root", default="data/")
    p.add_argument("--dataset", nargs="+", default=["synthetic"],
                   help="scanrefer sr3d sr3d+ nr3d scannet synthetic")
    p.add_argument("--test_dataset", default=None)
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--num_points", type=int, default=50000)
    p.add_argument("--use_color", action="store_true")
    p.add_argument("--use_height", action="store_true")
    p.add_argument("--use_multiview", action="store_true")
    p.add_argument("--no_augment", dest="augment", action="store_false")
    p.add_argument("--augment_det", action="store_true")
    p.add_argument("--detect_intermediate", action="store_true")
    p.add_argument("--joint_det", action="store_true")
    p.add_argument("--butd", action="store_true")
    p.add_argument("--butd_gt", action="store_true")
    p.add_argument("--butd_cls", action="store_true")
    # model
    p.add_argument("--num_queries", "--num_target", dest="num_queries", type=int, default=256,
                   help="query count (the reference calls this --num_target)")
    p.add_argument("--num_encoder_layers", type=int, default=3)
    p.add_argument("--sampling", default="kps",
                   help="query sampling (only 'kps' exists, like the reference default)")
    p.add_argument("--num_decoder_layers", type=int, default=6)
    p.add_argument("--self_position_embedding", default="loc_learned")
    p.add_argument("--self_attend", action="store_true", default=True)
    p.add_argument("--use_contrastive_align", action="store_true", default=True)
    p.add_argument("--use_soft_token_loss", action="store_true", default=True)
    p.add_argument("--sa_impl", default="fused", choices=["fused", "gather"])
    p.add_argument("--use_bf16", action="store_true", default=True)
    p.add_argument("--pp_checkpoint", default=None)
    # loss
    p.add_argument("--query_points_obj_topk", type=int, default=4)
    # optimization
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lr_backbone", type=float, default=2e-3)
    p.add_argument("--text_encoder_lr", type=float, default=2e-5)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--max_epoch", type=int, default=100)
    p.add_argument("--lr_decay_epochs", type=int, nargs="+", default=[50, 75])
    p.add_argument("--lr_decay_rate", type=float, default=0.1)
    p.add_argument("--lr-scheduler", dest="lr_scheduler", default="multistep")
    p.add_argument("--warmup-epoch", dest="warmup_epoch", type=int, default=-1)
    p.add_argument("--warmup-multiplier", dest="warmup_multiplier", type=int, default=100)
    p.add_argument("--clip_norm", type=float, default=0.1)
    p.add_argument("--optimizer", default="adamW",
                   help="only adamW is implemented (the reference default)")
    p.add_argument("--bn_momentum", type=float, default=0.1,
                   help="accepted for compatibility; only the reference default 0.1 is "
                        "implemented (a fixed constant)")
    p.add_argument("--syncbn", action="store_true",
                   help="accepted for compatibility; one device, so BN statistics are the "
                        "batch's")
    p.add_argument("--start_epoch", type=int, default=1,
                   help="accepted for compatibility; auto-resume restores the epoch from the "
                        "checkpoint")
    # io
    p.add_argument("--log_dir", default="logs/eda_tpu")
    p.add_argument("--checkpoint_path", default=None,
                   help="a checkpoint directory of this port to restore from")
    p.add_argument("--save_freq", type=int, default=5)
    p.add_argument("--val_freq", type=int, default=5)
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--ap_iou_thresholds", type=float, nargs="+", default=[0.25, 0.5])
    # run mode
    p.add_argument("--eval", action="store_true")
    p.add_argument("--eval_train", action="store_true",
                   help="evaluate on the train split (implies --eval, main_utils.py:115,122)")
    p.add_argument("--reduce_lr", action="store_true",
                   help="resume params but not optimizer state, restarting the LR schedule "
                        "(main_utils.py:117,136)")
    p.add_argument("--num_workers", type=int, default=4,
                   help="host batch-assembly threads (reference DataLoader workers)")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=None, help="cap steps (smoke runs)")
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--profile", type=int, default=0,
                   help="trace N train steps with torch.profiler into LOG_DIR/profile")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: CUDA)")
    p.add_argument("--wo_obj_name", default=None,
                   help="alternative ScanRefer annotations without object names (eval variant)")
    args = p.parse_args(argv)
    args.eval = args.eval or args.eval_train  # main_utils.py:122
    if args.sampling != "kps":
        p.error(f"--sampling {args.sampling}: only 'kps' is implemented")
    if args.optimizer.lower() != "adamw":
        p.error(f"--optimizer {args.optimizer}: only adamW is implemented")
    if args.bn_momentum != 0.1:
        p.error("--bn_momentum: only the reference default 0.1 is implemented")
    for refused, why in refusals(args):
        p.error(f"{refused}: {why}")
    return args


def refusals(args):
    """(flag, reason) for every requested feature this port does not have yet."""
    out = []
    if args.test_dataset == "scannet":
        out.append(("--test_dataset scannet", "ScanNet detection evaluation is not ported "
                    "(ROADMAP Queue 1 item 4)"))
    for flag in ("butd", "butd_gt", "butd_cls"):
        if getattr(args, flag):
            out.append((f"--{flag}", "the detected-box stream is not ported "
                        "(ROADMAP Queue 1 item 4)"))
    if args.sa_impl != "fused":
        out.append((f"--sa_impl {args.sa_impl}", "the gather SA is not ported "
                    "(ROADMAP Queue 1 item 4)"))
    if args.pp_checkpoint:
        out.append(("--pp_checkpoint", "the GroupFree backbone converter is not ported "
                    "(ROADMAP Queue 1 item 4)"))
    if args.checkpoint_path and args.checkpoint_path.endswith((".pth", ".pt")):
        out.append((f"--checkpoint_path {args.checkpoint_path}",
                    "released .pth checkpoints need the converters (ROADMAP Queue 1 item 4); "
                    "pass a checkpoint directory of this port"))
    return out


def build_configs(args):
    model = ModelConfig(
        num_queries=args.num_queries,
        num_decoder_layers=args.num_decoder_layers,
        num_encoder_layers=args.num_encoder_layers,
        self_position_embedding=args.self_position_embedding,
        self_attend=args.self_attend,
        contrastive_align=args.use_contrastive_align,
        butd=args.butd,
        num_points=args.num_points,
        sa_impl=args.sa_impl,
        use_bf16=args.use_bf16,
        # per-point channels beyond xyz: RGB + height + 128-d multiview
        # (reference num_input_channel, train_dist_mod.py:92-96)
        input_feature_dim=(3 * int(args.use_color) + int(args.use_height)
                           + 128 * int(args.use_multiview)),
    )
    if args.debug and args.dataset == ["synthetic"]:
        model = model.tiny()
    train = TrainConfig(
        batch_size=args.batch_size,
        lr=args.lr,
        lr_backbone=args.lr_backbone,
        text_lr=args.text_encoder_lr,
        weight_decay=args.weight_decay,
        max_epoch=args.max_epoch,
        lr_decay_epochs=tuple(args.lr_decay_epochs),
        lr_decay_rate=args.lr_decay_rate,
        lr_scheduler=args.lr_scheduler,
        warmup_epoch=args.warmup_epoch,
        warmup_multiplier=args.warmup_multiplier,
        clip_norm=args.clip_norm,
        save_freq=args.save_freq,
        val_freq=args.val_freq,
        seed=args.seed,
        checkpoint_dir=args.log_dir,
    )
    data = DataConfig(
        datasets=tuple(args.dataset),
        test_dataset=args.test_dataset or args.dataset[0],
        data_root=args.data_root,
        use_color=args.use_color,
        use_height=args.use_height,
        use_multiview=args.use_multiview,
        augment=args.augment,
        augment_det=args.augment_det,
        detect_intermediate=args.detect_intermediate,
        joint_det=args.joint_det,
        butd=args.butd,
        butd_gt=args.butd_gt,
        butd_cls=args.butd_cls,
        debug=args.debug,
    )
    return model, train, data


def batch_of(source, indices) -> dict:
    """The numpy batch of ``indices``: ``{"inputs", "targets"}`` from the
    synthetic generator, ``{"inputs", "targets", "hardness"}`` from a dataset
    (the detected-box stream is not ported, so ``butd=False``)."""
    if isinstance(source, SyntheticScenes):
        return source.train_batch(indices)
    return source.batch(indices, butd=False)


def prefetch_batches(gen, index_chunks, num_workers):
    """Assemble the batches of ``index_chunks`` (``batch_of``) on
    ``num_workers`` background threads with a bounded queue (the reference's
    DataLoader workers); in order."""
    if num_workers <= 0:
        for idx in index_chunks:
            yield batch_of(gen, idx)
        return
    with ThreadPoolExecutor(num_workers) as pool:
        pending = collections.deque()
        it = iter(index_chunks)
        for _ in range(num_workers * 2):
            try:
                pending.append(pool.submit(batch_of, gen, next(it)))
            except StopIteration:
                break
        while pending:
            batch = pending.popleft().result()
            try:
                pending.append(pool.submit(batch_of, gen, next(it)))
            except StopIteration:
                pass
            yield batch


def make_loader(args, model_cfg: ModelConfig, split: str, for_eval: bool = False):
    """(source, number of examples) of a split (``train.py:make_loader``).

    Synthetic scenes: seed 0 for the train split and 1 for the others, 128
    scenes with ``--debug``, else 4096. Real data: ``GroundingDataset.from_args``,
    with ScanNet detection prompts mixed in at 10x under ``--joint_det`` on the
    train split unless ``for_eval`` (an evaluation never mixes).
    """
    if args.dataset == ["synthetic"]:
        gen = SyntheticScenes(
            SyntheticConfig(num_points=model_cfg.num_points, num_objects=8, text_len=64,
                            max_objects=model_cfg.max_detected_boxes,
                            seed=0 if split == "train" else 1),
            vocab_size=model_cfg.text_vocab_size,
        )
        return gen, 128 if args.debug else 4096
    ds = GroundingDataset.from_args(args, split)
    if args.joint_det and split == "train" and not for_eval:
        det = DetectionPromptDataset(
            ds.scans, split=split, use_color=args.use_color, augment=args.augment,
            tokenizer=ds.tokenizer, use_height=args.use_height,
            multiview_path=ds.multiview_path, detected_dir=ds.detected_dir,
            augment_det=args.augment_det, butd_gt=args.butd_gt, butd_cls=args.butd_cls,
        )
        ds = MixedDataset([ds, det], multipliers=[1, 10])
    return ds, len(ds)


def epoch_chunks(order_rng: np.random.Generator, n_train: int, steps_per_epoch: int,
                 global_batch: int):
    """One epoch's index chunks: a permutation of the split from ``order_rng``,
    cut into ``steps_per_epoch`` batches, wrapping around at its end."""
    order = order_rng.permutation(n_train)
    chunks = []
    for it in range(steps_per_epoch):
        idx = order[(it * global_batch) % n_train:][:global_batch]
        if len(idx) < global_batch:
            idx = np.concatenate([idx, order[: global_batch - len(idx)]])
        chunks.append(idx)
    return chunks


TRAIN_SCALARS = ("loss", "loss_ce", "loss_bbox", "loss_giou", "loss_sem_align",
                 "query_points_generation_loss", "grad_norm")


def main(argv=None) -> int:
    args = parse_args(argv)
    if os.environ.get("EDA_TPU_MULTIHOST"):
        raise SystemExit("EDA_TPU_MULTIHOST: several hosts are not ported "
                         "(ROADMAP Queue 1 item 6)")
    device = resolve_device("cpu" if args.cpu else None)
    model_cfg, train_cfg, _ = build_configs(args)
    os.makedirs(args.log_dir, exist_ok=True)
    logger = setup_logger(args.log_dir)
    logger.info("device: %s%s", device,
                f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
    with open(os.path.join(args.log_dir, "config.json"), "w") as f:
        json.dump(dict(vars(args)), f, indent=2, default=str)

    # eval-only builds the evaluated split alone (main_utils.py:226-227)
    split = ("train" if args.eval_train else "val") if args.eval else "train"
    gen, n_train = make_loader(args, model_cfg, split, for_eval=args.eval)
    global_batch = args.batch_size
    steps_per_epoch = args.steps_per_epoch or max(n_train // global_batch, 1)
    sample = batch_of(gen, [0])["inputs"]["point_clouds"]
    model_cfg = dataclasses.replace(model_cfg, input_feature_dim=sample.shape[-1] - 3)
    model = EDAGrounder(model_cfg)
    model.init_weights(train_cfg.seed)
    warm_start(model, model_cfg, data_root=args.data_root, log=logger.info)
    model = model.to(device)
    logger.info("params: %.1fM", sum(p.numel() for p in model.parameters()) / 1e6)

    crit = SetCriterionConfig(
        num_decoder_layers=model_cfg.num_decoder_layers,
        query_points_obj_topk=args.query_points_obj_topk,
        dataset=args.dataset[0] if args.dataset[0] != "synthetic" else "scanrefer",
        use_contrastive_align=model_cfg.contrastive_align,
    )
    state = TrainState(model, AdamW(model, train_cfg, steps_per_epoch))
    ckpt = CheckpointManager(os.path.join(args.log_dir, "ckpt"), save_freq=args.save_freq)
    restore_opt = not (args.eval or args.reduce_lr)  # main_utils.py:136
    source = (CheckpointManager(args.checkpoint_path, save_freq=args.save_freq)
              if args.checkpoint_path else ckpt)
    state, start_epoch = source.restore(state, restore_optimizer=restore_opt)
    if start_epoch:
        logger.info("resumed from epoch %d", start_epoch)

    writer = MetricWriter(args.log_dir)
    try:
        if args.eval:
            # eval-only: the whole split, then exit (main_utils.py:356-362)
            logger.info("Testing evaluation (eval-only mode)...")
            evaluate(args, model, model_cfg, logger, writer=writer, step=state.step,
                     loader=(gen, n_train))
            return 0
        return train(args, state, make_train_step(crit, seed=train_cfg.seed), gen, n_train,
                     steps_per_epoch, start_epoch, ckpt, model_cfg, logger, writer, device)
    finally:
        writer.close()


def train(args, state, step_fn, gen, n_train, steps_per_epoch, start_epoch, ckpt, model_cfg,
          logger, writer, device) -> int:
    """The epoch loop of ``train.py:main`` (``:385-466``)."""
    # the reference's DistributedSampler.set_epoch contract: the epoch's
    # permutation comes from the seed (main_utils.py:229-242,368)
    order_rng = np.random.default_rng(args.seed)
    profile_left = args.profile
    prof = None
    if profile_left:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=activities)
        prof.start()

    total_steps = 0
    val_loader = None
    for epoch in range(start_epoch, args.max_epoch):
        t_ep = time.time()
        chunks = epoch_chunks(order_rng, n_train, steps_per_epoch, args.batch_size)
        losses = []
        for it, batch_np in enumerate(prefetch_batches(gen, chunks, args.num_workers)):
            batch_np.pop("hardness", None)  # the evaluator's, not the step's
            metrics = step_fn(state, to_device(batch_np, device))
            total_steps += 1
            if profile_left:
                float(metrics["loss"])  # waits for the step
                profile_left -= 1
                if profile_left == 0:
                    prof.stop()
                    out_dir = os.path.join(args.log_dir, "profile")
                    os.makedirs(out_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
                    logger.info("profile trace written to %s", out_dir)
            if it % args.print_freq == 0:
                scalars = {k: float(metrics[k]) for k in TRAIN_SCALARS if k in metrics}
                losses.append(scalars["loss"])
                logger.info(
                    "epoch %d step %d/%d loss %.4f (kps %.3f ce %.3f bbox %.3f giou %.3f "
                    "sem %.3f)", epoch, it, steps_per_epoch, scalars["loss"],
                    scalars["query_points_generation_loss"], scalars["loss_ce"],
                    scalars["loss_bbox"], scalars["loss_giou"], scalars["loss_sem_align"])
                # train_loss scalar group (record_tensorboard.py:33-52)
                writer.write(total_steps, scalars, group="train")
            if args.max_steps and total_steps >= args.max_steps:
                logger.info("max_steps reached")
                ckpt.save(epoch, state, force=True)
                return 0
        logger.info("epoch %d done in %.1fs (mean loss %.4f)", epoch, time.time() - t_ep,
                    np.mean(losses) if losses else float("nan"))
        ckpt.save(epoch, state)
        if (epoch + 1) % args.val_freq == 0 or epoch == args.max_epoch - 1:
            if val_loader is None:
                val_loader = make_loader(args, model_cfg, "val", for_eval=True)
            evaluate(args, state.model, model_cfg, logger, writer=writer, step=total_steps,
                     loader=val_loader)

    ckpt.save(args.max_epoch - 1, state, force=True)
    return 0


def tail_chunks(n: int, bsz: int):
    """Fixed-size index chunks covering [0, n) with a padded and masked tail.

    Returns a list of (idx (bsz,), valid (bsz,) bool); padding rows reuse
    index 0 and are masked False, so no split silently drops its tail.
    """
    chunks = []
    for start in range(0, n, bsz):
        idx = np.arange(start, min(start + bsz, n))
        valid = np.ones(bsz, bool)
        if len(idx) < bsz:
            valid[len(idx):] = False
            idx = np.concatenate([idx, np.zeros(bsz - len(idx), np.int64)])
        chunks.append((idx, valid))
    return chunks


def evaluate(args, model, model_cfg, logger, writer=None, step=0, loader=None):
    """Grounding evaluation of the whole split (``train.py:evaluate``).

    ``loader``: the split's (source, size) from ``make_loader`` (built here
    when None). The tail batch is padded to the batch size and its padding
    rows are masked out of the counters; a dataset's hardness flags feed the
    per-split counts. One-deep pipeline: batch i + 1 is scored before batch
    i's IoU stack is pulled to the host, so the pull overlaps the next batch's
    work on the card. Returns the evaluator.
    """
    device = next(model.parameters()).device
    gen, n_val = loader or make_loader(args, model_cfg, "train" if args.eval_train else "val",
                                       for_eval=True)
    evaluator = GroundingEvaluator(prefixes=("last_", "proposal_"))
    score_fn = make_eval_score_step(model, prefixes=evaluator.prefixes, modes=evaluator.modes)
    pairs = tail_chunks(n_val, max(args.batch_size, 1))
    t0 = time.perf_counter()
    pending = None
    for batch_np, (_, valid) in zip(
            prefetch_batches(gen, [idx for idx, _ in pairs], args.num_workers), pairs):
        hardness = batch_np.pop("hardness", None)
        ious = score_fn(to_device(batch_np, device))
        if pending is not None:
            p_ious, p_hard, p_valid = pending
            evaluator.evaluate(None, None, p_hard, valid=p_valid, ious=p_ious)
        pending = (ious, hardness, valid)
    if pending is not None:
        p_ious, p_hard, p_valid = pending
        evaluator.evaluate(None, None, p_hard, valid=p_valid, ious=p_ious)
    seconds = time.perf_counter() - t0
    logger.info("scored %d scenes in %.2f s (%.2f scenes/s, scene generation included)",
                n_val, seconds, n_val / seconds)
    logger.info("\n%s", evaluator.print_stats())
    if writer is not None:
        writer.write(step, {
            f"{prefix}Acc{t}Top{k}_{mode}": evaluator.accuracy(prefix, t, k, mode)
            for prefix in ("last_",) for t in (0.25, 0.5) for k in (1, 5, 10)
            for mode in ("bbs", "bbf")
        }, group="val")
    return evaluator
