"""Smoke run of the PyTorch port on one NVIDIA GPU: serving, training and evaluation.

Usage: ``python3 chip_smoke.py`` from the repository root (needs one CUDA card).

1. Prints the card's name and power limit and the torch / CUDA versions.
2. Builds every CUDA kernel from ``eda_tpu_torch/csrc`` (one nvcc per source,
   all started at once) and prints the build time. The pair pool's kernels,
   its backward's, both bf16 prep kernels' and the f32 prep's tensor-core
   kernels must spill no register and, where the toolkit has ``cuobjdump``,
   every GEMM kernel of the seven libraries must hold HGMMA (``wgmma``)
   instructions; the counts are printed (the wide pool kernels, the compact
   pool backward at (128, 128, 256), the prep backward's cluster kernel and
   the kernels above (256, 256, 512) / c1 256 among them); the two libraries
   whose products are ``csrc/mma_gemm.cuh``'s ``mma.sync`` tiles (the pool
   backward at (512, 512, 1024), the prep backward at c1 512) likewise spill
   nothing and hold HMMA in every GEMM kernel (``check_mma_build``).
   Then the pool tie check: all six pool variants (``pair``, ``mxu``,
   ``pre``, each with and without winners) on a full-width SA2 input with
   W3 = 0 and distinct b3, where every in-radius pair of a center gives b3
   exactly, so the tie rule alone sets the winners; with blocks whose centers
   have no point in radius and windows clamped at N - W. Values and winners
   must equal the plain version's and the rule's at every (center, channel),
   with -1e9 and rank 0 exactly at the centers out of reach. The same at two
   windows wider than the kernel holds in shared memory at once (SA2 at 512,
   SA1 at 2048 points), and on each input with a random W3 every variant
   within 0.03 of the plain version; prints the pair pool's time there.
   Then the pool backward edge check: K5 and K6 against their plain version
   on ``bwd_edge_inputs`` (a center whose channels one point wins all, one
   whose channels c3 points win, blocks with no live row, compact winners
   outside the window, windows clamped at N - W) at SA2's widths with W =
   256 and 512, SA1's with W = 2048, the tiny SA1 triple and the width-4
   backbone's SA1 shape ((256, 256, 512), W = 1024 over 50 000 points, once
   with winners tied on a window's first 4 points: the compact rows on
   ``csrc/sa_pair_pool_bwd_wide_compact.cu``), both variants at each,
   within the training step's tolerances, bit for bit on a second launch.
   Then the FPS edge check: K1 bit-exact against its plain version, at the
   cluster size it picks and at 1, 2, 4 and 8 CTAs a row, on
   ``fps_edge_inputs`` (duplicated points and equal-distance ties,
   zero-padded tails and an all-padding row, 20 000 points for the scratch
   variant, N = 1001 and 8191). And the prep backward edge check: K7 within
   2% of each output's largest value on ``prep_bwd_edge_inputs`` (row counts
   that are no multiple of 64, the tiny widths, zero dA, large-magnitude
   points, the width-2 backbone's SA1 over more tiles than CTAs and its
   SA2 / SA3 widths on the cluster kernel, SA2's over more tiles than
   clusters, an odd c1 above 64 at K = 16), every output bit-identical on a
   second launch.
   Then the pool widths check: the six pool variants and K5 / K6 at three
   triples outside the instantiated widths ((48, 48, 96) on an SA1-shaped
   input at W = 1024, (96, 80, 200) and (192, 160, 384) on SA2-shaped ones at
   W = 256), which the wrappers run zero-padded, and at the wide triple
   (256, 256, 512) itself at W = 1024 (the compact backward at c3 512),
   against the plain versions at the real widths under the tolerances above;
   (384, 384, 768), (300, 300, 600) and (288, 256, 512), padded on the
   forward-only (512, 512, 1024), under the three radius tests, their winners
   pool and backward raising the named error before any launch; triples above
   (512, 512, 1024) must raise. The prep edge check: K2 within
   0.02 plus one bf16 step of its plain version on ``prep_edge_inputs`` (row
   counts no multiple of 64, c1 of 16 to 256 at in_dim 3 and at the kernel's
   largest, 2048, where W1 streams, large points). The mask
   edge check: K9a bit-exact on ``mask_edge_inputs`` (windows no multiple of
   a CTA's rows, starts below 0 and past N - W, unaligned windows, a single
   block, points within 1e-5 of the radius).
3. Checks a small grounder (``ModelConfig(use_bf16=True).tiny()``) on the card
   against the same weights and inputs on the CPU, where every kernel wrapper
   runs its plain PyTorch version: the serving forward, then one training step
   with dropout off (loss, metrics, gradients, new parameters); then scores the
   tiny model's card end points on the card and on the CPU: the IoU stacks
   agree to 1e-6 except at ranks whose scores lie within 1e-5 of a
   neighbour's (those are excused and counted).
4. Serving. Records the serving kernels' inputs (K1 FPS, K2 prep, K3 pair
   pool) in one full-width forward (``ModelConfig(use_bf16=True)``, batch 8,
   50 000-point scenes, random weights from a seed) and holds each kernel call
   against its plain version on those inputs: FPS bit-exact, the bf16 prep
   within 0.02 (plus one bf16 step of the value), the pair pool within 0.03
   with identical -1e9 rows; times both with CUDA events, per SA layer, and
   prints per pool layer the TFLOP/s over the dense window work and the share
   of (center, 64-point) tiles with no pair in radius, which the kernel
   skips; runs each FPS call at 1, 2, 4 and 8 CTAs a row (bit-exact) and
   prints its ms and microseconds per serial step. Then
   serves five batches of 8 scenes with every launch counter set to 0 first:
   each batch must advance K1, K2 and K3 by 4 (one launch per SA layer) and
   no training kernel, and give a finite (8, 256, 3) ``last_center``. Prints ms
   per batch and scenes/s, the forward's cost with the attention the port had
   before (``scaled_dot_product_attention``) against the one that rounds where
   flax rounds, the stage times and the busiest device operations.
5. Training. Records the training kernels' inputs (K4 pair pool with winners,
   K5 compact and K6 windowed pair-pool backward, K7 prep backward) in one
   full-width training step at batch 8 and holds each against its plain
   version; times both per SA layer. K5, K6 and K7 must give every output
   (dA and dpts included) bit for bit again on a second launch; per
   backward layer the live pair rows, the TFLOP/s over the live-row work and
   the peak memory of one call are printed. Then runs five training steps from fresh
   counters: each must give a finite loss and ``grad_norm``, change the
   parameters, and advance K1, K2, K4 and K7 by 4, K5 by 1, K6 by 3 and K3 by
   0. Prints ms per step and scenes/s, the stage times of one step (forward,
   loss, backward, optimizer), the matcher's host syncs and the busiest device
   operations of one step, and runs two steps from one state, which must agree
   bit for bit.
6. Radius-test modes. For ``mxu`` (K8) and ``pre`` (K9a mask, K9b pool), with
   ``EDA_SA_D2`` set in the process, records the mode's kernel calls in one
   full-width serving forward and one training step at batch 8 (each with its
   launch counts checked) and holds each call against its plain version: the
   mask bit-exact, pooled values within 0.03 with identical -1e9 rows,
   winners as K4's. On the same inputs it runs the ``pair`` kernel and counts
   the (center, channel) entries that differ from it by more than 0.03; every
   center with one must have a window point within 1e-5 of the radius
   (``eda_tpu/ops/pallas/sa_kernel.py:75-80``).
7. Evaluation under ``pair``, ``mxu`` and ``pre``: ``entry.build_evaluator``
   at batch 8 (size heads moved as in the tiny check, so that boxes overlap
   the GT boxes) scores five batches of full-width scenes under each mode,
   the modes taking turns on each batch; each IoU stack goes to the mode's
   evaluator as ``bench.py`` does. Each batch must launch the mode's kernels
   four times and no other pool or training kernel, and give a finite
   (2, 2, 8, 10) IoU stack in [0, 1]. A scene whose ``mxu`` or ``pre`` end
   points equal its ``pair`` end points bit for bit must score pair's IoU
   stack; any other scene must differ from pair's from an SA layer's output on
   (both counted). Prints ms per batch and scenes/s per mode and one line of
   ``print_stats()``.
8. The training CLI (``python -m eda_tpu_torch.train``) on the card: tiny
   synthetic scenes, batch 8, ``--max_steps 3``, then ``--eval`` from its
   checkpoint over the whole val split. The run directory must hold
   ``config.json``, ``log.txt``, ``metrics.jsonl`` and the forced
   checkpoint, the three ``train`` records and the ``val`` record finite (the
   accuracies in [0, 1]). A tiny training state saved after two steps and
   restored on the card into a model of other weights must be bit-identical
   to the one saved; one more step from each must give every metric, state
   tensor and AdamW moment bit for bit (every sum of the backward has a
   fixed order), and so must two steps from one tiny f32 state; then
   ``GATHER_CLI_STEPS`` tiny ``--sa_impl gather`` steps with finite losses.
   The "training" phase checks the same at full width in bf16.
9. Real-format data through the CLI at the flagship's width, fabricated by
   ``tests/real_data_fixtures.py`` from a seed: 8 train and 4 val scenes in
   the ScanNet layout (60 000 vertices each, so the 50 000-point downsample
   draws without replacement), ScanRefer-format annotations (32 a scene), a
   byte-level BPE ``vocab.json`` + ``merges.txt`` whose merges build the
   fixture's words, and a ``roberta-base/pytorch_model.bin`` in HF names (12
   layers, width 768, 50 265 tokens) from a seeded ``RobertaEncoder``; packs
   the scenes with ``eda_tpu_torch.tools.pack_scans`` in one process; trains
   16 steps at batch 8 on ``--dataset scanrefer --use_color`` and 16 on
   ``--dataset synthetic`` with the same flags, scores the 128 val
   annotations with ``--eval`` from the first run's checkpoint, and trains 2
   steps under ``--joint_det``. Each real-data run's
   log must report every text-encoder tensor loaded, its text encoder before
   step 1 must be the seeded one bit for bit, every batch must carry
   256-token texts and a positive map with mass in each target row, every
   loss and ``grad_norm`` must be finite, each step must advance K1, K2, K4
   and K7 by 4, K5 by 1, K6 by 3 and K3 by 0, and each eval batch K1-K3 by
   4; the eval's accuracies must lie in [0, 1]. Prints the packing time, the
   host ms per ``GroundingDataset.example`` against the synthetic
   generator's per scene, both CLI runs' steps/s between their first and
   last ``metrics.jsonl`` rows (steps 1 and 16; the input pipeline's waits
   included), the eval's scenes/s and the accuracy split by hardness.
10. The two-stage grounder (phase "butd", ``ModelConfig(use_bf16=True,
   butd=True)``: 132 detected-box slots, 128-wide box embeddings, the
   485 x 768 frozen class table, a ``cross_d`` block in every encoder and
   decoder layer). The tiny butd model on the card against its CPU twin:
   the forward, one training step (dropout off; ``grad_norm`` within 20% and
   the leaves that the CPU step itself cannot reproduce on inputs moved by
   1e-6 held by the global cosine only, as
   ``tests/test_torch_butd_train_step.py``; the class table's moments zero)
   and the ``--butd_cls`` IoU stack. Five full-width serving batches of 8
   from zeroed counters, each launching K1-K3 four times and nothing else,
   with a finite (8, 256, 3) ``last_center``; three full-width training
   steps, each with a finite loss and ``grad_norm`` and the single-stage
   step's launches, the class table after the first equal to p (1 - lr wd)
   within one f32 ulp with no gradient; each against the single-stage
   forward or step in the same process (one call each in turns A B B A; the
   device busy time of one profiled butd call beside the single-stage one
   profiled in the "serving" or "training" phase). Then the CLI on the "real data" phase's tree
   with GroupFree-format detections for both splits: 6 ``--butd --butd_cls``
   steps (steps/s from ``metrics.jsonl``), the grounding eval with the
   filter from their checkpoint and the ScanNet detection eval
   (``--test_dataset scannet --butd``; mAP@0.25 and @0.5 finite in [0, 1]),
   each batch launching K1-K3 four times.
11. The f32 model (phase "f32", ``ModelConfig()``, ``use_bf16=False``): K2f
   and K7f (``csrc/sa_prep_f32.cu``) against their plain versions on
   ``prep_f32_edge_inputs`` (each flagship layer's (in_dim, c1) at ragged
   row counts and at 63, 64, 65 and 129 rows, the tiny widths over several
   tiles and within one, widths that are no multiple of 4 or 8, large
   points; K2f per element within ``prep_f32_tolerance``, K7f within 1e-4
   of each output's largest value, bit-identical on a second launch, dA read
   unrounded; the cases of the tensor route above c1 128 run in "w2x f32")
   and at the largest in_dim each takes at c1 128 (at least the previous
   kernels' 358 / 333; one more raises, as does c1 257); the tiny f32
   model, step and scoring against their CPU twins; at full width K2f and
   K7f against their plain versions on a forward's and a step's inputs,
   ``REQUESTS`` serving batches (K1, K2f, K3 four launches each) and
   ``F32_STEPS`` training steps (K1, K2f, K4, K7f four, K5 one, K6 three),
   one profiled forward and step, and two steps from one state bit for bit.
11a. The width-2 backbone (phase "w2x", ``w2x_configs``: the bf16 flagship
   with Group-Free-3D's ``width=2`` SA and FP widths, SA2-4 at (256, 256,
   512), SA3-4's prep at in_dim 515): the wide pool (a cluster of four CTAs
   a block) on tie inputs (``W2X_TIE_CASES``: SA2's shape at W = 256 and
   1024, a ragged last stage with an odd count of blocks, one cluster in
   all) and its backward (the staged fold) on edge inputs
   (``W2X_BWD_EDGE_CASES``: blocks of more than 16 tiles, CTAs of fewer rows
   than a tile, more blocks than SMs; and SA1's compact kernel at its own
   shape, with winners outside the window, every channel of a center live
   and rows of many centers tied on one point); the tiny W2X model, step and scoring against
   their CPU twins; at full width, batch 8, K2, K3 / K4, K5 / K6 and K7
   against their plain versions on a forward's and a step's inputs (the
   full-width tolerances), ``REQUESTS`` serving batches and ``W2X_STEPS``
   training steps with the flagship's launch counts, ``radius_mode_phase``
   under ``mxu`` and ``pre``, one eval batch scored under each radius test,
   a profiled forward and step, and two steps from one state bit for bit.
   Its kernel rows join the JSON line named with " (w2x)".
11b. The width-2 backbone in f32 (phase "w2x f32", ``w2x_configs(ModelConfig())``,
   SA2-4's prep at c1 256, in_dim 259 / 515; K2f on 2-CTA clusters,
   ``prep_fwd_cluster``): K2f and K7f on the edge inputs of the tensor route
   above c1 128 (the W2X SA2 and SA3 widths at ragged rows and the tile
   edges, SA2's over 626 tiles, SA3's at 3 rows and batch 8's 8 192, (131,
   250), (35, 201) and (259, 129)) as in phase "f32", K2f also following an
   in-place update of W1 (its split is kept a W1 version), and at the
   largest in_dim each takes at c1 256 (at least 515; one more, and c1 257,
   raise);
   the tiny f32 W2X model, step and scoring against their CPU twins, the
   step under the f32 gates (gradient cosine ``F32_GLOBAL_COS``,
   ``grad_norm`` within ``F32_GRAD_NORM_REL``) and every leaf under the
   per-leaf gates, none excused; at full width, batch 8, K2f and K7f against
   their plain versions on a forward's and a step's inputs,
   ``W2X_F32_REQUESTS`` serving batches and ``W2X_STEPS`` training steps
   with the f32 launch counts, a
   profiled forward and step, two steps from one state bit for bit and one
   eval batch scored under ``pair``. Its kernel rows join the JSON line
   named with " (w2x f32)".
11c. The width-4 backbone (phase "w4x", ``w4x_configs(ModelConfig(use_bf16=
   True))``: Group-Free-3D's ``width=4``, ``sa_mlps`` (256, 256, 512) then 3
   x (512, 512, 1024), in_dim 6 / 515 / 1027 / 1027), serving, evaluation and
   training: the pool at (512, 512, 1024) (``csrc/sa_pair_pool_512.cu``) with
   and without winners on tie inputs under each radius test
   (``pool_tie_check`` of ``W4X_TIE_CASES``: values and winners equal to the
   plain version's and the tie rule's with W3 = 0, within 0.03 with a random
   W3; W = 256, 2048 over two radius-test stages, 100 with an odd count of
   blocks, one block); its backward (``csrc/sa_pair_pool_bwd_512.cu``, both
   variants) on ``W4X_BWD_EDGE_CASES`` (SA2's shape, W = 2048, winners tied
   on 4 points) within the training step's tolerances, bit for bit on a
   second launch; K2 and K7 at c1 512 on ``w4x_prep_edge_inputs`` (ragged
   rows, the tile edges, in_dim 1027 and 2048, odd c1 257 / 300 / 384, large
   points, SA1's (6, 256)); the tiny W4X model, training step and scoring
   against their CPU twins; at full width, batch 8, K2 and the pools of a
   forward against their plain versions (SA1 on the flagship's kernels, SA2-4
   on the c1-512 prep and the XL pool), ``REQUESTS`` serving batches each
   launching K1, K2 and K3 four times (``w4x_forward_launches``), a profiled
   forward, the ``mxu`` and ``pre`` XL pools on a forward's inputs (and
   against the pair kernel), one scored eval batch under each radius test;
   then K4, K5, K6 and K7 of a training step against their plain versions
   (SA1's K5 on ``csrc/sa_pair_pool_bwd_wide_compact.cu``, with its live rows
   beside their distinct (center, position) pairs; SA2-4 on the XL winners
   pool, the XL backward and the c1-512 prep backward), ``W4X_STEPS`` steps with their launches
   (``w4x_step_launches``), a profiled step, the ``mxu`` and ``pre`` winners
   pools on one step each (and against the pair kernel) and two steps from
   one state bit for bit. Its rows are named " (w4x)". Then phase "w4x f32"
   (``w4x_configs(ModelConfig())``): the same for K2f and K7f (c1 512 on
   ``csrc/sa_prep_512.cu`` and ``csrc/sa_prep_bwd_512.cu``, SA1's c1 256 at
   in_dim 6 on the FMA route; the tiny step under the bf16 phase's rule) with
   ``W4X_REQUESTS`` serving batches, one ``pair`` eval batch and
   ``W4X_STEPS`` steps; rows " (w4x f32)".
12. The gather SA (phase "gather", ``sa_impl="gather"``): the tiny model
   against its CPU twin under ``nearest`` and ``first``; at full width in
   f32 one serving batch and ``GATHER_STEPS`` training steps, each launching
   K1 four times (over the whole 50 000-point cloud at SA1) and nothing
   else; each layer's ball query timed under both modes; one profiled
   forward and step; two steps from one state bit for bit.
13. The device sort (phase "device sort", ``ModelConfig(use_bf16=True,
   points_presorted=False)``: every fused SA layer sorts its input on the
   card by Morton key, FPS runs over all 50 000 points at SA1). The tiny
   model against its CPU twin; the keys on the card equal the CPU's bit for
   bit (the clouds and points on cell boundaries); one full-width forward on
   the pipeline's clouds and one on per-scene permuted copies (the host
   presort makes SA1's sort the identity on the former), each from zeroed
   counters launching K1-K3 four times and nothing else, with a finite
   (8, 256, 3) ``last_center`` and every K1-K3 call held against its plain
   version; each layer's sort, gathers and output restore timed; one
   training step on permuted clouds launching ``step_launches("pair")``
   with its K4-K7 calls against their plain versions, and two steps from
   one state bit for bit; the forward and the step against the presorted
   model's in turns, each profiled. The fused q/k/v projection: a
   flagship-width encoder, decoder (bf16) and RoBERTa layer (f32) in train
   mode, fused against unfused on one set of weights (outputs and every
   gradient leaf, ``QKV_ATOL`` / ``QKV_F32_REL``), the flagship forward
   (the fused run on the unfused run's KPS indices, every compared end
   point within ``QKV_ATOL``) and one training step each, timed in turns.
   The ``winner`` pool at SA2's shape in f32: its gradients within
   ``WINNER_RTOL`` / ``WINNER_ATOL`` of the scan's, two backward passes bit
   for bit, both timed. The kernel tools: ``sa_kernel_bench`` at every
   layer (K4, K3, K5 / K6) and ``profile_step --steps 2`` at batch 8. Then
   the device busy ms of every profiled call.
14. Data and tensor parallelism (phase "parallel", ``eda_tpu_torch.parallel``).
   In this process under a one-rank NCCL group, the flagship bf16 training
   step at batch 8 must equal the ungrouped step from the same state bit for
   bit (metrics, every parameter, BatchNorm statistic and AdamW moment) and
   launch what it launches; the gradient and metric all-reduces go through
   NCCL (the gradient's all-reduce timed). Then two spawned processes on the
   one card, gloo named explicitly (NCCL takes one card a rank), every
   collective staged through host memory: as data = 2 each takes its 4 rows
   of the batch-8 step, in bf16 and in f32, and as data = 1 x model = 2 the
   whole batch in bf16 (its forward before KPS within
   ``PARALLEL_FORWARD_ATOL``), each against the one-process batch-8 step
   from the same state on the same rows, first on that step's KPS indices and
   matches, then on its own. The loss is held within ``PARALLEL_LOSS_REL``;
   every metric, the gradient cosine globally and per leaf, the BatchNorm
   statistics and the share of new parameters within 0.01 lr under the
   precision's ``PARALLEL_GATES`` on the same decisions (pinned, or free
   decisions that all came out equal); the share of decisions that differ
   is printed. On every rank and in each mode: BatchNorm statistics and
   losses equal on both ranks, two steps from one state bit for bit, the
   launches of one training step, the split leaves still parts after the
   step; each rank's ms a step and its all-reduces' count, bytes and host ms
   are printed.
15. The bench (``python -m eda_tpu_torch.bench --eval --batch 8 --iters 8``):
   the forward, training and eval timers at full width with few repetitions,
   their spreads on stderr and their JSON lines on stdout.
16. Prints the per-kernel JSON line, the card line, and as its last line
   ``{"ok": true, "device": {...}}``.

Per kernel, the JSON line's ``ms``, ``plain_ms`` and ``bound_ms`` are sums over
the four SA layers of one batch-8 forward (K1-K3, K8, K9a, K9b, K2f) or
training step (K4-K7, K8 and K9b with winners, K7f), and ``layers`` holds each
layer's ``ms``, ``bound_ms`` and ``bound_by`` (K2f (w2x f32): bound by bytes at
SA1, by operations at SA2-4). ``launches`` is the count
of the serving run (K1-K3), the training run (K4-K7), the mode's evaluation
run (K8, K9a, K9b), the mode's training step (K8 and K9b with winners) or the
f32 serving run and training steps (K2f, K7f); a " (w2x)", " (w2x f32)",
" (w4x)" or " (w4x f32)" row's from that phase's runs of the same kind (the
W4X rows' serving batches and eval batches; their sums over the layers each
kernel runs: SA1 on the flagship's kernels, SA2-4 on the c1-512 ones). Each phase prints
its wall time. Any failed check raises, and the script exits non-zero. Without
CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
PEAK_F32 = 67e12      # f32 outside the tensor cores, flop/s
PEAK_TF32 = 495e12    # TF32 tensor cores, dense, flop/s: a true-f32 product as 3xTF32 at a third
PEAK_BF16 = 989e12    # bf16 tensor cores, dense, flop/s
BATCH = 8
REQUESTS = 5
STEPS = 5
HEAD_ATOL = 0.06      # card (cuBLAS bf16) vs CPU heads, as tests/test_torch_grounder.py

SERVING = ("fps_launch", "sa_prep_launch", "sa_pair_pool_launch")
TRAINING = ("sa_pair_pool_winners_launch", "sa_pool_bwd_compact_launch",
            "sa_pool_bwd_window_launch", "sa_prep_bwd_launch")
MASK = "sa_radius_mask_launch"
POOL_BWD = ("sa_pool_bwd_compact_launch", "sa_pool_bwd_window_launch")
# the compact rows at (256, 256, 512) (the width-4 backbone's SA1):
# csrc/sa_pair_pool_bwd_wide_compact.cu
POOL_BWD_WC = "sa_pool_bwd_wide_compact_launch"
F32_PREP, F32_PREP_BWD = "sa_prep_f32_launch", "sa_prep_bwd_f32_launch"
# the kernels above (256, 256, 512) / c1 256: the pool at (512, 512, 1024) (a
# symbol per radius test, with and without winners, pool_symbol_xl), its
# backward (compact, windowed), and K2 / K2f and K7 / K7f at c1 512
PREP_XL, F32_PREP_XL = "sa_prep_512_launch", "sa_prep_f32_512_launch"
POOL_BWD_XL = ("sa_pool_bwd_512_compact_launch", "sa_pool_bwd_512_window_launch")
PREP_BWD_XL, F32_PREP_BWD_XL = "sa_prep_bwd_512_launch", "sa_prep_bwd_f32_512_launch"
PREP_BWD = ("sa_prep_bwd_launch", F32_PREP_BWD, PREP_BWD_XL, F32_PREP_BWD_XL)
# the backward kernels that run the SA layers last to first
BACKWARD_ORDER = ("sa_pool_bwd_window_launch", POOL_BWD_XL[1]) + PREP_BWD
IOU_SHAPE = (2, 2, BATCH, 10)  # (prefixes, scoring modes, batch, top-k)
SCORE_TIE, IOU_ATOL = 1e-5, 1e-6  # tiny eval check, card vs CPU scoring
BOUNDARY = 1e-5  # |d2 - r^2| within which mxu / pre may decide a pair otherwise than pair
TILE_ROWS = 64  # window points per GEMM tile of csrc/sa_pair_pool.cu
SLEEP_CYCLES = 50_000_000  # ~25 ms of device sleep ahead of timed launches (cuda_ms)
# card vs CPU training step, as tests/test_torch_train_step.py holds the port to
# JAX, but 10% for a single metric: the tiny train-mode step magnifies bf16
# noise (the port against itself, the input moved by 1e-6, moves grad_norm 9%)
LOSS_REL, METRIC_REL = 0.01, 0.10
GLOBAL_COS, LEAF_COS, NORM_RATIO, ZERO_NORM = 0.85, 0.4, 2.0, 2e-3
PARAM_CLOSE, BN_REL = 0.8, 0.01
ZERO_GRAD = ("attn.key.bias", "points_obj_cls.dense.0.bias", "points_obj_cls.dense.1.bias",
             "pos_embed.dense.0.bias", "self_posembed.dense.0.bias", "box_embeddings.dense.0.bias")
# the two-stage tiny step, as tests/test_torch_butd_train_step.py holds it: its
# grad_norm moves 15% when the input points move by 1e-6, and the leaves whose
# moments fail the per-leaf gates against the CPU run on moved inputs are held
# by the global cosine only (at most BUTD_MAX_NOISY of them)
BUTD_GRAD_NORM_REL, BUTD_NOISE_DRAWS, BUTD_MAX_NOISY = 0.2, 3, 10
# kernel vs plain on a real training step, relative to each leaf's largest value:
# the prep backward as tests/test_sa_prep.py (0.02), the pool backward's weight
# gradients as tests/test_sa_kernel_interpret.py (1%); dA and db_c 0.5% (a bf16
# rounding of dx that lands on the other side of a boundary moves an element
# by ~5e-4 of the leaf's largest value)
PREP_BWD_REL, POOL_BWD_W_REL, POOL_BWD_A_REL = 0.02, 0.01, 0.005
GATHER_CLI_STEPS = 3  # tiny --sa_impl gather CLI steps


def pool_symbol(mode: str, winners: bool) -> str:
    from eda_tpu_torch.ops.cuda.sa_kernel import KERNELS

    return KERNELS[mode, winners].symbol


def pool_symbol_xl(mode: str, winners: bool = False) -> str:
    from eda_tpu_torch.ops.cuda.sa_kernel import KERNELS_XL, KERNELS_XL_WINNERS

    return (KERNELS_XL_WINNERS if winners else KERNELS_XL)[mode].symbol


def forward_launches(mode: str, f32: bool = False) -> dict:
    """Kernel launches of one flagship forward under radius-test ``mode``
    (``f32``: the f32 model, whose layer 0 is K2f)."""
    out = {"fps_launch": 4, F32_PREP if f32 else "sa_prep_launch": 4,
           pool_symbol(mode, False): 4}
    if mode == "pre":
        out[MASK] = 4
    return out


def step_launches(mode: str, f32: bool = False) -> dict:
    """Kernel launches of one flagship training step: compact backward at SA1 only."""
    out = {"fps_launch": 4, F32_PREP if f32 else "sa_prep_launch": 4,
           pool_symbol(mode, True): 4, "sa_pool_bwd_compact_launch": 1,
           "sa_pool_bwd_window_launch": 3, F32_PREP_BWD if f32 else "sa_prep_bwd_launch": 4}
    if mode == "pre":
        out[MASK] = 4
    return out


def launch_counts() -> dict:
    from eda_tpu_torch.ops.cuda import build

    return {s: k.launches for s, k in build.KERNELS.items()}


def check_launches(before: dict, want: dict, what: str) -> None:
    """Every kernel advanced from ``before`` by ``want`` (0 where not listed)."""
    for symbol, count in launch_counts().items():
        if count - before[symbol] != want.get(symbol, 0):
            raise AssertionError(f"{what}: {symbol} launched {count - before[symbol]} times, "
                                 f"not {want.get(symbol, 0)}")


@contextlib.contextmanager
def radius_mode(mode: str):
    """``EDA_SA_D2=mode`` in this process, restored afterwards."""
    saved = os.environ.get("EDA_SA_D2")
    os.environ["EDA_SA_D2"] = mode
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("EDA_SA_D2")
        else:
            os.environ["EDA_SA_D2"] = saved


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches after one warm-up.

    The launches queue up behind a device sleep of ~25 ms, so that the card
    runs them back to back and the host's time per call (the wrapper's Python,
    ~0.1-0.3 ms) does not pass for the device time of a short kernel."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed(fn):
    """(result, host-clock ms) of ``fn()`` between two synchronizes."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


class Recorder:
    """Records the arguments of kernel wrappers the model calls.

    ``targets`` are (module, attribute, symbol) triples; a symbol may be a
    function of the call's keyword and positional arguments (the pool
    backward's variant; the kernel a layer's widths run on).
    """

    def __init__(self, targets):
        self.targets = targets
        self.calls = {}

    def __enter__(self):
        self.saved = []
        for module, name, symbol in self.targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))

            def wrapped(*args, _fn=fn, _symbol=symbol, **kwargs):
                key = _symbol(kwargs, args) if callable(_symbol) else _symbol
                self.calls.setdefault(key, []).append((args, kwargs))
                return _fn(*args, **kwargs)

            setattr(module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


@contextlib.contextmanager
def patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def bound(ops: float, peak: float, nbytes: float):
    """(least ms, what sets it) for ``ops`` at ``peak`` and ``nbytes`` at HBM rate."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def fps_bound(args, kw):
    xyz, npoint = args
    B, N, _ = xyz.shape
    ops = B * (npoint - 1) * N * 9  # 3 sub, 3 mul, 2 add, 1 min per point and step
    return bound(ops, PEAK_F32, xyz.numel() * 4 + B * npoint * 4)


def f32_prep(kw) -> bool:
    return kw.get("compute_dtype") == torch.float32


def prep_bound(args, kw):
    """Points read once, A written once (bf16, or f32 for K2f), W1 and the
    vectors in f32; the products at the bf16 tensor-core peak, or K2f's true
    f32 products at a third of the TF32 peak (three TF32 products each)."""
    pts, w1 = args[0], args[1]
    B, N, in_dim = pts.shape
    c1 = w1.shape[1]
    size, peak = (4, PEAK_TF32 / 3) if f32_prep(kw) else (2, PEAK_BF16)
    nb = pts.numel() * 4 + B * N * c1 * size + (in_dim + 3) * c1 * 4
    return bound(2 * B * N * in_dim * c1, peak, nb)


def window_d2(xyz, cen, starts, window: int):
    """Yields (first block, end block, d2): the squared distances (B, blocks, 16,
    W) of each 16-center block's centers to its window's points, x, y, z summed
    in order, a few blocks at a time."""
    from eda_tpu_torch.ops.cuda.sa_kernel import BLOCK, window_starts

    B, N, _ = xyz.shape
    n_blocks = cen.shape[1] // BLOCK
    starts = window_starts(starts.long(), N, window)
    offs = torch.arange(window, device=xyz.device)
    chunk = max(1, (1 << 24) // (B * BLOCK * window))
    for j0 in range(0, n_blocks, chunk):
        j1 = min(n_blocks, j0 + chunk)
        pos = (starts[:, j0:j1, None] + offs).reshape(B, -1, 1)
        p = xyz.gather(1, pos.expand(-1, -1, 3)).view(B, j1 - j0, 1, window, 3)
        d = p - cen[:, j0 * BLOCK:j1 * BLOCK].view(B, j1 - j0, BLOCK, 1, 3)
        yield j0, j1, d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def in_radius_pairs(xyz, cen, starts, radius, window) -> int:
    """Pairs of this run's windows that lie within the radius (the work the pool needs)."""
    r2 = torch.tensor(radius * radius, dtype=torch.float32).item()
    return sum(int((d2 <= r2).sum()) for _, _, d2 in window_d2(xyz, cen, starts, window))


def pool_bound(args, kw, winners: bool = False):
    """The pair MLP over this run's in-radius pairs; ``pre`` reads the mask, not xyz."""
    A, xyz, b_c, cen, starts, w2, b2, s2, lb2, w3, b3 = args
    c1, c2, c3 = A.shape[-1], w2.shape[1], w3.shape[1]
    if kw["d2_mode"] == "pre":
        pairs, geometry = int(kw["mask"].sum()), nbytes(kw["mask"])
    else:
        pairs = in_radius_pairs(xyz, cen, starts, kw["radius"], kw["window"])
        geometry = nbytes(xyz, cen)
    out = b_c.shape[0] * b_c.shape[1] * c3 * (8 if winners else 4)
    nb = (nbytes(A, b_c, starts, b2, s2, lb2, b3) + geometry + (w2.numel() + w3.numel()) * 2
          + out)
    return bound(pairs * 2 * (c1 * c2 + c2 * c3), PEAK_BF16, nb)


def dense_flops(args, kw) -> int:
    """The pair MLP over every pair of the windows the pool computes."""
    A, b_c, w2, w3 = args[0], args[2], args[5], args[9]
    c1, c2, c3 = A.shape[-1], w2.shape[1], w3.shape[1]
    return b_c.shape[0] * b_c.shape[1] * kw["window"] * 2 * (c1 * c2 + c2 * c3)


def empty_tiles(args, kw) -> tuple:
    """(empty, all): the pool's (center, 64-point window tile) pairs, and those
    with no pair in radius, which the kernel skips (from ``window_d2``, or
    from the mask under ``pre``)."""
    xyz, cen, starts = args[1], args[3], args[4]
    window = kw["window"]
    pad = -window % TILE_ROWS
    r2 = torch.tensor(kw["radius"] * kw["radius"], dtype=torch.float32).item()
    if kw["d2_mode"] == "pre":
        keeps = [kw["mask"].transpose(2, 3).bool()]
    else:
        keeps = (d2 <= r2 for _, _, d2 in window_d2(xyz, cen, starts, window))
    empty = total = 0
    for keep in keeps:  # (B, blocks, 16, W)
        tiles = torch.nn.functional.pad(keep, (0, pad)).unflatten(-1, (-1, TILE_ROWS)).any(-1)
        empty += int((~tiles).sum())
        total += tiles.numel()
    return empty, total


def mask_bound(args, kw):
    """Per window row: p - o and |p'|^2 (8 operations); per (row, center): the
    expansion and the test (8). Bytes: xyz, centers and starts read once, the
    mask written once."""
    xyz, cen, starts = args
    B, M, _ = cen.shape
    rows = B * (M // 16) * kw["window"]
    return bound(rows * (8 + 16 * 8), PEAK_F32, rows * 16 + nbytes(xyz, cen, starts))


def boundary_centers(xyz, cen, starts, radius: float, window: int):
    """(B, M) bool: centers with a window point p where ||p - c|^2 - r^2| <= BOUNDARY."""
    from eda_tpu_torch.ops.cuda.sa_kernel import BLOCK

    r2 = torch.tensor(radius * radius, dtype=torch.float32).item()
    near = torch.zeros(cen.shape[:2], dtype=torch.bool, device=xyz.device)
    for j0, j1, d2 in window_d2(xyz, cen, starts, window):
        near[:, j0 * BLOCK:j1 * BLOCK] = ((d2 - r2).abs() <= BOUNDARY).any(-1).flatten(1)
    return near


def against_pair(symbol: str, args, kw, got, layer: int) -> None:
    """The mode kernel's values against the pair kernel on the same inputs:
    counts the (center, channel) entries more than 0.03 apart and requires a
    window point on the radius boundary at each of their centers."""
    from eda_tpu_torch.ops.cuda import sa_kernel

    if symbol.endswith("winners_launch"):
        pair = sa_kernel.sa_pair_pool_winners(*args, **{**kw, "d2_mode": "pair", "mask": None})
        pair, got = pair[0], got[0]
    else:
        pair = sa_kernel.sa_pair_pool(*args, **{**kw, "d2_mode": "pair", "mask": None})
    differ = ((got - pair).abs() > 0.03) | ((got < -1e8) != (pair < -1e8))
    centers = differ.any(-1)
    near = boundary_centers(args[1], args[3], args[4], kw["radius"], kw["window"])
    print(f"  SA{layer} against pair: {int(differ.sum())} of {differ.numel()} (center, channel) "
          f"entries differ by more than 0.03 ({int((got != pair).sum())} differ at all), at "
          f"{int(centers.sum())} centers; "
          f"{int(near.sum())} centers have a window point within {BOUNDARY} of the radius")
    if (centers & ~near).any():
        raise AssertionError(f"{symbol} differs from pair at SA{layer} at a center with no "
                             f"window point on the radius boundary")


def window_offsets(args, kw):
    """(B, M, c3) each channel's winner's offset in its center's window."""
    A, winners, starts = args[0], args[3], args[4]
    from eda_tpu_torch.ops.cuda.sa_kernel import BLOCK, window_starts

    start = window_starts(starts.long(), A.shape[1], kw["window"]).repeat_interleave(BLOCK, dim=1)
    return winners.long() - start[..., None]


def distinct_keys(key):
    """The distinct nonnegative values along the last axis of ``key``."""
    key = key.sort(-1).values
    return ((key[..., 1:] != key[..., :-1]) & (key[..., 1:] >= 0)).sum(-1) + (key[..., 0] >= 0)


def live_channels(args, kw):
    """(B, M, c3) bool: the (center, channel) entries whose cotangent reaches a
    pair row of the pool backward: g != 0, and (windowed) an in-window winner."""
    live = args[2] != 0
    if kw["compact"]:
        return live
    rel = window_offsets(args, kw)
    return live & (rel >= 0) & (rel < kw["window"])


def center_rows(args, kw):
    """(B, M) pair rows of each center in the pool backward: its live channels
    (compact), or their distinct winners (windowed)."""
    live = live_channels(args, kw)
    if kw["compact"]:
        return live.sum(-1)
    return distinct_keys(torch.where(live, args[3].long(), -1))


def center_positions(args, kw):
    """(B, M) distinct positions of each center's live channels: their winners'
    window offsets, one for all winners outside the window (the compact
    backward at (256, 256, 512) computes the forward once a position)."""
    window = kw["window"]
    rel = window_offsets(args, kw)
    key = torch.where((rel >= 0) & (rel < window), rel, window)
    return distinct_keys(torch.where(args[2] != 0, key, -1))


def live_rows(args, kw) -> tuple:
    """(pair rows, won channels) the pool backward needs for this run's data."""
    return int(center_rows(args, kw).sum()), int(live_channels(args, kw).sum())


def pool_bwd_ops(args, kw) -> int:
    """The pool backward's live-row work: per row h0 @ W2, dh0 = dx @ W2^T and
    dW2 = h0^T dx; per won channel its W3^T row and its dW3 column."""
    c1, c2 = args[5].shape
    rows, channels = live_rows(args, kw)
    return rows * 6 * c1 * c2 + channels * 4 * c2


def pool_bwd_position_ops(args, kw) -> int:
    """The compact backward's work where a center's rows of one window position
    share that position's forward: per row dh0 = dx @ W2^T; per distinct
    (center, position) h0 @ W2 and dW2 += h0^T S, S the sum of its rows' dx;
    per won channel its W3^T row and its dW3 column."""
    c1, c2 = args[5].shape
    rows, channels = live_rows(args, kw)
    positions = int(center_positions(args, kw).sum())
    return rows * 2 * c1 * c2 + positions * 4 * c1 * c2 + channels * 4 * c2


def pool_bwd_bound(args, kw, ops=pool_bwd_ops):
    A, b_c, g, winners, starts, w2, b2, s2, lb2, w3 = args
    c2 = w2.shape[1]
    nb = (nbytes(A, b_c, g, winners, starts, b2, s2, lb2) + (w2.numel() + w3.numel()) * 2
          + A.numel() * 4 + b_c.numel() * 4 + (w2.numel() + w3.numel() + 3 * c2 + w3.shape[1]) * 4)
    return bound(ops(args, kw), PEAK_BF16, nb)


def prep_bwd_bound(args, kw):
    pts, dA, w1 = args[0], args[1], args[2]
    B, N, in_dim = pts.shape
    c1 = w1.shape[1]
    # recompute x, dpts = dx @ W1^T, dW1 = pts^T dx: three (B*N, in_dim, c1) products;
    # dA read in the compute dtype (K7f: f32), dpts written in f32; K7f's
    # products true f32, as 3xTF32
    size, peak = (4, PEAK_TF32 / 3) if f32_prep(kw) else (2, PEAK_BF16)
    nb = pts.numel() * 4 + dA.numel() * size + pts.numel() * 4 + (3 * in_dim + 5) * c1 * 4
    return bound(6 * B * N * in_dim * c1, peak, nb)


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / (want.float().abs().max() + 1e-30))


def abs_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_kernel(symbol: str, got, want, layer: int, call=None) -> float:
    """Max abs error of a kernel result against its plain version; raises past
    tolerance: absolute for K1-K4 (as their CPU tests; K2f per element, from
    its ``call``'s (args, kwargs)), relative to each leaf's largest value for
    the backward kernels."""
    if symbol == "fps_launch":
        if not torch.equal(got, want):
            raise AssertionError(f"FPS kernel differs from its plain version at SA{layer}")
        return 0.0
    if symbol in ("sa_prep_launch", PREP_XL):
        g, w = got.float(), want.float()
        err = (g - w).abs().max().item()
        # 0.02, plus one bf16 step (2^-7 relative) where the LN output is large;
        # K2 at c1 512 also the image of one flipped rounding of its sum of up
        # to 2048 products (prep_xl_tolerance)
        tol = 0.02 + w.abs() * 2.0 ** -7
        if symbol == PREP_XL:
            tol = tol + prep_xl_tolerance(*call[0][:4], call[1]["radius"])
        if not ((g - w).abs() <= tol).all():
            raise AssertionError(f"prep kernel off its plain version at SA{layer}: {err}")
        return err
    if symbol in (F32_PREP, F32_PREP_XL):
        (pts, w1, b1), radius = call[0][:3], call[1]["radius"]
        err = (got - want).abs()
        if not (err <= prep_f32_tolerance(pts, w1, b1, radius, want)).all():
            raise AssertionError(f"f32 prep kernel off its plain version at SA{layer}: "
                                 f"{err.max().item()}")
        return err.max().item()
    if symbol == MASK:
        if not torch.equal(got, want):
            raise AssertionError(f"mask kernel differs from its plain version at SA{layer}")
        return 0.0
    if symbol.startswith("sa_pair_pool"):
        if symbol.endswith("winners_launch"):
            (got, got_win), (want, want_win, second) = got, want
            # the two sides round h1 to bf16 after f32 sums in other orders, so a
            # pooled value moves by up to the largest value error: a winner is
            # decided where the best two values are further apart than twice that
            separated = (want - second) > 2 * abs_err(got, want) + 1e-6
            if not torch.equal(got_win[separated], want_win[separated]):
                raise AssertionError(f"pool winners differ from the plain version at SA{layer}")
            print(f"  SA{layer} winners equal on {int(separated.sum())} of {separated.numel()} "
                  f"(center, channel) pairs whose best two values differ; "
                  f"{int((got_win == want_win).sum())} equal in all")
        if not torch.equal(got < -1e8, want < -1e8):
            raise AssertionError(f"pool kernel -1e9 rows differ at SA{layer}")
        err = abs_err(got, want)
        if err > 0.03:
            raise AssertionError(f"pool kernel off its plain version at SA{layer}: {err}")
        return err
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    print(f"  SA{layer} errors relative to each output's largest value: "
          f"{[f'{e:.2e}' for e in errs]}")
    if symbol in PREP_BWD:  # dpts, dW1, db1, dscale, dlnb
        f32 = symbol in (F32_PREP_BWD, F32_PREP_BWD_XL)
        if max(errs) > (PREP_F32_BWD_REL if f32 else PREP_BWD_REL):
            raise AssertionError(f"prep backward off its plain version at SA{layer}: {errs}")
    elif max(errs[:2]) > POOL_BWD_A_REL or max(errs[2:]) > POOL_BWD_W_REL:
        # dA, db_c | dW2, db2, ds2, dlb2, dW3, db3
        raise AssertionError(f"pool backward off its plain version at SA{layer}: {errs}")
    return max(abs_err(g, w) for g, w in zip(got, want))


def kernel_specs():
    """symbol -> (kernel wrapper, plain version, bound, timed launches)."""
    from eda_tpu_torch.ops.cuda import fps, sa_kernel, sa_mask, sa_pool_bwd, sa_prep

    bwd = (sa_pool_bwd.sa_pool_bwd, sa_pool_bwd.sa_pool_bwd_plain)
    specs = {
        "fps_launch": (fps.fps, fps.fps_plain, fps_bound, 20),
        "sa_prep_launch": (sa_prep.sa_prep, sa_prep.sa_prep_plain, prep_bound, 20),
        "sa_pool_bwd_compact_launch": (*bwd, pool_bwd_bound, 5),
        "sa_pool_bwd_window_launch": (*bwd, pool_bwd_bound, 5),
        POOL_BWD_WC: (*bwd, lambda a, k: pool_bwd_bound(a, k, pool_bwd_position_ops), 3),
        "sa_prep_bwd_launch": (sa_prep.sa_prep_bwd, sa_prep.sa_prep_bwd_plain, prep_bwd_bound, 10),
        F32_PREP: (sa_prep.sa_prep, sa_prep.sa_prep_plain, prep_bound, 20),
        PREP_XL: (sa_prep.sa_prep, sa_prep.sa_prep_plain, prep_bound, 20),
        F32_PREP_XL: (sa_prep.sa_prep, sa_prep.sa_prep_plain, prep_bound, 20),
        F32_PREP_BWD: (sa_prep.sa_prep_bwd, sa_prep.sa_prep_bwd_plain, prep_bwd_bound, 10),
        PREP_BWD_XL: (sa_prep.sa_prep_bwd, sa_prep.sa_prep_bwd_plain, prep_bwd_bound, 10),
        F32_PREP_BWD_XL: (sa_prep.sa_prep_bwd, sa_prep.sa_prep_bwd_plain, prep_bwd_bound, 10),
        POOL_BWD_XL[0]: (*bwd, pool_bwd_bound, 3),
        POOL_BWD_XL[1]: (*bwd, pool_bwd_bound, 3),
        MASK: (sa_mask.sa_radius_mask, sa_mask.sa_radius_mask_plain, mask_bound, 20),
    }
    for mode in sa_kernel.D2_MODES:
        specs[pool_symbol(mode, False)] = (sa_kernel.sa_pair_pool, sa_kernel.sa_pair_pool_plain,
                                           pool_bound, 5)
        specs[pool_symbol(mode, True)] = (
            sa_kernel.sa_pair_pool_winners,
            lambda *a, **k: sa_kernel.sa_pair_pool_winners_plain(*a, runner_up=True, **k),
            lambda a, k: pool_bound(a, k, winners=True), 5)
        specs[pool_symbol_xl(mode)] = (sa_kernel.sa_pair_pool, sa_kernel.sa_pair_pool_plain,
                                       pool_bound, 3)
        specs[pool_symbol_xl(mode, True)] = (specs[pool_symbol(mode, True)][:3]) + (3,)
    return specs


@torch.no_grad()
def check_kernels(calls, symbols, layers: dict, compare_pair: bool = False,
                  first_layer: dict = None) -> list:
    """Hold every recorded kernel call against its plain version; time both.
    With ``compare_pair`` the pool calls are also held against the pair kernel.
    ``first_layer``: the SA layer of a symbol's first call (by default 1 for a
    forward kernel, 4 for a backward one, which runs the layers last to first;
    the width-4 backbone runs SA2-4 on kernels of their own)."""
    from eda_tpu_torch.ops.cuda import build

    specs = kernel_specs()
    rows = []
    for symbol in symbols:
        kernel_fn, plain_fn, bound_fn, reps = specs[symbol]
        name = symbol.removesuffix("_launch")
        kernel = build.KERNELS[symbol]
        if len(calls.get(symbol, [])) != layers[symbol]:
            raise AssertionError(f"{name}: the run made {len(calls.get(symbol, []))} calls, "
                                 f"not {layers[symbol]}")
        total = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        bound_ops = bound_bytes = 0.0
        per_layer = []
        for i, (args, kw) in enumerate(calls[symbol]):
            # the backward runs the layers last to first
            if symbol in BACKWARD_ORDER:
                layer = (first_layer or {}).get(symbol, 4) - i
            else:
                layer = i + (first_layer or {}).get(symbol, 1)
            got, want = kernel_fn(*args, **kw), plain_fn(*args, **kw)
            torch.cuda.synchronize()
            err = check_kernel(symbol, got, want, layer, (args, kw))
            if compare_pair and symbol != MASK:
                against_pair(symbol, args, kw, got, layer)
            if symbol in POOL_BWD + (POOL_BWD_WC,) + POOL_BWD_XL + PREP_BWD:
                again = kernel_fn(*args, **kw)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{name} SA{layer}: an output differs between two "
                                         f"launches")
                del again
            del got, want
            ms = cuda_ms(lambda: kernel_fn(*args, **kw), reps)
            plain_ms = cuda_ms(lambda: plain_fn(*args, **kw), 1)
            bound_ms, by = bound_fn(args, kw)
            bound_ops += bound_ms if by == "operations" else 0.0
            bound_bytes += bound_ms if by == "bytes" else 0.0
            per_layer.append({"layer": f"SA{layer}", "ms": ms, "bound_ms": bound_ms,
                              "bound_by": by})
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)][:2]
            print(f"kernel {name} SA{layer} {shapes}: max_err {err} ms {ms:.4f} "
                  f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} ({by})")
            if symbol in POOL_BWD + (POOL_BWD_WC,) + POOL_BWD_XL:
                n_rows, _ = live_rows(args, kw)
                if kw["compact"]:
                    pos = center_positions(args, kw).flatten().float()
                    n_pos = int(pos.sum())
                    mid, p90 = torch.quantile(pos, torch.tensor([0.5, 0.9], device=pos.device))
                    print(f"  SA{layer} compact rows: {n_rows} live rows over {n_pos} distinct "
                          f"(center, position) pairs, {n_rows / max(n_pos, 1):.2f} rows a pair; "
                          f"positions a center: mean {float(pos.mean()):.1f}, median "
                          f"{float(mid):.0f}, p90 {float(p90):.0f}, max {float(pos.max()):.0f}")
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                kernel_fn(*args, **kw)
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
                rate = f"{pool_bwd_ops(args, kw) / ms / 1e9:.1f} TFLOP/s over the live-row work"
                if symbol == POOL_BWD_WC:
                    old_ms, _ = pool_bwd_bound(args, kw)
                    rate += (f" ({pool_bwd_position_ops(args, kw) / ms / 1e9:.1f} over the work a "
                             f"position shares, its bound_ms; the live-row bound {old_ms:.5f} ms)")
                print(f"  SA{layer} pool backward: {n_rows} live rows, {rate}, "
                      f"peak memory of one call {peak:.1f} MiB")
            if symbol.startswith("sa_pair_pool"):
                empty, tiles = empty_tiles(args, kw)
                print(f"  SA{layer} pool: {dense_flops(args, kw) / ms / 1e9:.1f} TFLOP/s over the "
                      f"dense window work; {empty} of {tiles} (center, {TILE_ROWS}-point) tiles "
                      f"({100 * empty / tiles:.1f}%) have no pair in radius and are skipped")
            for key, value in (("err", err), ("ms", ms), ("plain_ms", plain_ms),
                               ("bound_ms", bound_ms)):
                total[key] = max(total[key], value) if key == "err" else total[key] + value
        rows.append({
            "name": name, "route": "cuda",
            "source": f"eda_tpu_torch/csrc/{kernel.source}.cu",
            "replaces": kernel.replaces, "launches": 0, "max_abs_err": total["err"],
            "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": None, "layers": per_layer,
        })
    return rows


def hgmma_counts(library: Path):
    """HGMMA instructions per kernel function of a built library, from
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    return sass_counts(library, "HGMMA")


def sass_counts(library: Path, op: str):
    """Instructions holding ``op`` per kernel function of a built library, from
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, function = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            function = line.split("Function : ")[1].strip()
            counts[function] = 0
        elif function is not None and op in line:
            counts[function] += 1
    return counts


# tensor-core kernel libraries: source -> the names of its GEMM kernels; the
# pool's and its backward's wide kernels, (256, 256, 512), the backward's
# compact kernel at (128, 128, 256) and the prep kernels' cluster routes at c1
# 256, the f32 forward's and backward's (REQUIRED_KERNELS), must be among them
GEMM_KERNELS = {"sa_pair_pool": ("sa_pair_pool_kernel", "sa_pair_pool_wide"),
                "sa_pair_pool_512": ("sa_pair_pool_512",),
                "sa_prep_512": ("sa_prep_512",),
                "sa_pair_pool_bwd": ("pool_bwd_tiles", "pool_bwd_wide", "pool_bwd_compact"),
                "sa_pair_pool_bwd_wide_compact": ("pool_bwd_compact_wide",),
                "sa_prep_bwd": ("prep_bwd_tiles", "prep_bwd_cluster"),
                "sa_prep": ("sa_prep_kernel", "sa_prep_cluster"),
                "sa_prep_f32": ("prep_tc", "prep_fwd_cluster")}
REQUIRED_KERNELS = (("sa_pair_pool_bwd", "pool_bwd_compact"), ("sa_prep_bwd", "prep_bwd_cluster"),
                    ("sa_pair_pool_bwd_wide_compact", "pool_bwd_compact_wide"),
                    ("sa_prep", "sa_prep_cluster"), ("sa_prep_f32", "prep_tc_cluster"),
                    ("sa_prep_f32", "prep_fwd_cluster"), ("sa_pair_pool_512", "sa_pair_pool_512"),
                    ("sa_prep_512", "sa_prep_512"))


def check_pool_build(logs: dict, build) -> None:
    """The pair pool's forward and backward kernels, both bf16 prep kernels
    and the f32 prep's tensor-core route (SA2-4's widths) spill nothing and
    run their products on tensor cores (HGMMA in every GEMM kernel's SASS,
    where cuobjdump exists)."""
    spills = [line.strip() for source in GEMM_KERNELS for line in logs[source].splitlines()
              if any(int(n) for n in re.findall(r"(\d+) bytes spill", line))]
    if spills:
        raise AssertionError(f"tensor-core kernels spill registers: {spills}")
    for source, kernels in GEMM_KERNELS.items():
        counts = hgmma_counts(build._target(source))
        if counts is None:
            print(f"{source} HGMMA count: not checked (no cuobjdump)")
            continue
        gemms = {f: n for f, n in counts.items() if any(k in f for k in kernels)}
        print(f"{source} HGMMA count: {sum(gemms.values())} HGMMA instructions in {len(gemms)} "
              f"GEMM kernels, fewest in one kernel {min(gemms.values(), default=0)}; no spills")
        if not gemms or min(gemms.values()) == 0:
            raise AssertionError(f"a {source} GEMM kernel has no HGMMA instruction")
        wide = [n for f, n in gemms.items() if "wide" in f]
        if source in ("sa_pair_pool", "sa_pair_pool_bwd"):
            # the wide kernels (the cluster forward, the staged-fold backward)
            # are built and hold HGMMA like the others
            if not wide:
                raise AssertionError(f"{source} holds no wide kernel")
            print(f"  of which {len(wide)} wide kernels, fewest HGMMA in one {min(wide)}")
        for kind, name in REQUIRED_KERNELS:
            if source != kind:
                continue
            found = [n for f, n in gemms.items() if name in f]
            if not found:
                raise AssertionError(f"{source} holds no {name} kernel")
            print(f"  of which {name}: {found[0]} HGMMA")


# the training kernels above (256, 256, 512) / c1 256 (the XL pool backward,
# the c1-512 prep backward): their products are mma_gemm.cuh's mma.sync tiles
# (HMMA), source -> the name of its GEMM kernel
MMA_KERNELS = {"sa_pair_pool_bwd_512": "gemm_kernel", "sa_prep_bwd_512": "gemm_kernel"}


def check_mma_build(logs: dict, build) -> None:
    """The ``MMA_KERNELS`` libraries spill nothing and every GEMM kernel of
    theirs runs its products on the tensor cores (HMMA in its SASS, where
    cuobjdump exists)."""
    spills = [line.strip() for source in MMA_KERNELS for line in logs[source].splitlines()
              if any(int(n) for n in re.findall(r"(\d+) bytes spill", line))]
    if spills:
        raise AssertionError(f"mma.sync kernels spill registers: {spills}")
    for source, name in MMA_KERNELS.items():
        counts = sass_counts(build._target(source), "HMMA")
        if counts is None:
            print(f"{source} HMMA count: not checked (no cuobjdump)")
            continue
        gemms = {f: n for f, n in counts.items() if name in f}
        print(f"{source} HMMA count: {sum(gemms.values())} HMMA instructions in {len(gemms)} "
              f"GEMM kernels, fewest in one kernel {min(gemms.values(), default=0)}; no spills")
        if not gemms or min(gemms.values()) == 0:
            raise AssertionError(f"a {source} GEMM kernel has no HMMA instruction")


def tie_inputs(B=BATCH, N=2048, M=1024, window=256, widths=(128, 128, 256), seed=0):
    """A pool input on which every in-radius pair of a center gives the same
    value, b3, whatever the summation order (W3 = 0, b3 distinct), so that the
    winners are set by the tie rule alone. By default a full-width SA2 input.

    Points lie on a 1/16 grid and r^2 halfway between two grid distances, so
    the three radius tests decide every pair alike. The centers of blocks 1
    and 5 of every scene move out of reach (their rows must be -1e9, rank 0);
    the last blocks' windows are clamped at N - W. Returns (args, kw), CPU
    tensors, ``kw`` without the radius test."""
    c1, c2, c3 = widths
    g = torch.Generator().manual_seed(seed)
    x = torch.sort(torch.randint(0, 8 * 16, (B, N), generator=g), dim=1).values / 16
    yz = torch.randint(0, 8, (B, N, 2), generator=g) / 16
    xyz = torch.cat([x[..., None], yz], -1).float()
    ranks = torch.sort(torch.rand(B, N, generator=g).argsort(1)[:, :M], dim=1).values
    cen = xyz.gather(1, ranks[..., None].expand(-1, -1, 3)).clone()
    for block in (1, 5):
        cen[:, 16 * block:16 * (block + 1)] += 100.0
    starts = (ranks.view(B, M // 16, 16)[:, :, 8] - window // 2).clamp(0, N - window).int()
    radius = math.sqrt(40.5 / 256)  # r^2 halfway between grid distances 40/256 and 41/256
    args = (torch.randn(B, N, c1, generator=g).bfloat16(), xyz,
            torch.randn(B, M, c1, generator=g).bfloat16(), cen, starts,
            torch.randn(c1, c2, generator=g) * 0.1, torch.randn(c2, generator=g) * 0.1,
            1 + 0.1 * torch.randn(c2, generator=g), torch.randn(c2, generator=g) * 0.1,
            torch.zeros(c2, c3), (torch.randperm(c3, generator=g).float() - c3 / 2) / 16)
    return args, {"radius": radius, "window": window}


def rule_winners(args, kw) -> tuple:
    """((B, M) global rank, (B, M) none): the point the tie rule picks among a
    center's in-radius window points, all of equal value: the earliest tile of
    min(128, W) points with one, the last one in that tile; rank 0 for a
    center with none."""
    from eda_tpu_torch.ops.cuda.sa_kernel import window_starts

    xyz, cen, starts = args[1], args[3], args[4]
    window = kw["window"]
    r2 = torch.tensor(kw["radius"] * kw["radius"], dtype=torch.float32).item()
    keep = torch.cat([d2 <= r2 for _, _, d2 in window_d2(xyz, cen, starts, window)], 1)
    tile = torch.arange(window, device=keep.device) // min(128, window)
    first = torch.where(keep, tile, window).amin(-1, keepdim=True)
    pos = torch.where(keep & (tile == first), torch.arange(window, device=keep.device), -1).amax(-1)
    start = window_starts(starts.long(), xyz.shape[1], window)[..., None]
    none = (pos < 0).flatten(1)
    return torch.where(pos >= 0, start + pos, 0).flatten(1), none


# pool tie check inputs: (layer, widths, N, M, window). The full-width SA2
# input at the flagship window (one stage of csrc/sa_pair_pool.cu), and windows
# wider than the kernel's shared memory holds at once (SA2 at 512, SA1 at 2048:
# two stages each), as the wide sa_windows settings and the dense path give
TIE_CASES = ((2, (128, 128, 256), 2048, 1024, 256), (2, (128, 128, 256), 2048, 1024, 512),
             (1, (64, 64, 128), 4096, 2048, 2048))


@torch.no_grad()
def pool_tie_check(cases=TIE_CASES) -> None:
    """Every pool variant on ``tie_inputs`` of each entry of ``cases``:
    values and winners equal to the plain version's and to the rule's at every
    (center, channel), -1e9 rows and rank 0 exactly at the centers out of
    reach. Then the same inputs with a random W3: every variant within 0.03 of
    the plain version, winners equal where the best two values are apart."""
    from eda_tpu_torch.ops.cuda import sa_kernel, sa_mask

    for layer, widths, n_points, n_centers, window, *batch in cases:
        B = batch[0] if batch else BATCH
        args, kw = tie_inputs(B=B, N=n_points, M=n_centers, window=window, widths=widths)
        args = tuple(a.cuda() for a in args)
        N = args[1].shape[1]
        if boundary_centers(args[1], args[3], args[4], kw["radius"], window).any():
            raise AssertionError("tie input: a window point lies on the radius")
        rule, empty = rule_winners(args, kw)
        clamped = int((sa_kernel.window_starts(args[4].long(), N, window) == N - window).sum())
        mask = sa_mask.sa_radius_mask(args[1], args[3], args[4], **kw)
        g = torch.Generator(device="cuda").manual_seed(layer)
        w3 = torch.randn(widths[1:], generator=g, device="cuda") * 0.1
        random_w3 = args[:9] + (w3,) + args[10:]
        for mode in sa_kernel.D2_MODES:
            mkw = dict(kw, d2_mode=mode, mask=mask if mode == "pre" else None)
            got = sa_kernel.sa_pair_pool(*args, **mkw)
            got_v, got_w = sa_kernel.sa_pair_pool_winners(*args, **mkw)
            want_v, want_w = sa_kernel.sa_pair_pool_winners_plain(*args, **mkw)
            torch.cuda.synchronize()
            for what, ok in (("values", torch.equal(got, want_v) and torch.equal(got_v, want_v)),
                             ("winners", torch.equal(got_w, want_w)),
                             ("rule", torch.equal(want_w, rule[..., None].expand_as(want_w).int())),
                             ("-1e9 rows", torch.equal((got_v == -1e9).all(-1), empty)
                              and not (got_w[empty] != 0).any())):
                if not ok:
                    raise AssertionError(f"pool tie check, {mode}, SA{layer} W={window}: "
                                         f"{what} differ")
            want = sa_kernel.sa_pair_pool_winners_plain(*random_w3, **mkw, runner_up=True)
            check_kernel(pool_symbol(mode, False), sa_kernel.sa_pair_pool(*random_w3, **mkw),
                         want[0], layer)
            check_kernel(pool_symbol(mode, True),
                         sa_kernel.sa_pair_pool_winners(*random_w3, **mkw), want, layer)
        pair_kw = dict(kw, d2_mode="pair")
        ms = cuda_ms(lambda: sa_kernel.sa_pair_pool(*random_w3, **pair_kw), 5)
        win_ms = cuda_ms(lambda: sa_kernel.sa_pair_pool_winners(*random_w3, **pair_kw), 5)
        print(f"pool tie check SA{layer} widths {widths}, W={window}: all six variants equal "
              f"the plain version and the tie rule at every one of {got_w.numel()} (center, "
              f"channel) pairs with W3 = 0; {int(empty.sum())} centers with no point in "
              f"radius give -1e9 and rank 0; {clamped} windows clamped at N - W; with a "
              f"random W3 within 0.03 of the plain version; pair pool {ms:.4f} ms, with "
              f"winners {win_ms:.4f} ms (batch {B}, {n_centers} centers, "
              f"{dense_flops(random_w3, kw) / ms / 1e9:.1f} TFLOP/s over the dense window work)")


def bwd_edge_inputs(B=2, N=2048, M=1024, window=256, widths=(128, 128, 256), seed=0,
                    tie_pool=None):
    """A pool-backward input with the row packing's edge cases, in every block
    of 16 centers (center m, kind m % 16):
    kind 0: one point wins every channel (windowed: one row carrying all c3);
    kind 1: every channel won by a different point (c3 rows, several tiles;
    where the window is narrower than c3, each of its W points wins a channel
    or two: W rows);
    kind 2: the odd channels won outside the window (compact: zero A rows);
    other kinds: random in-window winners, 20% of the cotangents 0; with
    ``tie_pool`` drawn from the window's first ``tie_pool`` points only, so
    that the rows of many centers and channels tie on one point.
    Every fourth block has g = 0 everywhere (no live row), and the last two
    blocks' windows are clamped at N - W. Returns (args, kw), CPU tensors,
    ``kw`` without the variant; needs N - W >= c3."""
    from eda_tpu_torch.ops.cuda.sa_kernel import BLOCK, window_starts

    c1, c2, c3 = widths
    gen = torch.Generator().manual_seed(seed)
    n_blocks = M // BLOCK
    starts = (torch.arange(n_blocks) * (N - window) // max(n_blocks - 1, 1)).repeat(B, 1)
    starts[:, -2:] = N  # clamped to N - W
    start = window_starts(starts, N, window).repeat_interleave(BLOCK, dim=1)[..., None]
    kind = (torch.arange(M) % BLOCK)[None, :, None]
    chan = torch.arange(c3)
    winners = start + torch.randint(0, tie_pool or window, (B, M, c3), generator=gen)
    winners = torch.where(kind == 0, winners[..., :1], winners)
    distinct = torch.rand(B, M, max(window, c3), generator=gen).argsort(-1)[..., :c3] % window
    winners = torch.where(kind == 1, start + distinct, winners)
    outside = torch.where(start + window + chan < N, start + window + chan, start - 1 - chan)
    winners = torch.where((kind == 2) & (chan % 2 == 1), outside, winners)
    g = torch.randn(B, M, c3, generator=gen)
    g = torch.where((kind > 2) & (torch.rand(B, M, c3, generator=gen) < 0.2), 0.0, g)
    g = torch.where(((torch.arange(M) // BLOCK) % 4 == 3)[None, :, None], 0.0, g)
    args = (torch.randn(B, N, c1, generator=gen).bfloat16(),
            torch.randn(B, M, c1, generator=gen).bfloat16(), g, winners.int(), starts.int(),
            torch.randn(c1, c2, generator=gen) * 0.1, torch.randn(c2, generator=gen) * 0.1,
            1 + 0.1 * torch.randn(c2, generator=gen), torch.randn(c2, generator=gen) * 0.1,
            torch.randn(c2, c3, generator=gen) * 0.1)
    return args, {"window": window}


# pool backward edge inputs: (layer, widths, N, M, window[, tie pool]). The
# full-width SA2 layer at the flagship window and at 512, SA1's widths at 2048
# (both variants called directly; the model picks compact at both), the tiny
# SA1 triple, and the width-4 backbone's SA1 shape, (256, 256, 512) at W = 1024
# over 50 000 points (its compact rows on csrc/sa_pair_pool_bwd_wide_compact.cu:
# blocks of centers with up to 512 positions each, with none, with a
# position for all winners outside the window), once with the random winners
# drawn from a window's first 4 points (rows of many centers and channels tied
# on one point)
BWD_EDGE_CASES = ((2, (128, 128, 256), 2048, 1024, 256), (2, (128, 128, 256), 2048, 1024, 512),
                  (1, (64, 64, 128), 4096, 2048, 2048), (1, (16, 16, 32), 512, 128, 64),
                  (1, (256, 256, 512), 50000, 2048, 1024),
                  (1, (256, 256, 512), 50000, 2048, 1024, 4))


def bwd_symbol(compact: bool, xl: bool = False, wide: bool = False) -> str:
    """The pool backward symbol of a variant at the XL widths, the WIDE ones or below."""
    if compact and wide and not xl:
        return POOL_BWD_WC
    symbols = POOL_BWD_XL if xl else POOL_BWD
    return symbols[0] if compact else symbols[1]


@torch.no_grad()
def pool_bwd_edge_check(cases=BWD_EDGE_CASES) -> None:
    """K5 and K6 against the plain version on ``bwd_edge_inputs`` of each
    entry of ``cases`` ((layer, widths, N, M, window[, tie pool])), within the
    step's tolerances, every output bit for bit on a second launch."""
    from eda_tpu_torch.ops.cuda import sa_pool_bwd

    for layer, widths, n_points, n_centers, window, *tie in cases:
        args, kw = bwd_edge_inputs(N=n_points, M=n_centers, window=window, widths=widths,
                                   tie_pool=tie[0] if tie else None)
        args = tuple(a.cuda() for a in args)
        for compact in (True, False):
            ckw = dict(kw, compact=compact)
            rows = center_rows(args, ckw)
            got = sa_pool_bwd.sa_pool_bwd(*args, **ckw)
            again = sa_pool_bwd.sa_pool_bwd(*args, **ckw)
            want = sa_pool_bwd.sa_pool_bwd_plain(*args, **ckw)
            torch.cuda.synchronize()
            check_kernel(bwd_symbol(compact), got, want, layer)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"pool backward edge check SA{layer} W={window}: an "
                                     f"output differs between two launches")
            empty = int((rows.view(rows.shape[0], -1, 16).sum(-1) == 0).sum())
            print(f"pool backward edge check SA{layer} widths {widths}, W={window}, "
                  f"{'compact' if compact else 'windowed'}: within tolerance, bit-identical "
                  f"on a second launch; live rows per center {int(rows.min())}-"
                  f"{int(rows.max())}, {empty} blocks without a live row, {int(rows.sum())} "
                  f"rows in all")


# pool widths inputs: (layer, widths, N, M, window), triples outside the
# instantiated WIDTHS that the wrappers pad: an SA1-shaped input at W = 1024
# and SA2-shaped ones at W = 256 (the last padded on the wide kernel); and the
# wide triple itself at W = 1024, where the model picks the compact backward
# (c3 512 < W)
WIDTH_CASES = ((1, (48, 48, 96), 8192, 2048, 1024), (2, (96, 80, 200), 2048, 1024, 256),
               (2, (192, 160, 384), 2048, 1024, 256), (1, (256, 256, 512), 8192, 2048, 1024))
# triples above (256, 256, 512), which run padded on XL (512, 512, 1024), the
# serving and winners pools and the backward: SA2-shaped inputs at W = 256,
# batch 2 (layer, widths, N, M, window)
XL_WIDTH_CASES = ((2, (384, 384, 768), 2048, 1024, 256), (2, (300, 300, 600), 2048, 1024, 256),
                  (2, (288, 256, 512), 2048, 1024, 256))
XL_WIDTH_BATCH = 2
# triples above the widest instantiation, XL, which must raise on CUDA, naming
# the ROADMAP item of wider layers
TOO_WIDE = ((576, 512, 1024), (512, 544, 1024), (512, 512, 1040))


def random_w3(args, seed: int):
    """``tie_inputs`` args with a random W3 in place of its zeros."""
    g = torch.Generator().manual_seed(seed)
    w3 = torch.randn(args[9].shape, generator=g) * 0.1
    return args[:9] + (w3.to(args[9].device),) + args[10:]


@torch.no_grad()
def pool_widths_check() -> None:
    """The six pool variants and K5 / K6 at each ``WIDTH_CASES`` triple, which
    runs zero-padded on the next instantiated triple (or on its own), against
    the plain versions at the real widths under the tolerances of the
    full-width checks; the same at each ``XL_WIDTH_CASES`` triple (padded on
    XL: the six pool variants and the XL backward); every ``TOO_WIDE`` triple
    raises the error naming ``sa_kernel.WIDER_ITEM`` before any launch."""
    from eda_tpu_torch.ops.cuda import sa_kernel, sa_mask, sa_pool_bwd

    for layer, widths, n_points, n_centers, window in WIDTH_CASES:
        args, kw = tie_inputs(N=n_points, M=n_centers, window=window, widths=widths)
        args = tuple(a.cuda() for a in random_w3(args, layer))
        mask = sa_mask.sa_radius_mask(args[1], args[3], args[4], **kw)
        for mode in sa_kernel.D2_MODES:
            mkw = dict(kw, d2_mode=mode, mask=mask if mode == "pre" else None)
            want = sa_kernel.sa_pair_pool_winners_plain(*args, **mkw, runner_up=True)
            got = sa_kernel.sa_pair_pool(*args, **mkw)
            got_w = sa_kernel.sa_pair_pool_winners(*args, **mkw)
            torch.cuda.synchronize()
            if got.shape != want[0].shape or got_w[1].shape != want[1].shape:
                raise AssertionError(f"pool widths {widths}: output shapes differ")
            err = check_kernel(pool_symbol(mode, False), got, want[0], layer)
            check_kernel(pool_symbol(mode, True), got_w, want, layer)
            print(f"pool widths SA{layer} {widths} (runs on "
                  f"{sa_kernel.kernel_widths(*widths)}), W={window}, {mode}: within 0.03 of the "
                  f"plain version (max err {err:.2e}), winners as the plain version's")
        bargs, bkw = bwd_edge_inputs(N=n_points, M=n_centers, window=window, widths=widths)
        bargs = tuple(a.cuda() for a in bargs)
        for compact in (True, False):
            ckw = dict(bkw, compact=compact)
            got = sa_pool_bwd.sa_pool_bwd(*bargs, **ckw)
            want = sa_pool_bwd.sa_pool_bwd_plain(*bargs, **ckw)
            torch.cuda.synchronize()
            if any(g.shape != w.shape for g, w in zip(got, want)):
                raise AssertionError(f"pool backward widths {widths}: output shapes differ")
            check_kernel(bwd_symbol(compact), got, want, layer)
            print(f"pool widths SA{layer} {widths}, W={window}, "
                  f"{'compact' if compact else 'windowed'} backward: within tolerance")
    for layer, widths, n_points, n_centers, window in XL_WIDTH_CASES:
        args, kw = tie_inputs(B=XL_WIDTH_BATCH, N=n_points, M=n_centers, window=window,
                              widths=widths)
        args = tuple(a.cuda() for a in random_w3(args, layer))
        mask = sa_mask.sa_radius_mask(args[1], args[3], args[4], **kw)
        for mode in sa_kernel.D2_MODES:
            mkw = dict(kw, d2_mode=mode, mask=mask if mode == "pre" else None)
            want = sa_kernel.sa_pair_pool_winners_plain(*args, **mkw, runner_up=True)
            got = sa_kernel.sa_pair_pool(*args, **mkw)
            got_w = sa_kernel.sa_pair_pool_winners(*args, **mkw)
            torch.cuda.synchronize()
            if got.shape != want[0].shape or got_w[1].shape != want[1].shape:
                raise AssertionError(f"pool widths {widths}: output shapes differ")
            err = check_kernel(pool_symbol_xl(mode), got, want[0], layer)
            check_kernel(pool_symbol_xl(mode, True), got_w, want, layer)
            print(f"pool widths SA{layer} {widths} (runs on "
                  f"{sa_kernel.kernel_widths(*widths)}), W={window}, {mode}: within 0.03 of the "
                  f"plain version (max err {err:.2e}), winners as the plain version's")
        bargs, bkw = bwd_edge_inputs(B=1, N=2048, M=64, window=512, widths=widths)
        bargs = tuple(a.cuda() for a in bargs)
        for compact in (True, False):
            ckw = dict(bkw, compact=compact)
            got = sa_pool_bwd.sa_pool_bwd(*bargs, **ckw)
            want = sa_pool_bwd.sa_pool_bwd_plain(*bargs, **ckw)
            torch.cuda.synchronize()
            if any(g.shape != w.shape for g, w in zip(got, want)):
                raise AssertionError(f"pool backward widths {widths}: output shapes differ")
            check_kernel(bwd_symbol(compact, xl=True), got, want, layer)
            print(f"pool widths SA{layer} {widths}, W=512, "
                  f"{'compact' if compact else 'windowed'} backward: within tolerance")
    for widths in TOO_WIDE:
        args, kw = tie_inputs(B=1, N=2048, M=64, window=512, widths=widths)
        bargs, bkw = bwd_edge_inputs(B=1, N=2048, M=64, window=512, widths=widths)
        args, bargs = (tuple(a.cuda() for a in t) for t in (args, bargs))
        for what, fn in (("pool", lambda: sa_kernel.sa_pair_pool(*args, **kw, d2_mode="pair")),
                         ("winners pool", lambda: sa_kernel.sa_pair_pool_winners(
                             *args, **kw, d2_mode="pair")),
                         ("pool backward",
                          lambda: sa_pool_bwd.sa_pool_bwd(*bargs, **bkw, compact=False))):
            before = launch_counts()
            try:
                fn()
            except ValueError as err:
                if sa_kernel.WIDER_ITEM not in str(err):
                    raise
                check_launches(before, {}, f"{what} at widths {widths}")
                continue
            raise AssertionError(f"{what} at widths {widths} did not raise on CUDA")
    print(f"pool widths above {sa_kernel.WIDTHS[-1]}: {TOO_WIDE} raise the error naming "
          f"{sa_kernel.WIDER_ITEM} on CUDA before any launch: pool, winners pool and backward")


# FPS edge inputs: CPU clouds and their sample counts
def fps_edge_inputs(seed=0) -> dict:
    """name -> ((B, N, 3) f32 CPU cloud, npoint): the FPS kernel's edge cases.

    Points on a 4 x 4 x 4 grid, each twice (duplicates, and many points at
    equal distance from every pick); a row with a zero-padded tail, an
    all-padding row and a row padded from 700; 20 000 points (the kernel's
    scratch variant: too many for registers); N = 1001 and 8191, no multiple
    of 32 or of any cluster size."""
    g = torch.Generator().manual_seed(seed)
    grid = torch.randint(0, 4, (2, 500, 3), generator=g).float() - 1.5
    padded = torch.rand(3, 1500, 3, generator=g) * 8 - 4
    padded[0, 1200:] = 0
    padded[1] = 0
    padded[2, 700:] = 0
    return {
        "duplicates and equal-distance ties, N=1000": (torch.cat([grid, grid], 1), 300),
        "zero-padded tails and an all-padding row, N=1500": (padded, 400),
        "N=20000, the scratch variant": (torch.rand(2, 20000, 3, generator=g) * 8 - 4, 256),
        "N=1001": (torch.rand(3, 1001, 3, generator=g) * 8 - 4, 333),
        "N=8191": (torch.rand(2, 8191, 3, generator=g) * 8 - 4, 1024),
    }


FPS_CLUSTERS = (1, 2, 4, 8)


@torch.no_grad()
def fps_edge_check() -> None:
    """The FPS kernel bit-exact against its plain version on every
    ``fps_edge_inputs`` case, at the cluster size it picks and at each of
    ``FPS_CLUSTERS``."""
    from eda_tpu_torch.ops.cuda import fps

    for name, (xyz, npoint) in fps_edge_inputs().items():
        xyz = xyz.cuda()
        want = fps.fps_plain(xyz, npoint)
        for cluster in (0,) + FPS_CLUSTERS:
            got = fps.fps_cluster(xyz, npoint, cluster)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"fps edge check {name}: cluster {cluster} differs from "
                                     f"the plain version")
        print(f"fps edge check {name}: bit-exact at the kernel's cluster size "
              f"({fps.cluster_size(xyz.shape[1])}) and at {FPS_CLUSTERS}")


@torch.no_grad()
def fps_sweep(calls) -> None:
    """Each FPS call of the forward at every cluster size: bit-exact against
    the plain version; ms and microseconds per serial step."""
    from eda_tpu_torch.ops.cuda import fps

    for layer, (args, kw) in enumerate(calls, 1):
        xyz, npoint = args
        want = fps.fps_plain(xyz, npoint)
        parts = []
        for cluster in FPS_CLUSTERS:
            got = fps.fps_cluster(xyz, npoint, cluster)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"fps sweep SA{layer}: cluster {cluster} differs from the "
                                     f"plain version")
            ms = cuda_ms(lambda: fps.fps_cluster(xyz, npoint, cluster), 20)
            parts.append(f"{cluster}: {ms:.4f} ms, {1e3 * ms / (npoint - 1):.3f} us/step")
        print(f"fps sweep SA{layer} (B={xyz.shape[0]}, N={xyz.shape[1]}, M={npoint}), CTAs a "
              f"row {'; '.join(parts)}; the kernel takes {fps.cluster_size(xyz.shape[1])}")


def prep_bwd_edge_inputs(seed=0) -> dict:
    """name -> ((pts, dA, w1, b1, scale) CPU tensors, radius): the prep
    backward's edge cases. Row counts that are no multiple of the kernel's
    64-row tile at SA1's and SA3's widths and at the width-2 backbone's SA2 and
    SA3 (in_dim 259 and 515 at c1 256, the latter with W1 streamed) and the
    largest in_dim, 2048 (W1 and P in four K chunks); the width-2 backbone's
    SA1 (in_dim 6 at c1 128, dW1 held) over more 64-row tiles than the kernel
    has CTAs (so that a CTA holds several tiles' sums) and its SA2 over more
    tiles than the cluster kernel has clusters (each adding several tiles into
    its record); an odd c1 above 64 at K = 16 (the record path, not the held
    one); the tiny config's widths
    (in_dim 6 / 35 / 67, c1 16 / 32); a zero cotangent; points of large
    magnitude; above c1 256 (csrc/sa_prep_bwd_512.cu) the width-4 backbone's
    SA2 and SA3 / SA4 widths (in_dim 515 and 1027 at c1 512) at ragged rows
    and an odd c1 of 300."""
    g = torch.Generator().manual_seed(seed)

    def case(B, N, in_dim, c1, radius, scale_xyz=4.0, scale_f=1.0, zero=False):
        pts = torch.cat([(torch.rand(B, N, 3, generator=g) * 2 - 1) * scale_xyz,
                         torch.randn(B, N, in_dim - 3, generator=g) * scale_f], -1)
        dA = torch.zeros(B, N, c1) if zero else torch.randn(B, N, c1, generator=g)
        w1 = torch.randn(in_dim, c1, generator=g) * in_dim ** -0.5
        b1 = torch.randn(c1, generator=g) * 0.1
        scale = 1 + 0.1 * torch.randn(c1, generator=g)
        return (pts, dA.bfloat16(), w1, b1, scale), radius

    return {
        "SA1 widths (6, 64), 1000 rows": case(1, 1000, 6, 64, 0.2),
        "W2X SA1 widths (6, 128), 70 001 rows": case(1, 70001, 6, 128, 0.2),
        "SA3 widths (259, 128), 3 x 77 rows": case(3, 77, 259, 128, 0.8),
        "tiny SA1 widths (6, 16), 2 x 1000 rows": case(2, 1000, 6, 16, 0.2),
        "tiny SA2 widths (35, 32), 2 x 250 rows": case(2, 250, 35, 32, 0.4),
        "tiny SA3 widths (67, 32), 2 x 100 rows": case(2, 100, 67, 32, 0.8),
        "zero dA, SA2 widths (131, 128)": case(2, 300, 131, 128, 0.4, zero=True),
        "W2X SA2 widths (259, 256), 1 x 130 rows": case(1, 130, 259, 256, 0.4),
        "W2X SA2 widths (259, 256), 40 001 rows": case(1, 40001, 259, 256, 0.4),
        "odd c1 at K 16 (6, 127), 2 x 1000 rows": case(2, 1000, 6, 127, 0.2),
        "W2X SA3 widths (515, 256), 2 x 77 rows": case(2, 77, 515, 256, 0.8),
        "the largest in_dim (2048, 256), 1 x 70 rows": case(1, 70, 2048, 256, 1.2),
        "large-magnitude points, SA1 widths": case(1, 4100, 6, 64, 0.2, 500.0, 50.0),
        "W4X SA2 widths (515, 512), 2 x 2049 rows": case(2, 2049, 515, 512, 0.4),
        "W4X SA3 widths (1027, 512), 1 x 4097 rows": case(1, 4097, 1027, 512, 0.8),
        "odd c1 above 256 (303, 300), 2 x 77 rows": case(2, 77, 303, 300, 0.4),
    }


@torch.no_grad()
def prep_bwd_edge_check() -> None:
    """K7 against its plain version on every ``prep_bwd_edge_inputs`` case,
    within ``PREP_BWD_REL``, and every output bit-identical on a second
    launch; above c1 256 also K7f (dA unrounded) within ``PREP_F32_BWD_REL``."""
    from eda_tpu_torch.ops.cuda import sa_prep

    for name, (args, radius) in prep_bwd_edge_inputs().items():
        args = tuple(a.cuda() for a in args)
        dtypes = (torch.bfloat16,) + ((torch.float32,) if args[2].shape[1] > sa_prep.WIDE_C1
                                      else ())
        for dtype in dtypes:
            kw = dict(radius=radius, compute_dtype=dtype)
            got = sa_prep.sa_prep_bwd(*args, **kw)
            again = sa_prep.sa_prep_bwd(*args, **kw)
            want = sa_prep.sa_prep_bwd_plain(*args, **kw)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            tol = PREP_F32_BWD_REL if dtype == torch.float32 else PREP_BWD_REL
            if max(errs) > tol or not all(torch.isfinite(a).all() for a in got):
                raise AssertionError(f"prep backward edge check {name} ({dtype}): {errs}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"prep backward edge check {name} ({dtype}): an output "
                                     f"differs between two launches")
            print(f"prep backward edge check {name}{' (K7f)' if dtype == torch.float32 else ''}"
                  f": errors relative to each output's largest value "
                  f"{[f'{e:.2e}' for e in errs]}; dpts, dW1, db1, dscale, dlnb bit-identical "
                  f"on a second launch")


# the prep forward's edge widths: c1 with its instantiation's padding, in_dim
# at 3 and at the kernel's largest
PREP_EDGE_C1 = (16, 48, 64, 128, 256)
# rows of the cluster route's wrapping edge case: more 64-row tiles (257) than
# the clusters a card holds, the last of 8 rows
W2X_WRAP_ROWS = 16_392


def prep_edge_inputs(max_in_dim, seed=0, cluster_max=None) -> dict:
    """name -> ((pts, w1, b1, scale, lnb) CPU tensors, radius): the prep
    forward's edge cases. ``max_in_dim(c1)`` is the kernel's largest in_dim.
    Each c1 of ``PREP_EDGE_C1`` at in_dim 3 and at ``max_in_dim(c1)``; row
    counts that are no multiple of the 64-point tile (and fewer than one tile);
    SA1's and SA3's widths at ragged row counts, the width-2 backbone's SA3
    over 126 tiles; coordinates and features of large magnitude. At the
    width-2 backbone's widths (``w2x_prep``; in_dim 515 on the cluster route,
    259 beside it): fewer tiles than the clusters the card holds (1 x 3 and 1
    x 130 rows), more (``W2X_WRAP_ROWS``, the persistent clusters wrapping, a
    ragged last tile), SA4's 4 096 rows, and, given ``cluster_max(c1)``, the
    route's largest in_dim and one past it (W1 streamed on one CTA)."""
    g = torch.Generator().manual_seed(seed)

    def case(B, N, in_dim, c1, radius, scale_xyz=4.0, scale_f=1.0):
        pts = torch.cat([(torch.rand(B, N, 3, generator=g) * 2 - 1) * scale_xyz,
                         torch.randn(B, N, in_dim - 3, generator=g) * scale_f], -1)
        w1 = torch.randn(in_dim, c1, generator=g) * in_dim ** -0.5
        b1 = torch.randn(c1, generator=g) * 0.1
        scale = 1 + 0.1 * torch.randn(c1, generator=g)
        lnb = 0.1 * torch.randn(c1, generator=g)
        return (pts, w1, b1, scale, lnb), radius

    cases = {}
    for c1 in PREP_EDGE_C1:
        cases[f"c1 {c1}, in_dim 3, 2 x 100 rows"] = case(2, 100, 3, c1, 0.2)
        top = max_in_dim(c1)
        cases[f"c1 {c1}, in_dim {top} (the largest), 130 rows"] = case(1, 130, top, c1, 0.4)
    cases["SA1 widths (6, 64), 3 x 1001 rows"] = case(3, 1001, 6, 64, 0.2)
    cases["SA3 widths (259, 128), 2 x 77 rows"] = case(2, 77, 259, 128, 0.8)
    cases["SA2 widths (131, 128), 1 x 40 rows"] = case(1, 40, 131, 128, 0.4)
    # the width-2 backbone's SA2-4 widths on the cluster route
    cases["W2X SA3 widths (515, 256), 8 x 1001 rows"] = case(8, 1001, 515, 256, 0.8)
    for in_dim, radius in ((259, 0.4), (515, 0.8)):
        for B, N in ((1, 3), (1, 130), (1, W2X_WRAP_ROWS)):
            cases[f"W2X widths ({in_dim}, 256), {B} x {N} rows"] = case(B, N, in_dim, 256, radius)
    cases["W2X SA4 widths (515, 256), 1 x 4096 rows"] = case(1, 4096, 515, 256, 1.2)
    if cluster_max is not None:
        top = cluster_max(256)
        for in_dim, what in ((top, "the cluster route's largest"), (top + 1, "one past it")):
            cases[f"c1 256, in_dim {in_dim} ({what}), 130 rows"] = case(1, 130, in_dim, 256, 0.4)
    cases["large-magnitude points, SA1 widths, 4100 rows"] = case(1, 4100, 6, 64, 0.2,
                                                                    500.0, 50.0)
    cases["large-magnitude points, SA2 widths, 300 rows"] = case(1, 300, 131, 128, 0.4,
                                                                   500.0, 50.0)
    return cases


def w2x_prep(in_dim: int, c1: int) -> bool:
    """The width-2 backbone's prep widths and those around the bf16 forward's
    cluster route (c1 256, in_dim 433 up to ``sa_prep.cluster_max_in_dim``):
    the "w2x" phase's edge cases."""
    return c1 == 256 and in_dim >= 256


@torch.no_grad()
def prep_edge_check(wide: bool = False) -> None:
    """K2 against its plain version on the ``prep_edge_inputs`` cases at the
    width-2 backbone's c1 256 (``wide``: ``w2x_prep``) or the others, within
    0.02 plus one bf16 step of the value, and bit-identical on a second
    launch."""
    from eda_tpu_torch.ops.cuda import sa_prep

    for name, (args, radius) in prep_edge_inputs(
            sa_prep.max_in_dim, cluster_max=sa_prep.cluster_max_in_dim).items():
        if w2x_prep(*args[1].shape) != wide:
            continue
        args = tuple(a.cuda() for a in args)
        got = sa_prep.sa_prep(*args, radius=radius)
        again = sa_prep.sa_prep(*args, radius=radius)
        want = sa_prep.sa_prep_plain(*args, radius=radius)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"prep edge check {name}: shape {tuple(got.shape)}")
        err = check_kernel("sa_prep_launch", got, want, 0)
        if not torch.equal(got, again):
            raise AssertionError(f"prep edge check {name}: A differs between two launches")
        print(f"prep edge check {name}: max err {err:.3e}, bit-identical on a second launch")


def mask_edge_inputs(seed=0) -> dict:
    """name -> ((xyz, cen, starts) CPU tensors, radius, window): the radius
    mask's edge cases. Windows that are no multiple of a CTA's rows (1100
    from the 1024-row CTAs of W >= 1024 up, 200 and 1000 below); starts below
    0 and past N - W (clamped, with N - W no multiple of 16 and N no multiple
    of 4, so the windows' points lie unaligned); a single block of 16 centers; and
    points within 1e-5 of the radius of their block's centers."""
    g = torch.Generator().manual_seed(seed)

    def case(B, N, M, window, radius, clamp=False):
        xyz = torch.sort(torch.rand(B, N, 3, generator=g) * 4, dim=1).values.contiguous()
        ranks = torch.sort(torch.rand(B, N, generator=g).argsort(1)[:, :M], dim=1).values
        cen = xyz.gather(1, ranks[..., None].expand(-1, -1, 3)).clone()
        starts = (ranks.view(B, M // 16, 16)[:, :, 8] - window // 2).clamp(min=0)
        if clamp:
            starts[:, -2:] = N  # past N - W: clamped there
            starts[:, 0] = -5  # below 0: floored to -16, clamped to 0
        return (xyz, cen, starts.int()), radius, window

    cases = {
        "W=1100 (1024-row CTAs), N=5000": case(2, 5000, 256, 1100, 0.3),
        "W=200 (256-row CTAs), N=2048": case(2, 2048, 128, 200, 0.4),
        "W=1000, N=1003, clamped starts": case(2, 1003, 64, 1000, 0.5, clamp=True),
        "W=256, N=1001, clamped starts": case(3, 1001, 96, 256, 0.4, clamp=True),
        "a single block, W=64, N=64": case(1, 64, 16, 64, 0.6),
    }
    # points on the radius: every window point of block 0 moved to the sphere
    # of radius r about its first center, up to 1e-6 of f32 rounding
    (xyz, cen, starts), radius, window = case(2, 2048, 64, 256, 0.5)
    start = torch.clamp((starts // 16) * 16, 0, 2048 - window)
    for b in range(2):
        s = int(start[b, 0])
        d = torch.randn(window, 3, generator=g)
        d = d / d.norm(dim=-1, keepdim=True) * (radius + 2e-6 * torch.randn(window, 1,
                                                                             generator=g))
        xyz[b, s:s + window] = cen[b, 0] + d
    cases["points within 1e-5 of the radius, W=256"] = ((xyz, cen, starts), radius, window)
    return cases


@torch.no_grad()
def mask_edge_check() -> None:
    """K9a bit-exact against its plain version on every ``mask_edge_inputs``
    case."""
    from eda_tpu_torch.ops.cuda import sa_mask

    for name, (args, radius, window) in mask_edge_inputs().items():
        args = tuple(a.cuda() for a in args)
        got = sa_mask.sa_radius_mask(*args, radius=radius, window=window)
        want = sa_mask.sa_radius_mask_plain(*args, radius=radius, window=window)
        torch.cuda.synchronize()
        check_kernel(MASK, got, want, 0)
        near = int(boundary_centers(args[0], args[1], args[2], radius, window).sum())
        print(f"mask edge check {name}: bit-exact, {int(want.sum())} of {want.numel()} "
              f"(row, center) pairs in radius; {near} centers with a window point within "
              f"{BOUNDARY} of the radius")


# the flagship's prep widths (in_dim, c1) at SA1-SA4 with RGB, and the tiny config's
F32_PREP_WIDTHS = ((6, 64), (131, 128), (259, 128), (259, 128))
TINY_PREP_WIDTHS = ((6, 16), (35, 32), (67, 32))
# K2f / K7f against their plain versions, as tests/test_sa_prep.py holds the f32
# Pallas prep: A within 2e-5 abs (plus, per row, the one-pass variance's
# cancellation: PREP_F32_ULPS f32 steps of the row's (S2 / c1) / var times
# |A| + 1), each gradient within 1e-4 of its largest value
PREP_F32_ATOL, PREP_F32_BWD_REL, PREP_F32_ULPS = 2e-5, 1e-4, 64
TILE_EDGE_ROWS = (63, 64, 65, 129)  # around the 64-row tiles of csrc/sa_prep_f32.cu
MANY_TILE_ROWS = {1: 299_969, 2: 40_001}  # SA1 / SA2 widths: several tiles a CTA
# widths that are no multiple of 8 (the tensor route's) or of 4 (the CUDA-core route's),
# on each route below and above c1 128
ODD_PREP_WIDTHS = ((12, 21), (7, 30), (6, 150), (131, 250), (35, 201), (259, 129))
# the width-2 backbone's f32 prep widths at SA1-SA4 with RGB: SA2-4 on the
# tensor route at c1 256, their backward direct
W2X_F32_PREP_WIDTHS = ((6, 128), (259, 256), (515, 256), (515, 256))
W2X_SA3_ROWS = 8 * 1024  # W2X SA3's rows at batch 8: on the forward's cluster route two tiles a set
# by c1, the least in_dim the f32 prep kernels must take, forward / backward:
# at 128 the previous kernels' limits, at 256 the width-2 backbone's SA3-4
PREP_F32_MIN_LIMITS = {128: (358, 333), 256: (515, 515)}


def wide_prep(in_dim: int, c1: int) -> bool:
    """The f32 prep runs these widths on its tensor route above c1 128."""
    return in_dim > 8 and c1 > 128


def prep_f32_edge_inputs(seed=0, cluster_tiles=None) -> dict:
    """name -> ((pts, w1, b1, scale, lnb, dA) CPU tensors, radius): the f32 prep's
    edge cases. Each flagship layer's widths at a ragged row count (no multiple
    of a 64-row tile); SA1's and SA2's at 63, 64, 65 and 129 rows (tile
    boundaries; SA2's in_dim needs five K chunks of the tensor route) and at
    ``MANY_TILE_ROWS`` (several tiles a CTA, the rings wrapping, a last tile
    of one row); the width-2 backbone's SA2 and SA3 widths (c1 256) at a
    ragged row count, SA2's also at the tile edges and ``MANY_TILE_ROWS[2]``,
    SA3's at 3 rows, the tile edges and batch 8's ``W2X_SA3_ROWS`` (the
    forward's cluster route with one warpgroup a cluster, with two, one of
    them idle in the last set, and many sets a cluster); the tiny config's
    widths over several tiles and within one; widths that are no multiple of
    8 (tensor route) or 4 (CUDA-core route), below and above c1 128 (c1 129:
    one column in the cluster forward's second CTA); points of large
    magnitude; dA in f32 with values that bf16 does not hold. Around the
    backward's cluster route
    (c1 256, any in_dim it takes, no more tiles than the clusters the card
    holds): 3 and 129 rows and SA4's 4 096 (on it), 40 001 rows (a last tile
    of one row, the direct backward), and, given ``cluster_tiles``, the
    route's most 64-row tiles (a ragged last one) and one tile more (the
    direct backward) at W2X SA3's widths; its largest in_dim is the
    backward's (``prep_f32_limit_check``)."""
    g = torch.Generator().manual_seed(seed)

    def case(B, N, in_dim, c1, radius, scale_xyz=4.0, scale_f=1.0):
        pts = torch.cat([(torch.rand(B, N, 3, generator=g) * 2 - 1) * scale_xyz,
                         torch.randn(B, N, in_dim - 3, generator=g) * scale_f], -1)
        w1 = torch.randn(in_dim, c1, generator=g) * in_dim ** -0.5
        b1 = torch.randn(c1, generator=g) * 0.1
        scale = 1 + 0.1 * torch.randn(c1, generator=g)
        lnb = 0.1 * torch.randn(c1, generator=g)
        dA = torch.randn(B, N, c1, generator=g)
        return (pts, w1, b1, scale, lnb, dA), radius

    cases = {}
    for layer, ((in_dim, c1), radius) in enumerate(zip(F32_PREP_WIDTHS, (0.2, 0.4, 0.8, 1.2)), 1):
        cases[f"SA{layer} widths ({in_dim}, {c1}), 2 x 2049 rows"] = case(2, 2049, in_dim, c1,
                                                                          radius)
    for layer, (in_dim, c1) in ((1, F32_PREP_WIDTHS[0]), (2, F32_PREP_WIDTHS[1])):
        for rows in TILE_EDGE_ROWS + (MANY_TILE_ROWS[layer],):
            cases[f"SA{layer} widths, 1 x {rows} rows"] = case(1, rows, in_dim, c1, 0.4)
    for layer, radius in ((2, 0.4), (3, 0.8)):
        in_dim, c1 = W2X_F32_PREP_WIDTHS[layer - 1]
        cases[f"W2X SA{layer} widths ({in_dim}, {c1}), 2 x 2049 rows"] = case(2, 2049, in_dim,
                                                                              c1, radius)
    for rows in TILE_EDGE_ROWS + (MANY_TILE_ROWS[2],):
        cases[f"W2X SA2 widths, 1 x {rows} rows"] = case(1, rows, *W2X_F32_PREP_WIDTHS[1], 0.4)
    cases["W2X SA3 widths, 1 x 3 rows"] = case(1, 3, *W2X_F32_PREP_WIDTHS[2], 0.8)
    for rows in TILE_EDGE_ROWS + (W2X_SA3_ROWS,):
        cases[f"W2X SA3 widths, 1 x {rows} rows"] = case(1, rows, *W2X_F32_PREP_WIDTHS[2], 0.8)
    cases["W2X SA4 widths, 1 x 4096 rows"] = case(1, 4096, *W2X_F32_PREP_WIDTHS[3], 1.2)
    if cluster_tiles is not None:
        for rows, what in ((64 * cluster_tiles - 5, "the cluster route's most tiles"),
                           (64 * cluster_tiles + 1, "one tile more")):
            cases[f"W2X SA3 widths, 1 x {rows} rows ({what})"] = case(
                1, rows, *W2X_F32_PREP_WIDTHS[2], 0.8)
    for in_dim, c1 in TINY_PREP_WIDTHS:
        cases[f"tiny widths ({in_dim}, {c1}), 3 x 101 rows"] = case(3, 101, in_dim, c1, 0.4)
        cases[f"tiny widths ({in_dim}, {c1}), 1 x 50 rows"] = case(1, 50, in_dim, c1, 0.4)
    for in_dim, c1 in ODD_PREP_WIDTHS:
        cases[f"widths ({in_dim}, {c1}), 2 x 77 rows"] = case(2, 77, in_dim, c1, 0.4)
    cases["SA2 widths, 1 x 3 rows"] = case(1, 3, 131, 128, 0.4)
    cases["large-magnitude points, SA1 widths, 4100 rows"] = case(1, 4100, 6, 64, 0.2,
                                                                    500.0, 50.0)
    return cases


def prep_xl_tolerance(pts, w1, b1, scale, radius):
    """K2 at c1 512, per element, beyond ``check_kernel``'s 0.02 plus one bf16
    step: the LayerNorm's image (rstd |scale|) of two bf16 steps of x. The
    tensor cores sum the 515-2048 products of X in another order than the
    plain version's f32 matmul (within ~1e-6 relative), so bf16(X) may round
    to the other neighbour, and the second rounding, of bf16(X) + bf16(b1),
    can make that two steps of x (one element of 4.1 M at W4X SA3's widths on
    an NVIDIA H100, chip_smoke's W4X edge case: X 2.7e-6 past a midpoint)."""
    from eda_tpu_torch.ops.cuda import sa_prep

    _, x = sa_prep._recompute(pts, w1, b1, radius)
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x * x).mean(-1, keepdim=True) - mean * mean + sa_prep.EPS)
    step = torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126))) - 7)
    return 2 * step * rstd * scale.float().abs()


def prep_f32_tolerance(pts, w1, b1, radius, want):
    """Per element: PREP_F32_ATOL + 1e-4 |A| + the one-pass statistics' cancellation."""
    from eda_tpu_torch.ops.cuda import sa_prep

    _, x = sa_prep._recompute(pts, w1, b1, radius, torch.float32)
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    kappa = (x * x).mean(-1, keepdim=True) / (var + sa_prep.EPS)
    eps = torch.finfo(torch.float32).eps
    return PREP_F32_ATOL + 1e-4 * want.abs() + PREP_F32_ULPS * eps * kappa * (want.abs() + 1)


@torch.no_grad()
def prep_f32_edge_check(wide: bool = False) -> None:
    """K2f and K7f against their plain versions on the ``prep_f32_edge_inputs``
    cases whose widths the tensor route takes above c1 128 (``wide``) or the
    others; K2f's A and K7f's gradients bit-identical on a second launch, K2f
    following an in-place update of W1 where it keeps W1's split
    (``prep_f32_inplace_check``), K7f's dA read unrounded (a bf16-rounded dA
    gives other gradients); then the in_dim limits at c1 256 (``wide``) or 128
    (``prep_f32_limit_check``)."""
    from eda_tpu_torch.ops.cuda import sa_prep

    f32 = dict(compute_dtype=torch.float32)
    cases = prep_f32_edge_inputs(cluster_tiles=sa_prep.cluster_max_tiles_f32())
    for name, (args, radius) in cases.items():
        if wide_prep(*args[1].shape) != wide:
            continue
        pts, w1, b1, scale, lnb, dA = (a.cuda() for a in args)
        got = sa_prep.sa_prep(pts, w1, b1, scale, lnb, radius=radius, **f32)
        again = sa_prep.sa_prep(pts, w1, b1, scale, lnb, radius=radius, **f32)
        want = sa_prep.sa_prep_plain(pts, w1, b1, scale, lnb, radius=radius, **f32)
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or got.shape != want.shape:
            raise AssertionError(f"f32 prep edge check {name}: {got.dtype} {tuple(got.shape)}")
        err = (got - want).abs()
        if not (err <= prep_f32_tolerance(pts, w1, b1, radius, want)).all():
            raise AssertionError(f"f32 prep edge check {name}: K2f off its plain version by "
                                 f"{err.max().item()}")
        if not torch.equal(got, again):
            raise AssertionError(f"f32 prep edge check {name}: K2f's A differs between two "
                                 f"launches")
        rows, (in_dim, c1) = pts.shape[0] * pts.shape[1], w1.shape
        route = sa_prep.f32_forward_route_cuda(rows, in_dim, c1)
        if route != sa_prep.f32_forward_route(rows, in_dim, c1):
            raise AssertionError(f"f32 prep edge check {name}: the library's forward route "
                                 f"{route} is not sa_prep.f32_forward_route's")
        cached = prep_f32_inplace_check(name, pts, w1, b1, scale, lnb, radius)
        bwd = (pts, dA, w1, b1, scale)
        got_b = sa_prep.sa_prep_bwd(*bwd, radius=radius, **f32)
        again = sa_prep.sa_prep_bwd(*bwd, radius=radius, **f32)
        want_b = sa_prep.sa_prep_bwd_plain(*bwd, radius=radius, **f32)
        rounded = sa_prep.sa_prep_bwd(pts, dA.bfloat16().float(), w1, b1, scale, radius=radius,
                                      **f32)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got_b, want_b)]
        if max(errs) > PREP_F32_BWD_REL or not all(torch.isfinite(a).all() for a in got_b):
            raise AssertionError(f"f32 prep backward edge check {name}: {errs}")
        if not all(torch.equal(a, b) for a, b in zip(got_b, again)):
            raise AssertionError(f"f32 prep backward edge check {name}: an output differs "
                                 f"between two launches")
        if torch.equal(rounded[1], got_b[1]):
            raise AssertionError(f"f32 prep backward edge check {name}: dW1 does not see dA "
                                 f"unrounded")
        print(f"f32 prep edge check {name}: K2f ({route}) max err {err.max().item():.3e}, "
              f"bit-identical on a second launch{cached}; K7f errors relative to each "
              f"output's largest value {[f'{e:.2e}' for e in errs]}, bit-identical on a second "
              f"launch, dA read unrounded")
    if wide:
        prep_f32_wrap_check(cases)
    prep_f32_limit_check(256 if wide else 128)


@torch.no_grad()
def prep_f32_inplace_check(name, pts, w1, b1, scale, lnb, radius) -> str:
    """Where K2f takes W1 split once a W1 (its cluster route, c1 above 128), on a
    copy of ``w1``: the split made once and reused while W1 is unchanged; after an
    in-place update of W1 (as the optimizer's step makes) split again, and K2f
    within ``prep_f32_tolerance`` of the plain version on the new W1. Returns
    what it held ("" where the route splits W1 at every launch)."""
    from eda_tpu_torch.ops.cuda import sa_prep

    f32 = dict(compute_dtype=torch.float32, radius=radius)
    rows = pts.shape[0] * pts.shape[1]
    w = w1.clone()
    first = sa_prep.f32_w1_split(rows, w)
    if first is None:
        return ""
    if sa_prep.f32_w1_split(rows, w) is not first:
        raise AssertionError(f"f32 prep in-place check {name}: W1 split again while unchanged")
    w.mul_(-0.75)
    w[0] += 0.5
    got = sa_prep.sa_prep(pts, w, b1, scale, lnb, **f32)
    if sa_prep.f32_w1_split(rows, w) is first:
        raise AssertionError(f"f32 prep in-place check {name}: W1 not split again after an "
                             f"in-place update")
    want = sa_prep.sa_prep_plain(pts, w, b1, scale, lnb, **f32)
    torch.cuda.synchronize()
    err = (got - want).abs()
    if not (err <= prep_f32_tolerance(pts, w, b1, radius, want)).all():
        raise AssertionError(f"f32 prep in-place check {name}: K2f after an in-place update of "
                             f"W1 off its plain version by {err.max().item()}")
    return (f", W1's split reused, and after W1 changed in place split again (max err "
            f"{err.max().item():.3e})")


# clusters of K7f's cluster route in the wrapping check: each takes three or
# four of the route's most tiles
PREP_F32_WRAP_CLUSTERS = 20


@torch.no_grad()
def prep_f32_wrap_check(cases: dict) -> None:
    """K7f on its cluster route with the clusters capped at
    ``PREP_F32_WRAP_CLUSTERS`` (``sa_prep.set_max_clusters_f32``), so that
    they take several tiles in turn, the last ragged (the ``cases`` with the
    route's most tiles): within ``PREP_F32_BWD_REL`` of the plain version and
    bit-identical on a second launch. The cap is lifted after."""
    from eda_tpu_torch.ops.cuda import sa_prep

    f32 = dict(compute_dtype=torch.float32)
    names = [n for n in cases if "the cluster route's most tiles" in n]
    if not names:
        raise AssertionError("f32 prep wrap check: no case with the cluster route's most tiles")
    sa_prep.set_max_clusters_f32(PREP_F32_WRAP_CLUSTERS)
    try:
        for name in names:
            args, radius = cases[name]
            pts, w1, b1, scale, _, dA = (a.cuda() for a in args)
            bwd = (pts, dA, w1, b1, scale)
            got = sa_prep.sa_prep_bwd(*bwd, radius=radius, **f32)
            again = sa_prep.sa_prep_bwd(*bwd, radius=radius, **f32)
            want = sa_prep.sa_prep_bwd_plain(*bwd, radius=radius, **f32)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            if max(errs) > PREP_F32_BWD_REL or not all(torch.isfinite(a).all() for a in got):
                raise AssertionError(f"f32 prep wrap check {name}: {errs}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"f32 prep wrap check {name}: an output differs between "
                                     f"two launches")
            print(f"f32 prep wrap check {name} on {PREP_F32_WRAP_CLUSTERS} clusters: K7f errors "
                  f"{[f'{e:.2e}' for e in errs]}, bit-identical on a second launch")
    finally:
        sa_prep.set_max_clusters_f32(0)


@torch.no_grad()
def prep_f32_limit_check(c1: int) -> None:
    """K2f and K7f at the largest in_dim each takes at ``c1`` (130 rows) against
    their plain versions; the limits no lower than ``PREP_F32_MIN_LIMITS``;
    one more in_dim, K2f and K7f at c1 513 raise (above c1 256 they are the
    c1-512 kernels, ``w4x_prep_edge_check``)."""
    from eda_tpu_torch.ops.cuda import sa_prep

    f32 = dict(compute_dtype=torch.float32, radius=0.4)
    least = PREP_F32_MIN_LIMITS[c1]
    limits = [sa_prep.max_in_dim_f32(c1, backward) for backward in (False, True)]
    if any(got < want for got, want in zip(limits, least)):
        raise AssertionError(f"f32 prep in_dim limits {limits} at c1 {c1}, below {least}")
    g = torch.Generator().manual_seed(1)

    def inputs(in_dim, c1, rows=130):
        """(forward args, backward args) on the card."""
        pts = torch.randn(1, rows, in_dim, generator=g).cuda()
        w1 = (torch.randn(in_dim, c1, generator=g) * in_dim ** -0.5).cuda()
        b1, lnb = (0.1 * torch.randn(2, c1, generator=g)).cuda()
        scale = (1 + 0.1 * torch.randn(c1, generator=g)).cuda()
        dA = torch.randn(1, rows, c1, generator=g).cuda()
        return (pts, w1, b1, scale, lnb), (pts, dA, w1, b1, scale)

    def raises(fn) -> bool:
        try:
            fn()
        except ValueError:
            return True
        return False

    fwd, _ = inputs(limits[0], c1)
    got, want = sa_prep.sa_prep(*fwd, **f32), sa_prep.sa_prep_plain(*fwd, **f32)
    err = (got - want).abs()
    if not (err <= prep_f32_tolerance(*fwd[:3], 0.4, want)).all():
        raise AssertionError(f"f32 prep at ({limits[0]}, {c1}): {err.max().item()}")
    _, bwd = inputs(limits[1], c1)
    errs = [rel_err(a, b) for a, b in zip(sa_prep.sa_prep_bwd(*bwd, **f32),
                                          sa_prep.sa_prep_bwd_plain(*bwd, **f32))]
    if max(errs) > PREP_F32_BWD_REL:
        raise AssertionError(f"f32 prep backward at ({limits[1]}, {c1}): {errs}")
    past = (inputs(limits[0] + 1, c1, 4)[0], inputs(limits[1] + 1, c1, 4)[1],
            inputs(12, sa_prep.XL_C1 + 1, 4)[0], inputs(12, sa_prep.XL_C1 + 1, 4)[1])
    if not all(raises(lambda: fn(*args, **f32)) for fn, args in zip(
            (sa_prep.sa_prep, sa_prep.sa_prep_bwd, sa_prep.sa_prep, sa_prep.sa_prep_bwd), past)):
        raise AssertionError(f"f32 prep past its in_dim limits at c1 {c1}, or K2f or K7f at "
                             f"c1 513 did not raise")
    print(f"f32 prep limit check: at c1 {c1} K2f takes in_dim {limits[0]} (at least "
          f"{least[0]}; max err {err.max().item():.3e}), K7f {limits[1]} (at least "
          f"{least[1]}; errors {[f'{e:.2e}' for e in errs]}); one more, and K2f and K7f at "
          f"c1 513, raise")


def small_model_check(root_cfg) -> None:
    """A tiny grounder on the card (kernels) against the CPU (plain versions).

    Every seed becomes a query (``num_queries`` = seed count), so the check
    does not hang on the order of near-tied objectness logits: the queries are
    aligned by seed index before the heads are compared.
    """
    from eda_tpu_torch.entry import build as build_model

    cfg = root_cfg.tiny()
    cfg = dataclasses.replace(cfg, num_queries=cfg.sa_npoints[1])
    gpu_model, gpu_in = build_model(cfg, batch_size=2, device="cuda", seed=1)
    cpu_model, cpu_in = build_model(cfg, batch_size=2, device="cpu", seed=1)
    with torch.inference_mode():
        got = {k: v.cpu() for k, v in gpu_model(gpu_in).items()}
        want = cpu_model(cpu_in)
    for i in range(1, 5):
        if not torch.equal(got[f"sa{i}_inds"], want[f"sa{i}_inds"]):
            raise AssertionError(f"tiny model: sa{i}_inds differ between card and CPU")
    feat_err = (got["fp2_features"].float() - want["fp2_features"].float()).abs().max().item()
    g_inds, w_inds = got["query_points_sample_inds"], want["query_points_sample_inds"]
    if not torch.equal(g_inds.sort(1).values, w_inds.sort(1).values):
        raise AssertionError("tiny model: the queries' seeds differ between card and CPU")
    perm = torch.stack([g.argsort()[w.argsort().argsort()] for g, w in zip(g_inds, w_inds)])
    errs = {}
    for key in ("proposal_center", "last_center", "last_pred_size", "last_sem_cls_scores"):
        g = got[key].gather(1, perm[..., None].expand(-1, -1, got[key].shape[-1]))
        errs[key] = (g.float() - want[key].float()).abs().max().item()
    print(f"tiny model card vs CPU: sa inds equal, fp2_features max err {feat_err}, "
          f"query-aligned max errs {errs}")
    if feat_err > 0.05 or max(errs.values()) > HEAD_ATOL:
        raise AssertionError("tiny model on the card is off its CPU twin")
    if not torch.isfinite(got["last_center"]).all():
        raise AssertionError("tiny model: non-finite last_center on the card")


def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-300))


def _leaf_fails(g, w) -> bool:
    """A leaf's moments fail the per-leaf gates: cosine or norm ratio."""
    return (_cos(g, w) < LEAF_COS
            or not 1 / NORM_RATIO <= float(g.norm() / w.norm()) <= NORM_RATIO)


def _first_moments(state) -> dict:
    names = {p: n for n, p in state.model.named_parameters()}
    return {names[p]: mu.cpu() for p, (mu, _) in state.optimizer.moments.items()}


def small_train_check(root_cfg, grad_norm_rel: float = METRIC_REL, noise_draws: int = 0,
                      pool_noise: float = 0.0, global_cos: float = GLOBAL_COS) -> None:
    """One tiny training step on the card against its CPU twin, dropout off.

    The CPU run's KPS indices and matches are handed to the card run (the
    discrete choices that near-ties make noise-sensitive), and the tolerances
    are those ``tests/test_torch_train_step.py`` holds the port to JAX with,
    ``grad_norm`` within ``grad_norm_rel`` and the gradient's global cosine
    at least ``global_cos``. With ``noise_draws`` the CPU step
    also runs on inputs moved by up to 1e-6 that many times, and the leaves
    whose moments fail the per-leaf gates there are held by the global cosine
    only (``tests/test_torch_butd_train_step.py``). With ``pool_noise`` each of
    those CPU runs also moves every pooled value of its pair pools by up to
    that share (the pool kernels round h1 to bf16 after f32 sums in another
    order than their plain versions: one bf16 step, 2^-8, moves a pooled value
    by as much). The noisy leaves that fail the per-leaf gates on the card
    are the ones excused, and are counted.
    """
    from eda_tpu_torch.entry import build_trainer
    from eda_tpu_torch.losses import criterion
    from eda_tpu_torch.models import grounder
    from eda_tpu_torch.models.layers import Dropout
    from eda_tpu_torch.ops import fused_sa
    from eda_tpu_torch.train.optim import group_of

    cfg = dataclasses.replace(root_cfg.tiny(), dropout=0.0)

    def trainer(device):
        state, step, batch = build_trainer(cfg, batch_size=2, device=device, seed=1)
        for m in state.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        return state, step, batch

    cpu, step, cpu_batch = trainer("cpu")
    gpu, _, gpu_batch = trainer("cuda")
    chosen = {}

    def record(fn, key):
        def wrapped(*a, **k):
            chosen[key] = fn(*a, **k)
            return chosen[key]
        return wrapped

    def replay(key):
        def lookup(*a, **k):
            v = chosen[key]
            return v.cuda() if key == "kps" else type(v)(*(t.cuda() for t in v))
        return lookup

    with patched(grounder, "top_k_indices", record(grounder.top_k_indices, "kps")), \
            patched(criterion, "hungarian_match", record(criterion.hungarian_match, "match")):
        want = {k: float(v) for k, v in step(cpu, cpu_batch).items()}
    with patched(grounder, "top_k_indices", replay("kps")), \
            patched(criterion, "hungarian_match", replay("match")):
        got = {k: float(v) for k, v in step(gpu, gpu_batch).items()}
    if not all(math.isfinite(v) for v in got.values()):
        raise AssertionError(f"tiny train step on the card: non-finite metrics {got}")
    mu_cpu, mu_gpu = _first_moments(cpu), _first_moments(gpu)
    noisy = set()
    for draw in range(noise_draws):
        moved, _, moved_batch = trainer("cpu")
        xyz = moved_batch["inputs"]["point_clouds"][..., :3]
        xyz += torch.empty_like(xyz).uniform_(-1e-6, 1e-6,
                                              generator=torch.Generator().manual_seed(draw))
        gen = torch.Generator().manual_seed(100 + draw)

        def moved_pool(*a, _pool=fused_sa.sa_pair_pool_winners, **k):
            values, winners = _pool(*a, **k)
            shift = (torch.rand(values.shape, generator=gen) * 2 - 1) * pool_noise
            return values * (1 + shift), winners

        with patched(grounder, "top_k_indices", lambda logits, k: chosen["kps"]), \
                patched(criterion, "hungarian_match", lambda *a, **k: chosen["match"]), \
                patched(fused_sa, "sa_pair_pool_winners",
                        moved_pool if pool_noise else fused_sa.sa_pair_pool_winners):
            step(moved, moved_batch)
        mu_moved = _first_moments(moved)
        noisy |= {k for k, w in mu_cpu.items() if w.any() and not k.endswith(ZERO_GRAD)
                  and _leaf_fails(mu_moved[k], w)}
    if len(noisy) > BUTD_MAX_NOISY:
        raise AssertionError(f"tiny train step: {len(noisy)} leaves noisy on the CPU itself")
    rel = {k: abs(got[k] - w) / (abs(w) + 1e-6) for k, w in want.items()}
    limit = {k: grad_norm_rel if k == "grad_norm" else METRIC_REL for k in rel}
    worst_key = max(rel, key=lambda k: rel[k] / limit[k])
    loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    # the butd class table takes no gradient: its moments stay zero
    frozen = [k for k in mu_cpu if k.startswith("butd_class_embeddings.")]
    bad = [k for k in frozen if mu_cpu[k].any() or mu_gpu[k].any()]
    keys = sorted(set(mu_cpu) - set(frozen))
    glob = _cos(torch.cat([mu_gpu[k].flatten() for k in keys]),
                torch.cat([mu_cpu[k].flatten() for k in keys]))
    largest = max(float(v.norm()) for v in mu_cpu.values())
    excused = []
    for k in keys:
        g, w = mu_gpu[k], mu_cpu[k]
        if k.endswith(ZERO_GRAD):
            if max(float(g.norm()), float(w.norm())) >= ZERO_NORM * largest:
                bad.append(k)
        elif _leaf_fails(g, w):
            (excused if k in noisy else bad).append(k)
    lrs = {"main": cpu.optimizer.cfg.lr, "backbone": cpu.optimizer.cfg.lr_backbone, "text": 0.0}
    cstate, gstate = cpu.model.state_dict(), gpu.model.state_dict()
    close = total = 0
    bn_err = 0.0
    for k, w in cstate.items():
        g = gstate[k].cpu().float()
        if k.endswith(("running_mean", "running_var")):
            bn_err = max(bn_err, rel_err(g, w))
            continue
        lr = lrs[group_of(k)]
        diff = (g - w.float()).abs()
        if lr == 0.0:
            if not torch.equal(g, w.float()):
                bad.append(k)
            continue
        if diff.max() > 2 * lr * (1 + 1e-3) + 1e-6 * w.abs().max():
            bad.append(k)
        close += int((diff <= 0.1 * lr).sum())
        total += diff.numel()
    print(f"tiny train step card vs CPU{' (butd)' if cfg.butd else ''}: loss "
          f"{got['loss']:.5f} vs {want['loss']:.5f}, grad_norm {got['grad_norm']:.4f} vs "
          f"{want['grad_norm']:.4f}, worst metric rel {rel[worst_key]:.4f} ({worst_key}), "
          f"gradient global cos {glob:.4f}, params within 0.1 lr {close / total:.4f}, BN "
          f"stats rel {bn_err:.5f}" + (f", {len(noisy)} leaves noisy on the CPU itself "
                                       f"{sorted(noisy)}, of which {len(excused)} fail the "
                                       f"per-leaf gates on the card and are excused {excused}"
                                       if noise_draws else ""))
    if (loss_err > LOSS_REL or rel[worst_key] > limit[worst_key] or glob < global_cos or bad
            or close < PARAM_CLOSE * total or bn_err > BN_REL):
        raise AssertionError(f"tiny train step on the card is off its CPU twin; leaves {bad}")


def positive_sizes(model) -> None:
    """Move every size head's output bias by +1, so that the random model's
    boxes have positive extents and overlap the GT boxes (else every IoU is ~0)."""
    with torch.no_grad():
        for name, module in model.named_modules():
            if name.endswith("size_head"):
                module.dense[2].bias += 1.0


def small_eval_check(root_cfg, filter_non_gt_boxes: bool = False) -> None:
    """The tiny model's card end points scored on the card and on the CPU; with
    ``filter_non_gt_boxes`` (``--butd_cls``) a prediction that overlaps no
    detected box by IoU > 0.25 scores 0: every center head's output layer is
    zeroed then, so that each box sits on its query's seed (most seeds lie on
    an object, whose box is a detected box) and some pass the filter, and
    the predictions that pass must be the same on both sides."""
    from eda_tpu_torch.entry import build_evaluator
    from eda_tpu_torch.eval.grounding import grounding_scores, score_and_iou_multi
    from eda_tpu_torch.ops.boxes import box_cxcyczwhd_to_xyzxyz, pairwise_box_iou_3d

    model, _, evaluator, batch = build_evaluator(root_cfg.tiny(), batch_size=2, device="cuda",
                                                 seed=1)
    positive_sizes(model)
    if filter_non_gt_boxes:
        with torch.no_grad():
            for name, module in model.named_modules():
                if name.endswith("center_head"):
                    module.dense[2].weight.zero_()
                    module.dense[2].bias.zero_()
    kw = dict(prefixes=evaluator.prefixes, modes=evaluator.modes)
    targets = dict(batch["targets"])
    if filter_non_gt_boxes:
        targets.update(__det_boxes=batch["inputs"]["det_boxes"],
                       __det_mask=batch["inputs"]["det_mask"])
    with torch.inference_mode():
        ends = model(batch["inputs"])
        got = score_and_iou_multi(ends, targets, **kw).cpu()
        cpu_ends = {k: v.cpu() for k, v in ends.items()}
        cpu_targets = {k: v.cpu() for k, v in targets.items()}
        want = score_and_iou_multi(cpu_ends, cpu_targets, **kw)
    excused = torch.zeros_like(want, dtype=torch.bool)
    for pi, prefix in enumerate(evaluator.prefixes):
        for mi, mode in enumerate(evaluator.modes):
            scores, _ = grounding_scores(cpu_ends, cpu_targets, prefix=prefix, mode=mode)
            top = scores.sort(1, descending=True).values[:, :want.shape[-1] + 1]
            tie = (top[:, :-1] - top[:, 1:]).abs() <= SCORE_TIE  # rank r with rank r + 1
            excused[pi, mi, :, 1:] |= tie[:, :-1]
            excused[pi, mi] |= tie
    compared = (got - want).abs()[~excused]
    err = compared.max().item() if compared.numel() else 0.0
    if filter_non_gt_boxes:
        passing = []
        for ends_, targets_ in ((ends, targets), (cpu_ends, cpu_targets)):
            boxes = torch.cat([ends_["last_center"], ends_["last_pred_size"]], -1)
            iou, _ = pairwise_box_iou_3d(box_cxcyczwhd_to_xyzxyz(targets_["__det_boxes"]),
                                         box_cxcyczwhd_to_xyzxyz(boxes))
            passing.append((torch.where(targets_["__det_mask"].bool()[:, :, None], iou, 0.0)
                            .amax(1) > 0.25).cpu())
        if not torch.equal(*passing) or not passing[0].any():
            raise AssertionError(f"tiny eval: the --butd_cls filter passes "
                                 f"{int(passing[0].sum())} predictions on the card and "
                                 f"{int(passing[1].sum())} on the CPU, not the same ones")
        print(f"tiny eval --butd_cls filter: the same {int(passing[0].sum())} of "
              f"{passing[0].numel()} last_ predictions pass on the card and the CPU")
    print(f"tiny eval card vs CPU scoring{' (--butd_cls filter)' if filter_non_gt_boxes else ''}"
          f": IoU stack {tuple(got.shape)}, max IoU "
          f"{want.max().item():.4f}, max err {err} at compared ranks, "
          f"{int(excused.sum())} of {excused.numel()} ranks excused (score ties)")
    if err > IOU_ATOL or not torch.isfinite(got).all():
        raise AssertionError("tiny eval: card scoring is off the CPU scoring")


def stage_times(model, batch) -> dict:
    """Host-clock ms of the forward's stages, each ended by a synchronize."""
    with torch.inference_mode():
        _, backbone = timed(lambda: model.backbone_net(batch["point_clouds"]))
        _, text = timed(lambda: model.text_encoder(batch["text_ids"], batch["text_mask"].bool()))
        _, whole = timed(lambda: model(batch))
    return {"backbone": backbone, "text_encoder": text, "whole": whole,
            "rest": whole - backbone - text}


PROFILED: dict = {}  # label -> device busy ms of its profiled call


def profile(fn, label: str, also=(), top: int = 15, fps_calls=None) -> float:
    """Device time by operation and the device's busy share over one call of
    ``fn``: the ``top`` busiest operations, and every one whose name holds a
    string of ``also``. Returns the device's busy ms and keeps it in
    ``PROFILED[label]``.

    Late in this process the profiler has kept no record of one FPS kernel
    of a call (SA1's: ~19 ms over 50 000 points on an NVIDIA H100 80GB HBM3
    at 700 W, while the call's host time grew by as much), where a fresh
    process keeps it every time. So the FPS records are counted against the
    FPS launches; when they fall short and ``fps_calls`` (the recorded
    (args, kwargs) of the call's FPS launches) is given, the busy time counts
    those calls at their own CUDA-event times in place of the kept records;
    otherwise the shortfall is printed."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from eda_tpu_torch.ops.cuda import build
    from eda_tpu_torch.ops.cuda import fps as fps_module

    launched = build.KERNELS["fps_launch"].launches
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    launched = build.KERNELS["fps_launch"].launches - launched
    # device-side events only (kernels, copies): a host op's device time
    # repeats that of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    kept = sum(e.count for e in events if "fps_" in e.key)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    note = ""
    if kept != launched and fps_calls:
        kept_ms = sum(e.self_device_time_total for e in events if "fps_" in e.key) / 1e3
        alone_ms = sum(cuda_ms(lambda a=a, k=k: fps_module.fps(*a, **k), 3)
                       for a, k in fps_calls)
        busy_ms += alone_ms - kept_ms
        note = (f"; the profile kept {kept} of {launched} FPS kernel records ({kept_ms:.3f} ms): "
                f"busy counts the {len(fps_calls)} FPS calls at their CUDA-event times, "
                f"{alone_ms:.3f} ms")
    elif kept != launched:
        note = (f"; the profile kept {kept} of {launched} FPS kernel records, so the busy time "
                f"lacks the missing ones")
    PROFILED[label] = busy_ms
    print(f"profiled {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of wall; profiler on){note}")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < top or any(a in e.key for a in also):
            print(f"  device {e.self_device_time_total / 1e3:9.3f} ms  calls {e.count:5d}  "
                  f"{e.key[:90]}")
    return busy_ms


def sdpa_attention(self, q, k, v, key_valid=None):
    """The port's attention before it rounded where flax rounds: one
    ``scaled_dot_product_attention`` call (the yardstick of its cost)."""
    import torch.nn.functional as F

    B, Lq, d = q.shape
    h = self.n_heads
    dh = d // h
    qh = self.query(q).view(B, Lq, h, dh).transpose(1, 2)
    kh = self.key(k).view(B, k.shape[1], h, dh).transpose(1, 2)
    vh = self.value(v).view(B, v.shape[1], h, dh).transpose(1, 2)
    qh = qh / torch.tensor(math.sqrt(dh), dtype=torch.float32).to(self.dtype)
    mask = None if key_valid is None else key_valid[:, None, None, :].bool()
    x = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=1.0)
    return self.out(x.transpose(1, 2).reshape(B, Lq, d))


def attention_cost(model, batch) -> None:
    """Serving forward with the rounding attention and with SDPA, in turns A B B A."""
    from eda_tpu_torch.models import layers

    times = {"rounded": [], "sdpa": []}
    with torch.inference_mode():
        for which in ("rounded", "sdpa", "sdpa", "rounded"):
            fwd = sdpa_attention if which == "sdpa" else layers.MultiHeadAttention.forward
            with patched(layers.MultiHeadAttention, "forward", fwd):
                for _ in range(2):
                    times[which].append(timed(lambda: model(batch))[1])
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"serving forward by attention (ms per batch, median of 4, turns A B B A): "
          f"rounded as flax {med['rounded']:.2f}, scaled_dot_product_attention "
          f"{med['sdpa']:.2f}, cost {med['rounded'] - med['sdpa']:+.2f} ms")


def serving_phase(cfg):
    from eda_tpu_torch.entry import build as build_model
    from eda_tpu_torch.entry import make_batch
    from eda_tpu_torch.ops import fused_sa, pointops
    from eda_tpu_torch.ops.cuda import build

    model, inputs = build_model(cfg, batch_size=BATCH, device="cuda", seed=0)
    with Recorder([(pointops, "furthest_point_sample", "fps_launch"),
                   (fused_sa, "sa_prep", "sa_prep_launch"),
                   (fused_sa, "sa_pair_pool", "sa_pair_pool_launch")]) as rec:
        with torch.inference_mode():
            model(inputs)
    torch.cuda.synchronize()
    rows = check_kernels(rec.calls, SERVING, {s: 4 for s in SERVING})
    fps_sweep(rec.calls["fps_launch"])
    del rec

    batches = [inputs] + [make_batch(cfg, range(BATCH * i, BATCH * (i + 1)), "cuda")
                          for i in range(1, REQUESTS)]
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    times = []
    with torch.inference_mode():
        for i, batch in enumerate(batches):
            before = launch_counts()
            out, ms = timed(lambda: model(batch)["last_center"])
            times.append(ms)
            if out.shape != (BATCH, cfg.num_queries, 3) or not torch.isfinite(out).all():
                raise AssertionError(f"request {i}: bad last_center {tuple(out.shape)}")
            check_launches(before, forward_launches("pair"), f"request {i}")
            print(f"request {i}: {BATCH} scenes in {ms:.2f} ms, last_center finite")
    launches = launch_counts()
    steady = statistics.median(times[1:])
    print(f"serving forward, batch {BATCH}: {steady:.2f} ms per batch, "
          f"{1e3 * BATCH / steady:.2f} scenes/s (median of requests 1-{REQUESTS - 1}; "
          f"request 0 {times[0]:.2f} ms)")
    attention_cost(model, batches[-1])
    print(f"stage ms of one batch: {stage_times(model, batches[-1])}")
    with torch.inference_mode():
        profile(lambda: model(batches[-1]), "serving forward")
    return rows, launches, model, inputs


def train_phase(cfg):
    from eda_tpu_torch.entry import build_trainer
    from eda_tpu_torch.losses import criterion, matcher
    from eda_tpu_torch.ops import fused_sa
    from eda_tpu_torch.ops.cuda import build
    from eda_tpu_torch.train.step import dropout_generator, step_generator

    state, step, batch = build_trainer(cfg, batch_size=BATCH, device="cuda", seed=0)
    bwd = lambda kw, _: bwd_symbol(kw["compact"])  # noqa: E731
    with Recorder([(fused_sa, "sa_pair_pool_winners", "sa_pair_pool_winners_launch"),
                   (fused_sa, "sa_pool_bwd", bwd),
                   (fused_sa, "sa_prep_bwd", "sa_prep_bwd_launch")]) as rec:
        step(state, batch)
    torch.cuda.synchronize()
    layers = {"sa_pair_pool_winners_launch": 4, "sa_pool_bwd_compact_launch": 1,
              "sa_pool_bwd_window_launch": 3, "sa_prep_bwd_launch": 4}
    rows = check_kernels(rec.calls, TRAINING, layers)
    del rec

    trained = [p for n, p in state.model.named_parameters() if not n.startswith("text_encoder")]
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    matcher.HOST_SYNCS = 0
    times = []
    for i in range(STEPS):
        before = launch_counts()
        old = [p.detach().clone() for p in trained]
        metrics, ms = timed(lambda: step(state, batch))
        times.append(ms)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"step {i}: loss {loss}, grad_norm {norm}")
        changed = sum(not torch.equal(o, p) for o, p in zip(old, trained))
        if changed < 0.9 * len(trained):
            raise AssertionError(f"step {i}: only {changed} of {len(trained)} parameters changed")
        check_launches(before, step_launches("pair"), f"step {i}")
        print(f"step {i}: {BATCH} scenes in {ms:.2f} ms, loss {loss:.4f}, grad_norm {norm:.4f}, "
              f"{changed} of {len(trained)} parameters changed")
    launches = launch_counts()
    steady = statistics.median(times[1:])
    print(f"training step, batch {BATCH}: {steady:.2f} ms per step, "
          f"{1e3 * BATCH / steady:.2f} scenes/s (median of steps 1-{STEPS - 1}; "
          f"step 0 {times[0]:.2f} ms); matcher host syncs {matcher.HOST_SYNCS} in {STEPS} steps")

    # stage times of one step, each stage ended by a synchronize
    model, opt = state.model, state.optimizer
    model.train()
    with dropout_generator(model, step_generator(0, state.step, "cuda")):
        ends, t_fwd = timed(lambda: model(batch["inputs"]))
    (loss, _), t_loss = timed(lambda: criterion.compute_hungarian_loss(
        criterion.SetCriterionConfig(num_decoder_layers=cfg.num_decoder_layers), ends,
        batch["targets"]))
    opt.zero_grad()
    _, t_bwd = timed(loss.backward)
    _, t_opt = timed(opt.step)
    print(f"stage ms of one training step: forward {t_fwd:.2f}, loss (matching included) "
          f"{t_loss:.2f}, backward {t_bwd:.2f}, optimizer {t_opt:.2f}")
    del ends, loss
    profile(lambda: step(state, batch), "training step", also=("pool_bwd", "reduce_"))
    exact_repeat_check(state, step, batch, "full-width step")
    return rows, launches, state, step, batch


def radius_mode_phase(mode: str, model, inputs, state, step, batch):
    """The mode's kernels on a full-width serving forward and training step,
    against their plain versions and against the pair kernel. Returns the
    kernels' rows and the launches of the training step."""
    from eda_tpu_torch.ops import fused_sa
    from eda_tpu_torch.ops.cuda import build

    pool = lambda kw, _: pool_symbol(kw["d2_mode"], False)  # noqa: E731
    pool_winners = lambda kw, _: pool_symbol(kw["d2_mode"], True)  # noqa: E731
    masks = [(fused_sa, "sa_radius_mask", MASK)] if mode == "pre" else []
    with radius_mode(mode):
        before = launch_counts()
        with Recorder([(fused_sa, "sa_pair_pool", pool)] + masks) as serve:
            with torch.inference_mode():
                out = model(inputs)["last_center"]
        check_launches(before, forward_launches(mode), f"{mode} serving forward")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{mode}: non-finite last_center")
        for kernel in build.KERNELS.values():
            kernel.launches = 0
        with Recorder([(fused_sa, "sa_pair_pool_winners", pool_winners)]) as train:
            metrics = step(state, batch)
        torch.cuda.synchronize()
        launches = launch_counts()
        check_launches({s: 0 for s in launches}, step_launches(mode), f"{mode} training step")
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"{mode}: non-finite training loss")
        symbols = ([MASK] if mode == "pre" else []) + [pool_symbol(mode, False)]
        rows = check_kernels(serve.calls, symbols, {s: 4 for s in symbols}, compare_pair=True)
        winners = pool_symbol(mode, True)
        rows += check_kernels(train.calls, [winners], {winners: 4}, compare_pair=True)
    rows[-1]["launches"] = launches[winners]
    return rows


def against_pair_stack(mode: str, stacks: dict, ends: dict, i: int) -> int:
    """The mode's IoU stack against the batch's pair stack, scene by scene.
    A scene whose end points equal pair's bit for bit must score the same IoU
    stack. A scene where the radius test decided a pair otherwise (near the
    boundary, which the radius-mode phase bounds) has another forward and is
    not compared; its end points must first differ at an SA layer's output.
    Returns the number of scenes compared."""
    mine, pair = ends[mode], ends["pair"]
    keys = [k for k, v in pair.items() if isinstance(v, torch.Tensor) and v.shape[:1] == (BATCH,)]
    same = [b for b in range(BATCH) if all(torch.equal(mine[k][b], pair[k][b]) for k in keys)]
    pools = [f"sa{j}_features" for j in range(1, 5)]
    for b in set(range(BATCH)) - set(same):
        if all(torch.equal(mine[k][b], pair[k][b]) for k in pools):
            raise AssertionError(f"{mode} eval batch {i}, scene {b}: end points differ from "
                                 f"pair's with equal SA outputs")
    if not torch.equal(stacks[mode][:, :, same], stacks["pair"][:, :, same]):
        raise AssertionError(f"{mode} eval batch {i}: a scene with pair's end points scores "
                             f"another IoU stack")
    return len(same)


def eval_phase(cfg) -> dict:
    """Five batches of 8 scored under each radius-test mode, the modes taking
    turns on each batch (forward order on even batches, reverse on odd ones)
    so that the host's drift falls on all three alike. Every size head's bias
    is moved as in ``small_eval_check`` so that the boxes overlap the GT boxes;
    the ``mxu`` and ``pre`` IoU stacks of each scene whose end points equal
    pair's must equal its ``pair`` stack. Returns the launches of each mode's
    five batches."""
    from eda_tpu_torch.entry import build_evaluator, make_train_batch
    from eda_tpu_torch.eval.grounding import GroundingEvaluator, score_and_iou_multi
    from eda_tpu_torch.train import step as step_module

    model, score_step, evaluator, batch = build_evaluator(cfg, batch_size=BATCH, device="cuda")
    positive_sizes(model)
    batches = [batch] + [make_train_batch(cfg, range(BATCH * i, BATCH * (i + 1)), "cuda")
                         for i in range(1, REQUESTS)]
    modes = ("pair", "mxu", "pre")
    evaluators = {m: GroundingEvaluator(prefixes=evaluator.prefixes, modes=evaluator.modes)
                  for m in modes}
    times = {m: [] for m in modes}
    launches = {m: dict.fromkeys(launch_counts(), 0) for m in modes}
    compared = {m: 0 for m in modes[1:]}
    largest = 0.0
    scored = {}

    def keep(end_points, targets, **kw):  # the score step's end points, kept to compare
        scored["ends"] = end_points
        return score_and_iou_multi(end_points, targets, **kw)

    with patched(step_module, "score_and_iou_multi", keep):
        for i, b in enumerate(batches):
            stacks, ends = {}, {}
            for mode in modes if i % 2 == 0 else modes[::-1]:
                with radius_mode(mode):
                    before = launch_counts()
                    t = time.perf_counter()
                    ious = score_step(b)
                    evaluators[mode].evaluate(None, None, ious=ious)  # pulls the stack to the host
                    times[mode].append(1e3 * (time.perf_counter() - t))
                check_launches(before, forward_launches(mode), f"{mode} eval batch {i}")
                for symbol, count in launch_counts().items():
                    launches[mode][symbol] += count - before[symbol]
                if (ious.shape != IOU_SHAPE or not torch.isfinite(ious).all()
                        or ious.min() < 0 or ious.max() > 1):
                    raise AssertionError(f"{mode} eval batch {i}: bad IoU stack "
                                         f"{tuple(ious.shape)}")
                stacks[mode], ends[mode] = ious, scored.pop("ends")
            largest = max(largest, stacks["pair"].max().item())
            for mode in modes[1:]:
                compared[mode] += against_pair_stack(mode, stacks, ends, i)
            del stacks, ends
    for mode in modes:
        steady = statistics.median(times[mode][1:])
        print(f"eval under {mode}, batch {BATCH}: {steady:.2f} ms per batch, "
              f"{1e3 * BATCH / steady:.2f} scenes/s (median of batches 1-{REQUESTS - 1}; "
              f"batch 0 {times[mode][0]:.2f} ms; all {[round(t, 2) for t in times[mode]]}); "
              f"IoU stacks {IOU_SHAPE} finite in [0, 1]")
        if mode != "pair":
            print(f"  {compared[mode]} of {REQUESTS * BATCH} scenes have pair's end points bit "
                  f"for bit and score pair's IoU stack; the other "
                  f"{REQUESTS * BATCH - compared[mode]} differ from pair's from an SA "
                  f"layer's output on")
        print(f"  {evaluators[mode].print_stats().splitlines()[0]}")
    print(f"largest IoU with the GT box in the eval batches: {largest:.4f}")
    return launches


def _same_state(a, b) -> bool:
    """Parameters, BatchNorm statistics, AdamW moments and counts and the step, bit for bit."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    return (a.step == b.step and oa["count"] == ob["count"] and sa.keys() == sb.keys()
            and all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(x, y) for x, y in zip(oa["mu"] + oa["nu"], ob["mu"] + ob["nu"])))


def cli_phase(root_cfg) -> None:
    """The training CLI on the card (tiny synthetic, ``--max_steps 3``, then
    ``--eval`` on its checkpoint), a checkpoint restored on the card, and
    whether two identical training steps on the card agree bit for bit."""
    import tempfile

    from eda_tpu_torch.entry import build_trainer
    from eda_tpu_torch.train import cli
    from eda_tpu_torch.train.checkpoint import CheckpointManager

    flags = ["--dataset", "synthetic", "--debug", "--use_color", "--batch_size", str(BATCH),
             "--num_workers", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        run, evaluated = Path(tmp) / "run", Path(tmp) / "eval"
        if cli.main(flags + ["--max_steps", "3", "--print_freq", "1", "--log_dir", str(run)]):
            raise AssertionError("cli: the training run failed")
        if cli.main(flags + ["--eval", "--checkpoint_path", str(run / "ckpt"),
                             "--log_dir", str(evaluated)]):
            raise AssertionError("cli: the eval run failed")
        names = sorted(p.name for p in run.iterdir())
        if not {"ckpt", "config.json", "log.txt", "metrics.jsonl"} <= set(names):
            raise AssertionError(f"cli: run directory holds {names}")
        if [p.name for p in (run / "ckpt").iterdir()] != ["epoch_0.pt"]:
            raise AssertionError("cli: no forced checkpoint at max_steps")
        records = [json.loads(line) for d in (run, evaluated)
                   for line in (d / "metrics.jsonl").read_text().splitlines()]
        train = [r for r in records if r["group"] == "train"]
        val = [r for r in records if r["group"] == "val"]
        values = [v for r in train + val for k, v in r.items() if k not in ("group", "time")]
        if ([r["step"] for r in train] != [1, 2, 3] or len(val) != 1 or val[0]["step"] != 3
                or not all(math.isfinite(v) for v in values)
                or not all(0.0 <= v <= 1.0 for k, v in val[0].items() if "Acc" in k)):
            raise AssertionError(f"cli: metrics {train} {val}")
        if "resumed from epoch 1" not in (evaluated / "log.txt").read_text():
            raise AssertionError("cli: --eval did not restore the checkpoint")
        print(f"cli: 3 steps, losses {[round(r['loss'], 4) for r in train]}, the full val split "
              f"scored from the checkpoint: last_ Acc@0.25 top-1 bbs "
              f"{val[0]['last_Acc0.25Top1_bbs']:.4f}, bbf {val[0]['last_Acc0.25Top1_bbf']:.4f}")

        cfg = root_cfg.tiny()
        state, step, batch = build_trainer(cfg, batch_size=2, device="cuda", seed=0)
        for _ in range(2):
            step(state, batch)
        mgr = CheckpointManager(str(Path(tmp) / "ckpt"), save_freq=1)
        mgr.save(0, state)
        restored, _ = mgr.restore(build_trainer(cfg, batch_size=2, device="cuda", seed=1)[0])
        if not _same_state(state, restored):
            raise AssertionError("cli: the state restored on the card is not the state saved")
    # the same step from bit-identical states, twice: every sum of the
    # backward is a fixed-order sum, so the update repeats bit for bit
    m1, m2 = step(state, batch), step(restored, batch)
    differ = sorted(k for k in m1 if not torch.equal(m1[k], m2[k]))
    if differ or not _same_state(state, restored):
        raise AssertionError(f"cli: two steps from the restored state differ (metrics "
                             f"{differ}, or a state tensor or moment)")
    print(f"cli: checkpoint restored on the card bit-identical to the state saved; the next "
          f"step from both bit-identical: all {len(m1)} metrics, all "
          f"{len(state.model.state_dict())} state tensors and every moment")
    f32_state, f32_step, f32_batch = build_trainer(dataclasses.replace(root_cfg.tiny(),
                                                                       use_bf16=False),
                                                   batch_size=2, device="cuda", seed=0)
    f32_step(f32_state, f32_batch)
    exact_repeat_check(f32_state, f32_step, f32_batch, "cli: tiny f32 step")

    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp) / "gather"
        if cli.main(flags + ["--sa_impl", "gather", "--max_steps", str(GATHER_CLI_STEPS),
                             "--print_freq", "1", "--log_dir", str(run)]):
            raise AssertionError("cli: the --sa_impl gather run failed")
        config = json.loads((run / "config.json").read_text())
        train = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in train if r["group"] == "train"]
        if len(losses) != GATHER_CLI_STEPS or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"cli --sa_impl gather: losses {losses}")
        if "gather" not in json.dumps(config):
            raise AssertionError("cli --sa_impl gather: config.json does not name the gather SA")
        print(f"cli --sa_impl gather: {GATHER_CLI_STEPS} steps, losses "
              f"{[round(v, 4) for v in losses]}")


def pack(root: Path, scan_dir: Path, ids: dict, processes: int) -> None:
    """``python -m eda_tpu_torch.tools.pack_scans`` for each split, over the fabricated ids."""
    from eda_tpu_torch.tools import pack_scans as pack_tool

    with patched(pack_tool, "split_scan_ids", lambda split: ids[split]):
        for split in ids:
            if pack_tool.main(["--scan_dir", str(scan_dir), "--data_root", str(root),
                               "--split", split, "--processes", str(processes)]):
                raise AssertionError(f"pack_scans failed for {split}")



REAL_ANNOS = 32  # utterances a fabricated scene names (ScanRefer has ~64 a scene)
REAL_STEPS = 16  # steps of the timed CLI runs
RATE_FREQ = 5  # their --print_freq: metrics.jsonl rows at steps 1, 6, 11 and 16


def cli_rate(run: Path) -> tuple:
    """(steps/s, first step, last step) between the first and the last train row of
    a run's ``metrics.jsonl``: wall time, waits for the input pipeline included."""
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    rows = [r for r in rows if r["group"] == "train"]
    first, last = rows[0], rows[-1]
    rate = (last["step"] - first["step"]) / (last["time"] - first["time"])
    return rate, first["step"], last["step"]


def real_data_phase(root_cfg, tmp: Path):
    """The training CLI on real-format data at the flagship's width: pack a
    fabricated ScanNet tree under ``tmp``, train ``REAL_STEPS`` steps on
    ScanRefer-format annotations with the RoBERTa warm start and, in the same
    process, as many on synthetic scenes (both rates from ``metrics.jsonl``),
    score the val split from the checkpoint, and train 2 steps under
    ``--joint_det``. Returns (data root, ids by split, each scene's object
    labels) for the "butd" phase."""
    sys.path.append(str(Path(__file__).resolve().parent / "tests"))
    from real_data_fixtures import CheckedSteps, fabricate_real_data

    from eda_tpu_torch.data.dataset import GroundingDataset
    from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
    from eda_tpu_torch.ops.cuda import build
    from eda_tpu_torch.train import cli

    t = time.perf_counter()
    root, scan_dir, ids, encoder, labels = fabricate_real_data(
        tmp, root_cfg, n_vertices=60_000, scenes={"train": 8, "val": 4},
        annos_per_scene=REAL_ANNOS)
    print(f"real data: fabricated {len(ids['train'])} + {len(ids['val'])} scenes of 60000 "
          f"vertices, {REAL_ANNOS} utterances each, and a {len(encoder.state_dict())}-tensor "
          f"RoBERTa in {time.perf_counter() - t:.1f} s")
    # one process: spawned workers would each import this script and torch
    # first (~11 s on the card); tests/test_torch_scannet_data.py runs them
    t = time.perf_counter()
    pack(root, scan_dir, ids, processes=1)
    print(f"real data: packed the two splits in {time.perf_counter() - t:.2f} s "
          f"(one process)")

    flags = ["--dataset", "scanrefer", "--use_color", "--data_root", str(root),
             "--batch_size", str(BATCH), "--num_workers", "4"]
    args = cli.parse_args(flags)
    ds = GroundingDataset.from_args(args, "train")
    syn = SyntheticScenes(SyntheticConfig(num_points=root_cfg.num_points, num_objects=8,
                                          text_len=64, max_objects=132, seed=0))
    n_timed = 32
    for source in (ds, syn):
        source.example(0)
    t = time.perf_counter()
    for i in range(n_timed):
        ds.example(i)
    real_ms = 1e3 * (time.perf_counter() - t) / n_timed
    t = time.perf_counter()
    for i in range(n_timed):
        syn.example(i)
    syn_ms = 1e3 * (time.perf_counter() - t) / n_timed
    print(f"real data: host ms per example, one thread, {n_timed} examples: "
          f"GroundingDataset.example {real_ms:.2f} (50000 points, 256 tokens), the "
          f"synthetic generator {syn_ms:.2f} (50000 points, 64 tokens)")

    want = {k: v.detach().clone() for k, v in encoder.state_dict().items()}

    def same_text_encoder(state):
        got = state.model.text_encoder.state_dict()
        if got.keys() != want.keys() or not all(
                torch.equal(got[k].cpu(), want[k]) for k in want):
            raise AssertionError("real data: the warm-started text encoder is not the "
                                 "seeded encoder bit for bit")

    rates = {}
    for name, extra, n_steps, freq in (
            ("scanrefer", [], REAL_STEPS, RATE_FREQ), ("joint_det", ["--joint_det"], 2, 1)):
        steps = CheckedSteps(cli.make_train_step, same_text_encoder)
        run = tmp / name
        for kernel in build.KERNELS.values():
            kernel.launches = 0
        with patched(cli, "make_train_step", steps):
            if cli.main(flags + extra + ["--max_steps", str(n_steps), "--print_freq",
                                         str(freq), "--log_dir", str(run)]):
                raise AssertionError(f"real data: the {name} run failed")
        metrics = steps.finish()
        if len(metrics) != n_steps:
            raise AssertionError(f"real data: {len(metrics)} {name} steps, not {n_steps}")
        for i, launched in enumerate(steps.launches):
            want_launches = step_launches("pair")
            if {s: c for s, c in launched.items() if c} != want_launches:
                raise AssertionError(f"real data: {name} step {i} launched {launched}, "
                                     f"not {want_launches}")
        log = (run / "log.txt").read_text()
        loaded = f"text_encoder: loaded {len(want)} RoBERTa leaves"
        if loaded not in log:
            raise AssertionError(f"real data: the {name} log lacks '{loaded}'")
        if n_steps > RATE_FREQ:
            rates[name] = cli_rate(run)
        torch.cuda.empty_cache()
        print(f"real data: {name} run, {n_steps} steps at batch {BATCH}: losses "
              f"{[round(m[0], 4) for m in metrics]}, grad_norm "
              f"{[round(m[1], 4) for m in metrics]}; {loaded}; the text encoder before "
              f"step 1 is the seeded one bit for bit; every step launched "
              f"{step_launches('pair')}")
    # the same CLI on synthetic scenes (64-token texts), same batch and workers
    if cli.main(["--dataset", "synthetic", "--use_color", "--data_root", str(tmp / "none"),
                 "--batch_size", str(BATCH), "--num_workers", "4", "--max_steps",
                 str(REAL_STEPS), "--print_freq", str(RATE_FREQ),
                 "--log_dir", str(tmp / "synthetic")]):
        raise AssertionError("real data: the synthetic CLI run failed")
    rates["synthetic"] = cli_rate(tmp / "synthetic")
    torch.cuda.empty_cache()
    for name, (rate, first, last) in rates.items():
        print(f"real data: CLI on {name} {rate:.3f} steps/s = {rate * BATCH:.2f} scenes/s at "
              f"batch {BATCH}, 4 loader threads (metrics.jsonl times, steps {first} -> "
              f"{last}, loader waits included)")

    evaluated = tmp / "eval"
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    if cli.main(flags + ["--eval", "--checkpoint_path", str(tmp / "scanrefer" / "ckpt"),
                         "--log_dir", str(evaluated)]):
        raise AssertionError("real data: the eval run failed")
    n_val = len(ids["val"]) * REAL_ANNOS
    batches = -(-n_val // BATCH)
    check_launches({s: 0 for s in launch_counts()},
                   {s: c * batches for s, c in forward_launches("pair").items()},
                   "real data eval")
    log = (evaluated / "log.txt").read_text()
    (val,) = [json.loads(line) for line in (evaluated / "metrics.jsonl").read_text()
              .splitlines() if json.loads(line)["group"] == "val"]
    accs = {k: v for k, v in val.items() if "Acc" in k}
    if not accs or not all(0.0 <= v <= 1.0 for v in accs.values()):
        raise AssertionError(f"real data: eval accuracies {accs}")
    splits = [line for line in log.splitlines()
              if re.match(r"^(vd|vid|hard|easy|unique|multi): ", line)]
    rate = re.search(r"scored (\d+) scenes in ([\d.]+) s \(([\d.]+) scenes/s", log)
    if not splits or rate is None or int(rate.group(1)) != n_val:
        raise AssertionError("real data: the eval log lacks its rate or hardness splits")
    print(f"real data: eval of {n_val} val annotations from the checkpoint: "
          f"{rate.group(3)} scenes/s ({rate.group(2)} s, the first batch and host assembly "
          f"included), {batches} batches launching {forward_launches('pair')} each; last_ "
          f"Acc@0.25 top-1 bbs {val['last_Acc0.25Top1_bbs']:.4f}, "
          f"bbf {val['last_Acc0.25Top1_bbf']:.4f}; by hardness: {'; '.join(splits)}")
    return root, ids, labels


BUTD_CLI_STEPS = 6  # --butd --butd_cls CLI steps; metrics.jsonl rows at steps 1 and 6


BUTD_STEPS = 3  # full-width butd training steps


def _turns(fns: dict) -> dict:
    """Mean host-clock ms of each of two callables, run in turns A B B A."""
    (a, fa), (b, fb) = fns.items()
    times = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        times[name].append(timed(fn)[1])
    return {k: statistics.mean(v) for k, v in times.items()}


def butd_full_width(root_cfg, butd_cfg) -> None:
    """The full-width butd serving forward and training step, each against the
    single-stage one; one trainer of each serves too (its model in eval mode)."""
    from eda_tpu_torch.entry import build_trainer

    butd = build_trainer(butd_cfg, batch_size=BATCH, device="cuda", seed=0)
    plain = build_trainer(root_cfg, batch_size=BATCH, device="cuda", seed=0)
    butd_serving(butd_cfg, butd[0].model.eval(), plain[0].model.eval())
    butd_training(butd, plain)


def butd_serving(butd_cfg, model, plain) -> None:
    """Five full-width butd serving batches from zeroed counters, each launching
    K1-K3 four times and nothing else, with a finite (8, 256, 3) ``last_center``;
    then the butd forward against the single-stage one (``plain``) on the same
    scenes, in turns; the butd forward profiled, its device busy time beside
    the "serving" phase's profiled single-stage forward of the same scenes."""
    from eda_tpu_torch.data.synthetic import DETECTED_SLOTS
    from eda_tpu_torch.entry import make_batch
    from eda_tpu_torch.ops.cuda import build

    batches = [make_batch(butd_cfg, range(BATCH * i, BATCH * (i + 1)), "cuda")
               for i in range(REQUESTS)]
    inputs = batches[0]
    if inputs["det_boxes"].shape != (BATCH, DETECTED_SLOTS, 6):
        raise AssertionError(f"butd: det_boxes {tuple(inputs['det_boxes'].shape)}")
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    times = []
    with torch.inference_mode():
        for i, batch in enumerate(batches):
            before = launch_counts()
            out, ms = timed(lambda: model(batch)["last_center"])
            times.append(ms)
            if out.shape != (BATCH, butd_cfg.num_queries, 3) or not torch.isfinite(out).all():
                raise AssertionError(f"butd request {i}: bad last_center {tuple(out.shape)}")
            check_launches(before, forward_launches("pair"), f"butd request {i}")
        last = batches[-1]
        single = {k: v for k, v in last.items() if not k.startswith("det_")}
        med = _turns({"single-stage": lambda: plain(single), "butd": lambda: model(last)})
        busy = {"single-stage": PROFILED["serving forward"],
                "butd": profile(lambda: model(last), "butd serving forward", top=3)}
    print(f"butd serving forward, batch {BATCH}: requests {[round(t, 2) for t in times]} ms, "
          f"each launching {forward_launches('pair')}, last_center finite")
    print(f"butd vs single-stage serving forward, same scenes, turns A B B A: "
          f"{med['butd']:.2f} vs {med['single-stage']:.2f} ms per batch "
          f"({100 * (med['butd'] / med['single-stage'] - 1):+.1f}%); device busy "
          f"{busy['butd']:.2f} vs {busy['single-stage']:.2f} ms "
          f"({100 * (busy['butd'] / busy['single-stage'] - 1):+.1f}%)")


def butd_training(butd, plain) -> None:
    """``BUTD_STEPS`` full-width butd training steps (``butd``: state, step,
    batch): finite loss and ``grad_norm``, each launching as the single-stage
    step; after the first, the frozen class table equals p (1 - lr wd) within
    one f32 ulp and has no gradient. Then the butd step against the
    single-stage one (``plain``), in turns; the butd step profiled, its device
    busy time beside the "training" phase's profiled single-stage step."""
    from eda_tpu_torch.ops.cuda import build

    state, step, batch = butd
    table = state.model.butd_class_embeddings.weight
    decayed = table.detach() * (1 - state.optimizer.schedules["main"](0)
                                * state.optimizer.cfg.weight_decay)
    ulp = (torch.nextafter(decayed, torch.full_like(decayed, math.inf)) - decayed).abs()
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    times = []
    for i in range(BUTD_STEPS):
        before = launch_counts()
        metrics, ms = timed(lambda: step(state, batch))
        times.append(ms)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"butd step {i}: loss {loss}, grad_norm {norm}")
        check_launches(before, step_launches("pair"), f"butd step {i}")
        if i == 0:
            off = ((table.detach() - decayed).abs() > ulp).sum().item()
            if off or table.grad is not None:
                raise AssertionError(f"butd step 0: {off} class-table entries are not "
                                     f"p (1 - lr wd) within an ulp, or it has a gradient")
        print(f"butd step {i}: {BATCH} scenes in {ms:.2f} ms, loss {loss:.4f}, "
              f"grad_norm {norm:.4f}")
    plain, plain_step, plain_batch = plain
    med = _turns({"single-stage": lambda: plain_step(plain, plain_batch),
                  "butd": lambda: step(state, batch)})
    busy = {"single-stage": PROFILED["training step"],
            "butd": profile(lambda: step(state, batch), "butd training step", top=3)}
    print(f"butd training, batch {BATCH}: every step launched {step_launches('pair')}; the "
          f"class table after step 0 is p (1 - lr wd) within one f32 ulp, no gradient")
    print(f"butd vs single-stage training step, turns A B B A: {med['butd']:.2f} vs "
          f"{med['single-stage']:.2f} ms per step "
          f"({100 * (med['butd'] / med['single-stage'] - 1):+.1f}%); device busy "
          f"{busy['butd']:.2f} vs {busy['single-stage']:.2f} ms "
          f"({100 * (busy['butd'] / busy['single-stage'] - 1):+.1f}%)")


def butd_cli(root: Path, ids: dict, labels: dict, tmp: Path) -> None:
    """The CLI at full width on the "real data" phase's fabricated tree, with
    GroupFree-format detections for both splits: ``--butd --butd_cls``
    training steps, the grounding eval with the filter from their checkpoint,
    and the ScanNet detection eval (``--test_dataset scannet --butd``)."""
    import numpy as np
    from real_data_fixtures import CheckedSteps, fabricate_detections

    from eda_tpu_torch.ops.cuda import build
    from eda_tpu_torch.train import cli

    fabricate_detections(root, ids, labels, np.random.default_rng(0))
    flags = ["--dataset", "scanrefer", "--use_color", "--data_root", str(root),
             "--batch_size", str(BATCH), "--num_workers", "4", "--butd"]
    run = tmp / "butd"
    steps = CheckedSteps(cli.make_train_step)
    with patched(cli, "make_train_step", steps):
        if cli.main(flags + ["--butd_cls", "--max_steps", str(BUTD_CLI_STEPS), "--print_freq",
                             str(BUTD_CLI_STEPS - 1), "--log_dir", str(run)]):
            raise AssertionError("butd: the --butd --butd_cls CLI run failed")
    metrics = steps.finish()
    for i, launched in enumerate(steps.launches):
        if {s: c for s, c in launched.items() if c} != step_launches("pair"):
            raise AssertionError(f"butd: CLI step {i} launched {launched}")
    rate, first, last = cli_rate(run)
    print(f"butd: CLI --butd --butd_cls on real-format data, {BUTD_CLI_STEPS} steps at batch "
          f"{BATCH}: losses {[round(m[0], 4) for m in metrics]}; {rate:.3f} steps/s = "
          f"{rate * BATCH:.2f} scenes/s (metrics.jsonl times, steps {first} -> {last}, loader "
          f"waits included); every step launched {step_launches('pair')}")
    torch.cuda.empty_cache()

    ckpt = str(run / "ckpt")
    for name, extra in (("grounding", ["--butd_cls"]), ("detection", ["--test_dataset",
                                                                       "scannet"])):
        out = tmp / f"butd_{name}"
        for kernel in build.KERNELS.values():
            kernel.launches = 0
        if cli.main(flags + extra + ["--eval", "--checkpoint_path", ckpt, "--log_dir", str(out)]):
            raise AssertionError(f"butd: the {name} eval failed")
        log = (out / "log.txt").read_text()
        scored = re.search(r"scored (\d+) scenes in ([\d.]+) s \(([\d.]+) scenes/s", log)
        if scored is None:
            raise AssertionError(f"butd: the {name} eval log lacks its rate")
        n = int(scored.group(1))
        check_launches({s: 0 for s in launch_counts()},
                       {s: c * -(-n // BATCH) for s, c in forward_launches("pair").items()},
                       f"butd {name} eval")
        if name == "grounding":
            (val,) = [json.loads(line) for line in (out / "metrics.jsonl").read_text()
                      .splitlines() if json.loads(line)["group"] == "val"]
            accs = {k: v for k, v in val.items() if "Acc" in k}
            if n != len(ids["val"]) * REAL_ANNOS or not accs or not all(
                    0.0 <= v <= 1.0 for v in accs.values()):
                raise AssertionError(f"butd: grounding eval of {n} scenes, accuracies {accs}")
            result = (f"last_ Acc@0.25 top-1 bbs {val['last_Acc0.25Top1_bbs']:.4f}, bbf "
                      f"{val['last_Acc0.25Top1_bbf']:.4f}")
        else:
            maps = {float(t): float(v) for t, v in
                    re.findall(r"detection mAP@([\d.]+): ([\d.naif]+)", log)}
            if sorted(maps) != [0.25, 0.5] or not all(0.0 <= v <= 1.0 for v in maps.values()):
                raise AssertionError(f"butd: detection mAPs {maps}")
            result = f"mAP@0.25 {maps[0.25]:.4f}, mAP@0.5 {maps[0.5]:.4f}"
        print(f"butd: CLI {name} eval ({' '.join(extra)}) of {n} val scenes from the "
              f"checkpoint: {scored.group(3)} scenes/s ({scored.group(2)} s, the first batch "
              f"and host assembly included), each batch launching {forward_launches('pair')}; "
              f"{result}")
        torch.cuda.empty_cache()


def butd_phase(root_cfg, root: Path, ids: dict, labels: dict, tmp: Path) -> None:
    """The two-stage grounder (``butd=True``): the tiny model on the card
    against its CPU twin (forward, training step, the ``--butd_cls`` IoU
    stack), the full-width serving forward and training step, and the CLI on
    the fabricated real-format tree."""
    butd_cfg = dataclasses.replace(root_cfg, butd=True)
    for name, fn, args in (
            ("tiny model", small_model_check, (butd_cfg,)),
            ("tiny training step", small_train_check,
             (butd_cfg, BUTD_GRAD_NORM_REL, BUTD_NOISE_DRAWS)),
            ("tiny eval", small_eval_check, (butd_cfg, True)),
            ("full width", butd_full_width, (root_cfg, butd_cfg)),
            ("cli", butd_cli, (root, ids, labels, tmp))):
        t = time.perf_counter()
        fn(*args)
        torch.cuda.empty_cache()
        print(f"butd {name}: {time.perf_counter() - t:.1f} s")


def exact_repeat_check(state, step, batch, label: str) -> None:
    """Two training steps from one state (a deep copy of ``state``) give every
    metric, parameter, BatchNorm statistic and AdamW moment bit for bit."""
    import copy

    twin = copy.deepcopy(state)
    if not _same_state(state, twin):
        raise AssertionError(f"{label}: the copied state is not the state")
    m1, m2 = step(state, batch), step(twin, batch)
    differ = sorted(k for k in m1 if not torch.equal(m1[k], m2[k]))
    s1, s2 = state.model.state_dict(), twin.model.state_dict()
    tensors = [k for k in s1 if not torch.equal(s1[k], s2[k])]
    if differ or tensors or not _same_state(state, twin):
        worst = max(((s1[k] - s2[k]).abs().max().item(), k) for k in s1)
        raise AssertionError(f"{label}: two steps from one state differ: metrics {differ}, "
                             f"{len(tensors)} of {len(s1)} state tensors (largest "
                             f"{worst[0]:.3g} at {worst[1]}), or the moments")
    print(f"{label}: two steps from one state: all {len(m1)} metrics, all {len(s1)} state "
          f"tensors and every AdamW moment bit-identical")
    del twin


F32_STEPS = 3  # full-width f32 training steps


def f32_phase(root_cfg) -> list:
    """The f32 model, ``ModelConfig(use_bf16=False)``: K2f / K7f edge checks,
    the tiny model, step and scoring against their CPU twins, then at full
    width K2f / K7f against their plain versions, ``REQUESTS`` serving batches
    and ``F32_STEPS`` training steps with their launches, a profiled forward
    and step, and two steps from one state bit for bit. Returns the kernel
    rows of K2f and K7f."""
    from eda_tpu_torch.entry import build as build_model
    from eda_tpu_torch.entry import build_trainer, make_batch
    from eda_tpu_torch.ops import fused_sa
    from eda_tpu_torch.ops.cuda import build

    prep_f32_edge_check()
    small_model_check(root_cfg)
    small_train_check(root_cfg)
    small_eval_check(root_cfg)

    cfg = root_cfg
    prep = lambda kw, _: F32_PREP if f32_prep(kw) else "sa_prep_launch"  # noqa: E731
    model, inputs = build_model(cfg, batch_size=BATCH, device="cuda", seed=0)
    with Recorder([(fused_sa, "sa_prep", prep)]) as rec:
        with torch.inference_mode():
            model(inputs)
    torch.cuda.synchronize()
    rows = check_kernels(rec.calls, (F32_PREP,), {F32_PREP: 4})
    del rec
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    times = []
    with torch.inference_mode():
        for i in range(REQUESTS):
            batch = make_batch(cfg, range(BATCH * i, BATCH * (i + 1)), "cuda") if i else inputs
            before = launch_counts()
            out, ms = timed(lambda: model(batch)["last_center"])
            times.append(ms)
            if out.shape != (BATCH, cfg.num_queries, 3) or not torch.isfinite(out).all():
                raise AssertionError(f"f32 request {i}: bad last_center {tuple(out.shape)}")
            check_launches(before, forward_launches("pair", f32=True), f"f32 request {i}")
        rows[0]["launches"] = launch_counts()[F32_PREP]
        print(f"f32 serving forward, batch {BATCH}: {statistics.median(times[1:]):.2f} ms per "
              f"batch (median of requests 1-{REQUESTS - 1}), every launch as counted")
        profile(lambda: model(batch), "f32 serving forward")
    del model, inputs, batch
    torch.cuda.empty_cache()

    state, step, batch = build_trainer(cfg, batch_size=BATCH, device="cuda", seed=0)
    with Recorder([(fused_sa, "sa_prep_bwd", lambda kw, _: F32_PREP_BWD)]) as rec:
        step(state, batch)
    torch.cuda.synchronize()
    rows += check_kernels(rec.calls, (F32_PREP_BWD,), {F32_PREP_BWD: 4})
    del rec
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    times = []
    for i in range(F32_STEPS):
        before = launch_counts()
        metrics, ms = timed(lambda: step(state, batch))
        times.append(ms)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"f32 step {i}: loss {loss}, grad_norm {norm}")
        check_launches(before, step_launches("pair", f32=True), f"f32 step {i}")
        print(f"f32 step {i}: {ms:.2f} ms, loss {loss:.4f}, grad_norm {norm:.4f}")
    rows[1]["launches"] = launch_counts()[F32_PREP_BWD]
    profile(lambda: step(state, batch), "f32 training step",
            also=("prep_tc", "prep_fma", "split_w1"))
    exact_repeat_check(state, step, batch, "f32 full-width step")
    del state, step, batch
    torch.cuda.empty_cache()
    return rows


# The width-2 backbone ("W2X"): Group-Free-3D's Pointnet2Backbone(width=2)
# (models/backbone_module.py; its L12O256w2x / L12O512w2x ScanNet detectors)
# scales every SA and FP width of the flagship by 2. Its SA2-4 run on the wide
# pool kernels (256, 256, 512) and its SA3-4 prep at in_dim 515 with W1
# streamed. The tiny twin keeps the tiny config's depth and d_model (FP2 out 96).
W2X_SA_MLPS = ((128, 128, 256), (256, 256, 512), (256, 256, 512), (256, 256, 512))
W2X_FP_MLPS = ((512, 512), (512, 288))
W2X_TINY_FP_MLPS = ((512, 512), (512, 96))
# the wide kernels on edge inputs: ties (W3 = 0) at SA2's shape and the
# flagship window (four 64-row stages), at W = 1024 (sixteen), at W = 100 (a
# ragged last stage) with an odd count of 16-center blocks, and one cluster
# in all (batch 1, one block); (layer, widths, N, M, W[, batch]). The
# backward at W = 256 (fewer points than channels: a center's W points win
# all 512) and 512 (blocks of more than 16 tiles: the record folded several
# times), at W = 4 (every CTA fewer rows than one tile) and with more blocks
# than the card has SMs (a CTA takes several blocks in turn); and SA1's own
# shape, compact at (128, 128, 256) with W = 1024 over 50 000 points
# (pool_bwd_compact, 256 blocks over the SMs), the random winners drawn from
# a window's first 4 points, so that rows of many centers and channels tie
# on one point ((layer, widths, N, M, W[, tie pool]))
W2X_TIE_CASES = ((2, (256, 256, 512), 2048, 1024, 256), (2, (256, 256, 512), 2048, 1024, 1024),
                 (2, (256, 256, 512), 2048, 48, 100, 2), (2, (256, 256, 512), 2048, 16, 256, 1))
W2X_BWD_EDGE_CASES = ((2, (256, 256, 512), 2048, 1024, 256),
                      (2, (256, 256, 512), 2048, 1024, 512),
                      (2, (256, 256, 512), 1024, 64, 4),
                      (2, (256, 256, 512), 8192, 4096, 256),
                      (1, (128, 128, 256), 50000, 2048, 1024, 4))
W2X_STEPS = 3  # full-width W2X training steps
# The tiny W2X step's leaves are held as the flagship's, but those that fail
# the per-leaf gates on the CPU itself once its pools' values move by one bf16
# step (its 512-channel pools carry more of that rounding into the heads: a
# leaf summing L1 signs, such as a center head's bias, flips with it) are held
# by the global cosine only (at most BUTD_MAX_NOISY), as the butd step's noisy
# leaves are
W2X_POOL_NOISE = 2.0 ** -8


def w2x_configs(root_cfg):
    """(W2X at full width, its tiny twin) from ``root_cfg``'s other fields."""
    cfg = dataclasses.replace(root_cfg, sa_mlps=W2X_SA_MLPS, fp_mlps=W2X_FP_MLPS)
    tiny = dataclasses.replace(root_cfg.tiny(), sa_mlps=W2X_SA_MLPS, fp_mlps=W2X_TINY_FP_MLPS)
    return cfg, tiny


# The width-4 backbone ("W4X"): Group-Free-3D's Pointnet2Backbone(width=4), the
# constructor whose width=2 gives W2X, every SA and FP width of the flagship
# times 4. Its SA1 runs the wide pool (256, 256, 512) and K2 / K2f at c1 256,
# its SA2-4 the pool at (512, 512, 1024) (csrc/sa_pair_pool_512.cu, with winners
# for training), its backward (csrc/sa_pair_pool_bwd_512.cu) and K2 / K2f and
# K7 / K7f at c1 512 (csrc/sa_prep_512.cu, csrc/sa_prep_bwd_512.cu).
W4X_SA_MLPS = ((256, 256, 512), (512, 512, 1024), (512, 512, 1024), (512, 512, 1024))
W4X_FP_MLPS = ((1024, 1024), (1024, 288))
W4X_TINY_FP_MLPS = ((1024, 1024), (1024, 96))


def w4x_configs(root_cfg):
    """(W4X at full width, its tiny twin) from ``root_cfg``'s other fields."""
    cfg = dataclasses.replace(root_cfg, sa_mlps=W4X_SA_MLPS, fp_mlps=W4X_FP_MLPS)
    tiny = dataclasses.replace(root_cfg.tiny(), sa_mlps=W4X_SA_MLPS, fp_mlps=W4X_TINY_FP_MLPS)
    return cfg, tiny


@dataclasses.dataclass(frozen=True)
class TinyOf:
    """A stand-in root config whose ``tiny()`` is ``cfg``: the small checks
    build their model from ``root_cfg.tiny()``."""

    cfg: object

    def tiny(self):
        return self.cfg


def w2x_phase(root_cfg) -> list:
    """The width-2 backbone, ``w2x_configs(ModelConfig(use_bf16=True))``: the
    wide pool on tie inputs and its backward on edge inputs; K2 on the edge
    inputs at c1 256 (``prep_edge_check(wide=True)``); the tiny W2X
    model, step and scoring against their CPU twins; at full width (batch 8)
    K2, K3 / K4, K5 / K6 and K7 against their plain versions on a forward's
    and a step's inputs, ``REQUESTS`` serving batches and ``W2X_STEPS`` steps
    with their launches, the ``mxu`` and ``pre`` kernels on a forward and a
    step (``radius_mode_phase``), one scored eval batch under each radius
    test, a profiled forward and step, and two steps from one state bit for
    bit. Returns the kernel rows, named with " (w2x)"."""
    from eda_tpu_torch.entry import build as build_model
    from eda_tpu_torch.entry import build_evaluator, build_trainer, make_batch
    from eda_tpu_torch.ops import fused_sa
    from eda_tpu_torch.ops.cuda import build

    cfg, tiny = w2x_configs(root_cfg)
    pool_tie_check(W2X_TIE_CASES)
    pool_bwd_edge_check(W2X_BWD_EDGE_CASES)
    prep_edge_check(wide=True)
    small_model_check(TinyOf(tiny))
    small_train_check(TinyOf(tiny), noise_draws=BUTD_NOISE_DRAWS, pool_noise=W2X_POOL_NOISE)
    small_eval_check(TinyOf(tiny))

    model, inputs = build_model(cfg, batch_size=BATCH, device="cuda", seed=0)
    serve = ("sa_prep_launch", "sa_pair_pool_launch")
    with Recorder([(fused_sa, "sa_prep", serve[0]), (fused_sa, "sa_pair_pool", serve[1])]) as rec:
        with torch.inference_mode():
            model(inputs)
    torch.cuda.synchronize()
    rows = check_kernels(rec.calls, serve, {s: 4 for s in serve})
    del rec
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    times = []
    with torch.inference_mode():
        for i in range(REQUESTS):
            batch = make_batch(cfg, range(BATCH * i, BATCH * (i + 1)), "cuda") if i else inputs
            before = launch_counts()
            out, ms = timed(lambda: model(batch)["last_center"])
            times.append(ms)
            if out.shape != (BATCH, cfg.num_queries, 3) or not torch.isfinite(out).all():
                raise AssertionError(f"w2x request {i}: bad last_center {tuple(out.shape)}")
            check_launches(before, forward_launches("pair"), f"w2x request {i}")
    counts = launch_counts()
    for row, symbol in zip(rows, serve):
        row["launches"] = counts[symbol]
    print(f"w2x serving forward, batch {BATCH}: {statistics.median(times[1:]):.2f} ms per batch "
          f"(median of requests 1-{REQUESTS - 1}), every launch as counted")
    with torch.inference_mode():
        profile(lambda: model(batch), "w2x serving forward", also=("sa_pair_pool",))

    state, step, batch = build_trainer(cfg, batch_size=BATCH, device="cuda", seed=0)
    bwd = lambda kw, _: bwd_symbol(kw["compact"])  # noqa: E731
    with Recorder([(fused_sa, "sa_pair_pool_winners", TRAINING[0]),
                   (fused_sa, "sa_pool_bwd", bwd),
                   (fused_sa, "sa_prep_bwd", TRAINING[3])]) as rec:
        step(state, batch)
    torch.cuda.synchronize()
    layers = {TRAINING[0]: 4, POOL_BWD[0]: 1, POOL_BWD[1]: 3, TRAINING[3]: 4}
    train_rows = check_kernels(rec.calls, TRAINING, layers)
    del rec
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    times = []
    for i in range(W2X_STEPS):
        before = launch_counts()
        metrics, ms = timed(lambda: step(state, batch))
        times.append(ms)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"w2x step {i}: loss {loss}, grad_norm {norm}")
        check_launches(before, step_launches("pair"), f"w2x step {i}")
        print(f"w2x step {i}: {ms:.2f} ms, loss {loss:.4f}, grad_norm {norm:.4f}")
    counts = launch_counts()
    for row, symbol in zip(train_rows, TRAINING):
        row["launches"] = counts[symbol]
    rows += train_rows
    profile(lambda: step(state, batch), "w2x training step", also=("pool_bwd", "sa_pair_pool"))

    for mode in ("mxu", "pre"):
        rows += radius_mode_phase(mode, model, inputs, state, step, batch)
    exact_repeat_check(state, step, batch, "w2x full-width step")
    del model, inputs, state, step, batch
    torch.cuda.empty_cache()

    evaluator_model, score_step, evaluator, batch = build_evaluator(cfg, batch_size=BATCH,
                                                                    device="cuda")
    positive_sizes(evaluator_model)
    eval_launches = {}
    for mode in ("pair", "mxu", "pre"):
        with radius_mode(mode):
            before = launch_counts()
            ious, ms = timed(lambda: score_step(batch))
        check_launches(before, forward_launches(mode), f"w2x {mode} eval batch")
        eval_launches.update({s: n - before[s] for s, n in launch_counts().items()
                              if n != before[s]})
        if (ious.shape != IOU_SHAPE or not torch.isfinite(ious).all() or ious.min() < 0
                or ious.max() > 1):
            raise AssertionError(f"w2x {mode} eval batch: bad IoU stack {tuple(ious.shape)}")
        print(f"w2x eval under {mode}, batch {BATCH}: {ms:.2f} ms, IoU stack finite in [0, 1], "
              f"largest {ious.max().item():.4f}")
    for row in rows[len(serve) + len(TRAINING):]:
        if not row["name"].endswith("winners"):
            row["launches"] = eval_launches[row["name"] + "_launch"]
    del evaluator_model, score_step, evaluator, batch
    torch.cuda.empty_cache()
    for row in rows:
        row["name"] += " (w2x)"
    return rows


# the f32 gates of the tiny f32 step against its twin, as
# tests/test_torch_f32_train_step.py holds the f32 step to JAX: the gradient's
# global cosine and grad_norm
F32_GLOBAL_COS, F32_GRAD_NORM_REL = 0.98, 0.05
W2X_F32_REQUESTS = 3  # full-width f32 W2X serving batches (the smoke's time)


def w2x_f32_phase(root_cfg) -> list:
    """The f32 width-2 backbone, ``w2x_configs(ModelConfig())``: K2f and K7f on
    the edge inputs of the tensor route above c1 128 and at the in_dim limits
    of c1 256 (``prep_f32_edge_check(wide=True)``); the tiny f32 W2X model,
    step and scoring against their CPU twins (the step under the f32 gates,
    ``F32_GLOBAL_COS`` and ``F32_GRAD_NORM_REL``, every leaf under the
    per-leaf gates: no leaf excused); at full width (batch 8) K2f and K7f
    against their plain versions on a forward's and a step's inputs,
    ``W2X_F32_REQUESTS`` serving batches and ``W2X_STEPS`` training steps
    with their launches, a profiled forward and step, two steps from one state bit for
    bit and one eval batch scored under ``pair``. Its pools are the bf16 W2X
    phase's kernels. Returns the K2f and K7f rows, named with " (w2x f32)"."""
    from eda_tpu_torch.entry import build as build_model
    from eda_tpu_torch.entry import build_evaluator, build_trainer, make_batch
    from eda_tpu_torch.ops import fused_sa
    from eda_tpu_torch.ops.cuda import build

    cfg, tiny = w2x_configs(root_cfg)
    prep_f32_edge_check(wide=True)
    small_model_check(TinyOf(tiny))
    small_train_check(TinyOf(tiny), grad_norm_rel=F32_GRAD_NORM_REL,
                      global_cos=F32_GLOBAL_COS)
    small_eval_check(TinyOf(tiny))

    prep = lambda kw, _: F32_PREP if f32_prep(kw) else "sa_prep_launch"  # noqa: E731
    model, inputs = build_model(cfg, batch_size=BATCH, device="cuda", seed=0)
    with Recorder([(fused_sa, "sa_prep", prep)]) as rec:
        with torch.inference_mode():
            model(inputs)
    torch.cuda.synchronize()
    rows = check_kernels(rec.calls, (F32_PREP,), {F32_PREP: 4})
    del rec
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    times = []
    with torch.inference_mode():
        for i in range(W2X_F32_REQUESTS):
            batch = make_batch(cfg, range(BATCH * i, BATCH * (i + 1)), "cuda") if i else inputs
            before = launch_counts()
            out, ms = timed(lambda: model(batch)["last_center"])
            times.append(ms)
            if out.shape != (BATCH, cfg.num_queries, 3) or not torch.isfinite(out).all():
                raise AssertionError(f"w2x f32 request {i}: bad last_center {tuple(out.shape)}")
            check_launches(before, forward_launches("pair", f32=True), f"w2x f32 request {i}")
        rows[0]["launches"] = launch_counts()[F32_PREP]
        print(f"w2x f32 serving forward, batch {BATCH}: {statistics.median(times[1:]):.2f} ms "
              f"per batch (median of requests 1-{W2X_F32_REQUESTS - 1}), every launch as "
              f"counted")
        profile(lambda: model(batch), "w2x f32 serving forward",
                also=("prep_fwd_cluster", "prep_tc", "split_w1"))
    del model, inputs, batch
    torch.cuda.empty_cache()

    state, step, batch = build_trainer(cfg, batch_size=BATCH, device="cuda", seed=0)
    with Recorder([(fused_sa, "sa_prep_bwd", lambda kw, _: F32_PREP_BWD)]) as rec:
        step(state, batch)
    torch.cuda.synchronize()
    rows += check_kernels(rec.calls, (F32_PREP_BWD,), {F32_PREP_BWD: 4})
    del rec
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    for i in range(W2X_STEPS):
        before = launch_counts()
        metrics, ms = timed(lambda: step(state, batch))
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"w2x f32 step {i}: loss {loss}, grad_norm {norm}")
        check_launches(before, step_launches("pair", f32=True), f"w2x f32 step {i}")
        print(f"w2x f32 step {i}: {ms:.2f} ms, loss {loss:.4f}, grad_norm {norm:.4f}")
    rows[1]["launches"] = launch_counts()[F32_PREP_BWD]
    profile(lambda: step(state, batch), "w2x f32 training step",
            also=("prep_fwd_cluster", "prep_tc", "prep_fma", "split_w1", "reduce_records"))
    exact_repeat_check(state, step, batch, "w2x f32 full-width step")
    del state, step, batch
    torch.cuda.empty_cache()

    evaluator_model, score_step, evaluator, batch = build_evaluator(cfg, batch_size=BATCH,
                                                                    device="cuda")
    positive_sizes(evaluator_model)
    with radius_mode("pair"):
        before = launch_counts()
        ious, ms = timed(lambda: score_step(batch))
    check_launches(before, forward_launches("pair", f32=True), "w2x f32 pair eval batch")
    if (ious.shape != IOU_SHAPE or not torch.isfinite(ious).all() or ious.min() < 0
            or ious.max() > 1):
        raise AssertionError(f"w2x f32 eval batch: bad IoU stack {tuple(ious.shape)}")
    print(f"w2x f32 eval under pair, batch {BATCH}: {ms:.2f} ms, IoU stack finite in [0, 1], "
          f"largest {ious.max().item():.4f}")
    del evaluator_model, score_step, evaluator, batch
    torch.cuda.empty_cache()
    for row in rows:
        row["name"] += " (w2x f32)"
    return rows


W4X_REQUESTS = 3  # full-width f32 W4X serving batches (the bf16 phase serves REQUESTS)
W4X_STEPS = 3  # full-width W4X training steps a phase
# CPU draws of the tiny W4X step's noise rule (each a CPU step of the 1024-wide
# model; fewer draws excuse fewer leaves, so one keeps the check as strict)
W4X_NOISE_DRAWS = 1
# the pool at XL, with and without winners, on tie inputs (pool_tie_check; W3
# = 0: every in-radius pair of a center gives b3 exactly, so the tie rule
# alone sets the winners: ties inside a 64-point item and across items, over
# both warpgroups' columns): SA2's shape at the W4X window, two radius-test
# stages of 1024 points (W = 2048), a ragged window (W = 100) with an odd
# count of blocks, one block in all; (layer, widths, N, M, W, batch)
W4X_TIE_CASES = ((2, (512, 512, 1024), 2048, 1024, 256, 2),
                 (2, (512, 512, 1024), 4096, 256, 2048, 1),
                 (2, (512, 512, 1024), 2048, 48, 100, 2), (2, (512, 512, 1024), 2048, 16, 256, 1))


# the pool backward at XL on edge inputs (pool_bwd_edge_check, both variants):
# SA2's shape at the W4X window, W = 2048 (where the model's backward at c3
# 1024 is the compact one) and winners drawn from the window's first 4 points
# (rows of many centers tied on one point); (layer, widths, N, M, W[, tie pool])
W4X_BWD_EDGE_CASES = ((2, (512, 512, 1024), 2048, 1024, 256),
                      (2, (512, 512, 1024), 4096, 256, 2048),
                      (2, (512, 512, 1024), 2048, 256, 256, 4))


def xl_symbol(kw, args) -> str:
    """The serving pool symbol a recorded call runs on: its widths' kernel."""
    from eda_tpu_torch.ops.cuda.sa_kernel import XL, kernel_widths

    widths = kernel_widths(args[0].shape[-1], *args[9].shape)
    mode = kw.get("d2_mode") or "pair"
    return pool_symbol_xl(mode) if widths == XL else pool_symbol(mode, False)


def prep_symbol(kw, args) -> str:
    """The prep symbol a recorded call runs on: by dtype and c1."""
    from eda_tpu_torch.ops.cuda.sa_prep import WIDE_C1

    f32, xl = f32_prep(kw), args[1].shape[1] > WIDE_C1
    return (F32_PREP_XL if xl else F32_PREP) if f32 else (PREP_XL if xl else "sa_prep_launch")


def winners_symbol(kw, args) -> str:
    """The winners pool symbol a recorded call runs on: its widths' kernel."""
    from eda_tpu_torch.ops.cuda.sa_kernel import XL, kernel_widths

    widths = kernel_widths(args[0].shape[-1], *args[9].shape)
    mode = kw.get("d2_mode") or "pair"
    return pool_symbol_xl(mode, True) if widths == XL else pool_symbol(mode, True)


def pool_bwd_symbol(kw, args) -> str:
    """The pool backward symbol a recorded call runs on: its variant and widths' kernel."""
    from eda_tpu_torch.ops.cuda.sa_kernel import XL, kernel_widths
    from eda_tpu_torch.ops.cuda.sa_pool_bwd import WIDE

    widths = kernel_widths(args[0].shape[-1], *args[9].shape)
    return bwd_symbol(kw["compact"], widths == XL, widths == WIDE)


def prep_bwd_symbol(kw, args) -> str:
    """The prep backward symbol a recorded call runs on: by dtype and c1."""
    from eda_tpu_torch.ops.cuda.sa_prep import WIDE_C1

    f32, xl = f32_prep(kw), args[2].shape[1] > WIDE_C1
    return ((F32_PREP_BWD_XL if xl else F32_PREP_BWD) if f32
            else (PREP_BWD_XL if xl else "sa_prep_bwd_launch"))


def w4x_step_launches(mode: str, f32: bool = False) -> dict:
    """Kernel launches of one W4X training step: SA1 on the flagship's kernels at
    (256, 256, 512) (its backward the compact one at W = 1024), SA2-4 on the XL
    winners pool, the XL windowed backward and the c1-512 prep and its backward."""
    out = {"fps_launch": 4, F32_PREP if f32 else "sa_prep_launch": 1,
           F32_PREP_XL if f32 else PREP_XL: 3, pool_symbol(mode, True): 1,
           pool_symbol_xl(mode, True): 3, POOL_BWD_WC: 1, POOL_BWD_XL[1]: 3,
           F32_PREP_BWD if f32 else "sa_prep_bwd_launch": 1,
           F32_PREP_BWD_XL if f32 else PREP_BWD_XL: 3}
    if mode == "pre":
        out[MASK] = 4
    return out


def w4x_forward_launches(mode: str, f32: bool = False) -> dict:
    """Kernel launches of one W4X forward: SA1 on the flagship's kernels at
    (256, 256, 512), SA2-4 on the XL pool and the c1-512 prep."""
    out = {"fps_launch": 4, F32_PREP if f32 else "sa_prep_launch": 1,
           F32_PREP_XL if f32 else PREP_XL: 3, pool_symbol(mode, False): 1,
           pool_symbol_xl(mode): 3}
    if mode == "pre":
        out[MASK] = 4
    return out


# the c1-512 prep (K2 / K2f) on edge inputs: (B, N, in_dim, c1, radius, xyz
# scale, feature scale) by name; W4X's SA2 and SA3 / SA4 widths at ragged rows,
# the tile edges, 3 rows and SA4's batch-8 4 096; c1 512 at in_dim 3 and at the
# largest, 2048; odd c1 (257, 300, 384); large points; and W4X's SA1, c1 256 at
# in_dim 6 on the flagship kernels (K2f's FMA route)
W4X_PREP_CASES = {
    "W4X SA2 widths (515, 512), 1 x 3 rows": (1, 3, 515, 512, 0.4, 4.0, 1.0),
    "W4X SA2 widths (515, 512), 2 x 2049 rows": (2, 2049, 515, 512, 0.4, 4.0, 1.0),
    "W4X SA3 widths (1027, 512), 8 x 1001 rows": (8, 1001, 1027, 512, 0.8, 4.0, 1.0),
    "W4X SA3 widths (1027, 512), 1 x 63 rows": (1, 63, 1027, 512, 0.8, 4.0, 1.0),
    "W4X SA3 widths (1027, 512), 1 x 65 rows": (1, 65, 1027, 512, 0.8, 4.0, 1.0),
    "W4X SA3 widths (1027, 512), 1 x 129 rows": (1, 129, 1027, 512, 0.8, 4.0, 1.0),
    "W4X SA4 widths (1027, 512), 1 x 4096 rows": (1, 4096, 1027, 512, 1.2, 4.0, 1.0),
    "c1 512, in_dim 3, 2 x 100 rows": (2, 100, 3, 512, 0.2, 4.0, 1.0),
    "c1 512, in_dim 2048 (the largest), 130 rows": (1, 130, 2048, 512, 0.4, 4.0, 1.0),
    "widths (600, 257), 2 x 77 rows": (2, 77, 600, 257, 0.4, 4.0, 1.0),
    "widths (303, 300), 2 x 77 rows": (2, 77, 303, 300, 0.4, 4.0, 1.0),
    "widths (387, 384), 2 x 77 rows": (2, 77, 387, 384, 0.4, 4.0, 1.0),
    "large-magnitude points, W4X SA3 widths, 300 rows": (1, 300, 1027, 512, 0.8, 500.0, 50.0),
    "W4X SA1 widths (6, 256), 2 x 2049 rows": (2, 2049, 6, 256, 0.2, 4.0, 1.0),
    "large-magnitude points, W4X SA1 widths, 4100 rows": (1, 4100, 6, 256, 0.2, 500.0, 50.0),
}


def w4x_prep_edge_inputs(seed=0) -> dict:
    """name -> ((pts, w1, b1, scale, lnb) CPU tensors, radius) of ``W4X_PREP_CASES``."""
    g = torch.Generator().manual_seed(seed)
    cases = {}
    for name, (B, N, in_dim, c1, radius, scale_xyz, scale_f) in W4X_PREP_CASES.items():
        pts = torch.cat([(torch.rand(B, N, 3, generator=g) * 2 - 1) * scale_xyz,
                         torch.randn(B, N, in_dim - 3, generator=g) * scale_f], -1)
        w1 = torch.randn(in_dim, c1, generator=g) * in_dim ** -0.5
        b1 = torch.randn(c1, generator=g) * 0.1
        scale = 1 + 0.1 * torch.randn(c1, generator=g)
        lnb = 0.1 * torch.randn(c1, generator=g)
        cases[name] = (pts, w1, b1, scale, lnb), radius
    return cases


@torch.no_grad()
def w4x_prep_edge_check(f32: bool) -> None:
    """K2 (or K2f with ``f32``) on ``w4x_prep_edge_inputs`` against its plain
    version (K2 within 0.02 plus one bf16 step, K2f within
    ``prep_f32_tolerance``), bit-identical on a second launch, K2f's route as
    the library's; above c1 256 the backward (K7 / K7f, csrc/sa_prep_bwd_512.cu)
    on a random cotangent within ``PREP_BWD_REL`` / ``PREP_F32_BWD_REL`` of
    each output's largest value and bit-identical on a second launch; in_dim
    2049 and c1 513 raise."""
    from eda_tpu_torch.ops.cuda import sa_prep

    dtype = torch.float32 if f32 else torch.bfloat16
    kw = dict(compute_dtype=dtype)
    for name, (args, radius) in w4x_prep_edge_inputs().items():
        pts, w1, b1, scale, lnb = (a.cuda() for a in args)
        (in_dim, c1), rows = w1.shape, pts.shape[0] * pts.shape[1]
        got = sa_prep.sa_prep(pts, w1, b1, scale, lnb, radius=radius, **kw)
        again = sa_prep.sa_prep(pts, w1, b1, scale, lnb, radius=radius, **kw)
        want = sa_prep.sa_prep_plain(pts, w1, b1, scale, lnb, radius=radius, **kw)
        torch.cuda.synchronize()
        if got.dtype != dtype or got.shape != want.shape:
            raise AssertionError(f"W4X prep edge check {name}: {got.dtype} {tuple(got.shape)}")
        symbol = prep_symbol(kw, args)
        err = check_kernel(symbol, got, want, 0, ((pts, w1, b1, scale, lnb), {"radius": radius}))
        if not torch.equal(got, again):
            raise AssertionError(f"W4X prep edge check {name}: A differs between two launches")
        note = ""
        if f32:
            route = sa_prep.f32_forward_route_cuda(rows, in_dim, c1)
            if route != sa_prep.f32_forward_route(rows, in_dim, c1):
                raise AssertionError(f"W4X prep edge check {name}: the library's route {route}")
            note = f" ({route})"
        if c1 > sa_prep.WIDE_C1:
            gen = torch.Generator(device="cuda").manual_seed(rows)
            dA = torch.randn(want.shape, generator=gen, device="cuda")
            bargs = (pts, dA, w1, b1, scale)
            got_b = sa_prep.sa_prep_bwd(*bargs, radius=radius, **kw)
            again_b = sa_prep.sa_prep_bwd(*bargs, radius=radius, **kw)
            want_b = sa_prep.sa_prep_bwd_plain(*bargs, radius=radius, **kw)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(got_b, want_b)]
            tol = PREP_F32_BWD_REL if f32 else PREP_BWD_REL
            if max(errs) > tol or not all(torch.isfinite(a).all() for a in got_b):
                raise AssertionError(f"W4X prep backward edge check {name}: {errs}")
            if not all(torch.equal(a, b) for a, b in zip(got_b, again_b)):
                raise AssertionError(f"W4X prep backward edge check {name}: an output differs "
                                     f"between two launches")
            note += (f", the backward ({'K7f' if f32 else 'K7'}) within {tol} of each output's "
                     f"largest value (largest {max(errs):.2e}), bit-identical again")
        print(f"W4X prep edge check {name}: {symbol.removesuffix('_launch')}{note} max err "
              f"{err:.3e}, bit-identical on a second launch")
    g = torch.Generator().manual_seed(2)
    for in_dim, c1 in ((sa_prep.max_in_dim(512) + 1, 512), (12, sa_prep.XL_C1 + 1)):
        args = (torch.randn(1, 4, in_dim, generator=g).cuda(), torch.randn(in_dim, c1).cuda(),
                *torch.zeros(3, c1).cuda())
        try:
            sa_prep.sa_prep(*args, radius=0.4, **kw)
        except ValueError:
            continue
        raise AssertionError(f"W4X prep at ({in_dim}, {c1}) did not raise")
    print(f"W4X prep limits: in_dim {sa_prep.max_in_dim(512)} at c1 512; one more, and c1 "
          f"{sa_prep.XL_C1 + 1}, raise")


def w4x_training(cfg, label: str, f32: bool) -> list:
    """At full width (batch 8): the training kernels of one step against their
    plain versions (K4, K5, K6 and K7 in bf16: SA1 on the flagship's kernels,
    SA2-4 on the XL winners pool, the XL backward and the c1-512 prep backward;
    K7f alone in f32, whose pools are the bf16 phase's kernels), ``W4X_STEPS``
    steps with their launches (``w4x_step_launches``), a profiled step, in
    bf16 the ``mxu`` and ``pre`` winners pools on one step each
    (``w4x_radius_training``), and two steps from one state bit for bit.
    Returns the kernel rows (launches from the steps)."""
    from eda_tpu_torch.entry import build_trainer
    from eda_tpu_torch.ops import fused_sa
    from eda_tpu_torch.ops.cuda import build

    state, step, batch = build_trainer(cfg, batch_size=BATCH, device="cuda", seed=0)
    pools = (pool_symbol("pair", True), pool_symbol_xl("pair", True), POOL_BWD_WC,
             POOL_BWD_XL[1])
    prep_bwd = (F32_PREP_BWD, F32_PREP_BWD_XL) if f32 else ("sa_prep_bwd_launch", PREP_BWD_XL)
    symbols = prep_bwd if f32 else pools + prep_bwd
    with Recorder([(fused_sa, "sa_pair_pool_winners", winners_symbol),
                   (fused_sa, "sa_pool_bwd", pool_bwd_symbol),
                   (fused_sa, "sa_prep_bwd", prep_bwd_symbol)]) as rec:
        step(state, batch)
    torch.cuda.synchronize()
    rows = check_kernels(rec.calls, symbols, dict(zip(pools + prep_bwd, (1, 3, 1, 3, 1, 3))),
                         first_layer={pools[1]: 2, prep_bwd[0]: 1})
    del rec
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    for i in range(W4X_STEPS):
        before = launch_counts()
        metrics, ms = timed(lambda: step(state, batch))
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"{label} step {i}: loss {loss}, grad_norm {norm}")
        check_launches(before, w4x_step_launches("pair", f32), f"{label} step {i}")
        print(f"{label} step {i}: {ms:.2f} ms, loss {loss:.4f}, grad_norm {norm:.4f}")
    counts = launch_counts()
    for row, symbol in zip(rows, symbols):
        row["launches"] = counts[symbol]
    profile(lambda: step(state, batch), f"{label} training step",
            also=("sa_pair_pool_512", "gemm_kernel", "pool_bwd_compact_wide", "ln_backward"))
    if not f32:
        for mode in ("mxu", "pre"):
            rows += w4x_radius_training(mode, state, step, batch)
    exact_repeat_check(state, step, batch, f"{label} full-width step")
    del state, step, batch
    torch.cuda.empty_cache()
    return rows


def w4x_radius_training(mode: str, state, step, batch) -> list:
    """The mode's winners pools (SA1 on the flagship's kernel, SA2-4 on XL) on
    one full-width W4X training step with its launches, against their plain
    versions and the pair kernel; returns their rows."""
    from eda_tpu_torch.ops import fused_sa
    from eda_tpu_torch.ops.cuda import build

    symbols = (pool_symbol(mode, True), pool_symbol_xl(mode, True))
    with radius_mode(mode):
        for kernel in build.KERNELS.values():
            kernel.launches = 0
        with Recorder([(fused_sa, "sa_pair_pool_winners", winners_symbol)]) as rec:
            metrics = step(state, batch)
        torch.cuda.synchronize()
        launches = launch_counts()
        check_launches({s: 0 for s in launches}, w4x_step_launches(mode),
                       f"w4x {mode} training step")
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"w4x {mode}: non-finite training loss")
        rows = check_kernels(rec.calls, symbols, dict(zip(symbols, (1, 3))), compare_pair=True,
                             first_layer={symbols[1]: 2})
    for row, symbol in zip(rows, symbols):
        row["launches"] = launches[symbol]
    return rows


def w4x_serving(cfg, label: str, requests: int, f32: bool) -> list:
    """At full width (batch 8): the prep and (bf16; the f32 model's pools are
    the same kernels) pool calls of one forward against their plain versions,
    ``requests`` serving batches with their launches, a profiled forward; the
    kernel rows (launches from the batches)."""
    from eda_tpu_torch.entry import build as build_model
    from eda_tpu_torch.entry import make_batch
    from eda_tpu_torch.ops import fused_sa
    from eda_tpu_torch.ops.cuda import build

    model, inputs = build_model(cfg, batch_size=BATCH, device="cuda", seed=0)
    with Recorder([(fused_sa, "sa_prep", prep_symbol),
                   (fused_sa, "sa_pair_pool", xl_symbol)]) as rec:
        with torch.inference_mode():
            model(inputs)
    torch.cuda.synchronize()
    prep = (F32_PREP, F32_PREP_XL) if f32 else ("sa_prep_launch", PREP_XL)
    symbols = (*prep, pool_symbol("pair", False), pool_symbol_xl("pair"))
    checked = prep if f32 else symbols
    rows = check_kernels(rec.calls, checked, dict(zip(symbols, (1, 3, 1, 3))),
                         first_layer={prep[1]: 2, pool_symbol_xl("pair"): 2})
    del rec
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    times = []
    with torch.inference_mode():
        for i in range(requests):
            batch = make_batch(cfg, range(BATCH * i, BATCH * (i + 1)), "cuda") if i else inputs
            before = launch_counts()
            out, ms = timed(lambda: model(batch)["last_center"])
            times.append(ms)
            if out.shape != (BATCH, cfg.num_queries, 3) or not torch.isfinite(out).all():
                raise AssertionError(f"{label} request {i}: bad last_center {tuple(out.shape)}")
            check_launches(before, w4x_forward_launches("pair", f32), f"{label} request {i}")
        counts = launch_counts()
        for row, symbol in zip(rows, symbols):
            row["launches"] = counts[symbol]
        print(f"{label} serving forward, batch {BATCH}: {statistics.median(times[1:]):.2f} ms "
              f"per batch (median of requests 1-{requests - 1}), every launch as counted")
        profile(lambda: model(batch), f"{label} serving forward",
                also=("sa_pair_pool_512", "sa_prep_512", "pool_wide", "prep_fma"))
    del model, inputs, batch
    torch.cuda.empty_cache()
    return rows


def w4x_eval(cfg, label: str, modes) -> dict:
    """One scored eval batch (batch 8) under each radius test of ``modes``, with
    its launches; returns the launches by symbol."""
    from eda_tpu_torch.entry import build_evaluator

    evaluator_model, score_step, evaluator, batch = build_evaluator(cfg, batch_size=BATCH,
                                                                    device="cuda")
    positive_sizes(evaluator_model)
    launches = {}
    f32 = not cfg.use_bf16
    for mode in modes:
        with radius_mode(mode):
            before = launch_counts()
            ious, ms = timed(lambda: score_step(batch))
        check_launches(before, w4x_forward_launches(mode, f32), f"{label} {mode} eval batch")
        launches.update({s: n - before[s] for s, n in launch_counts().items() if n != before[s]})
        if (ious.shape != IOU_SHAPE or not torch.isfinite(ious).all() or ious.min() < 0
                or ious.max() > 1):
            raise AssertionError(f"{label} {mode} eval batch: bad IoU stack {tuple(ious.shape)}")
        print(f"{label} eval under {mode}, batch {BATCH}: {ms:.2f} ms, IoU stack finite in "
              f"[0, 1], largest {ious.max().item():.4f}")
    del evaluator_model, score_step, evaluator, batch
    torch.cuda.empty_cache()
    return launches


def w4x_phase(root_cfg) -> list:
    """The width-4 backbone, ``w4x_configs(ModelConfig(use_bf16=True))``: the
    XL pool with and without winners on tie inputs (``pool_tie_check`` of
    ``W4X_TIE_CASES``) and the XL backward on edge inputs
    (``W4X_BWD_EDGE_CASES``); K2 and K7 at c1 512 (and SA1's c1 256) on edge
    inputs (``w4x_prep_edge_check``); the tiny W4X model, training step and
    scoring against their CPU twins; at full width (batch 8) K2 and the pools
    of a forward against their plain versions, ``REQUESTS`` serving batches
    with their launches (K1, K2, K3 advancing by 4 a batch, SA2-4 on the
    c1-512 prep and the XL pool) and a profiled forward; the ``mxu`` and
    ``pre`` XL pools on a forward's inputs (and against the pair kernel); one
    scored eval batch under each radius test; the training step
    (``w4x_training``). Returns the kernel rows, named with " (w4x)"."""
    from eda_tpu_torch.entry import build as build_model
    from eda_tpu_torch.ops import fused_sa

    cfg, tiny = w4x_configs(root_cfg)
    pool_tie_check(W4X_TIE_CASES)
    pool_bwd_edge_check(W4X_BWD_EDGE_CASES)
    w4x_prep_edge_check(f32=False)
    small_model_check(TinyOf(tiny))
    small_train_check(TinyOf(tiny), noise_draws=W4X_NOISE_DRAWS, pool_noise=W2X_POOL_NOISE)
    small_eval_check(TinyOf(tiny))
    rows = w4x_serving(cfg, "w4x", REQUESTS, f32=False)

    model, inputs = build_model(cfg, batch_size=BATCH, device="cuda", seed=0)
    mode_rows = []
    for mode in ("mxu", "pre"):
        with radius_mode(mode):
            with Recorder([(fused_sa, "sa_pair_pool", xl_symbol)]) as rec:
                with torch.inference_mode():
                    model(inputs)
            torch.cuda.synchronize()
            mode_rows += check_kernels(rec.calls, (pool_symbol_xl(mode),),
                                       {pool_symbol_xl(mode): 3}, compare_pair=True,
                                       first_layer={pool_symbol_xl(mode): 2})
            del rec
    del model, inputs
    torch.cuda.empty_cache()
    launches = w4x_eval(cfg, "w4x", ("pair", "mxu", "pre"))
    for row in mode_rows:
        row["launches"] = launches[row["name"] + "_launch"]
    rows += mode_rows + w4x_training(cfg, "w4x", f32=False)
    for row in rows:
        row["name"] += " (w4x)"
    return rows


def w4x_f32_phase(root_cfg) -> list:
    """The f32 width-4 backbone, ``w4x_configs(ModelConfig())``: K2f and K7f at
    c1 512 and SA1's c1 256 at in_dim 6 (K2f's FMA route) on edge inputs; the
    tiny f32 W4X model, training step (under the bf16 phase's rule: at these widths
    the f32 step's gradients sit at the card's own noise level, see below) and
    scoring against their CPU twins; at full width (batch 8) K2f (SA1 on the
    FMA route, SA2-4 on the c1-512 kernel) against its plain version,
    ``W4X_REQUESTS`` serving batches with their launches, a profiled forward,
    one eval batch scored under ``pair``, and the training step
    (``w4x_training``: K7f). Returns the K2f and K7f rows, named with " (w4x
    f32)"."""
    cfg, tiny = w4x_configs(root_cfg)
    w4x_prep_edge_check(f32=True)
    small_model_check(TinyOf(tiny))
    # the bf16 phase's rule, not the f32 gates: at W4X's widths the tiny f32
    # step on the card stays at a gradient cosine of ~0.85 against its CPU
    # twin with every kernel wrapper on its plain version too (0.8475, against
    # 0.8509 with the kernels: the card's own f32 sums flip pooled near-ties),
    # and the CPU step against itself, its pooled values moved by 2^-8, at
    # 0.76-0.85 (an NVIDIA H100 80GB HBM3 at 700 W; PERF.md, the W4X training finding)
    small_train_check(TinyOf(tiny), noise_draws=W4X_NOISE_DRAWS, pool_noise=W2X_POOL_NOISE)
    small_eval_check(TinyOf(tiny))
    rows = w4x_serving(cfg, "w4x f32", W4X_REQUESTS, f32=True)
    w4x_eval(cfg, "w4x f32", ("pair",))
    rows += w4x_training(cfg, "w4x f32", f32=True)
    for row in rows:
        row["name"] += " (w4x f32)"
    return rows


GATHER_STEPS = 2  # full-width gather training steps


def gather_phase(root_cfg) -> None:
    """The gather SA (``sa_impl="gather"``): the tiny model against its CPU
    twin under ``nearest`` and ``first``; at full width in f32 (the
    reference's PointNet++) one serving batch and ``GATHER_STEPS`` training
    steps, each launching K1 four times (FPS over the whole 50 000-point
    cloud at SA1) and no other kernel; the ball query's time per layer under
    both modes; a profiled forward and step; two steps from one state."""
    from eda_tpu_torch.entry import build as build_model
    from eda_tpu_torch.entry import build_trainer
    from eda_tpu_torch.ops import pointops

    for mode in ("nearest", "first"):
        small_model_check(dataclasses.replace(root_cfg, sa_impl="gather", sa_ball_mode=mode))
    cfg = dataclasses.replace(root_cfg, sa_impl="gather")
    model, inputs = build_model(cfg, batch_size=BATCH, device="cuda", seed=0)
    with Recorder([(pointops, "furthest_point_sample", "fps_launch"),
                   (pointops, "ball_query_nearest", "ball_query_nearest")]) as rec:
        with torch.inference_mode():
            before = launch_counts()
            out, ms = timed(lambda: model(inputs)["last_center"])
            check_launches(before, {"fps_launch": 4}, "gather forward")
    if out.shape != (BATCH, cfg.num_queries, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"gather forward: bad last_center {tuple(out.shape)}")
    sizes = [tuple(a[0].shape[:2]) for a, _ in rec.calls["fps_launch"]]
    if sizes[0] != (BATCH, cfg.num_points):
        raise AssertionError(f"gather SA1 FPS ran over {sizes[0]}, not the whole cloud")
    print(f"gather forward, batch {BATCH}: {ms:.2f} ms (first call), K1 over {sizes}")
    for layer, (args, _) in enumerate(rec.calls["ball_query_nearest"], 1):
        xyz, centers, radius, nsample = args
        with torch.inference_mode():
            first = pointops.ball_query(xyz, centers, radius, nsample)
            ms_first = cuda_ms(lambda: pointops.ball_query(xyz, centers, radius, nsample), 3)
            ms_near = cuda_ms(lambda: pointops.ball_query_nearest(*args), 3)
        print(f"gather SA{layer} ball query (B={xyz.shape[0]}, N={xyz.shape[1]}, "
              f"M={centers.shape[1]}, {nsample} samples): nearest {ms_near:.3f} ms, first "
              f"{ms_first:.3f} ms; {int((first[..., 1:] != first[..., :1]).any(-1).sum())} of "
              f"{first.shape[0] * first.shape[1]} centers have more than one point in radius")
    del rec
    with torch.inference_mode():
        profile(lambda: model(inputs), "gather serving forward")
    del model, inputs
    torch.cuda.empty_cache()

    state, step, batch = build_trainer(cfg, batch_size=BATCH, device="cuda", seed=0)
    for i in range(GATHER_STEPS):
        before = launch_counts()
        metrics, ms = timed(lambda: step(state, batch))
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"gather step {i}: loss {loss}, grad_norm {norm}")
        check_launches(before, {"fps_launch": 4}, f"gather step {i}")
        print(f"gather step {i}: {ms:.2f} ms, loss {loss:.4f}, grad_norm {norm:.4f}")
    profile(lambda: step(state, batch), "gather training step")
    exact_repeat_check(state, step, batch, "gather full-width step")
    del state, step, batch
    torch.cuda.empty_cache()


DEVICE_SORT_RADII = (0.2, 0.4, 0.8, 1.2)  # the flagship's SA radii: the sort's cell sizes
QKV_ATOL = 3e-2       # fused against unfused q/k/v in bf16, as tests/test_fused_attention.py
QKV_F32_REL = 1e-4    # the f32 RoBERTa layer's gradients, relative to the largest of any leaf
WINNER_RTOL, WINNER_ATOL = 1e-4, 1e-5  # winner against scan gradients, tests/test_fused_sa.py


def permuted(batch: dict, seed: int) -> dict:
    """A serving batch, or a training batch ``{"inputs", "targets"}``, with each
    scene's points in a random order from ``seed``: the pipeline's host presort
    at cell 0.2 makes SA1's device sort at r = 0.2 the identity, a permuted
    cloud does not. Per-point training labels are permuted alike."""
    inputs = batch.get("inputs", batch)
    pcs = inputs["point_clouds"]
    g = torch.Generator().manual_seed(seed)
    perms = torch.stack([torch.randperm(pcs.shape[1], generator=g)
                         for _ in range(pcs.shape[0])]).to(pcs.device)
    out = dict(inputs, point_clouds=pcs.gather(1, perms[..., None].expand(-1, -1, pcs.shape[2])))
    if "inputs" not in batch:
        return out
    targets = dict(batch["targets"])
    targets["point_instance_label"] = targets["point_instance_label"].gather(1, perms)
    return {"inputs": out, "targets": targets}


def morton_card_check(xyz) -> None:
    """The device sort's keys on the card equal the CPU's bit for bit, on the
    clouds and on points exactly on (and one ulp above) cell boundaries."""
    from eda_tpu_torch.ops.fused_sa import morton_keys

    for r in DEVICE_SORT_RADII:
        edge = (torch.arange(-200, 200, dtype=torch.float32) * r)[:, None].expand(-1, 3)
        edge = torch.cat([edge, torch.nextafter(edge, torch.full_like(edge, math.inf))])
        for pts in (xyz, edge.cuda()):
            if not torch.equal(morton_keys(pts, r).cpu(), morton_keys(pts.cpu(), r)):
                raise AssertionError(f"device sort: Morton keys at cell {r} differ between card "
                                     f"and CPU")
    print(f"device sort: Morton keys at cells {DEVICE_SORT_RADII} equal on card and CPU "
          f"({tuple(xyz.shape[:2])} points and cell boundaries)")


def sort_times(calls) -> None:
    """Per SA layer of one device-sort forward, CUDA events: the keys and the
    stable sort; the gathers of xyz and features into that order; the whole of
    the layer's sort (with the inverse permutation and the centers' ranks);
    and the gather that restores the outputs' center order."""
    from eda_tpu_torch.ops import fused_sa
    from eda_tpu_torch.ops.pointops import gather_points

    total = 0.0
    for layer, (args, _) in enumerate(calls, 1):
        xyz, feats, center_idx, radius = args
        order = torch.sort(fused_sa.morton_keys(xyz, radius), dim=1, stable=True).indices
        center_order = fused_sa._sort_points(*args)[3]
        outs = torch.randn(xyz.shape[0], center_idx.shape[1], 256, device=xyz.device)
        ms = {
            "keys + sort": cuda_ms(lambda: torch.sort(fused_sa.morton_keys(xyz, radius), dim=1,
                                                      stable=True), 10),
            "xyz + feature gathers": cuda_ms(lambda: (gather_points(xyz, order),
                                                      gather_points(feats, order)), 10),
            "whole sort": cuda_ms(lambda: fused_sa._sort_points(*args), 10),
            "output restore": cuda_ms(lambda: outs.gather(1, torch.argsort(center_order, dim=1)[
                ..., None].expand(-1, -1, outs.shape[-1])), 10),
        }
        total += ms["whole sort"] + ms["output restore"]
        print(f"device sort SA{layer} (B={xyz.shape[0]}, N={xyz.shape[1]}, C={feats.shape[2]}, "
              f"M={center_idx.shape[1]}, cell {radius}): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
    print(f"device sort: {total:.4f} ms a forward (whole sorts and output restores, "
          f"{len(calls)} layers)")


def device_sort_serving(cfg, root_cfg) -> None:
    """Device-sort forwards on the pipeline's clouds and on permuted copies, each
    from zeroed counters (K1-K3 four launches, nothing else) with every K1-K3
    call against its plain version; the sort timed per layer; then against the
    presorted model on the same scenes, in turns, and profiled."""
    from eda_tpu_torch.entry import build as build_model
    from eda_tpu_torch.ops import fused_sa, pointops
    from eda_tpu_torch.ops.cuda import build
    from eda_tpu_torch.utils.flops import sa_geometry

    model, inputs = build_model(cfg, batch_size=BATCH, device="cuda", seed=0)
    shuffled = permuted(inputs, seed=1)
    morton_card_check(shuffled["point_clouds"][..., :3].contiguous())
    targets = [(pointops, "furthest_point_sample", "fps_launch"),
               (fused_sa, "sa_prep", "sa_prep_launch"),
               (fused_sa, "sa_pair_pool", "sa_pair_pool_launch"),
               (fused_sa, "_sort_points", "sort")]
    for name, batch in (("pipeline clouds", inputs), ("permuted clouds", shuffled)):
        for kernel in build.KERNELS.values():
            kernel.launches = 0
        with Recorder(targets) as rec:
            with torch.inference_mode():
                out = model(batch)["last_center"]
        torch.cuda.synchronize()
        check_launches(dict.fromkeys(launch_counts(), 0), forward_launches("pair"),
                       f"device-sort forward on the {name}")
        if out.shape != (BATCH, cfg.num_queries, 3) or not torch.isfinite(out).all():
            raise AssertionError(f"device-sort forward on the {name}: bad last_center "
                                 f"{tuple(out.shape)}")
        sizes = [tuple(a[0].shape[:2]) for a, _ in rec.calls["fps_launch"]]
        windowed = sum(not g.dense for g in sa_geometry(cfg))  # a dense layer needs no order
        if sizes[0] != (BATCH, cfg.num_points) or len(rec.calls["sort"]) != windowed:
            raise AssertionError(f"device-sort forward: FPS over {sizes}, "
                                 f"{len(rec.calls['sort'])} sorted layers")
        print(f"device-sort forward on the {name}: launched {forward_launches('pair')}, "
              f"last_center finite {tuple(out.shape)}, K1 over {sizes}")
        check_kernels(rec.calls, SERVING, {s: 4 for s in SERVING})
    sort_times(rec.calls["sort"])
    fps_calls = {"device sort": rec.calls["fps_launch"]}
    del rec
    plain, _ = build_model(root_cfg, batch_size=BATCH, device="cuda", seed=0)
    with torch.inference_mode():
        with Recorder([(pointops, "furthest_point_sample", "fps_launch")]) as rec:
            plain(inputs)
        fps_calls["presorted"] = rec.calls["fps_launch"]
        med = _turns({"presorted": lambda: plain(inputs), "device sort": lambda: model(shuffled)})
        busy = {"presorted": profile(lambda: plain(inputs), "presorted forward (device-sort "
                                     "phase)", top=3, fps_calls=fps_calls["presorted"]),
                "device sort": profile(lambda: model(shuffled), "device-sort serving forward",
                                       also=("fps", "Sort", "gather", "scatter"), top=8,
                                       fps_calls=fps_calls["device sort"])}
    print(f"device-sort vs presorted serving forward, same scenes, turns A B B A: "
          f"{med['device sort']:.2f} vs {med['presorted']:.2f} ms per batch; device busy "
          f"{busy['device sort']:.2f} vs {busy['presorted']:.2f} ms "
          f"({busy['device sort'] - busy['presorted']:+.2f} ms)")


def device_sort_training(cfg, root_cfg) -> None:
    """One device-sort training step on permuted clouds from zeroed counters
    (``step_launches("pair")``) with its K4-K7 calls against their plain
    versions; two steps from one state bit for bit; then against the presorted
    step, in turns, and profiled."""
    from eda_tpu_torch.entry import build_trainer
    from eda_tpu_torch.ops import fused_sa, pointops
    from eda_tpu_torch.ops.cuda import build

    state, step, batch = build_trainer(cfg, batch_size=BATCH, device="cuda", seed=0)
    batch = permuted(batch, seed=2)
    bwd = lambda kw, _: bwd_symbol(kw["compact"])  # noqa: E731
    for kernel in build.KERNELS.values():
        kernel.launches = 0
    with Recorder([(fused_sa, "sa_pair_pool_winners", "sa_pair_pool_winners_launch"),
                   (fused_sa, "sa_pool_bwd", bwd),
                   (fused_sa, "sa_prep_bwd", "sa_prep_bwd_launch"),
                   (pointops, "furthest_point_sample", "fps_launch")]) as rec:
        metrics = step(state, batch)
    torch.cuda.synchronize()
    check_launches(dict.fromkeys(launch_counts(), 0), step_launches("pair"),
                   "device-sort training step")
    loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
    if not (math.isfinite(loss) and math.isfinite(norm)):
        raise AssertionError(f"device-sort step: loss {loss}, grad_norm {norm}")
    print(f"device-sort training step: launched {step_launches('pair')}, loss {loss:.4f}, "
          f"grad_norm {norm:.4f}")
    layers = {"sa_pair_pool_winners_launch": 4, "sa_pool_bwd_compact_launch": 1,
              "sa_pool_bwd_window_launch": 3, "sa_prep_bwd_launch": 4}
    check_kernels(rec.calls, TRAINING, layers)
    fps_calls = rec.calls["fps_launch"]
    del rec
    exact_repeat_check(state, step, batch, "device-sort full-width step")
    plain, plain_step, plain_batch = build_trainer(root_cfg, batch_size=BATCH, device="cuda",
                                                   seed=0)
    with Recorder([(pointops, "furthest_point_sample", "fps_launch")]) as rec:
        plain_step(plain, plain_batch)
    med = _turns({"presorted": lambda: plain_step(plain, plain_batch),
                  "device sort": lambda: step(state, batch)})
    busy = {"presorted": profile(lambda: plain_step(plain, plain_batch),
                                 "presorted training step (device-sort phase)", top=3,
                                 fps_calls=rec.calls["fps_launch"]),
            "device sort": profile(lambda: step(state, batch), "device-sort training step",
                                   also=("fps", "Sort"), top=8, fps_calls=fps_calls)}
    print(f"device-sort vs presorted training step, turns A B B A: {med['device sort']:.2f} vs "
          f"{med['presorted']:.2f} ms per step; device busy {busy['device sort']:.2f} vs "
          f"{busy['presorted']:.2f} ms ({busy['device sort'] - busy['presorted']:+.2f} ms)")


def _leaf_rel_errs(a: dict, b: dict) -> dict:
    """Each leaf's largest difference over the largest gradient value of all
    leaves in ``b``: an absolute tolerance on the layer's gradient scale, as
    ``tests/test_fused_attention.py`` holds every leaf to one ``atol``. (A
    leaf's own scale is no yardstick: the attention key biases' gradient is
    zero in exact arithmetic, and at random flagship-width weights the
    softmax saturates and the query weights' gradient is rounding noise.)"""
    largest = max(v.abs().max().item() for v in b.values())
    return {k: ((a[k] - b[k]).abs().max() / largest).item() for k in b}


def fused_qkv_layers() -> None:
    """One flagship-width encoder, decoder (bf16) and RoBERTa layer (f32) in
    train mode, dropout off, fused against unfused on one set of weights:
    outputs within ``QKV_ATOL`` (bf16) or 1e-5 (f32), every gradient leaf
    within ``QKV_ATOL`` (bf16) or ``QKV_F32_REL`` (f32) of the layer's largest
    gradient value."""
    from eda_tpu_torch.models.grounder import init_weights
    from eda_tpu_torch.models.layers import BiDecoderLayer, BiEncoderLayer
    from eda_tpu_torch.models.roberta import RobertaLayer

    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g).cuda()

    valid = torch.arange(64)[None].expand(BATCH, -1).cuda() < torch.randint(
        8, 65, (BATCH, 1), generator=g).cuda()
    bf16 = torch.bfloat16
    cases = {
        "encoder": (lambda f: BiEncoderLayer(288, 8, 256, True, bf16, 0.0, fused_qkv=f),
                    (rand(BATCH, 1024, 288), rand(BATCH, 1024, 288), None, rand(BATCH, 64, 288),
                     valid), QKV_ATOL, QKV_ATOL),
        "decoder": (lambda f: BiDecoderLayer(288, 8, 256, "loc_learned", bf16, 0.0, fused_qkv=f),
                    (rand(BATCH, 256, 288), rand(BATCH, 1024, 288), rand(BATCH, 64, 288),
                     rand(BATCH, 256, 6), valid), QKV_ATOL, QKV_ATOL),
        "roberta": (lambda f: RobertaLayer(768, 12, 3072, fused_qkv=f),
                    (rand(BATCH, 64, 768), valid), 1e-5, QKV_F32_REL),
    }
    for name, (make, args, out_tol, grad_tol) in cases.items():
        runs = {}
        for fused in (False, True):
            layer = make(fused)
            init_weights(layer, 0)
            layer = layer.cuda().train()
            out = layer(*args)
            out = out if isinstance(out, tuple) else (out,)
            sum(o.float().pow(2).sum() for o in out).backward()
            runs[fused] = ([o.detach().float() for o in out],
                           {n: p.grad for n, p in layer.named_parameters()})
        out_err = max((a - b).abs().max().item() for a, b in zip(runs[True][0], runs[False][0]))
        errs = _leaf_rel_errs(runs[True][1], runs[False][1])
        worst = max(errs, key=errs.get)
        print(f"fused q/k/v {name} layer (flagship width, batch {BATCH}), fused vs unfused: "
              f"outputs max abs err {out_err:.3g}, gradients worst leaf {worst} "
              f"{errs[worst]:.3g} of the largest gradient value")
        if out_err > out_tol or errs[worst] > grad_tol:
            raise AssertionError(f"fused q/k/v {name} layer off the unfused one")


def fused_qkv_model(root_cfg) -> None:
    """The flagship forward with fused and unfused q/k/v on one set of weights
    and inputs (the fused run on the unfused run's KPS indices): every compared
    end point within ``QKV_ATOL``; both timed in turns. Then one training step
    of each from one state: finite, the main path's launches, timed in turns."""
    from eda_tpu_torch.entry import build as build_model
    from eda_tpu_torch.entry import build_trainer
    from eda_tpu_torch.models import grounder as grounder_module
    from eda_tpu_torch.ops.cuda import build

    fused_cfg = dataclasses.replace(root_cfg, fused_qkv=True)
    plain, inputs = build_model(root_cfg, batch_size=BATCH, device="cuda", seed=0)
    fused, _ = build_model(fused_cfg, batch_size=BATCH, device="cuda", seed=0)
    fused.load_state_dict(plain.state_dict())
    with torch.inference_mode():
        want = plain(inputs)
        inds = want["query_points_sample_inds"]
        with patched(grounder_module, "top_k_indices", lambda logits, k: inds):
            got = fused(inputs)
        keys = ("text_memory", "seed_features", "seeds_obj_cls_logits", "proposal_center",
                "last_center", "last_pred_size", "last_sem_cls_scores")
        errs = {k: (got[k].float() - want[k].float()).abs().max().item() for k in keys}
        print(f"fused vs unfused q/k/v flagship forward, max abs errs {errs}")
        if max(errs.values()) > QKV_ATOL:
            raise AssertionError("fused q/k/v forward off the unfused one")
        med = _turns({"unfused": lambda: plain(inputs), "fused": lambda: fused(inputs)})
    print(f"fused vs unfused q/k/v serving forward, turns A B B A: {med['fused']:.2f} vs "
          f"{med['unfused']:.2f} ms per batch")
    del plain, fused, want, got
    runs = {}
    for name, cfg in (("unfused", root_cfg), ("fused", fused_cfg)):
        runs[name] = build_trainer(cfg, batch_size=BATCH, device="cuda", seed=0)
    metrics = {}
    for name, (state, step, batch) in runs.items():
        for kernel in build.KERNELS.values():
            kernel.launches = 0
        metrics[name] = {k: float(v) for k, v in step(state, batch).items()}
        check_launches(dict.fromkeys(launch_counts(), 0), step_launches("pair"),
                       f"{name} q/k/v step")
        if not all(math.isfinite(v) for v in metrics[name].values()):
            raise AssertionError(f"{name} q/k/v step: {metrics[name]}")
    med = _turns({name: (lambda r=r: r[1](r[0], r[2])) for name, r in runs.items()})
    print(f"fused vs unfused q/k/v training step: loss {metrics['fused']['loss']:.4f} vs "
          f"{metrics['unfused']['loss']:.4f}, grad_norm {metrics['fused']['grad_norm']:.4f} vs "
          f"{metrics['unfused']['grad_norm']:.4f}; turns A B B A {med['fused']:.2f} vs "
          f"{med['unfused']:.2f} ms per step")


def winner_check() -> None:
    """``fused_set_abstraction(impl="winner")`` at SA2's shape (batch 8, 2048
    unsorted points, 1024 centers, window 256, widths (128, 128, 256)), f32:
    its gradients against the scan's (``impl="xla"``), two backward passes
    bit for bit; the forward and backward of each timed.

    Each gradient element within ``WINNER_ATOL`` + ``WINNER_RTOL`` times its
    leaf's largest value: the rtol of ``tests/test_fused_sa.py`` taken on the
    leaf's scale, not the element's. At this size W1's gradient sums 16 384
    rows whose terms cancel, so an element near 0 carries the f32 rounding
    of large terms; the scan's own backward adds its gathered rows with
    atomics, and two scan backward passes differ by the printed amount."""
    from eda_tpu_torch.ops import fused_sa

    N, M, C, widths = 2048, 1024, 128, (128, 128, 256)
    g = torch.Generator().manual_seed(0)
    xyz = (torch.rand(BATCH, N, 3, generator=g) * 5).cuda()
    feats = torch.randn(BATCH, N, C, generator=g).cuda()
    cidx = torch.stack([torch.randperm(N, generator=g)[:M] for _ in range(BATCH)]).cuda()
    groups, prev = ([], [], [], []), 3 + C
    for c in widths:
        groups[0].append(torch.randn(prev, c, generator=g) * prev ** -0.5)
        groups[1].append(torch.randn(c, generator=g) * 0.1)
        groups[2].append(1 + 0.1 * torch.randn(c, generator=g))
        groups[3].append(0.1 * torch.randn(c, generator=g))
        prev = c
    cot = torch.randn(BATCH, M, widths[-1], generator=g).cuda()

    def run(impl):
        params = fused_sa.SAParams(*(tuple(p.cuda().requires_grad_() for p in grp)
                                     for grp in groups))
        f = feats.clone().requires_grad_()
        out = fused_sa.fused_set_abstraction(
            xyz, f, cidx, params, radius=0.4, window=256, compute_dtype=torch.float32,
            presorted=False, impl=impl, return_rank_order=False)
        (out * cot).sum().backward()
        return out.detach(), [f.grad] + [p.grad for grp in params for p in grp]

    out_w, grads_w = run("winner")
    out_s, grads_s = run("xla")
    _, again = run("winner")
    _, scan_again = run("xla")
    torch.cuda.synchronize()
    if not torch.allclose(out_w, out_s, rtol=WINNER_RTOL, atol=WINNER_ATOL):
        raise AssertionError("winner pool forward off the scan's")
    worst = scan_noise = 0.0
    for i, (a, b, c) in enumerate(zip(grads_w, grads_s, scan_again)):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        print(f"  winner gradient {i} {tuple(b.shape)}: largest value {scale:.4g}, largest "
              f"difference from the scan's {err:.3g} ({err / scale:.3g} of it), two scan "
              f"passes differ by {(c - b).abs().max().item():.3g}")
        if err > WINNER_ATOL + WINNER_RTOL * scale:
            raise AssertionError(f"winner gradient {i} off the scan's: {err} at scale {scale}")
        worst = max(worst, err / scale)
        scan_noise = max(scan_noise, (c - b).abs().max().item() / scale)
    if not all(torch.equal(a, b) for a, b in zip(grads_w, again)):
        raise AssertionError("winner backward: two passes differ")
    ms = {impl: cuda_ms(lambda: run(impl), 3) for impl in ("winner", "xla")}
    print(f"winner pool at SA2's shape, f32: gradients within atol {WINNER_ATOL} + rtol "
          f"{WINNER_RTOL} of each leaf's scale of the scan's (largest difference {worst:.3g} of "
          f"its leaf's largest value; two scan passes {scan_noise:.3g}); forward equal to the "
          f"scan's: {torch.equal(out_w, out_s)}; two winner backward passes bit-identical; "
          f"forward + backward {ms['winner']:.2f} ms (scan {ms['xla']:.2f} ms)")


def tools_check() -> None:
    """The kernel tools on the card: ``sa_kernel_bench`` at every layer (K4,
    K3 with ``--no-winners``, K5 / K6 with ``--bwd``) at batch 8, and
    ``profile_step --steps 2`` at batch 8; a nonzero exit fails."""
    from eda_tpu_torch.tools import profile_step, sa_kernel_bench

    for layer in sorted(sa_kernel_bench.LAYERS):
        for extra in ([], ["--no-winners"], ["--bwd"]):
            argv = ["--layer", layer, "--batch", str(BATCH), "--iters", "8", "--inner", "2"]
            if sa_kernel_bench.main(argv + extra):
                raise AssertionError(f"sa_kernel_bench {argv + extra} failed")
    with tempfile.TemporaryDirectory() as tmp:
        if profile_step.main(["--steps", "2", "--batch", str(BATCH), "--out", tmp,
                              "--top", "12"]):
            raise AssertionError("profile_step failed")


def device_sort_phase(root_cfg) -> None:
    """Phase "device sort": ``ModelConfig(use_bf16=True, points_presorted=False)``
    (each fused SA layer sorts its input on the card), the fused q/k/v
    projection, the ``winner`` pool and the kernel tools."""
    cfg = dataclasses.replace(root_cfg, points_presorted=False)
    small_model_check(cfg)
    device_sort_serving(cfg, root_cfg)
    torch.cuda.empty_cache()
    device_sort_training(cfg, root_cfg)
    torch.cuda.empty_cache()
    fused_qkv_layers()
    fused_qkv_model(root_cfg)
    torch.cuda.empty_cache()
    winner_check()
    torch.cuda.empty_cache()
    tools_check()
    torch.cuda.empty_cache()


# the parallel phase: the 2-rank and model = 2 steps against the one-process
# batch-8 step on the same card. A parallel step differs from it in the order of
# the BatchNorm sums and of the loss shares (and, tensor-parallel, in the
# partial products, rounded to bf16 and summed in bf16 as XLA's psum), which
# the bf16 roundings carry into KPS and match decisions: free-running, the
# first full-width data = 2 step on an H100 80GB HBM3 at 700 W kept the loss
# within 0.2% but its global gradient cosine was 0.44. So each step is held on
# the one-process step's KPS indices and matches (their rows), as the CPU tests
# hold the port to JAX, and again on its own decisions, where the share of
# decisions that differ from the one-process step's is printed. Held always:
# the loss within 1%, as JAX's own DP / TP tests allow (tests/test_train.py:
# 121-144). Held on the same decisions (pinned, or free-running decisions that
# all came out equal on every rank): every metric (grad_norm included, which a
# gradient off by the rank count would miss by 2x), the global and per-leaf
# gradient cosines, the BatchNorm statistics and the share of new parameters
# within 0.01 lr of the one-process step's (AdamW's first update is about
# lr * sign(g), so this is the share of gradient signs that agree; any two
# first steps from one state lie within 2 lr), under the gates of the
# precision, set from this phase's readings on an H100 80GB HBM3 at 700 W
# (the same on every run: two steps from one state agree bit for bit). bf16:
# the cosines and BatchNorm gates of the tiny card-vs-CPU step (readings:
# global cosine 0.949 / 0.960 for data = 2 / model = 2, worst leaf 0.62 /
# 0.64, BatchNorm 1.3e-3 / 1.4e-3, worst metric 2.2% / 3.4%), parameters
# 0.7 (readings 0.777 / 0.821; 0.44 free-running, where 1.2% of the KPS
# points and 84% of their positions moved). f32 (ModelConfig(use_bf16=False), where only the order of
# the sums and the pools' bf16 A differ; readings for data = 2: cosine
# 0.999997, worst leaf 0.999982, BatchNorm 6.2e-6, worst metric 7.5e-5,
# parameters 0.9988), as tests/torch_parity.py's parallel gates
PARALLEL_LOSS_REL = 0.01
PARALLEL_GATES = {  # by use_bf16
    True: dict(metric=0.10, metric_atol=1e-3, global_cos=GLOBAL_COS, leaf_cos=LEAF_COS,
               bn=BN_REL, params=0.7),
    False: dict(metric=1e-3, metric_atol=1e-6, global_cos=0.9999, leaf_cos=0.999, bn=1e-4,
                params=0.99),
}
PARALLEL_FORWARD_ATOL = HEAD_ATOL
PARALLEL_RANKS = 2


def _fresh_state(cfg, device, mesh=None):
    """The flagship training state of ``entry.build_trainer`` (seed 0), split on ``mesh``."""
    from eda_tpu_torch.config import TrainConfig
    from eda_tpu_torch.entry import STEPS_PER_EPOCH
    from eda_tpu_torch.models.grounder import EDAGrounder
    from eda_tpu_torch.parallel.mesh import shard_params
    from eda_tpu_torch.train.optim import AdamW
    from eda_tpu_torch.train.step import TrainState

    model = EDAGrounder(cfg)
    model.init_weights(0)
    model = model.to(device).train()
    if mesh is not None:
        shard_params(model, mesh)
    return TrainState(model, AdamW(model, TrainConfig(), STEPS_PER_EPOCH, mesh=mesh))


def _timed_collectives(mesh) -> list:
    """Record (bytes, host ms between synchronizes) of each of ``mesh``'s all-reduces
    until ``del mesh.all_reduce_``."""
    calls, plain = [], mesh.all_reduce_

    def wrapped(x, axis="data"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain(x, axis)
        torch.cuda.synchronize()
        calls.append((x.numel() * x.element_size(), 1e3 * (time.perf_counter() - t)))
        return out

    mesh.all_reduce_ = wrapped
    return calls


def _against_one_process(label, state, ref, m, m_ref, mesh, gates) -> dict:
    """A parallel step's metrics, gradients (this rank's parts), new parameters
    and BatchNorm statistics against the one-process step's: the loss always
    held, the rest under ``gates`` (``PARALLEL_GATES``) unless they are None.
    Prints every number before any check raises."""
    from eda_tpu_torch.config import TrainConfig
    from eda_tpu_torch.parallel.mesh import shard, sharded_names
    from eda_tpu_torch.train.optim import group_of

    rel = {k: abs(float(m[k]) - float(m_ref[k])) / (abs(float(m_ref[k])) + 1e-9) for k in m_ref}
    split = sharded_names(state.model, mesh)
    ref_params = dict(ref.model.named_parameters())
    got, want, leaves = [], [], {}
    close = total = 0
    lr = {"main": TrainConfig().lr, "backbone": TrainConfig().lr_backbone}
    for name, p in state.model.named_parameters():
        q = ref_params[name]
        part = (lambda t: shard(t, split[name], mesh)) if name in split else (lambda t: t)
        if p.grad is not None:
            g, w = p.grad.flatten().double(), part(q.grad).flatten().double()
            got.append(g)
            want.append(w)
            if not any(z in name for z in ZERO_GRAD) and w.norm() > 0:
                leaves[name] = float(g @ w / (g.norm() * w.norm() + 1e-300))
        if group_of(name) != "text":
            diff = (p.detach() - part(q.detach())).abs()
            close += int((diff <= 0.01 * lr[group_of(name)]).sum())
            total += diff.numel()
    g, w = torch.cat(got), torch.cat(want)
    glob = float(g @ w / (g.norm() * w.norm()))
    ref_stats = ref.model.state_dict()
    bn = max(float((v - ref_stats[k]).abs().max() / (ref_stats[k].abs().max() + 1e-6))
             for k, v in state.model.state_dict().items() if "running_" in k)
    worst_leaf = min((c, n) for n, c in leaves.items())
    out = dict(loss_rel=rel["loss"], grad_norm_rel=rel["grad_norm"],
               worst_metric=max((v, k) for k, v in rel.items()), global_cos=glob,
               worst_leaf_cos=worst_leaf[0], worst_leaf=worst_leaf[1], bn_rel=bn,
               params_close=close / total, held=gates is not None)
    print(f"{label} against the one-process step: {out}", flush=True)
    failures = []
    if rel["loss"] > PARALLEL_LOSS_REL:
        failures.append(f"loss {float(m['loss'])} vs {float(m_ref['loss'])}")
    if gates is not None:
        bad = [k for k in m_ref if abs(float(m[k]) - float(m_ref[k]))
               > gates["metric"] * abs(float(m_ref[k])) + gates["metric_atol"]]
        below = sorted((c, n) for n, c in leaves.items() if c < gates["leaf_cos"])
        if bad:
            failures.append(f"metrics beyond {gates['metric']}: {bad}")
        if glob < gates["global_cos"]:
            failures.append(f"global gradient cosine {glob:.7f}")
        if below:
            failures.append(f"{len(below)} leaves below cosine {gates['leaf_cos']}: {below[:4]}")
        if bn > gates["bn"]:
            failures.append(f"BatchNorm statistics {bn:.3g} away")
        if close < gates["params"] * total:
            failures.append(f"{close / total:.5f} of the new parameters within 0.01 lr")
    if failures:
        raise AssertionError(f"{label}: " + "; ".join(failures))
    return out


def _bn_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        if "running_" in k:
            h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _recorded_decisions(fn):
    """``fn()`` and the KPS indices and matches it decided."""
    from eda_tpu_torch.losses import criterion
    from eda_tpu_torch.models import grounder

    seen = {}

    def recording(module, name):
        plain = getattr(module, name)

        def wrapped(*args, **kwargs):
            seen[name] = plain(*args, **kwargs)
            return seen[name]

        return patched(module, name, wrapped)

    with recording(grounder, "top_k_indices"), recording(criterion, "hungarian_match"):
        out = fn()
    return out, seen


@contextlib.contextmanager
def _pinned(decisions, rows, batch_size: int):
    """Inside the block the model takes the recorded KPS indices and the loss the
    recorded matches, rows ``rows`` of each block of ``batch_size`` rows."""
    from eda_tpu_torch.losses import criterion
    from eda_tpu_torch.losses.matcher import MatchResult
    from eda_tpu_torch.models import grounder

    kps, match = decisions["top_k_indices"], decisions["hungarian_match"]
    blocks = match.match_q.shape[0] // batch_size
    idx = torch.cat([b * batch_size + rows for b in range(blocks)])
    with patched(grounder, "top_k_indices", lambda logits, k: kps[rows]), \
            patched(criterion, "hungarian_match",
                    lambda *a, **k: MatchResult(*(t[idx] for t in match))):
        yield


def _decisions_differ(decisions, ref, rows, batch_size: int) -> dict:
    """The shares that differ from the one-process step's ``ref`` decisions on
    rows ``rows``: of the KPS indices by position (``kps``), of the KPS points
    as a set (``kps_points``) and of the matched queries (``matches``)."""
    kps, match, kps_ref = decisions["top_k_indices"], decisions["hungarian_match"], \
        ref["top_k_indices"]
    blocks = match.match_q.shape[0] // len(rows)
    idx = torch.cat([b * batch_size + rows for b in range(blocks)])
    want = ref["hungarian_match"].match_q[idx]
    valid = ref["hungarian_match"].target_valid[idx]
    chosen = (kps[:, :, None] == kps_ref[rows][:, None, :]).any(-1)
    return dict(kps=float((kps != kps_ref[rows]).float().mean()),
                kps_points=float((~chosen).float().mean()),
                matches=float((match.match_q != want)[valid].float().mean()))


def _parallel_steps(label, state, step, batch, ref, m_ref, mesh, decisions, rows,
                    pinned: bool) -> dict:
    """Two steps from one state (bit for bit), each rank's launches and ms, the
    all-reduces' bytes and ms, and the step against the one-process step: on
    its ``decisions`` (rows ``rows``) when ``pinned``, else on its own, held
    under the precision's gates where every rank's decisions came out equal
    to the one-process step's."""
    import copy

    batch_size = len(decisions["top_k_indices"])
    decide = (lambda: _pinned(decisions, rows, batch_size)) if pinned else \
        contextlib.nullcontext
    twin = copy.deepcopy(state)
    zero_launches()
    with decide():
        (m, own), ms = timed(lambda: _recorded_decisions(lambda: step(state, batch)))
    check_launches({k: 0 for k in launch_counts()},
                   step_launches("pair", f32=not state.model.cfg.use_bf16), f"{label} step")
    calls = _timed_collectives(mesh)
    try:
        with decide():
            m2 = step(twin, batch)
    finally:
        del mesh.all_reduce_
    if not (all(torch.equal(m[k], m2[k]) for k in m) and _same_state(state, twin)):
        raise AssertionError(f"{label}: two steps from one state differ")
    del twin
    differ = _decisions_differ(own, decisions, rows, batch_size)
    same = not any(v for rank in mesh.gather_object(differ) for v in rank.values())
    gates = PARALLEL_GATES[state.model.cfg.use_bf16] if pinned or same else None
    out = _against_one_process(label, state, ref, m, m_ref, mesh, gates)
    grad = max(calls)  # the flat gradient buffer is the largest all-reduce
    out.update(ms=ms, loss=float(m["loss"]), digest=_bn_digest(state.model),
               decisions_differ=differ, collectives=len(calls),
               collective_ms=sum(c[1] for c in calls), grad_bytes=grad[0], grad_ms=grad[1],
               shapes={n: tuple(p.shape) for n, p in state.model.named_parameters()})
    return out


def zero_launches() -> None:
    from eda_tpu_torch.ops.cuda import build

    for kernel in build.KERNELS.values():
        kernel.launches = 0


def parallel_rank(mesh, cfg, batch_size: int) -> dict:
    """One of two ranks on the card (gloo, named by the caller): the data = 2
    step on its rows in bf16 and in f32, then data = 1 x model = 2 on the whole
    batch in bf16, each on the one-process step's decisions and on its own,
    against the one-process step from the same state on the same rows; and
    the model = 2 forward."""
    from eda_tpu_torch.entry import make_train_batch
    from eda_tpu_torch.losses.criterion import SetCriterionConfig
    from eda_tpu_torch.parallel.mesh import make_mesh, process_batch_rows
    from eda_tpu_torch.train.step import make_train_step

    device = mesh.device
    crit = SetCriterionConfig(num_decoder_layers=cfg.num_decoder_layers)
    batch = make_train_batch(cfg, range(batch_size), device)
    rows = torch.from_numpy(process_batch_rows(mesh, batch_size)).to(device)
    local = {g: {k: v[rows] for k, v in a.items()} for g, a in batch.items()}
    out = {}
    for name, c in (("data=2", cfg), ("data=2 f32", dataclasses.replace(cfg, use_bf16=False))):
        ref = _fresh_state(c, device)
        m_ref, decisions = _recorded_decisions(lambda: make_train_step(crit)(ref, batch))
        for label, pinned in ((name, True), (f"{name} free", False)):
            out[label] = _parallel_steps(label, _fresh_state(c, device, mesh),
                                         make_train_step(crit, mesh=mesh), local, ref, m_ref,
                                         mesh, decisions, rows, pinned)
        del ref
        torch.cuda.empty_cache()

    tp_mesh = make_mesh(data=1, model=PARALLEL_RANKS, device=device)
    # the forward in eval mode against the one-process model's, from the same weights
    model = _fresh_state(cfg, device, tp_mesh).model.eval()
    fresh = _fresh_state(cfg, device).model.eval()
    with torch.inference_mode():
        ends, ends_ref = model(batch["inputs"]), fresh(batch["inputs"])
    del model, fresh
    forward = {k: float((ends[k].float() - ends_ref[k].float()).abs().max())
               for k in ("seeds_obj_cls_logits", "proj_tokens", "text_memory")}
    same = float((ends["query_points_sample_inds"]
                  == ends_ref["query_points_sample_inds"]).float().mean())
    del ends, ends_ref
    print(f"model=2 forward against the one-process forward: max abs {forward}, {same:.4f} of "
          "the query indices equal", flush=True)
    if max(forward.values()) > PARALLEL_FORWARD_ATOL:
        raise AssertionError(f"model=2 forward: {forward}")
    ref = _fresh_state(cfg, device)
    m_ref, decisions = _recorded_decisions(lambda: make_train_step(crit)(ref, batch))
    every = torch.arange(batch_size, device=device)
    for label, pinned in (("model=2", True), ("model=2 free", False)):
        out[label] = _parallel_steps(label, _fresh_state(cfg, device, tp_mesh),
                                     make_train_step(crit, mesh=tp_mesh), batch, ref, m_ref,
                                     tp_mesh, decisions, every, pinned)
    out["model=2"].update(forward=forward, same_queries=same)
    return out


def parallel_phase(root_cfg) -> None:
    """Phase "parallel": W = 1 under NCCL bit for bit against the ungrouped
    full-width step, then two gloo ranks on the card as data = 2 and as data = 1
    x model = 2 against the one-process batch-8 step."""
    import copy

    import torch.distributed as dist

    from eda_tpu_torch.entry import build_trainer
    from eda_tpu_torch.losses.criterion import SetCriterionConfig
    from eda_tpu_torch.parallel.launch import spawn
    from eda_tpu_torch.parallel.mesh import init_process_group, make_mesh, shard_params
    from eda_tpu_torch.train.step import make_train_step

    state, step, batch = build_trainer(root_cfg, batch_size=BATCH, device="cuda", seed=0)
    twin = copy.deepcopy(state)
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group(0, 1, f"file://{tmp}/store", "nccl", "cuda:0")
        try:
            mesh = make_mesh(device="cuda:0")
            shard_params(twin.model, mesh)  # data = model = 1: no parameter changes
            mesh_step = make_train_step(
                SetCriterionConfig(num_decoder_layers=root_cfg.num_decoder_layers), mesh=mesh)
            launches = {}
            for label, fn, st in (("ungrouped", step, state), ("nccl W=1", mesh_step, twin)):
                zero_launches()
                launches[label] = (fn(st, batch), launch_counts())
                check_launches({k: 0 for k in launch_counts()}, step_launches("pair"), label)
            (m1, _), (m2, _) = launches.values()
            if not (all(torch.equal(m1[k], m2[k]) for k in m1) and _same_state(state, twin)):
                raise AssertionError("the W = 1 NCCL step is not the ungrouped step bit for bit")
            _, ms_plain = timed(lambda: step(state, batch))
            _, ms_nccl = timed(lambda: mesh_step(twin, batch))
            flat = torch.cat([p.grad.reshape(-1) for p in twin.optimizer.params
                              if p.grad is not None])
            ar_ms = cuda_ms(lambda: mesh.all_reduce_(flat), 10)
            print(f"parallel W=1 nccl: {len(m1)} metrics, every parameter, BatchNorm statistic "
                  f"and moment bit-identical to the ungrouped step, launches "
                  f"{step_launches('pair')} each; step {ms_plain:.2f} ms ungrouped, "
                  f"{ms_nccl:.2f} ms under NCCL; gradient all-reduce {ar_ms:.3f} ms over "
                  f"{flat.numel() * 4 / 1e6:.1f} MB")
            del flat
        finally:
            dist.destroy_process_group()
    del state, twin, step, batch
    torch.cuda.empty_cache()

    print(f"parallel: {PARALLEL_RANKS} ranks on one card over gloo, every collective staged "
          "through host memory (gloo's CUDA support does not cover every collective)")
    ranks = spawn(parallel_rank, PARALLEL_RANKS, root_cfg, BATCH, device="cuda:0",
                  backend="gloo", timeout=600)
    for mode in ranks[0]:
        runs = [r[mode] for r in ranks]
        if len({r["digest"] for r in runs}) != 1 or len({r["loss"] for r in runs}) != 1:
            raise AssertionError(f"{mode}: the ranks' BatchNorm statistics or losses differ")
        for r, run in enumerate(runs):
            keep = {k: round(v, 6) if isinstance(v, float) else v for k, v in run.items()
                    if k not in ("shapes", "digest")}
            print(f"parallel {mode} rank {r}: {json.dumps(keep)}")
    split = [n for n, shape in ranks[0]["model=2"]["shapes"].items()
             if shape != ranks[0]["data=2"]["shapes"][n]]
    from eda_tpu_torch.parallel.mesh import tp_param_spec

    want = [n for n in ranks[0]["data=2"]["shapes"] if tp_param_spec(n) is not None]
    if split != want:
        raise AssertionError(f"model=2: {len(split)} leaves are parts after the step, "
                             f"{len(want)} should be")
    print(f"parallel model=2: {len(split)} split leaves still parts after the step")


def bench_phase() -> None:
    """The bench's three timers at flagship batch 8 with few repetitions; its
    JSON lines go to stdout."""
    from eda_tpu_torch import bench

    if bench.main(["--eval", "--batch", str(BATCH), "--iters", "8"]):
        raise AssertionError("bench failed")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from eda_tpu_torch.config import ModelConfig
    from eda_tpu_torch.ops.cuda import build

    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            # C7519: ptxas notes each warpgroup.arrive it adds around a wgmma
            keep = "warning" in line or "registers" in line or "spill" in line
            if keep and "C7519" not in line:
                print(f"  nvcc {name}: {line.strip()}")
    check_pool_build(logs, build)
    check_mma_build(logs, build)

    cfg = ModelConfig(use_bf16=True)

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return out

    phase("pool ties", pool_tie_check)
    phase("pool backward edges", pool_bwd_edge_check)
    phase("fps edges", fps_edge_check)
    phase("prep backward edges", prep_bwd_edge_check)
    phase("pool widths", pool_widths_check)
    phase("prep edges", prep_edge_check)
    phase("mask edges", mask_edge_check)
    with radius_mode("pair"):
        phase("tiny model", small_model_check, cfg)
        phase("tiny training step", small_train_check, cfg)
        phase("tiny eval", small_eval_check, cfg)
        serve_rows, serve_launches, model, inputs = phase("serving", serving_phase, cfg)
        torch.cuda.empty_cache()
        train_rows, train_launches, *trainer = phase("training", train_phase, cfg)
    for row, symbol in zip(serve_rows + train_rows, SERVING + TRAINING):
        row["launches"] = (serve_launches if symbol in SERVING else train_launches)[symbol]
    mode_rows = {mode: phase(f"radius mode {mode}", radius_mode_phase, mode, model, inputs,
                             *trainer) for mode in ("mxu", "pre")}
    del model, inputs, trainer
    torch.cuda.empty_cache()
    eval_launches = phase("eval", eval_phase, cfg)
    phase("cli", cli_phase, cfg)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        real = phase("real data", real_data_phase, cfg, Path(tmp))
        torch.cuda.empty_cache()
        phase("butd", butd_phase, cfg, *real, Path(tmp))
    torch.cuda.empty_cache()
    f32_rows = phase("f32", f32_phase, ModelConfig())
    torch.cuda.empty_cache()
    w2x_rows = phase("w2x", w2x_phase, cfg)
    torch.cuda.empty_cache()
    w2x_f32_rows = phase("w2x f32", w2x_f32_phase, ModelConfig())
    torch.cuda.empty_cache()
    w4x_rows = phase("w4x", w4x_phase, cfg)
    torch.cuda.empty_cache()
    w4x_f32_rows = phase("w4x f32", w4x_f32_phase, ModelConfig())
    torch.cuda.empty_cache()
    phase("gather", gather_phase, ModelConfig())
    torch.cuda.empty_cache()
    phase("device sort", device_sort_phase, cfg)
    torch.cuda.empty_cache()
    phase("parallel", parallel_phase, cfg)
    busy = {k: round(v, 2) for k, v in PROFILED.items()}
    print(f"device busy ms of the profiled calls: {busy}")
    phase("bench", bench_phase)
    for mode, mode_row in mode_rows.items():
        for row in mode_row:
            if not row["name"].endswith("winners"):
                row["launches"] = eval_launches[mode][row["name"] + "_launch"]

    rows = (serve_rows + train_rows + mode_rows["mxu"] + mode_rows["pre"] + f32_rows + w2x_rows
            + w2x_f32_rows + w4x_rows + w4x_f32_rows)
    for row in rows:
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} was not launched on the main path")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
