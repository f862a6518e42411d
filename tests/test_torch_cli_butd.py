"""The two-stage grounder through the port's training CLI, against the root ``train.py``.

* ``--butd`` training steps on tiny synthetic scenes, then ``--eval
  --butd_cls`` from the checkpoint (the SR3D / NR3D filter);
* the ScanNet detection eval (``--test_dataset scannet --butd``, also with
  ``--butd_gt``) over fabricated val scans with GroupFree detections;
* ``--pp_checkpoint`` and a released-EDA ``.pth`` ``--checkpoint_path``.

Each eval's metrics equal ``train.py``'s exactly (the evaluator's counts, the
mAPs) on the same end points: the JAX CLI's ``evaluate`` and
``evaluate_detection`` score the port model's forward, reached from inside
JAX's jit through ``jax.pure_callback`` (``torch_parity.PortAsFlax``), so
these tests hold the CLI's batching, tail masking, filtering, 18-class
ground truth and scoring; the forwards themselves are held in
``test_torch_butd_model.py``.
"""

import argparse
import dataclasses
import json
import logging
import re
import types

import numpy as np
import pytest
import torch

import real_data_fixtures
import train as jax_train
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.train import cli
from torch_parity import PortAsFlax, one_torch_thread, real_data_tree  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax_state():
    return types.SimpleNamespace(params=None, batch_stats=None)


def test_cli_butd_train_then_butd_cls_eval_equals_train_py(tmp_path, monkeypatch):
    """Two ``--butd`` steps on tiny synthetic scenes, ``--eval --butd_cls`` from
    the checkpoint, and the ``--butd_cls`` evaluation's counts against
    ``train.py:evaluate`` on the checkpoint's end points."""
    flags = ["--cpu", "--debug", "--use_color", "--butd", "--batch_size", "8",
             "--num_workers", "2", "--log_dir", str(tmp_path)]
    assert cli.main(flags + ["--max_steps", "2", "--print_freq", "1"]) == 0
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in records)
    seen = {}
    evaluate = cli.evaluate

    def recorded(args, model, model_cfg, *a, **k):
        seen.update(args=args, model=model, model_cfg=model_cfg)
        seen["evaluator"] = evaluate(args, model, model_cfg, *a, **k)
        return seen["evaluator"]

    monkeypatch.setattr(cli, "evaluate", recorded)
    assert cli.main(flags + ["--eval", "--butd_cls"]) == 0
    log = (tmp_path / "log.txt").read_text()
    assert "resumed from epoch 1" in log and "Acc0.25Top1" in log

    args, model, model_cfg, got = seen["args"], seen["model"], seen["model_cfg"], seen["evaluator"]
    jax_args = jax_train.parse_args(flags[1:] + ["--eval", "--butd_cls"])
    assert model_cfg.butd and args.butd_cls and vars(args) == {**vars(jax_args), "cpu": True}
    saved = torch.load(tmp_path / "ckpt" / "epoch_0.pt", weights_only=True)["model"]
    assert all(torch.equal(v, saved[k]) for k, v in model.state_dict().items())
    logger = logging.getLogger("test_torch_cli_butd")

    gen, _ = cli.make_loader(args, model_cfg, "val")
    port = PortAsFlax(model, gen.batch(range(args.batch_size), butd=True))
    monkeypatch.setattr(jax_train, "_EVAL_CACHE", {})
    want = jax_train.evaluate(jax_args, port, None, _jax_state(),
                              jax_train.build_configs(jax_args)[0], logger)
    assert got.filter_non_gt_boxes and want.filter_non_gt_boxes
    assert got.dets == want.dets and got.gts == want.gts
    assert got.gts[("last_", 0.25, 1, "bbs")] == 128


@pytest.fixture(scope="module")
def det_tree(tmp_path_factory):
    """A fabricated tree with the full text vocabulary (the detection eval
    tokenizes its prompt with the hash tokenizer over 50 265 ids, as
    ``train.py`` does) and GroupFree detections for the val scans too."""
    from eda_tpu_torch.data.scannet import load_packed_scans

    root = real_data_tree(tmp_path_factory.mktemp("det"), text_vocab_size=50265)[0]
    scans = load_packed_scans(str(root / "val_v3scans.pkl"))
    labels = {sid: [o["instance_label"] for o in scan.three_d_objects]
              for sid, scan in scans.items()}
    real_data_fixtures.fabricate_detections(root, {"val": sorted(scans)}, labels,
                                            np.random.default_rng(2))
    return root


@pytest.mark.parametrize("butd_flags", [["--butd"], ["--butd", "--butd_gt"]],
                         ids=" ".join)
def test_cli_scannet_detection_eval_equals_train_py(det_tree, tmp_path, monkeypatch,
                                                    butd_flags):
    """``--test_dataset scannet``: the port CLI's ``--eval`` logs the mAPs that
    ``cli.evaluate_detection`` gives for the same weights, which equal
    ``train.py:evaluate_detection``'s on the same end points."""
    from eda_tpu_torch.data.detection_prompt import DetectionPromptDataset
    from eda_tpu_torch.data.scannet import load_packed_scans
    from eda_tpu_torch.train.convert import warm_start

    build_configs = cli.build_configs

    def tiny(args):
        model, train, data = build_configs(args)
        return dataclasses.replace(model.tiny(), text_vocab_size=50265, butd=model.butd), \
            train, data

    monkeypatch.setattr(cli, "build_configs", tiny)
    argv = ["--dataset", "scanrefer", "--test_dataset", "scannet", "--use_color",
            "--data_root", str(det_tree), "--batch_size", "3", "--num_workers", "0",
            "--log_dir", str(tmp_path), "--eval", "--ap_iou_thresholds", "0.05", "0.25",
            "0.5"] + butd_flags
    assert cli.main(["--cpu"] + argv) == 0
    logged = {float(t): float(v) for t, v in re.findall(r"detection mAP@([\d.]+): ([\d.]+)",
                                                       (tmp_path / "log.txt").read_text())}
    assert sorted(logged) == [0.05, 0.25, 0.5]

    args, jax_args = cli.parse_args(argv), jax_train.parse_args(argv)
    model_cfg = dataclasses.replace(cli.build_configs(args)[0], input_feature_dim=3)
    model = EDAGrounder(model_cfg)  # the CLI's weights: seed 0, then the warm start
    model.init_weights(args.seed)
    warm_start(model, model_cfg, data_root=args.data_root, log=lambda _: None)
    positive_sizes = [m.dense[2].bias for n, m in model.named_modules()
                      if n.endswith("size_head")]
    got = cli.evaluate_detection(args, model, model_cfg, logging.getLogger("test_torch_cli_butd"))
    assert {t: round(got[f"mAP@{t}"], 4) for t in logged} == logged
    with torch.no_grad():  # boxes with positive extents overlap the GT boxes
        for bias in positive_sizes:
            bias += 1.0
    got = cli.evaluate_detection(args, model, model_cfg, logging.getLogger("test_torch_cli_butd"))

    ds = DetectionPromptDataset(load_packed_scans(str(det_tree / "val_v3scans.pkl")),
                                split="val", augment=False,
                                detected_dir=str(det_tree / "group_free_pred_bboxes"),
                                butd_gt=args.butd_gt)
    port = PortAsFlax(model, ds.batch(range(3), butd=True)["inputs"])
    want = jax_train.evaluate_detection(jax_args, port, _jax_state(),
                                        jax_train.build_configs(jax_args)[0],
                                        logging.getLogger("test_torch_cli_butd"))
    print(f"detection eval {butd_flags}: port {got}, train.py {want}")
    assert got == want and len(ds) == 2
    assert got["mAP@0.05"] > 0.0 and all(0.0 <= v <= 1.0 for v in got.values())


def test_cli_loads_the_reference_checkpoints(tmp_path):
    """``--pp_checkpoint`` warm-starts the backbone from a GroupFree-style
    ``.pth`` and a ``.pth`` ``--checkpoint_path`` loads a released EDA
    checkpoint and starts at its epoch, through the CLI."""
    from torch_parity import fabricate_eda_state_dict

    cfg = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), butd=True)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in fabricate_eda_state_dict(cfg).items()}
    torch.save({"model": {k: v for k, v in sd.items() if k.startswith("backbone_net.")}},
               tmp_path / "gf.pth")
    torch.save({"model": sd, "epoch": 4, "config": argparse.Namespace(butd=True)},
               tmp_path / "eda.pth")
    flags = ["--cpu", "--debug", "--use_color", "--butd", "--batch_size", "8",
             "--num_workers", "0"]
    assert cli.main(flags + ["--max_steps", "1", "--pp_checkpoint", str(tmp_path / "gf.pth"),
                             "--log_dir", str(tmp_path / "a")]) == 0
    assert "pp_checkpoint: warm-started 32 backbone leaves" in (tmp_path / "a" / "log.txt"
                                                               ).read_text()
    assert cli.main(flags + ["--eval", "--checkpoint_path", str(tmp_path / "eda.pth"),
                             "--log_dir", str(tmp_path / "b")]) == 0
    log = (tmp_path / "b" / "log.txt").read_text()
    n_params = len([k for k in EDAGrounder(cfg).state_dict()
                    if not k.endswith(("running_mean", "running_var"))])
    assert "loaded EDA .pth: " in log and "resumed from epoch 5" in log
    loaded = int(re.search(r"loaded EDA \.pth: (\d+) param", log).group(1))
    assert loaded == n_params - 3 * 4 * 3  # the fused SA's biases and LayerNorms stay
