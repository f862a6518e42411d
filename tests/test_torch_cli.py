"""The port's training CLI (``python -m eda_tpu_torch.train``) against the root ``train.py``.

* the parser: every flag of ``train.py:parse_args`` with the same option
  strings, destination, default, type, nargs and choices; the features the
  port lacks are refused with their ROADMAP item, and the real-data flags are
  parsed as ``train.py`` parses them;
* ``build_configs`` gives the JAX package's three configs field for field;
* ``tail_chunks`` and an epoch's index chunks equal ``train.py``'s;
* the CLI smoke on the CPU (the twin of ``tests/test_cli_integration.py``):
  the run directory, the ``train`` and ``val`` metric groups, ``--profile``,
  and ``--eval`` restoring the forced checkpoint and running no step;
* ``evaluate`` (pipelined, padded tail) counts exactly what a serial
  recompute with the eval step and the evaluator's own scoring counts;
* real-format data: the first batches the CLI feeds are bit-identical to
  ``train.make_loader``'s (also under ``--joint_det``), and a tiny run on the
  CPU trains two steps on a fabricated ScanRefer tree with the RoBERTa warm
  start and scores the val split from its checkpoint.
"""

import argparse
import dataclasses
import json

import numpy as np
import pytest
import torch

import real_data_fixtures
import train as jax_train
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.eval.grounding import GroundingEvaluator
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.train import cli
from eda_tpu_torch.train.step import make_eval_step
from torch_parity import assert_same_example, one_torch_thread, real_data_tree  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _parser(parse_args, monkeypatch):
    """The ArgumentParser that ``parse_args`` builds."""
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, *a, **k):
        seen["parser"] = self
        return orig(self, *a, **k)

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        parse_args([])
    return seen["parser"]


def _surface(parser):
    return {opt: (a.dest, a.default, a.type, a.nargs, a.choices, a.const)
            for a in parser._actions for opt in a.option_strings if opt != "-h"}


def test_parser_has_every_flag_and_default_of_train_py(monkeypatch):
    want = _surface(_parser(jax_train.parse_args, monkeypatch))
    got = _surface(_parser(cli.parse_args, monkeypatch))
    assert got == want
    assert vars(cli.parse_args([])) == vars(jax_train.parse_args([]))


ACCEPTED = [
    [],
    ["--num_target", "7", "--lr-scheduler", "cosine", "--warmup-epoch", "2",
     "--warmup-multiplier", "5", "--no_augment", "--eval_train"],
    ["--use_color", "--use_height", "--weight_decay", "0.0005", "--lr_decay_epochs", "50", "75",
     "--detect_intermediate", "--augment_det", "--lr", "2e-4", "--lr_backbone", "2e-3",
     "--batch_size", "12", "--debug", "--seed", "3", "--max_epoch", "7"],
    ["--eval", "--checkpoint_path", "/tmp/x", "--wo_obj_name", "/tmp/y.json", "--reduce_lr"],
]


@pytest.mark.parametrize("argv", ACCEPTED, ids=lambda a: " ".join(a) or "defaults")
def test_build_configs_equal_train_py(argv):
    args, jax_args = cli.parse_args(argv), jax_train.parse_args(argv)
    assert vars(args) == vars(jax_args)
    for got, want in zip(cli.build_configs(args), jax_train.build_configs(jax_args)):
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


REFUSED = [
    (["--test_dataset", "scannet"], "item 4"),
    (["--butd"], "item 4"),
    (["--butd_gt"], "item 4"),
    (["--butd_cls"], "item 4"),
    (["--sa_impl", "gather"], "item 4"),
    (["--pp_checkpoint", "gf.pth"], "item 4"),
    (["--checkpoint_path", "eda.pth"], "item 4"),
    (["--checkpoint_path", "eda.pt"], "item 4"),
]


@pytest.mark.parametrize("argv,why", REFUSED, ids=lambda a: " ".join(a) if isinstance(a, list)
                         else None)
def test_parser_refuses_what_the_port_lacks(argv, why, capsys):
    jax_train.parse_args(argv)  # train.py accepts each of these ...
    with pytest.raises(SystemExit):  # ... the port refuses it, naming its ROADMAP item
        cli.parse_args(argv)
    err = capsys.readouterr().err
    assert f"ROADMAP Queue 1 {why}" in err


NOW_ACCEPTED = [
    ["--dataset", "scanrefer"],
    ["--dataset", "synthetic", "sr3d"],
    ["--joint_det"],
    ["--use_multiview"],
    ["--dataset", "sr3d+", "nr3d", "--joint_det", "--use_height", "--use_multiview"],
]


@pytest.mark.parametrize("argv", NOW_ACCEPTED, ids=" ".join)
def test_parser_accepts_the_real_data_flags(argv):
    """Refused before the real-data pipeline was ported; parsed now as ``train.py`` parses them."""
    args, jax_args = cli.parse_args(argv), jax_train.parse_args(argv)
    assert vars(args) == vars(jax_args)
    for got, want in zip(cli.build_configs(args), jax_train.build_configs(jax_args)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_main_refuses_roberta_weights_and_multihost(tmp_path, monkeypatch):
    """A ``roberta-base`` weights file under ``--data_root`` is no longer refused:
    the run warm-starts its text encoder from it (``train/convert.py``). Several
    hosts are still refused."""
    encoder = real_data_fixtures.seeded_roberta(ModelConfig(use_bf16=True).tiny(), seed=3)
    (tmp_path / "roberta-base").mkdir()
    torch.save(real_data_fixtures.hf_roberta_state(encoder),
               tmp_path / "roberta-base" / "pytorch_model.bin")
    seen = {}

    def first_step(state):
        seen.update({k: v.clone() for k, v in state.model.text_encoder.state_dict().items()})

    steps = real_data_fixtures.CheckedSteps(cli.make_train_step, first_step, text_len=64)
    with monkeypatch.context() as mp:
        mp.setattr(cli, "make_train_step", steps)
        assert cli.main(["--cpu", "--debug", "--use_color", "--data_root", str(tmp_path),
                         "--max_steps", "1", "--batch_size", "2",
                         "--log_dir", str(tmp_path / "run")]) == 0
    assert len(steps.finish()) == 1
    want = encoder.state_dict()
    assert seen.keys() == want.keys() and all(torch.equal(seen[k], want[k]) for k in want)
    assert f"text_encoder: loaded {len(want)} RoBERTa leaves" in (
        tmp_path / "run" / "log.txt").read_text()
    monkeypatch.setenv("EDA_TPU_MULTIHOST", "1")
    with pytest.raises(SystemExit, match="item 6"):
        cli.main(["--cpu", "--log_dir", str(tmp_path / "run")])


@pytest.mark.parametrize("n,bsz", [(128, 5), (128, 8), (7, 12), (4096, 12)])
def test_tail_chunks_equal_train_py(n, bsz):
    got, want = cli.tail_chunks(n, bsz), jax_train.tail_chunks(n, bsz)
    assert len(got) == len(want)
    for (gi, gv), (wi, wv) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("n_train,steps,batch", [(128, 64, 2), (128, 10, 12), (4096, 341, 12)])
def test_epoch_chunks_equal_train_py(n_train, steps, batch):
    """Three epochs from one seeded generator, against ``train.py:400-407`` verbatim."""
    got_rng, want_rng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        got = cli.epoch_chunks(got_rng, n_train, steps, batch)
        order = want_rng.permutation(n_train)
        want = []
        for it in range(steps):
            idx = order[(it * batch) % n_train:][:batch]
            if len(idx) < batch:
                idx = np.concatenate([idx, order[: batch - len(idx)]])
            want.append(idx)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_cli_smoke_train_then_eval(tmp_path):
    rc = cli.main(["--cpu", "--dataset", "synthetic", "--debug", "--use_color", "--max_steps",
                   "2", "--batch_size", "2", "--log_dir", str(tmp_path), "--print_freq", "1",
                   "--profile", "1", "--num_workers", "2"])
    assert rc == 0
    assert (tmp_path / "config.json").exists()
    assert json.loads((tmp_path / "config.json").read_text())["cpu"] is True
    log = (tmp_path / "log.txt").read_text()
    assert "loss" in log and "device: cpu" in log
    assert (tmp_path / "profile" / "trace.json").exists()
    # the checkpoint was forced on the max_steps exit
    saved = torch.load(tmp_path / "ckpt" / "epoch_0.pt", weights_only=True)
    assert saved["step"] == 2 and saved["optimizer"]["count"] == 2
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    train_records = [r for r in records if r["group"] == "train"]
    assert [r["step"] for r in train_records] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in train_records)

    # eval-only: restores the forced checkpoint, scores the whole val split,
    # runs no training step, and leaves the checkpoint as it was
    rc = cli.main(["--cpu", "--dataset", "synthetic", "--debug", "--use_color", "--eval",
                   "--batch_size", "8", "--log_dir", str(tmp_path), "--steps_per_epoch", "3"])
    assert rc == 0
    log = (tmp_path / "log.txt").read_text()
    assert "resumed from epoch 1" in log and "Testing evaluation" in log
    assert "Acc0.25Top1" in log
    assert log.count("max_steps reached") == 1
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    (val,) = [r for r in records if r["group"] == "val"]
    assert val["step"] == 2 and 0.0 <= val["last_Acc0.25Top1_bbf"] <= 1.0
    assert len([r for r in records if r["group"] == "train"]) == 2
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["epoch_0.pt"]


def test_evaluate_matches_a_serial_recompute(tmp_path):
    """``cli.evaluate`` (score step, one-deep pipeline, padded and masked tail
    batch) counts exactly as a serial loop over the same chunks that runs the
    eval forward and lets the evaluator score the end points itself."""
    import logging

    args = cli.parse_args(["--cpu", "--debug", "--use_color", "--batch_size", "5",
                           "--num_workers", "2", "--log_dir", str(tmp_path)])
    model_cfg, _, _ = cli.build_configs(args)
    model_cfg = dataclasses.replace(model_cfg, input_feature_dim=3)
    model = EDAGrounder(model_cfg)
    model.init_weights(0)
    got = cli.evaluate(args, model, model_cfg, logging.getLogger("test_torch_cli"))

    gen, n_val = cli.make_loader(args, model_cfg, "val")
    assert n_val % args.batch_size != 0  # the tail mask engages
    want = GroundingEvaluator(prefixes=("last_", "proposal_"))
    eval_fn = make_eval_step(model)
    for idx, valid in cli.tail_chunks(n_val, args.batch_size):
        batch = cli.to_device(gen.train_batch(idx), "cpu")
        end_points, _ = eval_fn(batch)
        want.evaluate(end_points, batch["targets"], valid=valid)
    assert got.dets == want.dets and got.gts == want.gts
    assert got.gts[("last_", 0.25, 1, "bbs")] == n_val


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return real_data_tree(tmp_path_factory.mktemp("cli_real"))


@pytest.mark.parametrize("extra", [[], ["--joint_det"], ["--no_augment", "--use_height"]],
                         ids=lambda a: " ".join(a) or "scanrefer")
def test_real_batches_equal_train_py(tree, extra):
    argv = ["--dataset", "scanrefer", "--use_color", "--batch_size", "3",
            "--data_root", str(tree[0])] + extra
    args, jax_args = cli.parse_args(argv), jax_train.parse_args(argv)
    model_cfg, jax_cfg = cli.build_configs(args)[0], jax_train.build_configs(jax_args)[0]
    gen, n = cli.make_loader(args, model_cfg, "train")
    jax_gen, jax_n = jax_train.make_loader(jax_args, jax_cfg, "train")
    assert n == jax_n == len(tree[2]["train"]) * (3 if not extra or extra[0] != "--joint_det"
                                                  else 3 + 10)
    chunks = cli.epoch_chunks(np.random.default_rng(0), n, 2, 3)
    for idx in chunks:
        assert_same_example(cli.batch_of(gen, idx), jax_gen.batch(idx, butd=False), str(idx))
    gen, n = cli.make_loader(args, model_cfg, "train", for_eval=True)  # evaluation never mixes
    assert n == len(tree[2]["train"]) * 3


def test_cli_real_data_train_then_eval(tree, tmp_path, monkeypatch):
    """Two steps on the fabricated ScanRefer tree (the tiny model, 256-token texts,
    the warm-started text encoder), then ``--eval`` from the checkpoint."""
    root, _, ids, encoder = tree
    build_configs = cli.build_configs

    def tiny(args):
        model, train, data = build_configs(args)
        return dataclasses.replace(model.tiny(), text_vocab_size=4096), train, data

    monkeypatch.setattr(cli, "build_configs", tiny)
    seen = {}

    def first_step(state):
        seen.update({k: v.clone() for k, v in state.model.text_encoder.state_dict().items()})

    steps = real_data_fixtures.CheckedSteps(cli.make_train_step, first_step)
    monkeypatch.setattr(cli, "make_train_step", steps)
    flags = ["--cpu", "--dataset", "scanrefer", "--use_color", "--data_root", str(root),
             "--batch_size", "4", "--num_workers", "2", "--log_dir", str(tmp_path)]
    assert cli.main(flags + ["--max_steps", "2", "--print_freq", "1"]) == 0
    assert len(steps.finish()) == 2 and len(steps.launches) == 2
    want = encoder.state_dict()
    assert all(torch.equal(seen[k], want[k]) for k in want)
    log = (tmp_path / "log.txt").read_text()
    assert f"text_encoder: loaded {len(want)} RoBERTa leaves" in log

    assert cli.main(flags + ["--eval"]) == 0
    log = (tmp_path / "log.txt").read_text()
    assert "resumed from epoch 1" in log
    n_val = len(ids["val"]) * real_data_fixtures.ANNOS_PER_SCENE
    assert f"scored {n_val} scenes" in log
    assert any(line.startswith(("unique: ", "multi: ")) for line in log.splitlines())
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    (val,) = [r for r in records if r["group"] == "val"]
    assert all(0.0 <= v <= 1.0 for k, v in val.items() if "Acc" in k)
