"""The port's accuracy probe (``python -m eda_tpu_torch.tools.window_sweep``) and its optimizer.

* the twin of ``tests/test_window_sweep_cli.py:17`` (fused, ``--cpu``): a
  JSON trace line per ``--eval-every`` step and the final per-window records,
  with the JAX tool's keys;
* a staged run (``--save-params``, then ``--init-params``) prints the traces
  and saves the state of one long run, bit for bit; a resumed run with other
  flags, or with ``--schedule cosine``, is refused;
* ``AdamW.constant`` against ``optax.chain(clip_by_global_norm(1.0),
  adamw(lr))`` on the same gradients for three steps: parameters and both
  moments within rtol 1e-5, atol 1e-7 (f32 arithmetic in the same order, as
  ``tests/test_torch_optim.py``), the text encoder decayed as optax decays it;
* the twin of ``tests/test_overfit_convergence.py:108``: 30 steps of the
  probe's recipe on 4 scenes, the loss below 0.75 of the first, the evaluator
  fed by real end points.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from eda_tpu_torch.tools import window_sweep
from eda_tpu_torch.train.optim import AdamW
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DRY = ["--dry", "--cpu", "--eval-on-train", "--schedule", "constant", "--lr", "1e-3",
       "--sweep", "default"]


def _run(argv, capsys):
    assert window_sweep.main(argv) == 0
    out = capsys.readouterr()
    return [json.loads(line) for line in out.out.splitlines() if line], out.err


def test_trace_lines(capsys):
    lines, _ = _run(DRY + ["--steps", "2", "--eval-every", "1", "--sweep", "default", "dense"],
                    capsys)
    traces = [r for r in lines if r.get("trace")]
    finals = [r for r in lines if not r.get("trace")]
    assert [t["step"] for t in traces] == [1, 2]
    for t in traces:
        assert sorted(t) == ["acc_025_top1", "acc_05_top1", "impl", "loss", "seed", "step",
                             "trace"]
        assert t["impl"] == "fused" and 0.0 <= t["acc_025_top1"] <= 1.0
    assert [f["sa_windows"] for f in finals] == [[256, 128, 64, 64], [1024, 1024, 1024, 1024]]
    for final in finals:
        assert final["steps"] == 2 and final["schedule"] == "constant"
        assert final["train_windows"] == [256, 128, 64, 64]
        assert 0.0 <= final["acc_025_top1"] <= 1.0 and final["fwd_scenes_per_sec"] > 0


def test_staged_run_is_one_long_run(tmp_path, capsys):
    common = DRY + ["--eval-every", "1", "--batch", "2", "--train-batches", "2",
                    "--eval-batches", "2"]
    whole, _ = _run(common + ["--steps", "3", "--save-params", str(tmp_path / "whole.pt")],
                    capsys)
    first, _ = _run(common + ["--steps", "2", "--save-params", str(tmp_path / "a.pt")], capsys)
    second, err = _run(common + ["--steps", "1", "--init-params", str(tmp_path / "a.pt"),
                                 "--save-params", str(tmp_path / "b.pt")], capsys)
    assert "warm-start" in err and "at step 2" in err
    traces = [r for r in first + second if r.get("trace")]
    assert traces == [r for r in whole if r.get("trace")]
    want = torch.load(tmp_path / "whole.pt", weights_only=True)
    got = torch.load(tmp_path / "b.pt", weights_only=True)
    assert got["step"] == want["step"] == 3 and got["flags"] == want["flags"]
    assert all(torch.equal(got["model"][k], want["model"][k]) for k in want["model"])
    assert got["optimizer"]["count"] == want["optimizer"]["count"] == 3
    for key in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(got["optimizer"][key],
                                                     want["optimizer"][key]))

    with pytest.raises(SystemExit, match="seed"):
        window_sweep.main(common + ["--steps", "1", "--seed", "1", "--init-params",
                                    str(tmp_path / "a.pt")])
    with pytest.raises(SystemExit):
        window_sweep.main(DRY[:-4] + ["--schedule", "cosine", "--init-params",
                                      str(tmp_path / "a.pt")])
    assert "--schedule constant" in capsys.readouterr().err


class _Tree(nn.Module):
    def __init__(self, params):
        super().__init__()
        for top, leaves in params.items():
            setattr(self, top, nn.ParameterDict(
                {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in leaves.items()}))


def test_constant_optimizer_matches_optax():
    rng = np.random.default_rng(0)
    shapes = {"backbone_net": {"w": (4, 3), "b": (3,)}, "text_encoder": {"w": (5,)},
              "head": {"w": (3, 2), "b": (2,)}}
    params = {top: {k: rng.normal(size=s).astype(np.float32) for k, s in leaves.items()}
              for top, leaves in shapes.items()}
    lr = 1e-3
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr))
    jparams = {top: {k: jnp.asarray(v) for k, v in leaves.items()}
               for top, leaves in params.items()}
    opt_state = tx.init(jparams)
    model = _Tree(params)
    port = AdamW.constant(model, lr)
    assert list(port.groups) == ["all"] and len(port.groups["all"]) == 5

    for scale in (3.0, 0.05, 2.0):  # clipped, not clipped, clipped
        grads = {top: {k: (scale * rng.normal(size=s)).astype(np.float32)
                       for k, s in leaves.items()} for top, leaves in shapes.items()}
        grads["text_encoder"] = {"w": np.zeros(5, np.float32)}  # no gradient reaches it
        updates, opt_state = tx.update(
            {t: {k: jnp.asarray(v) for k, v in ls.items()} for t, ls in grads.items()},
            opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for top, leaves in grads.items():
            for k, v in leaves.items():
                getattr(model, top)[k].grad = (None if top == "text_encoder"
                                               else torch.from_numpy(v))
        port.step()
        adam = opt_state[1][0]
        for top, leaves in jparams.items():
            for k, v in leaves.items():
                p = getattr(model, top)[k]
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(v), rtol=1e-5,
                                           atol=1e-7, err_msg=f"{top}.{k}")
                for i, moment in enumerate((adam.mu, adam.nu)):
                    np.testing.assert_allclose(port.moments[p][i].numpy(),
                                               np.asarray(moment[top][k]), rtol=1e-5, atol=1e-7)
    text = model.text_encoder["w"].detach().numpy()
    assert not np.array_equal(text, params["text_encoder"]["w"])  # weight decay moved it


def test_overfit_smoke_losses_fall_and_eval_wires(capsys):
    lines, err = _run(DRY + ["--batch", "4", "--train-batches", "1", "--eval-batches", "1",
                             "--steps", "30", "--eval-every", "30"], capsys)
    first = float(re.search(r"step 0: loss ([\d.]+)", err).group(1))
    (trace,) = [r for r in lines if r.get("trace")]
    assert trace["step"] == 30
    assert trace["loss"] < 0.75 * first, (first, trace["loss"])
    assert 0.0 <= trace["acc_025_top1"] <= 1.0
