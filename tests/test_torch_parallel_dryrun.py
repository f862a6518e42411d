"""``entry.dryrun_multichip``: the counterpart of ``__graft_entry__.dryrun_multichip`` on the CPU.

Four gloo ranks as data = 2 x model = 2 (two as data = 2) take one training
step of the tiny two-stage model and print JAX's line; every rank reports
the same finite loss. Without CUDA and without ``device="cpu"`` it raises:
the entry point runs on the cards unless the caller asks for the CPU.
"""

import re

import pytest
import torch

from eda_tpu_torch import entry


@pytest.mark.parametrize("n,data,model", [(4, 2, 2), (2, 2, 1)])
def test_dryrun_multichip(n, data, model, capsys):
    entry.dryrun_multichip(n, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(rf"dryrun_multichip\({n}\): mesh data={data} model={model}, "
                        r"loss=\d+\.\d{4} OK", line), line


def test_dryrun_multichip_needs_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.dryrun_multichip(2)
    assert capsys.readouterr().out == ""


def test_dp_scaling_needs_the_cards(monkeypatch, capsys):
    from eda_tpu_torch.tools import dp_scaling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dp_scaling.main(["--ranks", "4"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "4 CUDA cards" in out.err
