"""Rules of the PyTorch port that later slices must keep.

* ``eda_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor flax nor
  anything of the JAX package ``eda_tpu``;
* both import on a machine with no CUDA and no ``nvcc`` (kernels build on use);
* entry points run on CUDA unless the caller asks for the CPU, and never fall
  back to the CPU by themselves; ``chip_smoke.py`` fails without a card;
* ``weights.load_flax`` maps every flax leaf and sets every port parameter;
* the port's synthetic inputs and training targets are the JAX package's,
  byte for byte.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from eda_tpu.data.synthetic import SyntheticScenes as JaxSyntheticScenes
from eda_tpu.models import EDAGrounder as JaxGrounder
from eda_tpu_torch import entry
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.ops.cuda import build
from eda_tpu_torch.weights import from_flax, load_flax

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "eda_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "eda_tpu")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_without_cuda_or_jax():
    """Every port module and chip_smoke import in a fresh process, pulling in no JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import eda_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(eda_tpu_torch.__path__, 'eda_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'eda_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('eda_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


def test_entry_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = dataclasses.asdict(ModelConfig(use_bf16=True).tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.build(ModelConfig(use_bf16=True).tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry(**tiny)
    center = entry.entry(device="cpu", **tiny)
    assert center.device.type == "cpu" and center.shape == (2, 32, 3)
    assert torch.isfinite(center).all()
    # on CPU tensors every wrapper ran its plain version: no kernel launched
    assert all(k.launches == 0 for k in build.KERNELS.values())
    assert sorted(build.KERNELS) == [
        "fps_launch", "sa_pair_pool_launch", "sa_pair_pool_winners_launch",
        "sa_pool_bwd_compact_launch", "sa_pool_bwd_window_launch", "sa_prep_bwd_launch",
        "sa_prep_launch"]


def test_chip_smoke_fails_without_cuda(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_port_grounder_refuses_what_it_does_not_run():
    cfg = ModelConfig(use_bf16=True).tiny()
    for change in ({"butd": True}, {"sa_impl": "gather"}, {"points_presorted": False},
                   {"use_bf16": False}):
        with pytest.raises(NotImplementedError):
            EDAGrounder(dataclasses.replace(cfg, **change))


def _flax_tree(cfg):
    """The JAX grounder's variables as numpy zeros, from shapes alone."""
    model = JaxGrounder(cfg)
    inputs = {
        "point_clouds": jax.ShapeDtypeStruct((1, cfg.num_points, 6), jnp.float32),
        "text_ids": jax.ShapeDtypeStruct((1, 16), jnp.int32),
        "text_mask": jax.ShapeDtypeStruct((1, 16), jnp.bool_),
    }
    shapes = jax.eval_shape(lambda x: model.init(jax.random.key(0), x, train=False), inputs)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)


def test_from_flax_maps_every_leaf():
    tree = _flax_tree(JaxConfig(use_bf16=True).tiny())
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    port = EDAGrounder(ModelConfig(use_bf16=True).tiny())
    state = from_flax(tree)
    assert len(state) == n_leaves == len(port.state_dict())
    load_flax(port, tree)

    extra = {"params": {**tree["params"], "stray": {"kernel": np.zeros((2, 2), np.float32)}},
             "batch_stats": tree["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        load_flax(port, extra)
    short = {"params": {k: v for k, v in tree["params"].items() if k != "pos_embed"},
             "batch_stats": tree["batch_stats"]}
    with pytest.raises(KeyError, match="pos_embed"):
        load_flax(port, short)
    with pytest.raises(KeyError, match="no port parameter"):
        from_flax({"params": {"odd": {"thing": np.zeros(3, np.float32)}}})


@pytest.mark.parametrize("num_points,text_len", [(1024, 16), (50000, 64)])
def test_synthetic_inputs_byte_identical(num_points, text_len):
    """Serving inputs, training targets and the decoupled spans, byte for byte."""
    from eda_tpu.data.decouple import decoupled_spans as jax_spans
    from eda_tpu_torch.data.decouple import decoupled_spans

    kw = dict(num_points=num_points, num_objects=8, text_len=text_len)
    jax_gen = JaxSyntheticScenes(JaxSyntheticConfig(**kw), vocab_size=50265)
    gen = SyntheticScenes(SyntheticConfig(**kw), vocab_size=50265)
    want = jax_gen.batch([0, 3])
    got = gen.batch([0, 3])
    assert sorted(got) == ["point_clouds", "text_ids", "text_mask"]
    got_train = gen.train_batch([0, 3])
    for group, got_group in (("inputs", got), ("inputs", got_train["inputs"]),
                             ("targets", got_train["targets"])):
        assert sorted(got_group) == sorted(want[group]), group
        for key in got_group:
            assert got_group[key].dtype == np.asarray(want[group][key]).dtype, key
            assert got_group[key].tobytes() == np.asarray(want[group][key]).tobytes(), key
    for idx in (0, 3):
        caption = jax_gen.example(idx)["utterance"]
        assert gen.example(idx)["utterance"] == caption
        assert decoupled_spans(caption) == jax_spans(caption)
