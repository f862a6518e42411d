"""Rules of the PyTorch port that later slices must keep.

* ``eda_tpu_torch``, ``chip_smoke.py`` and the fixtures it imports
  (``tests/real_data_fixtures.py``) import neither JAX nor flax nor anything
  of the JAX package ``eda_tpu``;
* both import on a machine with no CUDA and no ``nvcc`` (kernels build on use);
* entry points (``build``, ``entry``, ``build_evaluator``, the training CLI,
  the bench, the window sweep and the class-table tool) run on CUDA unless the
  caller asks for the CPU, and never fall back to the CPU by themselves;
  ``chip_smoke.py`` fails without a card;
* ``weights.load_flax`` maps every flax leaf and sets every port parameter;
* the port's synthetic inputs and training targets are the JAX package's,
  byte for byte;
* the package and the CLI's real-data path import and run with ``regex``,
  ``h5py`` and ``transformers`` unimportable (the card has none of them);
  ``--use_multiview`` then stops at start-up, naming ``h5py``;
* a scan store may name only the scan class and numpy's array globals.
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
from torch_parity import one_torch_thread  # noqa: F401

from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from eda_tpu.data.synthetic import SyntheticScenes as JaxSyntheticScenes
from eda_tpu.models import EDAGrounder as JaxGrounder
from eda_tpu_torch import entry
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.models.pointnet2 import FusedSetAbstraction, SetAbstraction
from eda_tpu_torch.ops.cuda import build
from eda_tpu_torch.weights import from_flax, load_flax, to_flax

ROOT = Path(__file__).resolve().parents[1]
# chip_smoke.py imports tests/real_data_fixtures.py on the card
PORT_FILES = sorted((ROOT / "eda_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "real_data_fixtures.py"]
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
        "sys.path.append('tests')\n"
        "import real_data_fixtures\n"
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
        "fps_launch", "sa_pair_pool_launch", "sa_pair_pool_mxu_launch",
        "sa_pair_pool_mxu_winners_launch", "sa_pair_pool_pre_launch",
        "sa_pair_pool_pre_winners_launch", "sa_pair_pool_winners_launch",
        "sa_pool_bwd_compact_launch", "sa_pool_bwd_window_launch", "sa_prep_bwd_f32_launch",
        "sa_prep_bwd_launch", "sa_prep_f32_launch", "sa_prep_launch", "sa_radius_mask_launch"]
    assert all(k.replaces.startswith("eda_tpu/ops/pallas/") for k in build.KERNELS.values())


def test_build_evaluator_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(use_bf16=True).tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.build_evaluator(cfg, batch_size=2)
    model, score_step, evaluator, batch = entry.build_evaluator(cfg, batch_size=2, device="cpu")
    assert not model.training and next(model.parameters()).device.type == "cpu"
    ious = score_step(batch)
    assert ious.shape == (2, 2, 2, 10) and ious.device.type == "cpu"
    evaluator.evaluate(None, None, ious=ious)
    assert evaluator.gts[("last_", 0.25, 1, "bbf")] == 2
    assert all(k.launches == 0 for k in build.KERNELS.values())


def _tools(tmp_path):
    from eda_tpu_torch import bench
    from eda_tpu_torch.tools import window_sweep
    from eda_tpu_torch.train import cli

    return {
        "train": (cli.main, ["--debug", "--use_color", "--max_steps", "1", "--batch_size", "2",
                             "--log_dir", str(tmp_path / "run")]),
        "bench": (bench.main, ["--dry", "--no-train", "--no-mfu", "--iters", "1"]),
        "window_sweep": (window_sweep.main, ["--dry", "--steps", "1", "--batch", "2",
                                             "--train-batches", "1", "--eval-batches", "1",
                                             "--sweep", "default"]),
    }


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("tool", ["train", "bench", "window_sweep"])
def test_command_line_tools_need_cuda_unless_cpu_is_passed(tool, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = _tools(tmp_path)[tool]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    assert not (tmp_path / "run").exists()
    assert main(argv + ["--cpu"]) == 0
    assert all(k.launches == 0 for k in build.KERNELS.values())


def test_pool_bwd_timer_needs_a_card(monkeypatch, capsys):
    """A device timing has no CPU counterpart: without CUDA the tool fails, printing nothing."""
    from eda_tpu_torch.tools import pool_bwd_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pool_bwd_times.main([]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("kernels", ["prep_f32", "prep_bf16"])
def test_kernel_timer_needs_a_card_for_the_prep_kernels(kernels, monkeypatch, capsys):
    """``--kernels prep_f32`` / ``prep_bf16`` time K2f / K7f and K2 / K7: on the card only."""
    from eda_tpu_torch.tools import pool_bwd_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pool_bwd_times.main(["--kernels", kernels, "--busy"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.usefixtures("one_torch_thread")
def test_class_table_tool_needs_cuda_unless_cpu_is_passed(tmp_path, monkeypatch):
    from eda_tpu_torch.tools import gen_class_embeddings

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(gen_class_embeddings, "ModelConfig",
                        lambda: ModelConfig(use_bf16=True).tiny())
    argv = ["--roberta_dir", str(tmp_path / "none"), "--out", str(tmp_path / "t.npy")]
    with pytest.raises(RuntimeError, match="CUDA"):
        gen_class_embeddings.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        gen_class_embeddings.generate(class_names=["chair"], cfg=ModelConfig().tiny())
    assert not (tmp_path / "t.npy").exists()
    assert gen_class_embeddings.main(argv + ["--cpu"]) == 0
    table = np.load(tmp_path / "t.npy")
    assert table.shape == (485, ModelConfig().tiny().text_hidden) and np.isfinite(table).all()


def test_chip_smoke_fails_without_cuda(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_port_grounder_refuses_what_it_does_not_run():
    """The fused SA's device sort (``points_presorted=False``) is not ported;
    the gather SA never sorts, so it takes either setting, as in JAX."""
    cfg = ModelConfig(use_bf16=True).tiny()
    with pytest.raises(NotImplementedError, match="item 4.4"):
        EDAGrounder(dataclasses.replace(cfg, points_presorted=False))
    EDAGrounder(dataclasses.replace(cfg, points_presorted=False, sa_impl="gather"))


# refused until the f32 model and the gather SA were ported: each flag reaches
# its feature, the SA layers' compute dtype and their kind
NOW_BUILT = [
    ({"use_bf16": False}, FusedSetAbstraction, torch.float32),
    ({"sa_impl": "gather"}, SetAbstraction, torch.bfloat16),
    ({"sa_impl": "gather", "use_bf16": False, "sa_ball_mode": "first"}, SetAbstraction,
     torch.float32),
]


@pytest.mark.parametrize("change,kind,dtype", NOW_BUILT, ids=["f32", "gather", "gather-f32"])
def test_port_grounder_builds_the_f32_and_gather_models(change, kind, dtype):
    cfg = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), **change)
    backbone = EDAGrounder(cfg).backbone_net
    for i in range(1, 5):
        sa = getattr(backbone, f"sa{i}")
        assert isinstance(sa, kind)
        if kind is SetAbstraction:
            assert sa.ball_mode == cfg.sa_ball_mode and sa.nsample == cfg.sa_nsamples[i - 1]
            assert all(d.dtype == dtype for d in sa.mlp.dense)
        else:
            assert sa.dtype == dtype
    assert backbone.fp1.dtype == dtype


def _flax_tree(cfg):
    """The JAX grounder's variables as numpy zeros, from shapes alone."""
    model = JaxGrounder(cfg)
    inputs = {
        "point_clouds": jax.ShapeDtypeStruct((1, cfg.num_points, 6), jnp.float32),
        "text_ids": jax.ShapeDtypeStruct((1, 16), jnp.int32),
        "text_mask": jax.ShapeDtypeStruct((1, 16), jnp.bool_),
    }
    if cfg.butd:
        inputs.update(det_boxes=jax.ShapeDtypeStruct((1, 132, 6), jnp.float32),
                      det_class_ids=jax.ShapeDtypeStruct((1, 132), jnp.int32),
                      det_mask=jax.ShapeDtypeStruct((1, 132), jnp.bool_))
    shapes = jax.eval_shape(lambda x: model.init(jax.random.key(0), x, train=False), inputs)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)


@pytest.mark.parametrize("over", [{}, {"butd": True}, {"sa_impl": "gather"}],
                         ids=["single-stage", "butd", "gather"])
def test_from_flax_maps_every_leaf(over):
    tree = _flax_tree(dataclasses.replace(JaxConfig(use_bf16=True).tiny(), **over))
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    port = EDAGrounder(dataclasses.replace(ModelConfig(use_bf16=True).tiny(), **over))
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


def test_to_flax_inverts_from_flax():
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                                  _flax_tree(JaxConfig(use_bf16=True).tiny()))
    port = EDAGrounder(ModelConfig(use_bf16=True).tiny())
    load_flax(port, tree)
    back = to_flax(port.state_dict(), tree)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    state = {k: v + 1 for k, v in port.state_dict().items()}
    again = from_flax(to_flax(state, tree))
    assert again.keys() == state.keys() and all(torch.equal(again[k], state[k]) for k in state)
    with pytest.raises(KeyError, match="no flax leaf takes"):
        to_flax({**state, "stray.weight": torch.zeros(2)}, tree)
    with pytest.raises(KeyError, match="pos_embed"):
        to_flax({k: v for k, v in state.items() if not k.startswith("pos_embed")}, tree)


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


def test_real_data_path_needs_no_regex_h5py_or_transformers(tmp_path):
    """In a process where ``regex``, ``h5py``, ``transformers`` and ``tokenizers``
    cannot be imported: every port module imports, the CLI's loader builds the
    real-data datasets (BPE tokenizer, ``--joint_det`` mix) and assembles a
    batch, and ``--use_multiview`` raises at start-up naming ``h5py``."""
    from torch_parity import real_data_tree

    root = real_data_tree(tmp_path, scenes=(("train", 2), ("val", 1)))[0]
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('regex', 'h5py', 'transformers', 'tokenizers', 'jax', 'eda_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import eda_tpu_torch\n"
        "for m in pkgutil.walk_packages(eda_tpu_torch.__path__, 'eda_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from eda_tpu_torch.train import cli\n"
        f"flags = ['--dataset', 'scanrefer', '--joint_det', '--data_root', {str(root)!r}]\n"
        "args = cli.parse_args(flags)\n"
        "gen, n = cli.make_loader(args, cli.build_configs(args)[0], 'train')\n"
        "batch = cli.batch_of(gen, [0, n - 1])\n"
        "assert type(gen.parts[0].tokenizer).__name__ == 'BPETokenizer'\n"
        "assert batch['inputs']['text_ids'].shape == (2, 256)\n"
        "try:\n"
        "    cli.main(flags + ['--use_multiview', '--cpu', '--log_dir', sys.argv[1]])\n"
        "except RuntimeError as e:\n"
        "    print('refused:', e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "run")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "refused: --use_multiview reads its features with the h5py package" in out.stdout


def test_scan_store_refuses_other_globals(tmp_path):
    import os
    import pickle

    from eda_tpu_torch.data.scannet import load_packed_scans

    class Evil:
        def __reduce__(self):
            return (os.system, ("echo pwned",))

    for payload in ({"scene": Evil()}, {"scene": eval}, {"scene": Path("x")}):
        path = tmp_path / "store.pkl"
        path.write_bytes(pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL))
        with pytest.raises(pickle.UnpicklingError, match="may not name"):
            load_packed_scans(str(path))
    ok = {"scene": {"points": np.arange(3), "set": {1, 2}}}
    path.write_bytes(pickle.dumps(ok, protocol=pickle.HIGHEST_PROTOCOL))
    assert load_packed_scans(str(path))["scene"]["set"] == {1, 2}
