"""The port's mesh (``eda_tpu_torch/parallel/mesh.py``) against ``eda_tpu/parallel/mesh.py``.

* the rows of every global batch that each data rank holds are those that
  JAX's ``batch_rows_for_devices`` gives the devices of that data index, on
  the same (data, model) mesh shapes, and ``process_batch_rows`` tiles the
  batch disjointly;
* ``make_global_batch`` puts exactly a rank's rows on its device;
* ``to_host_global`` concatenates over the data group in data-rank order, on
  every rank (two and four spawned gloo processes);
* ``tp_param_spec`` splits, through the weight name map, exactly the leaves
  that JAX's ``tp_param_spec`` splits on the same model (single-stage,
  two-stage and fused q/k/v tiny models);
* ``shard_params`` keeps each rank's part, and its coverage guard fails
  loudly on a module rename while a model = 1 mesh never runs it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.models import EDAGrounder as JaxGrounder
from eda_tpu.parallel import batch_rows_for_devices
from eda_tpu.parallel import make_mesh as jax_make_mesh
from eda_tpu.parallel import tp_param_spec as jax_tp_param_spec
from eda_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from eda_tpu.data.synthetic import SyntheticScenes as JaxSyntheticScenes
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.parallel import mesh as port_mesh
from eda_tpu_torch.parallel.launch import spawn
from eda_tpu_torch.weights import from_flax

SHAPES = [(2, 1), (4, 1), (8, 1), (4, 2), (2, 2), (2, 4)]


def fake_mesh(data: int, model: int, rank: int = 0) -> port_mesh.Mesh:
    """A rank's coordinates without process groups (enough for rows and slicing)."""
    return port_mesh.Mesh(data, model, rank, torch.device("cpu"), "gloo")


@pytest.mark.parametrize("data,model", SHAPES)
@pytest.mark.parametrize("global_batch", [8, 16])
def test_rows_equal_jax(data, model, global_batch):
    jax_mesh = jax_make_mesh(jax.devices()[:data * model], model=model)
    seen = []
    for rank in range(data * model):
        mesh = fake_mesh(data, model, rank)
        got = port_mesh.process_batch_rows(mesh, global_batch)
        # the model devices of one data index hold the same rows
        want = batch_rows_for_devices(
            jax_mesh, [jax_mesh.devices[mesh.data_rank, mesh.model_rank]], global_batch)
        np.testing.assert_array_equal(got, want)
        if mesh.model_rank == 0:
            seen.append(got)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), np.arange(global_batch))
    np.testing.assert_array_equal(
        port_mesh.batch_rows_for_ranks(fake_mesh(data, model), range(data), global_batch),
        np.arange(global_batch))


def test_rows_refuse_a_batch_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        port_mesh.process_batch_rows(fake_mesh(4, 1), 6)
    np.testing.assert_array_equal(port_mesh.process_batch_rows(None, 5), np.arange(5))


def test_make_global_batch_holds_the_ranks_rows():
    mesh = fake_mesh(2, 2, rank=3)
    batch = {"inputs": {"a": np.arange(24, dtype=np.float32).reshape(8, 3)},
             "targets": {"b": np.arange(8, dtype=np.int32)}}
    rows = port_mesh.process_batch_rows(mesh, 8)
    np.testing.assert_array_equal(rows, [4, 5, 6, 7])
    local = {g: {k: v[rows] for k, v in a.items()} for g, a in batch.items()}
    out = port_mesh.make_global_batch(local, mesh, 8)
    assert torch.equal(out["inputs"]["a"], torch.from_numpy(batch["inputs"]["a"][4:]))
    assert torch.equal(out["targets"]["b"], torch.from_numpy(batch["targets"]["b"][4:]))
    with pytest.raises(ValueError, match="this rank holds 4"):
        port_mesh.make_global_batch(batch, mesh, 8)


def gather_rank(mesh):
    """Rank-dependent leaves through ``to_host_global`` (``spawn``)."""
    d = mesh.data_rank
    tree = {"ious": torch.full((2, 2, 3, 5), float(d)) + torch.arange(3.)[:, None],
            "hard": {"is_hard": np.array([d % 2 == 0, True, False])},
            "rows": np.arange(3, dtype=np.int64) + 3 * d}
    return (port_mesh.to_host_global(tree["ious"], mesh, axis=2),
            port_mesh.to_host_global({k: v for k, v in tree.items() if k != "ious"}, mesh))


@pytest.mark.parametrize("world,model", [(2, 1), (4, 2)])
def test_to_host_global_in_data_rank_order(world, model):
    results = spawn(gather_rank, world, model=model, timeout=60)
    data = world // model
    want_ious = np.concatenate(
        [np.full((2, 2, 3, 5), float(d), np.float32) + np.arange(3.)[:, None]
         for d in range(data)], axis=2)
    for ious, rest in results:  # every rank holds the global values
        np.testing.assert_array_equal(ious, want_ious)
        np.testing.assert_array_equal(rest["rows"], np.arange(3 * data))
        assert rest["hard"]["is_hard"].dtype == bool
        np.testing.assert_array_equal(
            rest["hard"]["is_hard"],
            np.concatenate([[d % 2 == 0, True, False] for d in range(data)]))
    assert port_mesh.to_host_global(torch.ones(2), None).tolist() == [1.0, 1.0]


def jax_sharded_port_names(cfg) -> set:
    """JAX's TP-sharded leaves of the tiny model, named as the port names them."""
    gen = JaxSyntheticScenes(JaxSyntheticConfig(num_points=cfg.num_points, num_objects=4,
                                                text_len=16, max_objects=cfg.max_detected_boxes),
                             vocab_size=cfg.text_vocab_size)
    inputs = jax.tree_util.tree_map(np.asarray, gen.batch(range(1), butd=cfg.butd)["inputs"])
    model = JaxGrounder(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), inputs, train=False))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])

    def keep(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                sub = keep(v, path + (jax.tree_util.DictKey(k),))
                if sub:
                    out[k] = sub
            elif jax_tp_param_spec(path + (jax.tree_util.DictKey(k),)) != P():
                out[k] = v
        return out

    return set(from_flax({"params": keep(params)}))


@pytest.mark.parametrize("fields", [{}, {"butd": True}, {"fused_qkv": True}],
                         ids=["single", "butd", "fused_qkv"])
def test_tp_param_spec_splits_jax_s_leaves(fields):
    want = jax_sharded_port_names(dataclasses.replace(JaxConfig().tiny(), **fields))
    model = EDAGrounder(dataclasses.replace(ModelConfig().tiny(), **fields))
    got = {n for n, _ in model.named_parameters() if port_mesh.tp_param_spec(n) is not None}
    assert got == want
    assert any(".ffn_lv.dense.1.weight" in n for n in got)
    assert any("text_encoder.layer.0.intermediate" in n for n in got)
    assert port_mesh.tp_param_spec("decoder.0.cross_v.attn.out.bias") is None
    assert port_mesh.tp_param_spec("decoder.0.ffn.dense.1.bias") is None
    assert port_mesh.tp_param_spec("text_encoder.layer.1.attention.out.weight") == 1


def rename_modules(module: torch.nn.Module, renames: dict) -> None:
    """Rename child modules in place (the silent de-shard hazard)."""
    for child in list(module.children()):
        rename_modules(child, renames)
    module._modules = type(module._modules)(
        (renames.get(name, name), child) for name, child in module._modules.items())


def test_shard_params_keeps_parts_and_guard_trips_on_rename():
    model = EDAGrounder(ModelConfig().tiny())
    model.init_weights(0)
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    port_mesh.shard_params(model, fake_mesh(1, 2, rank=1))
    for name, p in model.named_parameters():
        dim = port_mesh.tp_param_spec(name)
        want = full[name] if dim is None else full[name].chunk(2, dim)[1]
        assert torch.equal(p, want), name
    assert model.decoder[0].ffn.tp is not None and model.text_encoder.layer[0].tp is not None

    renamed = EDAGrounder(ModelConfig().tiny())
    rename_modules(renamed, {"query": "q_proj", "key": "k_proj", "value": "v_proj",
                             "out": "o_proj", "intermediate": "mlp_up", "dense": "layers"})
    with pytest.raises(ValueError, match="TP sharding coverage"):
        port_mesh.shard_params(renamed, fake_mesh(1, 2))
    port_mesh.shard_params(renamed, fake_mesh(2, 1))  # model = 1: the guard never runs
