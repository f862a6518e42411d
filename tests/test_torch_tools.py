"""The port's spatial ops, coverage probe, scene export and kernel tools against ``eda_tpu``'s.

* ``ops/spatial.py``: the cases of ``tests/test_spatial.py``, each also equal
  to ``eda_tpu.ops.spatial`` on the same inputs (keys, sorted scene, ranks and
  starts exactly);
* ``tools/coverage_probe.py``: numpy on both sides, so every coverage
  function gives JAX's value exactly on the same scenes and centers;
* ``eval/visualize.py``: ``export_scene`` writes JAX's PLY byte for byte;
* ``tools/sa_kernel_bench.py``: the same ``LAYERS`` table, and ``make_inputs
  --scenes`` gives JAX's clouds, centers and window starts exactly (the same
  synthetic scenes and FPS chain);
* ``tools/profile_step.py``: a tiny training step traced on the CPU lands in
  the JAX tool's buckets, and ``--parse`` re-reads the saved trace to the same
  buckets. That the tools need CUDA unless ``--device cpu`` is given is
  ``test_torch_port_rules.py``'s.
"""

import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401

import jax.numpy as jnp
from eda_tpu.eval import visualize as jax_visualize
from eda_tpu.ops import spatial as jax_spatial
from eda_tpu.tools import coverage_probe as jax_probe
from eda_tpu.tools import sa_kernel_bench as jax_bench
from eda_tpu_torch.data.presort import morton_keys_np
from eda_tpu_torch.eval import visualize
from eda_tpu_torch.ops import spatial
from eda_tpu_torch.ops.pointops import furthest_point_sample
from eda_tpu_torch.tools import coverage_probe, profile_step, sa_kernel_bench


def test_sort_by_cell_orders_keys(rng):
    xyz = rng.uniform(-3, 3, (2, 500, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 500, 4)).astype(np.float32)
    scene = spatial.sort_by_cell(torch.from_numpy(xyz), torch.from_numpy(feats), cell_size=0.5)
    keys = scene.keys.numpy()
    assert (np.diff(keys, axis=1) >= 0).all()
    np.testing.assert_array_equal(keys, spatial.cell_keys(scene.xyz, 0.5).numpy())
    for b in range(2):
        np.testing.assert_array_equal(scene.xyz[b].numpy(), xyz[b][scene.perm[b].numpy()])
    want = jax_spatial.sort_by_cell(jnp.asarray(xyz), jnp.asarray(feats), cell_size=0.5)
    for got, w in zip(scene, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


@pytest.mark.parametrize("cell", [0.5, 0.2, 0.7])
def test_cell_keys_match_the_compiled_reference(cell, rng):
    import jax

    xyz = np.concatenate([rng.uniform(-60, 1000, (3000, 3)),
                          np.arange(-20, 20)[:, None].repeat(3, 1) * cell]).astype(np.float32)
    want = jax.jit(lambda x: jax_spatial.cell_keys(x, cell))(jnp.asarray(xyz))
    np.testing.assert_array_equal(spatial.cell_keys(torch.from_numpy(xyz), cell).numpy(),
                                  np.asarray(want))


def test_center_ranks_match_searchsorted(rng):
    pts = np.sort(rng.integers(0, 1000, (2, 200)).astype(np.int32), axis=1)
    cens = np.sort(rng.integers(0, 1000, (2, 16)).astype(np.int32), axis=1)
    got = spatial.center_ranks(torch.from_numpy(pts), torch.from_numpy(cens))
    assert got.dtype == torch.int32
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(), np.searchsorted(pts[b], cens[b], "left"))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_spatial.center_ranks(jnp.asarray(pts), jnp.asarray(cens))))


def test_window_starts_clamped():
    ranks = np.array([[0, 100, 995]], np.int32)
    starts = spatial.window_starts(torch.from_numpy(ranks), n_points=1000, window=200)
    assert starts.tolist() == [[0, 0, 800]]
    np.testing.assert_array_equal(
        starts.numpy(), np.asarray(jax_spatial.window_starts(jnp.asarray(ranks), 1000, 200)))


def _scene(seed=0, n=6000, m=256):
    from eda_tpu_torch.data.synthetic import SyntheticConfig, SyntheticScenes

    gen = SyntheticScenes(SyntheticConfig(num_points=n, num_objects=8, text_len=64),
                          vocab_size=512)
    xyz = np.asarray(gen.example(seed)["inputs"]["point_clouds"][:, :3], np.float64)
    cidx = furthest_point_sample(torch.from_numpy(xyz[None].astype(np.float32)), m)[0].numpy()
    return xyz, cidx


def test_coverage_probe_functions_equal_jax():
    xyz, cidx = _scene()
    r = 0.2
    np.testing.assert_array_equal(coverage_probe.hilbert_keys_np(xyz, r),
                                  jax_probe.hilbert_keys_np(xyz, r))
    mk = morton_keys_np(xyz.astype(np.float32), r)
    for policy in ("mid", "range", "dual", "ideal"):
        for W, pb in ((1024, 16), (256, 8)):
            got = coverage_probe.window_coverage(mk, xyz, cidx, r, W, pb, policy)
            assert got == jax_probe.window_coverage(mk, xyz, cidx, r, W, pb, policy), policy
            assert 0 < got <= 1
    for shared in (False, True):
        assert (coverage_probe.segment_coverage(mk, xyz, cidx, r, 128, 16, shared)
                == jax_probe.segment_coverage(mk, xyz, cidx, r, 128, 16, shared))
    assert (coverage_probe.reference_coverage(xyz, cidx, r, 64)
            == jax_probe.reference_coverage(xyz, cidx, r, 64))


def test_coverage_probe_runs_its_modes(capsys):
    argv = ["--scenes", "1", "--num_points", "3000", "--centers", "128"]
    assert coverage_probe.main(argv + ["--sweep", "--segments", "--policies", "--reference"]) == 0
    out = capsys.readouterr().out
    assert "scene 0:" in out and "sweep pb=16 W=1024" in out and "8seg x192" in out
    assert "hilbert ideal" in out and "reference ball_query nsample=64" in out


def test_export_scene_writes_jax_s_ply(tmp_path, rng):
    xyz = rng.uniform(-2, 2, (500, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1.2, (500, 3)).astype(np.float32)
    gt = [np.array([0, 0, 0, 1, 2, 0.5], np.float32)]
    pred = [np.array([0.1, 0, 0, 1, 1, 1], np.float32), np.array([1, 1, 1, 0.2, 0.3, 0.4])]
    for kw in (dict(rgb=rgb, gt_boxes=gt, pred_boxes=pred), {}):
        got = visualize.export_scene(str(tmp_path / "port.ply"), xyz, **kw)
        want = jax_visualize.export_scene(str(tmp_path / "jax.ply"), xyz, **kw)
        assert open(got, "rb").read() == open(want, "rb").read()


def test_kernel_bench_inputs_are_jax_s():
    assert sa_kernel_bench.LAYERS == jax_bench.LAYERS
    for layer in ("sa1", "sa2"):
        A, xyz, b_c, cen, starts, params, kw = sa_kernel_bench.make_inputs(layer, 1, scenes=True)
        want = jax_bench.make_inputs(layer, 1, scenes=True)
        for got, w in ((xyz, want[1]), (cen, want[3]), (starts, want[4])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        assert kw == {k: want[6][k] for k in ("radius", "window")}
        N, M, radius, W, c1, (_, c2, c3) = sa_kernel_bench.LAYERS[layer]
        assert A.shape == (1, N, c1) and A.dtype == b_c.dtype == torch.bfloat16
        assert [tuple(p.shape) for p in params] == [(c1, c2), (c2,), (c2,), (c2,), (c2, c3), (c3,)]


@pytest.mark.usefixtures("one_torch_thread")
def test_profile_step_buckets_a_tiny_step_and_reparses_it(tmp_path, capsys):
    argv = ["--dry", "--device", "cpu", "--steps", "1", "--batch", "2", "--top", "5"]
    assert profile_step.main(argv + ["--out", str(tmp_path)]) == 0
    first = capsys.readouterr().out
    got = profile_step.report(str(tmp_path), steps=1)
    for bucket in ("backbone fwd", "backbone bwd", "model bwd", "loss", "text fwd", "other"):
        assert got.get(bucket, 0) > 0, bucket
    assert profile_step.main(["--parse", str(tmp_path), "--steps", "1", "--top", "5"]) == 0
    again = capsys.readouterr().out
    assert again.split("--- buckets ---")[1] in first + again
    assert "--- top 5 ops ---" in first


def test_profile_step_buckets_the_kernels():
    """Kernel symbols by name and context, as a CUDA trace names them."""
    fwd = [{"name": "backbone_net"}, {"name": "_Pool"}]
    bwd = [{"name": "profiler::step"},
           {"name": "autograd::engine::evaluate_function: _PoolBackward", "backbone": True}]
    assert profile_step.bucket("void fps_regs<8>(float const*, int, int, int*)", fwd) == \
        "FPS kernel"
    assert profile_step.bucket("void sa_pair_pool_kernel<64, 64, 128>(...)", fwd) == \
        "SA fwd kernel"
    assert profile_step.bucket("pool_bwd_tiles<false>(...)", bwd) == "SA bwd kernel"
    assert profile_step.bucket("ampere_sgemm", bwd) == "backbone bwd"
    assert profile_step.bucket("ampere_sgemm", bwd[:1] + [{"name": bwd[1]["name"]}]) == \
        "model bwd"
    assert profile_step.bucket("elementwise", fwd) == "backbone fwd"
    assert profile_step.bucket("elementwise", [{"name": "loss"}]) == "loss"
    assert profile_step.bucket("elementwise", []) == "other"
