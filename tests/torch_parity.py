"""Shared helpers of the ``test_torch_*`` parity tests (JAX reference vs PyTorch port).

The JAX side is compiled with ``xla_allow_excess_precision`` off: by default
XLA on the CPU keeps bf16 intermediates in f32 where a convert back to f32
follows (e.g. ``prod + bias`` in the prep kernel), so it skips roundings the
program asks for and that the port performs. With the option off, the JAX
reference rounds where its source says it does.
"""

from __future__ import annotations

import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}


def compiled(fn, *args, **static):
    """Run ``fn(*args, **static)`` as one XLA program without excess precision."""
    jitted = jax.jit(lambda *a: fn(*a, **static))
    return jitted.lower(*args).compile(compiler_options=NO_EXCESS_PRECISION)(*args)


def bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 values to bf16 (nearest even) and back, in numpy."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def perturb(variables, seed: int = 0):
    """Random LayerNorm/BatchNorm parameters and statistics and random biases,
    so that no parameter sits at its identity init."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        if name == "scale" or re.fullmatch(r"ln_scale\d+", name):
            return (1.0 + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean") or re.fullmatch(r"b\d+|ln_bias\d+", name):
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def tpu_path(monkeypatch, training: bool = False):
    """Put the JAX model on its TPU path, every Pallas kernel interpreted on the CPU.

    ``jax.default_backend`` reads "tpu" (so FusedSetAbstraction picks the
    Pallas pair kernel, ``impl="pallas_train"`` when it trains, and pointops
    the Pallas FPS). With ``training`` the pair pool's backward kernel is
    interpreted too and dropout is the identity (``flax.linen.Dropout``
    returns its input). Nothing in ``eda_tpu`` is edited.
    """
    from flax import linen as nn

    from eda_tpu.ops.pallas import fps as pallas_fps
    from eda_tpu.ops.pallas import sa_kernel, sa_prep

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(sa_prep, "_INTERPRET", True)
    names = [(sa_kernel, "sa_pair_pool_pallas"), (pallas_fps, "furthest_point_sample_pallas")]
    if training:
        names.append((sa_kernel, "sa_pair_pool_bwd_pallas"))
        monkeypatch.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    for module, name in names:
        orig = getattr(module, name)

        def patched(*a, _orig=orig, **k):
            k["interpret"] = True
            return getattr(_orig, "__wrapped__", _orig)(*a, **k)

        monkeypatch.setattr(module, name, patched)


@pytest.fixture
def jax_tpu_serving_path(monkeypatch):
    """The JAX model on its TPU serving path, interpreted on the CPU."""
    tpu_path(monkeypatch)


@pytest.fixture
def jax_tpu_training_path(monkeypatch):
    """The JAX model on its TPU training path (``impl="pallas_train"``),
    interpreted on the CPU, with dropout off."""
    tpu_path(monkeypatch, training=True)


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module's PyTorch work: the suite runs several
    workers on one machine, and tiny models gain nothing from more threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sa_layer_setup(seed, N, M, C, widths):
    """Two Morton-sorted clouds of N points with C features, M centers each,
    random fused SA parameters of the given widths (input 3 + C) and a random
    cotangent of the output: (xyz, feats, cidx, groups, G), numpy."""
    from eda_tpu_torch.data.presort import morton_sort

    rng = np.random.default_rng(seed)
    xyz = np.stack([morton_sort(rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32),
                                cell_size=0.3)[0] for _ in range(2)])
    feats = rng.normal(size=(2, N, C)).astype(np.float32)
    groups = ([], [], [], [])
    prev = 3 + C
    for c in widths:
        groups[0].append((rng.normal(size=(prev, c)) * prev ** -0.5).astype(np.float32))
        groups[1].append((rng.normal(size=c) * 0.1).astype(np.float32))
        groups[2].append((1 + 0.1 * rng.normal(size=c)).astype(np.float32))
        groups[3].append((0.1 * rng.normal(size=c)).astype(np.float32))
        prev = c
    cidx = np.stack([rng.permutation(N)[:M] for _ in range(2)]).astype(np.int32)
    G = rng.normal(size=(2, M, widths[-1])).astype(np.float32)
    return xyz, feats, cidx, groups, G


FUSED_SA_ATOL, FUSED_SA_REL = 0.03, 0.02


def fused_sa_layer_vs_jax(N, M, window, radius, C, widths):
    """The port's fused SA layer (bf16, plain versions on the CPU), forward and
    backward, against ``eda_tpu``'s on its interpreted Pallas training path
    (the ``jax_tpu_training_path`` fixture), on ``sa_layer_setup``'s inputs:
    the features within ``FUSED_SA_ATOL``, every gradient leaf within
    ``FUSED_SA_REL`` of its largest value (``tests/test_torch_fused_sa_train.py``)."""
    import jax.numpy as jnp

    from eda_tpu.ops import fused_sa as jax_fsa
    from eda_tpu_torch.ops import fused_sa as port_fsa

    xyz, feats, cidx, groups, G = sa_layer_setup(N + M + C, N, M, C, widths)
    kw = dict(radius=radius, window=window, block=64, compute_dtype=jnp.bfloat16,
              presorted=True, impl="pallas_train", return_rank_order=True)

    def loss(feats_, params):
        out, _ = jax_fsa.fused_set_abstraction(jnp.asarray(xyz), feats_, jnp.asarray(cidx),
                                               params, **kw)
        return jnp.sum(out * G), out

    params = jax_fsa.SAParams(*(tuple(jnp.asarray(v) for v in g) for g in groups))
    (_, want), (want_df, want_dp) = compiled(
        lambda f, p: jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(f, p),
        jnp.asarray(feats), params)

    port_params = port_fsa.SAParams(*(tuple(torch.tensor(v, requires_grad=True) for v in g)
                                      for g in groups))
    f = torch.tensor(feats, requires_grad=True)
    got, _ = port_fsa.fused_set_abstraction(torch.from_numpy(xyz), f, torch.from_numpy(cidx),
                                            port_params, radius=radius, window=window, block=64)
    (got * torch.from_numpy(G)).sum().backward()

    assert_layer_matches(got, want, f, want_df, port_params, want_dp)


def assert_layer_matches(got, want, f, want_df, port_params, want_dp):
    """The port's fused SA output within ``FUSED_SA_ATOL`` of JAX's, and the
    gradient of the features and of every parameter within ``FUSED_SA_REL`` of
    its largest value."""
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FUSED_SA_ATOL,
                               rtol=0)
    pairs = [("features", f.grad, want_df)]
    for gi, name in enumerate(("kernels", "biases", "ln_scales", "ln_biases")):
        for i, (p, w) in enumerate(zip(port_params[gi], getattr(want_dp, name))):
            pairs.append((f"{name}[{i}]", p.grad, w))
    for name, g, w in pairs:
        w = np.asarray(w)
        assert g is not None and g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max() / (np.abs(w).max() + 1e-6)
        assert err < FUSED_SA_REL, (name, err)


# share of (center, channel) entries whose pool winner the port and the JAX side
# pick apart (near-tied pairs, within the two sides' bf16 rounding differences)
MAX_SWAPPED = 0.01


def fused_sa_layer_vs_jax_on_its_winners(N, M, window, radius, C, widths):
    """``fused_sa_layer_vs_jax`` at the kinks: the port's pool
    hands its backward the winners the JAX side's pool exported (recorded by a
    debug callback around ``sa_pair_pool_pallas``), the share of entries whose
    winners differ held below ``MAX_SWAPPED``; and the cotangent is zero where
    the JAX output lies within ``FUSED_SA_ATOL`` of the last ReLU's kink, where
    the two sides' outputs may fall on either side of it."""
    import jax

    from eda_tpu.ops import fused_sa as jax_fsa
    from eda_tpu.ops.pallas import sa_kernel as jax_sk
    from eda_tpu_torch.ops import fused_sa as port_fsa

    import jax.numpy as jnp

    xyz, feats, cidx, groups, G = sa_layer_setup(N + M + C, N, M, C, widths)
    kw = dict(radius=radius, window=window, block=64, compute_dtype=jnp.bfloat16,
              presorted=True, impl="pallas_train", return_rank_order=True)
    params = jax_fsa.SAParams(*(tuple(jnp.asarray(v) for v in g) for g in groups))
    jax_winners, swapped = [], []
    jax_pool, port_pool = jax_sk.sa_pair_pool_pallas, port_fsa.sa_pair_pool_winners

    def recording(*args, **kw):
        out = jax_pool(*args, **kw)
        if kw.get("with_winners"):
            jax.debug.callback(lambda w: jax_winners.append(np.array(w)), out[1])
        return out

    def on_jax_winners(*args, **kw):
        out, win = port_pool(*args, **kw)
        theirs = torch.from_numpy(jax_winners[-1][:, :win.shape[1], :win.shape[2]])
        swapped.append(float((theirs != win).float().mean()))
        return out, theirs.to(win.dtype)

    def loss(feats_, params_, G_):
        out, _ = jax_fsa.fused_set_abstraction(jnp.asarray(xyz), feats_, jnp.asarray(cidx),
                                               params_, **kw)
        return jnp.sum(out * G_), out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sk, "sa_pair_pool_pallas", recording)
        mp.setattr(port_fsa, "sa_pair_pool_winners", on_jax_winners)
        want = np.asarray(compiled(lambda f, p: loss(f, p, G)[1], jnp.asarray(feats), params))
        G = np.where(want > FUSED_SA_ATOL, G, 0.0).astype(np.float32)
        jax_winners.clear()
        (_, want), (want_df, want_dp) = compiled(
            lambda f, p, g: jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(f, p, g),
            jnp.asarray(feats), params, jnp.asarray(G))
        port_params = port_fsa.SAParams(*(tuple(torch.tensor(v, requires_grad=True) for v in g)
                                          for g in groups))
        f = torch.tensor(feats, requires_grad=True)
        got, _ = port_fsa.fused_set_abstraction(torch.from_numpy(xyz), f, torch.from_numpy(cidx),
                                                port_params, radius=radius, window=window,
                                                block=64)
        (got * torch.from_numpy(G)).sum().backward()
    assert len(swapped) == 1 and swapped[0] < MAX_SWAPPED, swapped
    assert_layer_matches(got, want, f, want_df, port_params, want_dp)


def real_data_tree(tmp, n_vertices: int = 3000, scenes=(("train", 3), ("val", 2)),
                   text_vocab_size: int = 4096, multiview: bool = False):
    """A real-format data root under ``tmp``, packed by the JAX package.

    ``real_data_fixtures.fabricate_real_data`` (ScanNet scenes, ScanRefer annotations,
    a byte-level BPE vocabulary and the tiny text encoder's HF weights at
    ``text_vocab_size`` tokens), then, from the scenes' labels: SR3D, SR3D+
    and NR3D CSVs in the pre-split ``refer_it_3d/`` layout (an NR3D val row
    with ``correct_guess`` False, an SR3D row that does not mention its
    target's class), GroupFree detections for the train split, and with
    ``multiview`` a 128-d feature store for every scene. Returns (data root,
    scan dir, ids by split, the seeded encoder).
    """
    import csv
    from pathlib import Path

    import real_data_fixtures
    from eda_tpu.data.scannet import pack_scans
    from eda_tpu_torch.config import ModelConfig

    tmp = Path(tmp)
    cfg = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), text_vocab_size=text_vocab_size)
    root, scan_dir, ids, encoder, labels = real_data_fixtures.fabricate_real_data(
        tmp, cfg, n_vertices=n_vertices, scenes=dict(scenes))
    rng = np.random.default_rng(1)
    (root / "refer_it_3d").mkdir()
    for split, split_ids in ids.items():
        sr3d, nr3d = [], []
        for k, scan_id in enumerate(split_ids):
            names = labels[scan_id]
            for t in range(3):
                anchor = (t + 1) % len(names)
                rel = ("closest to", "on the left of", "above")[(k + t) % 3]
                sr3d.append({
                    "scan_id": scan_id, "target_id": t,
                    "distractor_ids": str([i for i in range(len(names))
                                           if names[i] == names[t] and i != t]),
                    "utterance": f"the {names[t]} that is {rel} the {names[anchor]}",
                    "instance_type": names[t], "anchors_types": str([names[anchor]]),
                    "anchor_ids": str([anchor]),
                    "mentions_target_class": "False" if (k, t) == (0, 2) else "True"})
                nr3d.append({
                    "scan_id": scan_id, "target_id": t,
                    "utterance": f"Facing the {names[anchor]}, it's the {names[t]} on the right.",
                    "instance_type": names[t],
                    "correct_guess": "False" if (k, t) == (0, 1) else "True"})
        for name, rows in (("sr3d", sr3d), ("sr3d+", sr3d), ("nr3d", nr3d)):
            with open(root / "refer_it_3d" / f"{name}_{split}.csv", "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=list(rows[0]))
                writer.writeheader()
                writer.writerows(rows)
    real_data_fixtures.fabricate_detections(root, {"train": ids["train"]}, labels, rng)
    if multiview:
        import h5py

        (root / "scanrefer_2d_feats").mkdir()
        with h5py.File(root / "scanrefer_2d_feats" / "enet_feats_maxpool.hdf5", "w") as f:
            for split_ids in ids.values():
                for scan_id in split_ids:
                    f[scan_id] = rng.normal(size=(50000, 128)).astype(np.float32)
    alignments = json.loads((root / "meta_data" / "scans_axis_alignment_matrices.json")
                            .read_text())
    for split, split_ids in ids.items():
        pack_scans(split_ids, str(scan_dir), str(root / f"{split}_v3scans.pkl"), alignments,
                   processes=1)
    return root, scan_dir, ids, encoder


def assert_same_arrays(got: dict, want: dict, where: str):
    assert list(got) == list(want), where
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, f"{where} {key}"
        assert g.tobytes() == w.tobytes(), f"{where} {key}"


def assert_same_example(got: dict, want: dict, where: str):
    assert list(got) == list(want)
    for group in want:
        if group == "hardness" and not np.ndim(want[group]["is_hard"]):
            assert got[group] == want[group] and all(
                type(got[group][k]) is type(want[group][k]) for k in want[group]), where
        else:
            assert_same_arrays(got[group], want[group], f"{where} {group}")


# the serving forward's tolerances (tests/test_torch_grounder.py's docstring says why)
HEAD_ATOL = 0.03
PROJ_ATOL = 0.02
LOGIT_ATOL = 0.03


def grounder_forwards(jax_cfg, cfg, inputs: dict, seed: int = 2, jax_kps: bool = False,
                      variables=None):
    """(port end points, JAX end points) of one eval-mode forward on ``inputs``
    (numpy), as numpy f32 / int: the JAX grounder's variables (``variables``,
    else its init perturbed from ``seed``), carried into the port with
    ``weights.load_flax``. Run the JAX side
    on its TPU serving path (``jax_tpu_serving_path``). With ``jax_kps`` the
    port's KPS returns the JAX run's query indices (its own are then checked
    with ``assert_kps_matches_up_to_boundary_ties``)."""
    import jax.numpy as jnp

    from eda_tpu.models import EDAGrounder as JaxGrounder
    from eda_tpu_torch.models import grounder as port_grounder
    from eda_tpu_torch.models.grounder import EDAGrounder
    from eda_tpu_torch.weights import load_flax

    jax_model = JaxGrounder(jax_cfg)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    if variables is None:
        variables = jax.jit(lambda x: jax_model.init(jax.random.key(0), x, train=False))(jin)
        variables = perturb(to_numpy(variables), seed=seed)
    want = compiled(lambda v, x: jax_model.apply(v, x, train=False), variables, jin)
    want = {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
            for k, v in want.items()}
    port = EDAGrounder(cfg)
    load_flax(port, variables)
    with pytest.MonkeyPatch.context() as mp:
        if jax_kps:
            inds = torch.from_numpy(np.array(want["query_points_sample_inds"], np.int64))
            mp.setattr(port_grounder, "top_k_indices", lambda logits, k: inds)
        with torch.inference_mode():
            got = port.eval()({k: torch.from_numpy(v) for k, v in inputs.items()})
    got = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
           for k, v in got.items()}
    return got, want


def assert_kps_matches_up_to_boundary_ties(got: dict, want: dict, k: int):
    """The port's own KPS on its logits keeps the JAX run's seeds, except seeds
    whose JAX logit lies within ``2 * LOGIT_ATOL`` of the k-th largest (the
    boundary near-ties the packages' bf16 logit difference may order either
    way); returns the number of excused seeds per scene."""
    from eda_tpu_torch.models.grounder import top_k_indices

    own = top_k_indices(torch.from_numpy(got["seeds_obj_cls_logits"]), k).numpy()
    excused = []
    for own_row, w_row, logits in zip(own, want["query_points_sample_inds"],
                                      want["seeds_obj_cls_logits"]):
        boundary = np.sort(logits)[::-1][k - 1]
        differ = np.array(sorted(set(own_row) ^ set(w_row)), np.int64)
        assert (np.abs(logits[differ] - boundary) <= 2 * LOGIT_ATOL).all(), differ
        excused.append(len(differ) // 2)
    return excused


def assert_grounder_outputs_match(got: dict, want: dict, cfg):
    """The port's serving end points against the JAX grounder's: the backbone's
    indices exactly, KPS's seed set (its order descending in the JAX logits up
    to ``LOGIT_ATOL``), and every prefix's heads after aligning the port's
    queries to the JAX order by seed index."""
    from eda_tpu_torch.models.grounder import decoder_prefixes

    assert set(got) == set(want)
    for key in ("sa1_inds", "sa2_inds", "sa3_inds", "sa4_inds", "seed_inds", "seed_xyz"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["seed_features"], want["seed_features"], atol=HEAD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got["text_feats_prepro"], want["text_feats_prepro"],
                               atol=1e-4, rtol=0)  # all f32: RoBERTa + projector
    np.testing.assert_allclose(got["seeds_obj_cls_logits"], want["seeds_obj_cls_logits"],
                               atol=LOGIT_ATOL, rtol=0)
    g_inds, w_inds = got["query_points_sample_inds"], want["query_points_sample_inds"]
    for g_row, w_row, logit_row in zip(g_inds, w_inds, want["seeds_obj_cls_logits"]):
        assert sorted(g_row) == sorted(w_row)
        assert (np.diff(logit_row[g_row]) <= 2 * LOGIT_ATOL).all()
    perm = np.stack([np.argsort(g)[np.argsort(np.argsort(w))] for g, w in zip(g_inds, w_inds)])

    def align(x):
        return np.take_along_axis(x, perm.reshape(perm.shape + (1,) * (x.ndim - 2)), 1)

    np.testing.assert_array_equal(align(g_inds), w_inds)
    np.testing.assert_array_equal(align(got["query_points_xyz"]), want["query_points_xyz"])
    for prefix in decoder_prefixes(cfg.num_decoder_layers):
        for name, atol in (("center", HEAD_ATOL), ("pred_size", HEAD_ATOL),
                           ("sem_cls_scores", HEAD_ATOL), ("proj_queries", PROJ_ATOL)):
            key = prefix + name
            np.testing.assert_allclose(align(got[key]), want[key], atol=atol, rtol=0,
                                       err_msg=key)


# --- one tiny training step, the port against JAX (tests/test_torch_train_step.py's
# docstring says why each gate is what it is) ---
STEPS_PER_EPOCH = 10
LOSS_REL = 0.01
METRIC_REL = 0.05
GLOBAL_COS = 0.85
LEAF_COS = 0.4
NORM_RATIO = 2.0
ZERO_NORM = 2e-3
PARAM_CLOSE = 0.8
BN_REL = 0.01
# parameters whose gradient is zero in exact arithmetic: attention key biases
# (softmax ignores a shift of all logits) and Dense biases that a train-mode
# BatchNorm follows (the batch mean removes them)
ZERO_GRAD = re.compile(r"attn\.key\.bias$|points_obj_cls\.dense\.[01]\.bias$"
                       r"|pos_embed\.dense\.0\.bias$|self_posembed\.dense\.0\.bias$"
                       r"|box_embeddings\.dense\.0\.bias$")
# zero-gradient leaves whose bf16 rounding leaves more than ZERO_NORM: the box
# embedding's bias sums 2 x 132 bf16 rows, 2 x 128 of them identical padding
# (measured on test_torch_butd_train_step.py's step: JAX 3.3e-3 of the largest
# leaf norm, the port 1.4e-4)
ZERO_NORM_OF = {"box_embeddings.dense.0.bias": 0.01}
# parameters that take no gradient at all: the butd class table
FROZEN = ("butd_class_embeddings.weight",)
DECISIONS = ("__query_inds", "__match_q", "__query_matched", "__query_target")


def _strip_masked(tree):
    """An optax group state's tree without the MaskedNode leaves of other groups."""
    import optax

    if isinstance(tree, dict):
        out = {k: _strip_masked(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if v is not None}
    return None if isinstance(tree, optax.MaskedNode) else np.asarray(tree, np.float32)


def _first_moments(opt_state) -> dict:
    """Port-named AdamW first moments of every trained JAX parameter."""
    import optax

    from eda_tpu_torch.weights import from_flax

    moments = {}
    for state in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(state, optax.ScaleByAdamState):
            moments.update(from_flax({"params": _strip_masked(state.mu)}))
    return moments


def _loss_with_decisions(cfg, end_points, targets):
    """The JAX loss, plus its KPS indices and the matches of every prefix
    (the same matcher on the same inputs as inside the loss)."""
    import jax.numpy as jnp

    from eda_tpu.losses import criterion as jax_criterion
    from eda_tpu.losses.matcher import hungarian_match as jax_hungarian_match
    from eda_tpu.models.grounder import decoder_prefixes
    from eda_tpu.ops.boxes import box_cxcyczwhd_to_xyzxyz

    loss, metrics = jax_criterion.compute_hungarian_loss(cfg, end_points, targets)
    gt = jnp.concatenate([targets["center_label"], targets["size_gts"]], -1)
    matches = []
    for p in decoder_prefixes(cfg.num_decoder_layers):
        boxes = jnp.concatenate([end_points[f"{p}center"], end_points[f"{p}pred_size"]], -1)
        logits = end_points[f"{p}sem_cls_scores"]
        matches.append(jax_hungarian_match(
            logits, box_cxcyczwhd_to_xyzxyz(boxes), boxes, gt, box_cxcyczwhd_to_xyzxyz(gt),
            targets["positive_map"][..., :logits.shape[-1]], targets["box_label_mask"] > 0,
            cost_class=cfg.cost_class, cost_bbox=cfg.cost_bbox, cost_giou=cfg.cost_giou))
    metrics["__query_inds"] = end_points["query_points_sample_inds"]
    for name in ("match_q", "query_matched", "query_target"):
        metrics["__" + name] = jnp.concatenate([getattr(m, name) for m in matches])
    return loss, metrics


def jax_train_step(batch, variables=None, butd: bool = False, overrides=None,
                   data: int = None):
    """One JAX training step of the tiny config (``butd`` as given, and the
    config fields of ``overrides``, e.g. ``use_bf16`` or ``sa_impl``) on its TPU
    path, dropout off, with its decisions; random perturbed weights unless
    ``variables`` (a function of the model and batch). With ``data``, the step
    runs over a mesh of the first ``data`` CPU devices, the batch sharded over
    its data axis, with ``num_replicas=data`` (``train.py``'s mesh step)."""
    import jax.numpy as jnp

    from eda_tpu.config import ModelConfig as JaxConfig
    from eda_tpu.config import TrainConfig as JaxTrainConfig
    from eda_tpu.losses.criterion import SetCriterionConfig as JaxCriterionConfig
    from eda_tpu.models import EDAGrounder as JaxGrounder
    from eda_tpu.train import step as jax_step_module
    from eda_tpu.train.optim import make_optimizer
    from eda_tpu.train.step import TrainState as JaxTrainState
    from eda_tpu.train.step import make_train_step as jax_make_train_step
    from eda_tpu_torch.weights import from_flax

    with pytest.MonkeyPatch.context() as mp:
        tpu_path(mp, training=True)
        mp.setattr(jax_step_module, "compute_hungarian_loss", _loss_with_decisions)
        jcfg = dataclasses.replace(JaxConfig(use_bf16=True).tiny(), dropout=0.0, butd=butd,
                                   **(overrides or {}))
        batch_j = jax.tree_util.tree_map(jnp.asarray, batch)
        model = JaxGrounder(jcfg)
        if variables is None:
            variables = jax.jit(lambda x: model.init(jax.random.key(0), x, train=False))(
                batch_j["inputs"])
            variables = perturb(to_numpy(variables), seed=2)
        else:
            variables = variables(model, batch_j)
        tx = make_optimizer(JaxTrainConfig(), variables["params"], STEPS_PER_EPOCH)
        state = JaxTrainState.create(variables["params"], variables["batch_stats"], tx)
        step = jax_make_train_step(
            model, JaxCriterionConfig(num_decoder_layers=jcfg.num_decoder_layers,
                                      num_replicas=data or 1), donate=False)
        rng = jax.random.key(0)
        if data:
            from eda_tpu.parallel import make_mesh, shard_batch

            batch_j = shard_batch(batch_j, make_mesh(jax.devices()[:data]))
        run = step.lower(state, batch_j, rng).compile(compiler_options=NO_EXCESS_PRECISION)
        new_state, metrics = run(state, batch_j, rng)
        return dict(
            batch=batch, variables=variables, overrides=dict(overrides or {}),
            decisions={k: torch.from_numpy(np.array(metrics[k])) for k in DECISIONS},
            metrics={k: float(v) for k, v in metrics.items() if k not in DECISIONS},
            params=from_flax({"params": to_numpy(new_state.params),
                              "batch_stats": to_numpy(new_state.batch_stats)}),
            moments=_first_moments(new_state.opt_state),
        )


def port_train_step(jax_run, own_decisions: bool = False, butd: bool = False):
    """The port's step on the JAX run's weights and batch, dropout off; with
    the JAX run's KPS indices and matches, or its own (recorded)."""
    from eda_tpu_torch.config import ModelConfig, TrainConfig
    from eda_tpu_torch.losses import criterion as port_criterion
    from eda_tpu_torch.losses.criterion import SetCriterionConfig
    from eda_tpu_torch.losses.matcher import MatchResult
    from eda_tpu_torch.models import grounder as port_grounder
    from eda_tpu_torch.models.grounder import EDAGrounder
    from eda_tpu_torch.models.layers import Dropout
    from eda_tpu_torch.train.optim import AdamW
    from eda_tpu_torch.train.step import TrainState, make_train_step
    from eda_tpu_torch.weights import load_flax

    cfg = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), dropout=0.0, butd=butd,
                              **jax_run.get("overrides", {}))
    model = EDAGrounder(cfg)
    load_flax(model, jax_run["variables"])
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    state = TrainState(model, AdamW(model, TrainConfig(), STEPS_PER_EPOCH))
    batch = {group: {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
             for group, arrays in jax_run["batch"].items()}
    dec, chosen = jax_run["decisions"], {}

    def record(fn, key):
        def wrapped(*a, **k):
            chosen[key] = fn(*a, **k)
            return chosen[key]
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        if own_decisions:
            mp.setattr(port_grounder, "top_k_indices", record(port_grounder.top_k_indices, "kps"))
            mp.setattr(port_criterion, "hungarian_match",
                       record(port_criterion.hungarian_match, "match"))
        else:
            mp.setattr(port_grounder, "top_k_indices",
                       lambda logits, k: dec["__query_inds"].long())
            mp.setattr(port_criterion, "hungarian_match", lambda *a, **k: MatchResult(
                dec["__match_q"], a[6], dec["__query_matched"], dec["__query_target"],
                torch.zeros(len(a[6]), dtype=torch.int32)))
        metrics = make_train_step(
            SetCriterionConfig(num_decoder_layers=cfg.num_decoder_layers))(state, batch)
    return dict(state=state, metrics={k: float(v) for k, v in metrics.items()},
                decisions=chosen)


# the f32 step's gradient gate (tests/test_torch_f32_train_step.py's note)
F32_GLOBAL_COS = 0.98


def f32_own_step(overrides):
    """One tiny f32 training step of ``jax_train_step`` with ``overrides`` on two
    synthetic scenes, and the port's step on its weights and batch with the
    port's own decisions."""
    from eda_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
    from eda_tpu.data.synthetic import SyntheticScenes as JaxSyntheticScenes

    gen = JaxSyntheticScenes(JaxSyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                             vocab_size=512)
    jax_run = jax_train_step(gen.batch(range(2)), overrides=overrides)
    return jax_run, port_train_step(jax_run, own_decisions=True)


def matched_seeds(match_q, kps):
    """(prefixes * B, T) matched query indices -> the seeds those queries sit on."""
    rows = torch.arange(match_q.shape[0]) % kps.shape[0]
    return kps[rows[:, None], match_q.long()]


def assert_own_decisions_are_jax_s(jax_run, port_run):
    dec, own = jax_run["decisions"], port_run["decisions"]
    kps, jax_kps = own["kps"].long(), dec["__query_inds"].long()
    assert torch.equal(kps.sort(1).values, jax_kps.sort(1).values)
    match = own["match"]
    valid = match.target_valid
    assert valid.sum() > 0
    assert torch.equal(matched_seeds(match.match_q, kps)[valid],
                       matched_seeds(dec["__match_q"], jax_kps)[valid])


def assert_f32_step_matches(jax_run, port_run):
    """The f32 gates: the port's own decisions are JAX's; the metrics; the
    gradients' global cosine >= ``F32_GLOBAL_COS`` and every leaf under the
    per-leaf gates; new parameters and BatchNorm statistics."""
    assert_own_decisions_are_jax_s(jax_run, port_run)
    assert_step_metrics_match(jax_run["metrics"], port_run["metrics"])
    got, want = port_moments(port_run), jax_run["moments"]
    keys = sorted(want)
    glob = cos(torch.cat([got[k].flatten() for k in keys]),
               torch.cat([want[k].flatten() for k in keys]))
    assert glob >= F32_GLOBAL_COS, glob
    assert_first_moments_match(jax_run, port_run)
    assert_new_parameters_match(jax_run, port_run)
    w, g = jax_run["metrics"], port_run["metrics"]
    print(f"loss rel {abs(g['loss'] - w['loss']) / abs(w['loss']):.2e}, grad_norm "
          f"{g['grad_norm']:.4f} vs {w['grad_norm']:.4f}, global cos {glob:.5f}")
    assert abs(g["loss"] - w["loss"]) <= LOSS_REL * abs(w["loss"])
    assert all(abs(g[k] - w[k]) <= METRIC_REL * abs(w[k]) + 1e-6 for k in w)


def cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-300))


def assert_step_metrics_match(want: dict, got: dict, grad_norm_rel: float = METRIC_REL):
    """The loss within ``LOSS_REL``, ``grad_norm`` within ``grad_norm_rel``, every
    other metric within ``METRIC_REL``."""
    assert set(got) == set(want)
    assert np.isfinite(list(got.values())).all()
    assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])
    for key, w in want.items():
        rel = grad_norm_rel if key == "grad_norm" else METRIC_REL
        assert abs(got[key] - w) <= rel * abs(w) + 1e-6, (key, got[key], w)


def port_moments(port_run: dict) -> dict:
    """Port-named AdamW first moments of a ``port_train_step`` run."""
    names = {p: n for n, p in port_run["state"].model.named_parameters()}
    return {names[p]: mu for p, (mu, _) in port_run["state"].optimizer.moments.items()}


def leaf_gate_failures(got: dict, want: dict) -> set:
    """Leaves (not zero-gradient, not frozen) whose moments fail the per-leaf
    gates: cosine below ``LEAF_COS`` or norm ratio outside ``NORM_RATIO``."""
    out = set()
    for name, w in want.items():
        if ZERO_GRAD.search(name) or name in FROZEN:
            continue
        g = got[name]
        ratio = float(g.norm() / w.norm())
        if cos(g, w) < LEAF_COS or not 1 / NORM_RATIO <= ratio <= NORM_RATIO:
            out.add(name)
    return out


def assert_first_moments_match(jax_run: dict, port_run: dict, excused=()):
    """The gradients, read as AdamW's first moments after the step: global and
    per-leaf cosine, norm ratio (leaves in ``excused`` held by the global
    cosine only); zero-gradient leaves tiny on both sides; the frozen leaves'
    moments exactly zero on both sides."""
    from eda_tpu_torch.train.optim import group_of

    got = port_moments(port_run)
    want = jax_run["moments"]
    assert set(got) == set(want)
    assert not any(group_of(n) == "text" for n in got)
    for name in FROZEN:
        if name in want:
            assert not got.pop(name).any() and not want[name].any(), name
    keys = sorted(got)
    glob = cos(torch.cat([got[k].flatten() for k in keys]),
               torch.cat([want[k].flatten() for k in keys]))
    assert glob >= GLOBAL_COS, glob
    largest = max(float(want[k].norm()) for k in keys)
    for name in keys:
        g, w = got[name], want[name]
        if ZERO_GRAD.search(name):  # zero in exact arithmetic: both must be tiny
            bound = ZERO_NORM_OF.get(name, ZERO_NORM) * largest
            assert max(float(g.norm()), float(w.norm())) < bound, name
    failed = leaf_gate_failures(got, want) - set(excused)
    assert not failed, sorted(failed)


def assert_new_parameters_match(jax_run: dict, port_run: dict):
    """New parameters within 2 lr of JAX's (``PARAM_CLOSE`` of them within 0.1
    lr), BatchNorm statistics within ``BN_REL`` of the leaf's largest value, the
    frozen text encoder unchanged."""
    from eda_tpu_torch.config import TrainConfig
    from eda_tpu_torch.train.optim import group_of

    cfg = TrainConfig()
    lrs = {"main": cfg.lr, "backbone": cfg.lr_backbone, "text": 0.0}
    state = port_run["state"].model.state_dict()
    close = total = 0
    for name, want in jax_run["params"].items():
        got, want = state[name].float(), want.float()
        if name.endswith(("running_mean", "running_var")):
            assert (got - want).abs().max() <= BN_REL * want.abs().max(), name
            continue
        lr = lrs[group_of(name)]
        if lr == 0.0:  # frozen text encoder
            assert torch.equal(got, want), name
            continue
        diff = (got - want).abs()
        assert diff.max() <= 2 * lr * (1 + 1e-3) + 1e-6 * want.abs().max(), name
        close += int((diff <= 0.1 * lr).sum())
        total += diff.numel()
    assert close >= PARAM_CLOSE * total, close / total


class PortAsFlax:
    """A port model behind a flax module's ``apply``: its eval-mode CPU forward,
    reached from inside ``jax.jit`` through ``jax.pure_callback``. It lets the
    JAX package's CLI evaluation (``train.py:evaluate``,
    ``evaluate_detection``) score the port's end points, so that the two
    CLIs' metrics can be compared on the same end points."""

    def __init__(self, model, sample_inputs: dict):
        self.model = model.eval()
        ends = self.forward(sample_inputs)
        self.shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in ends.items()}

    def forward(self, inputs: dict) -> dict:
        with torch.inference_mode():
            out = self.model({k: torch.from_numpy(np.array(v)) for k, v in inputs.items()})
        return {k: v.float().numpy() if v.is_floating_point() else v.numpy().astype(np.int32)
                for k, v in out.items()}

    def apply(self, variables, inputs, train: bool = False):
        assert not train
        return jax.pure_callback(self.forward, self.shapes, inputs)


# --- reference-layout state dicts, as tests/test_convert_eda.py and
# tests/test_converters.py build them ---
def fabricate_hf_state_dict(rng, vocab=64, hidden=16, layers=2, inter=32):
    sd = {}
    sd["embeddings.word_embeddings.weight"] = rng.normal(size=(vocab, hidden))
    sd["embeddings.position_embeddings.weight"] = rng.normal(size=(514, hidden))
    sd["embeddings.LayerNorm.weight"] = np.ones(hidden)
    sd["embeddings.LayerNorm.bias"] = np.zeros(hidden)
    for i in range(layers):
        p = f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            sd[f"{p}.attention.self.{name}.weight"] = rng.normal(size=(hidden, hidden))
            sd[f"{p}.attention.self.{name}.bias"] = rng.normal(size=(hidden,))
        sd[f"{p}.attention.output.dense.weight"] = rng.normal(size=(hidden, hidden))
        sd[f"{p}.attention.output.dense.bias"] = rng.normal(size=(hidden,))
        sd[f"{p}.attention.output.LayerNorm.weight"] = np.ones(hidden)
        sd[f"{p}.attention.output.LayerNorm.bias"] = np.zeros(hidden)
        sd[f"{p}.intermediate.dense.weight"] = rng.normal(size=(inter, hidden))
        sd[f"{p}.intermediate.dense.bias"] = rng.normal(size=(inter,))
        sd[f"{p}.output.dense.weight"] = rng.normal(size=(hidden, inter))
        sd[f"{p}.output.dense.bias"] = rng.normal(size=(hidden,))
        sd[f"{p}.output.LayerNorm.weight"] = np.ones(hidden)
        sd[f"{p}.output.LayerNorm.bias"] = np.zeros(hidden)
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _torch_sd(prefix, module):
    return {
        f"{prefix}.{k}": v.detach().numpy() for k, v in module.state_dict().items()
    }


def _mha_torch(d, heads):
    return torch.nn.MultiheadAttention(d, heads, dropout=0.0)


def _ffn_torch(d, dff):
    return torch.nn.Sequential(
        torch.nn.Linear(d, dff),
        torch.nn.ReLU(),
        torch.nn.Dropout(0.0),
        torch.nn.Linear(dff, d),
        torch.nn.Dropout(0.0),
    )


def _pos_embed_torch(in_ch, d):
    class PE(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.position_embedding_head = torch.nn.Sequential(
                torch.nn.Conv1d(in_ch, d, 1),
                torch.nn.BatchNorm1d(d),
                torch.nn.ReLU(),
                torch.nn.Conv1d(d, d, 1),
            )

    return PE()


def _three_mlp_torch(d, out):
    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = torch.nn.Sequential(
                torch.nn.Conv1d(d, d, 1, bias=False),
                torch.nn.BatchNorm1d(d),
                torch.nn.ReLU(),
                torch.nn.Dropout(0.3),
                torch.nn.Conv1d(d, d, 1, bias=False),
                torch.nn.BatchNorm1d(d),
                torch.nn.ReLU(),
                torch.nn.Dropout(0.3),
                torch.nn.Conv1d(d, out, 1),
            )

    return M()


def fabricate_eda_state_dict(cfg) -> dict:
    """Random torch modules with the reference's exact attribute names."""
    torch.manual_seed(0)
    sd = {}
    d = cfg.d_model

    # backbone: 4 SA (SharedMLP under mlp_module) + 2 FP (under mlp);
    # SA input = 3 (relative xyz) + feature channels (backbone_module.py:44-78)
    for i, mlp in enumerate(cfg.sa_mlps):
        in_ch = 3 + (cfg.input_feature_dim if i == 0 else cfg.sa_mlps[i - 1][-1])
        chans = [in_ch, *mlp]
        for j in range(len(mlp)):
            conv = torch.nn.Conv2d(chans[j], chans[j + 1], 1, bias=False)
            bn = torch.nn.BatchNorm2d(chans[j + 1])
            sd.update(_torch_sd(f"backbone_net.sa{i+1}.mlp_module.layer{j}.conv", conv))
            sd.update(_torch_sd(f"backbone_net.sa{i+1}.mlp_module.layer{j}.bn.bn", bn))
    fp_ins = (
        cfg.sa_mlps[2][-1] + cfg.sa_mlps[3][-1],
        cfg.sa_mlps[1][-1] + cfg.fp_mlps[0][-1],
    )
    for i, mlp in enumerate(cfg.fp_mlps):
        chans = [fp_ins[i], *mlp]
        for j in range(len(mlp)):
            conv = torch.nn.Conv2d(chans[j], chans[j + 1], 1, bias=False)
            bn = torch.nn.BatchNorm2d(chans[j + 1])
            sd.update(_torch_sd(f"backbone_net.fp{i+1}.mlp.layer{j}.conv", conv))
            sd.update(_torch_sd(f"backbone_net.fp{i+1}.mlp.layer{j}.bn.bn", bn))

    # text encoder (HF roberta names)
    hf = fabricate_hf_state_dict(
        np.random.default_rng(0),
        vocab=cfg.text_vocab_size,
        hidden=cfg.text_hidden,
        layers=cfg.text_layers,
        inter=cfg.text_intermediate,
    )
    sd.update({f"text_encoder.{k}": v for k, v in hf.items()})

    sd.update(_torch_sd("text_projector.0", torch.nn.Linear(cfg.text_hidden, d)))
    sd.update(_torch_sd("text_projector.1", torch.nn.LayerNorm(d)))

    sd.update(
        _torch_sd(
            "butd_class_embeddings",
            torch.nn.Embedding(cfg.num_obj_class, cfg.butd_class_embed_dim),
        )
    )
    sd.update(
        _torch_sd(
            "class_embeddings",
            torch.nn.Linear(cfg.butd_class_embed_dim, d - cfg.butd_box_dim),
        )
    )
    sd.update(_torch_sd("box_embeddings", _pos_embed_torch(6, cfg.butd_box_dim)))
    sd.update(_torch_sd("pos_embed", _pos_embed_torch(3, d)))

    for i in range(cfg.num_encoder_layers):
        key = f"cross_encoder.layers.{i}"
        sd.update(
            _torch_sd(f"{key}.self_attention_visual.self_attn", _mha_torch(d, cfg.n_heads))
        )
        sd.update(
            _torch_sd(f"{key}.self_attention_visual.norm1", torch.nn.LayerNorm(d))
        )
        sd.update(
            _torch_sd(f"{key}.self_attention_lang.self_attn", _mha_torch(d, cfg.n_heads))
        )
        sd.update(_torch_sd(f"{key}.self_attention_lang.norm1", torch.nn.LayerNorm(d)))
        for name in ("cross_lv", "cross_vl", "cross_d"):
            sd.update(
                _torch_sd(f"{key}.cross_layer.{name}", _mha_torch(d, cfg.n_heads))
            )
        for name in ("norm_lv", "norm_lv2", "norm_vl", "norm_vl2", "norm_d"):
            sd.update(_torch_sd(f"{key}.cross_layer.{name}", torch.nn.LayerNorm(d)))
        for name in ("ffn_lv", "ffn_vl"):
            sd.update(
                _torch_sd(
                    f"{key}.cross_layer.{name}", _ffn_torch(d, cfg.dim_feedforward)
                )
            )

    # points_obj_cls (modules.py:19-49)
    sd.update(_torch_sd("points_obj_cls.conv1", torch.nn.Conv1d(d, d, 1)))
    sd.update(_torch_sd("points_obj_cls.bn1", torch.nn.BatchNorm1d(d)))
    sd.update(_torch_sd("points_obj_cls.conv2", torch.nn.Conv1d(d, d, 1)))
    sd.update(_torch_sd("points_obj_cls.bn2", torch.nn.BatchNorm1d(d)))
    sd.update(_torch_sd("points_obj_cls.conv3", torch.nn.Conv1d(d, 1, 1)))

    sd.update(_torch_sd("decoder_query_proj", torch.nn.Conv1d(d, d, 1)))

    def head(prefix):
        sd.update(
            _torch_sd(f"{prefix}.center_residual_head", _three_mlp_torch(d, 3))
        )
        sd.update(_torch_sd(f"{prefix}.size_pred_head", _three_mlp_torch(d, 3)))
        sd.update(
            _torch_sd(
                f"{prefix}.sem_cls_scores_head", _three_mlp_torch(d, cfg.num_class)
            )
        )

    head("proposal_head")
    for i in range(cfg.num_decoder_layers):
        key = f"decoder.{i}"
        for name in ("self_attn", "cross_l", "cross_d", "cross_v"):
            sd.update(_torch_sd(f"{key}.{name}", _mha_torch(d, cfg.n_heads)))
        for name in ("norm1", "norm_l", "norm_d", "norm_v", "norm2"):
            sd.update(_torch_sd(f"{key}.{name}", torch.nn.LayerNorm(d)))
        sd.update(_torch_sd(f"{key}.ffn", _ffn_torch(d, cfg.dim_feedforward)))
        sd.update(_torch_sd(f"{key}.self_posembed", _pos_embed_torch(6, d)))
        head(f"prediction_heads.{i}")

    for name in (
        "contrastive_align_projection_image",
        "contrastive_align_projection_text",
    ):
        sd.update(_torch_sd(f"{name}.0", torch.nn.Linear(d, d)))
        sd.update(_torch_sd(f"{name}.2", torch.nn.Linear(d, d)))
        sd.update(_torch_sd(f"{name}.4", torch.nn.Linear(d, cfg.contrastive_dim)))

    return {
        k: np.asarray(v)
        for k, v in sd.items()
        if "num_batches_tracked" not in k
    }


# --- parallel steps of the port (tests/test_torch_parallel_*.py) ---
def parallel_rank_step(mesh, spec: dict) -> dict:
    """One rank of a data x model parallel port step (``parallel.launch.spawn``),
    or with ``mesh`` None the one-process step on the whole batch.

    ``spec``: ``overrides`` of the tiny bf16 config, ``variables`` (flax, numpy)
    or ``seed`` for the weights, ``batch`` (numpy, the global batch), ``crit``
    (``SetCriterionConfig`` fields), ``dropout`` (False: every Dropout off),
    ``steps`` and ``repeat`` (two copies of the state take each step; their
    results must agree bit for bit). Returns the metrics of each step, the
    new state and the first moments as full tensors (numpy), the local shapes
    of the parameters and whether the repeats agreed.
    """
    import copy

    from eda_tpu_torch.config import ModelConfig, TrainConfig
    from eda_tpu_torch.losses.criterion import SetCriterionConfig
    from eda_tpu_torch.models.grounder import EDAGrounder
    from eda_tpu_torch.models.layers import Dropout
    from eda_tpu_torch.parallel.mesh import (
        gather_shards, make_global_batch, process_batch_rows, shard_params, sharded_names)
    from eda_tpu_torch.train.optim import AdamW
    from eda_tpu_torch.train.step import TrainState, make_train_step
    from eda_tpu_torch.weights import load_flax

    cfg = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), **spec.get("overrides", {}))
    model = EDAGrounder(cfg)
    if "variables" in spec:
        load_flax(model, spec["variables"])
    else:
        model.init_weights(spec.get("seed", 0))
    if not spec.get("dropout", True):
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    device = "cpu" if mesh is None else mesh.device
    model = model.to(device)
    if mesh is not None:
        shard_params(model, mesh)
    state = TrainState(model, AdamW(model, TrainConfig(), STEPS_PER_EPOCH, mesh=mesh))
    batch = spec["batch"]
    n = len(batch["inputs"]["point_clouds"])
    rows = process_batch_rows(mesh, n)
    local = {g: {k: np.asarray(v)[rows] for k, v in arrays.items()} for g, arrays in batch.items()}
    if mesh is None:
        local = {g: {k: torch.from_numpy(v) for k, v in a.items()} for g, a in local.items()}
    else:
        local = make_global_batch(local, mesh, n)
    crit = SetCriterionConfig(num_decoder_layers=cfg.num_decoder_layers, **spec.get("crit", {}))
    step = make_train_step(crit, seed=spec.get("seed", 0), mesh=mesh)
    twin = copy.deepcopy(state) if spec.get("repeat") else None
    metrics, repeats_agree = [], True
    for _ in range(spec.get("steps", 1)):
        m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
        if twin is not None:
            m2 = step(twin, local)
            s1, s2 = state.model.state_dict(), twin.model.state_dict()
            repeats_agree &= all(torch.equal(m[k], m2[k]) for k in m)
            repeats_agree &= all(torch.equal(s1[k], s2[k]) for k in s1)
            o1, o2 = state.optimizer.state_dict(), twin.optimizer.state_dict()
            repeats_agree &= all(torch.equal(a, b) for key in ("mu", "nu")
                                 for a, b in zip(o1[key], o2[key]))
    split = sharded_names(model, mesh)
    full = {k: (gather_shards(v, split[k], mesh) if k in split else v).detach().cpu().numpy()
            for k, v in model.state_dict().items()}
    names = {p: n for n, p in model.named_parameters()}
    moments = {names[p]: (gather_shards(mu, split[names[p]], mesh) if names[p] in split else mu)
               .cpu().numpy() for p, (mu, _) in state.optimizer.moments.items()}
    return dict(metrics=metrics, state=full, moments=moments, repeats_agree=repeats_agree,
                shapes={n: tuple(p.shape) for n, p in model.named_parameters()})


def port_run_of(result: dict, overrides: dict) -> dict:
    """A ``port_train_step``-shaped run (``state``, ``metrics``) from the full
    tensors of ``parallel_rank_step``, for the JAX comparison helpers."""
    from eda_tpu_torch.config import ModelConfig, TrainConfig
    from eda_tpu_torch.models.grounder import EDAGrounder
    from eda_tpu_torch.train.optim import AdamW
    from eda_tpu_torch.train.step import TrainState

    model = EDAGrounder(dataclasses.replace(ModelConfig(use_bf16=True).tiny(), **overrides))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in result["state"].items()})
    opt = AdamW(model, TrainConfig(), STEPS_PER_EPOCH)
    names = {p: n for n, p in model.named_parameters()}
    for p, (mu, _) in opt.moments.items():
        mu.copy_(torch.from_numpy(result["moments"][names[p]]))
    return dict(state=TrainState(model, opt), metrics=result["metrics"][0])


def parallel_checkpoint_rank(mesh, spec: dict) -> dict:
    """One rank of a checkpoint round trip (``parallel.launch.spawn``): the
    tiny f32 model from ``seed`` on the rank's mesh; with ``save``, one step
    on ``batch`` and a save to ``directory``; else a restore from it. Returns
    the full state, the full moments and the update count after the save or
    the restore, the parameters' local shapes, and with ``step_after`` the
    loss of one more step."""
    from eda_tpu_torch.config import ModelConfig, TrainConfig
    from eda_tpu_torch.losses.criterion import SetCriterionConfig
    from eda_tpu_torch.models.grounder import EDAGrounder
    from eda_tpu_torch.parallel.mesh import (
        gather_shards, make_global_batch, process_batch_rows, shard_params, sharded_names)
    from eda_tpu_torch.train.checkpoint import CheckpointManager
    from eda_tpu_torch.train.optim import AdamW
    from eda_tpu_torch.train.step import TrainState, make_train_step

    cfg = ModelConfig().tiny()
    model = EDAGrounder(cfg)
    model.init_weights(spec["seed"])
    shard_params(model, mesh)
    state = TrainState(model, AdamW(model, TrainConfig(), STEPS_PER_EPOCH, mesh=mesh))
    batch = spec["batch"]
    n = len(batch["inputs"]["point_clouds"])
    rows = process_batch_rows(mesh, n)
    local = make_global_batch({g: {k: np.asarray(v)[rows] for k, v in a.items()}
                               for g, a in batch.items()}, mesh, n)
    step = make_train_step(SetCriterionConfig(num_decoder_layers=cfg.num_decoder_layers),
                           mesh=mesh)
    manager = CheckpointManager(spec["directory"], mesh=mesh)
    if spec["save"]:
        step(state, local)
        manager.save(0, state, force=True)
    else:
        manager.restore(state)
    split = sharded_names(model, mesh)
    names = {p: n for n, p in model.named_parameters()}
    out = dict(
        state={k: (gather_shards(v, split[k], mesh) if k in split else v).numpy().copy()
               for k, v in model.state_dict().items()},
        moments={names[p]: [(gather_shards(t, split[names[p]], mesh) if names[p] in split
                             else t).numpy().copy() for t in mt]
                 for p, mt in state.optimizer.moments.items()},
        count=state.optimizer.count, step=state.step,
        shapes={n: tuple(p.shape) for n, p in model.named_parameters()})
    if spec.get("step_after"):
        out["loss"] = float(step(state, local)["loss"])
    return out


# the port's parallel step against its one-process step on the same global
# batch (tests/test_torch_parallel_{dp,tp}.py): the same arithmetic but for
# the order of the sums (BatchNorm's global sums, the loss shares, the
# gradient all-reduce), which f32 and the pools' bf16 rounding of A amplify
# through one backward; measured on the tiny f32 model, batch 4, dropout on:
# metrics 5e-6, grad_norm 4.4e-4 (noise in the zero-gradient leaves), global
# moment cosine 0.999998, the worst per-leaf cosine 0.99989, BatchNorm
# statistics 1.7e-6
PARALLEL_METRIC_REL = 1e-4
PARALLEL_GRAD_NORM_REL = 5e-3
PARALLEL_GLOBAL_COS = 0.9999
PARALLEL_LEAF_COS = 0.999
PARALLEL_BN_ATOL = 1e-4
PARALLEL_PARAM_CLOSE = 0.99  # share of new parameters within 0.01 lr of the one-process step's


def assert_parallel_step_matches(one: dict, ranks: list):
    """Every rank of a parallel step against the one-process step (both
    ``parallel_rank_step`` results): equal on every rank, metrics, gradients
    (AdamW's first moments), BatchNorm statistics and new parameters close."""
    from eda_tpu_torch.config import TrainConfig
    from eda_tpu_torch.train.optim import group_of

    first = ranks[0]
    for res in ranks[1:]:  # one global step: identical on every rank
        assert res["metrics"] == first["metrics"]
        for key in first["state"]:
            assert np.array_equal(res["state"][key], first["state"][key]), key
        for key in first["moments"]:
            assert np.array_equal(res["moments"][key], first["moments"][key]), key
    want, got = one["metrics"][0], first["metrics"][0]
    assert set(got) == set(want)
    for key, w in want.items():
        rel = PARALLEL_GRAD_NORM_REL if key == "grad_norm" else PARALLEL_METRIC_REL
        assert abs(got[key] - w) <= rel * abs(w) + 1e-6, (key, got[key], w)
    keys = sorted(one["moments"])
    flat = [np.concatenate([r["moments"][k].ravel() for k in keys]) for r in (one, first)]
    glob = float(flat[0] @ flat[1] / np.linalg.norm(flat[0]) / np.linalg.norm(flat[1]))
    assert glob >= PARALLEL_GLOBAL_COS, glob
    worst = 1.0
    for key in keys:
        w, g = one["moments"][key].ravel(), first["moments"][key].ravel()
        if ZERO_GRAD.search(key) or not w.any():
            continue
        c = float(w @ g / np.linalg.norm(w) / np.linalg.norm(g))
        worst = min(worst, c)
        assert c >= PARALLEL_LEAF_COS, (key, c)
    cfg = TrainConfig()
    lrs = {"main": cfg.lr, "backbone": cfg.lr_backbone, "text": 0.0}
    close = total = 0
    for key, w in one["state"].items():
        g = first["state"][key]
        if key.endswith(("running_mean", "running_var")):
            assert np.abs(g - w).max() <= PARALLEL_BN_ATOL, key
            continue
        diff = np.abs(g - w)
        lr = lrs[group_of(key)]
        assert diff.max() <= 2 * lr * (1 + 1e-3) + 1e-6 * np.abs(w).max(), key
        close += int((diff <= 0.01 * lr).sum())
        total += diff.size
    print(f"global moment cos {glob:.7f}, worst leaf cos {worst:.6f}, "
          f"params within 0.01 lr {close / total:.5f}")
    assert close >= PARALLEL_PARAM_CLOSE * total, close / total


def parallel_restore_rank(mesh, directories: list) -> int:
    """One rank's restore of the tiny f32 model from ``directories[rank]``
    (``parallel.launch.spawn``); returns the restored step."""
    from eda_tpu_torch.config import ModelConfig, TrainConfig
    from eda_tpu_torch.models.grounder import EDAGrounder
    from eda_tpu_torch.parallel.mesh import shard_params
    from eda_tpu_torch.train.checkpoint import CheckpointManager
    from eda_tpu_torch.train.optim import AdamW
    from eda_tpu_torch.train.step import TrainState

    model = EDAGrounder(ModelConfig().tiny())
    model.init_weights(0)
    shard_params(model, mesh)
    state = TrainState(model, AdamW(model, TrainConfig(), STEPS_PER_EPOCH, mesh=mesh))
    CheckpointManager(directories[mesh.rank], mesh=mesh).restore(state)
    return state.step
