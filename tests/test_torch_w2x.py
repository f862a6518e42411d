"""The width-2 backbone ("W2X") of the port against ``eda_tpu`` on the CPU.

W2X is the flagship with Group-Free-3D's ``Pointnet2Backbone(width=2)`` widths
(``chip_smoke.W2X_SA_MLPS``, ``W2X_FP_MLPS``): its SA layers see in_dim 6,
259, 515 and 515, its SA2-4 run on the pool kernels' widest instantiation,
(256, 256, 512), and its SA3-4 prep streams W1. On the CPU every kernel
wrapper runs its plain version, which the card holds each kernel to
(``chip_smoke.py``'s "w2x" phase); these tests hold the plain versions and the
model to ``eda_tpu``:

* the fused SA layer, forward and backward, at each W2X layer's widths and
  in_dim on the tiny config's point counts, against ``eda_tpu``'s interpreted
  Pallas training path, under the tolerances of
  ``tests/test_torch_fused_sa_train.py`` (0.03 abs on the features, 2% of each
  gradient leaf's largest value);
* the ``--pp_checkpoint`` warm start from a Group-Free-layout backbone at
  W2X's widths (fabricated, as ``tests/test_torch_convert_eda.py`` does at the
  tiny widths) gives ``eda_tpu``'s parameters bit for bit, and its log lines.

The tiny f32 W2X grounder and training step against ``eda_tpu`` are cases of
``tests/test_torch_f32_model.py`` and ``tests/test_torch_f32_train_step.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    fabricate_eda_state_dict,
    fused_sa_layer_vs_jax,
    jax_tpu_training_path,
    one_torch_thread,
    to_numpy,
)

import chip_smoke
from eda_tpu.config import ModelConfig as JaxConfig
from eda_tpu.data.synthetic import SyntheticConfig as JaxSyntheticConfig
from eda_tpu.data.synthetic import SyntheticScenes as JaxSyntheticScenes
from eda_tpu.models import EDAGrounder as JaxGrounder
from eda_tpu.train import convert as jax_convert
from eda_tpu_torch.config import ModelConfig
from eda_tpu_torch.models.grounder import EDAGrounder
from eda_tpu_torch.ops.cuda import sa_kernel
from eda_tpu_torch.train import convert
from eda_tpu_torch.weights import from_flax, load_flax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the tiny config's SA layers (ModelConfig.tiny(): 1024 points, npoints 256 /
# 128 / 64 / 32, windows 256 / 128 / 64 / 64, radii 0.2 / 0.4 / 0.8 / 1.2, 3
# input features) at W2X's widths; each layer's input features are the
# previous layer's c3, so in_dim is 6, 259, 515, 515
W2X_LAYERS = [(1024, 256, 256, 0.2, 3, chip_smoke.W2X_SA_MLPS[0]),
              (256, 128, 128, 0.4, 256, chip_smoke.W2X_SA_MLPS[1]),
              (128, 64, 64, 0.8, 512, chip_smoke.W2X_SA_MLPS[2]),
              (64, 32, 64, 1.2, 512, chip_smoke.W2X_SA_MLPS[3])]


@pytest.mark.parametrize("N,M,window,radius,C,widths", W2X_LAYERS,
                         ids=["SA1", "SA2", "SA3", "SA4"])
def test_w2x_fused_sa_layer_matches_jax_pallas_train(
        jax_tpu_training_path, N, M, window, radius, C, widths):  # noqa: F811
    assert sa_kernel.kernel_widths(*widths) == widths  # an instantiated triple
    fused_sa_layer_vs_jax(N, M, window, radius, C, widths)


def test_w2x_configs_are_the_flagship_at_width_2():
    cfg, tiny = chip_smoke.w2x_configs(ModelConfig(use_bf16=True))
    base = ModelConfig(use_bf16=True)
    assert cfg.sa_mlps == tuple(tuple(2 * c for c in m) for m in base.sa_mlps)
    assert cfg.fp_mlps == ((512, 512), (512, 288)) and cfg.fp_mlps[-1][-1] == base.d_model
    assert dataclasses.replace(cfg, sa_mlps=base.sa_mlps, fp_mlps=base.fp_mlps) == base
    assert tiny.sa_mlps == cfg.sa_mlps and tiny.fp_mlps[-1][-1] == tiny.d_model == 96
    assert dataclasses.replace(tiny, sa_mlps=base.tiny().sa_mlps,
                               fp_mlps=base.tiny().fp_mlps) == base.tiny()
    in_dims = [3 + (cfg.input_feature_dim if i == 0 else cfg.sa_mlps[i - 1][-1])
               for i in range(4)]
    assert in_dims == [6, 259, 515, 515]
    assert [sa_kernel.kernel_widths(*m) for m in cfg.sa_mlps] == list(cfg.sa_mlps)


def test_w2x_warm_start_pp_checkpoint_equals_jax(tmp_path):
    over = dict(sa_mlps=chip_smoke.W2X_SA_MLPS, fp_mlps=chip_smoke.W2X_TINY_FP_MLPS, butd=True)
    jcfg = dataclasses.replace(JaxConfig(use_bf16=True).tiny(), **over)
    cfg = dataclasses.replace(ModelConfig(use_bf16=True).tiny(), **over)
    sd = fabricate_eda_state_dict(jcfg)
    backbone = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()
                if k.startswith("backbone_net.")}
    assert backbone["backbone_net.sa3.mlp_module.layer0.conv.weight"].shape == (256, 515, 1, 1)
    assert backbone["backbone_net.fp1.mlp.layer0.conv.weight"].shape == (512, 1024, 1, 1)
    torch.save({"model": backbone, "epoch": 3}, tmp_path / "gf_detector.pth")
    table = np.random.default_rng(1).normal(size=(485, 768)).astype(np.float32)
    np.save(tmp_path / "class_embeddings3d.npy", table)

    gen = JaxSyntheticScenes(JaxSyntheticConfig(num_points=1024, num_objects=4, text_len=16),
                             vocab_size=jcfg.text_vocab_size)
    inputs = {k: jnp.asarray(v) for k, v in gen.batch(range(2), butd=True)["inputs"].items()}
    model = JaxGrounder(jcfg)
    init = to_numpy(jax.jit(lambda x: model.init(jax.random.key(0), x, train=False))(inputs))
    logs, jax_logs = [], []
    params, stats = jax_convert.warm_start(
        init["params"], init["batch_stats"], jcfg, data_root=str(tmp_path),
        pp_checkpoint=str(tmp_path / "gf_detector.pth"), log=jax_logs.append)
    port = EDAGrounder(cfg)
    load_flax(port, init)
    convert.warm_start(port, cfg, data_root=str(tmp_path),
                       pp_checkpoint=str(tmp_path / "gf_detector.pth"), log=logs.append)
    want = from_flax({"params": params, "batch_stats": stats})
    state = port.state_dict()
    assert all(torch.equal(state[k], want[k]) for k in want)
    assert logs == [jax_logs[0], f"text_encoder: no RoBERTa weights under "
                    f"{tmp_path / 'roberta-base'}, skipping", jax_logs[1]]
    assert "warm-started 32 backbone leaves" in logs[0]
    # the checkpoint's SA kernels reached the port at W2X's widths
    w = backbone["backbone_net.sa3.mlp_module.layer1.conv.weight"][:, :, 0, 0]
    assert torch.equal(state["backbone_net.sa3.kernels.1"], w.T.contiguous())
