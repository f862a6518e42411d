"""The width-4 backbone ("W4X") of the port against ``eda_tpu`` on the CPU: its SA layers.

W4X is the flagship with Group-Free-3D's ``Pointnet2Backbone(width=4)`` widths
(``chip_smoke.W4X_SA_MLPS``, ``W4X_FP_MLPS``): its SA layers see in_dim 6,
515, 1027 and 1027, its SA1 runs the pool's (256, 256, 512) kernels, its SA2-4
the forward-only (512, 512, 1024) pool (``sa_kernel.XL``) and the c1-512 prep
(``csrc/sa_prep_512.cu``). On the CPU every kernel wrapper runs its plain
version, which the card holds each kernel to (``chip_smoke.py``'s "w4x" and
"w4x f32" phases). Here the fused SA layer, forward and backward, at each W4X
layer's widths and in_dim on the tiny config's point counts, against
``eda_tpu``'s interpreted Pallas training path, under the tolerances of
``tests/test_torch_fused_sa_train.py`` (0.03 abs on the features, 2% of each
gradient leaf's largest value). The backward runs the plain versions, which
the training kernels at these widths (ROADMAP item 8.2b) will be held to.

It runs at the two kinks of the layer as the two sides see them
(``torch_parity.fused_sa_layer_vs_jax_on_its_winners``): with 1024 channels
over a window of 64 points all in radius (SA4) every center has channels whose
best two pairs lie within the two sides' bf16 rounding differences (0.005
apart at 1 080 of SA4's 65 536 (center, channel) entries), and outputs within
that of the last ReLU's kink. A swapped winner or ReLU decision moves a
gradient leaf by up to 6% of its largest value (the reference's own
cross-implementation test allows 15% for such swaps,
``tests/test_sa_kernel_interpret.py:439-461``). So the port's backward takes
the JAX side's winners, their disagreements counted and held below
``torch_parity.MAX_SWAPPED`` of the entries, and the cotangent is zero where
the JAX output lies within 0.03 of the ReLU's kink.

The odd widths between (256, 256, 512) and XL, the configs, the prep, the tiny
grounder and the training kernels' ceilings are in ``test_torch_w4x_model.py``.
"""

import pytest
from torch_parity import (  # noqa: F401
    fused_sa_layer_vs_jax_on_its_winners,
    jax_tpu_training_path,
    one_torch_thread,
)

import chip_smoke
from eda_tpu_torch.ops.cuda import sa_kernel

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the tiny config's SA layers (ModelConfig.tiny(): 1024 points, npoints 256 /
# 128 / 64 / 32, windows 256 / 128 / 64 / 64, radii 0.2 / 0.4 / 0.8 / 1.2, 3
# input features) at W4X's widths; each layer's input features are the
# previous layer's c3, so in_dim is 6, 515, 1027, 1027
W4X_LAYERS = [(1024, 256, 256, 0.2, 3, chip_smoke.W4X_SA_MLPS[0]),
              (256, 128, 128, 0.4, 512, chip_smoke.W4X_SA_MLPS[1]),
              (128, 64, 64, 0.8, 1024, chip_smoke.W4X_SA_MLPS[2]),
              (64, 32, 64, 1.2, 1024, chip_smoke.W4X_SA_MLPS[3])]

@pytest.mark.parametrize("N,M,window,radius,C,widths", W4X_LAYERS,
                         ids=["SA1", "SA2", "SA3", "SA4"])
def test_w4x_fused_sa_layer_matches_jax_pallas_train(
        jax_tpu_training_path, N, M, window, radius, C, widths):  # noqa: F811
    assert sa_kernel.kernel_widths(*widths) == widths  # an instantiated triple
    fused_sa_layer_vs_jax_on_its_winners(N, M, window, radius, C, widths)
