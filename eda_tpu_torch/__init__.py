"""PyTorch/CUDA port of eda_tpu: 3D visual grounding on an NVIDIA H100.

The JAX package ``eda_tpu`` is the reference this port is tested against;
the port imports nothing from it. Every Pallas TPU kernel on the ported path
has a hand-written CUDA counterpart under ``csrc/`` with a plain PyTorch
version beside its wrapper in ``ops/cuda/``.
"""
