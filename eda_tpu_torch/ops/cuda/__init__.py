"""CUDA kernels: build, ctypes wrappers and their plain PyTorch versions."""
