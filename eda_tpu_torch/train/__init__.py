"""The training step of the grounding model (PyTorch port)."""
