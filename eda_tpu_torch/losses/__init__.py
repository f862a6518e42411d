"""Matching and losses of the grounding model (PyTorch port)."""
