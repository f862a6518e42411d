"""Synthetic serving inputs and host-side preprocessing."""
