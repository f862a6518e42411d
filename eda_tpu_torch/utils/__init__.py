"""Logging, metrics and FLOP accounting of the port."""
