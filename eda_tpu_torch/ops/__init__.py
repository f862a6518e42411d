"""Point-cloud operators and the fused set abstraction."""
