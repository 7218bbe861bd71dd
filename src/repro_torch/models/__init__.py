"""Model assembly (PyTorch)."""
