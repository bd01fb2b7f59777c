"""Image metrics and frame/path rendering (PyTorch)."""
