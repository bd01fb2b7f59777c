"""Fields and encodings (PyTorch)."""
