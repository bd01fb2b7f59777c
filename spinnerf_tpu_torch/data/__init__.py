"""Scenes and ray banks (PyTorch)."""
