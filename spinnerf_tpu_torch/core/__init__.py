"""Rays, sampling, compositing and losses (PyTorch)."""
