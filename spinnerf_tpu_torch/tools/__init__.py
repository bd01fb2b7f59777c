"""Measurement harnesses of the port (PyTorch)."""
