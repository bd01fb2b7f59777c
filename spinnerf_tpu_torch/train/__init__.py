"""Train step, optimizer, checkpoints and the training loop (PyTorch)."""
