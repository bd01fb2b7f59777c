"""Training-loop utilities (PyTorch port)."""
