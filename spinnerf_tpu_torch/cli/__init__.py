"""The command-line entry point: `python -m spinnerf_tpu_torch.cli`."""
