"""Pipeline stages (PyTorch port of `spinnerf_tpu/pipeline/`)."""
