"""spinnerf-tpu ported to PyTorch and CUDA for one NVIDIA H100.

Mirrors `spinnerf_tpu/`'s module layout; imports `torch` and numpy, never
`jax` or the JAX package. Entry points run on `cuda` unless the caller
passes `device="cpu"`; the hash-grid encodes and the fused MLP run
hand-written CUDA kernels (`csrc/*.cu`) on CUDA tensors and their plain
PyTorch versions on CPU tensors.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else `cuda`.

    Raises when no card is present and the caller did not ask for the CPU —
    the port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")
