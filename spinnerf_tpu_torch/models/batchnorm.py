"""BatchNorm with flax's `nn.BatchNorm` semantics, for the LaMa generator,
its discriminators and the ADE20k segmentation net.

`nn.BatchNorm2d` differs from flax's training mode in two defaults:
- flax keeps `momentum=0.99` (the running value's share; torch's
  `momentum` is the batch's share, so 0.01 here);
- flax updates the running variance with the *biased* batch variance
  (torch uses the unbiased one), and computes it as E[x^2] - E[x]^2,
  clipped at 0 (`use_fast_variance`).

In `train()` mode `BatchNorm2d` normalises with the batch statistics (the
gradient flows through them) and updates the running ones as flax does;
in `eval()` mode it is `nn.BatchNorm2d`'s inference forward, bit for bit.

flax returns the updated statistics as values that still depend on the
parameters: a later pass of the same network in inference mode on them is
differentiated through them (the LaMa trainer's discriminator phase). With
`track_graph` on, a train-mode pass keeps the updated statistics with
their graph and the next eval-mode pass normalises with those, until
`track_graph` is turned off (`graph_stats`).

Under data parallelism (`sync_batchnorm`), a train-mode pass takes the
statistics of the whole batch: each rank's E[x] and E[x^2] (equal shards)
averaged across ranks by a differentiable all-reduce, so the gradient
through the statistics is the whole batch's, and the running statistics
stay equal on every rank.

`flax_init_` gives a module's convolutions and BatchNorms flax's default
initialisers, from a CPU `torch.Generator`.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from spinnerf_tpu_torch.models.hashgrid import _lecun_normal_
from spinnerf_tpu_torch.parallel.mesh import all_reduce_sum

MOMENTUM = 0.99          # flax's: the running value's share
EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """NCHW BatchNorm with flax's training semantics (module docstring);
    the parameter and buffer names are `nn.BatchNorm2d`'s."""

    def __init__(self, num_features: int, eps: float = EPS, device=None,
                 dtype=None):
        super().__init__(num_features, eps=eps, momentum=1.0 - MOMENTUM,
                         device=device, dtype=dtype)
        self.track_graph = False
        self.graph_stats = None
        self.mesh = None            # `sync_batchnorm`'s

    def forward(self, x):
        if not self.training:
            if self.track_graph and self.graph_stats is not None:
                mean, var = self.graph_stats
                return _normalize(x, mean, var, self.weight, self.bias,
                                  self.eps)
            return super().forward(x)
        mean, sq = x.mean((0, 2, 3)), (x * x).mean((0, 2, 3))
        if self.mesh is not None:
            mean, sq = (all_reduce_sum(torch.stack([mean, sq]))
                        / self.mesh.size).unbind()
        var = torch.clamp(sq - mean * mean, min=0.0)
        new_mean = MOMENTUM * self.running_mean + (1.0 - MOMENTUM) * mean
        new_var = MOMENTUM * self.running_var + (1.0 - MOMENTUM) * var
        # new buffers, not in-place updates: an earlier eval-mode pass
        # whose graph is still alive (the R1 penalty) saved the old ones
        self.running_mean = new_mean.detach()
        self.running_var = new_var.detach()
        if self.track_graph:
            self.graph_stats = (new_mean, new_var)
        return _normalize(x, mean, var, self.weight, self.bias, self.eps)


def _normalize(x, mean, var, weight, bias, eps):
    """flax's `_normalize`: (x - mean) * (rsqrt(var + eps) * scale) + bias."""
    mul = torch.rsqrt(var + eps) * weight
    return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
        + bias[None, :, None, None]


def flax_init_(module: nn.Module, generator=None):
    """flax's default initialisers on every convolution and BatchNorm of
    `module`, drawn from a CPU `generator`: lecun-normal kernels (fan_in
    the inputs of one output; a transpose conv's kernel read as [out, in,
    ...]), zero biases, BN scale 1, bias 0, mean 0, variance 1. Another
    random stream than `jax.random`, so not the JAX package's draws.
    Returns `module`."""
    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            _lecun_normal_(m.weight.transpose(0, 1), generator)
        elif isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, generator)
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and \
                m.bias is not None:
            nn.init.zeros_(m.bias)
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module


def sync_batchnorm(module: nn.Module, mesh):
    """Every `BatchNorm2d` of `module` takes its train-mode statistics over
    the ranks of `mesh` (a `parallel.Mesh`; None: this rank's batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.mesh = mesh


@contextlib.contextmanager
def graph_stats(module: nn.Module):
    """Within the block, each `BatchNorm2d` of `module` keeps the running
    statistics of its last train-mode pass with their graph, and eval-mode
    passes normalise with them; they are dropped on exit."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.track_graph = True
    try:
        yield
    finally:
        for m in bns:
            m.track_graph = False
            m.graph_stats = None
