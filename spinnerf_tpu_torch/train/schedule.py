"""Learning-rate schedule and optimizer (port of
`spinnerf_tpu/train/schedule.py`).

Adam with betas (0.9, 0.999) and the reference's continuous decay
lr(step) = lrate * 0.1^(step / (lrate_decay * 1000)). As optax does, the
k-th update (k = 0, 1, ...) uses lr(k): the schedule is read at the update
count before the update, so the first update uses lr(0).
"""
from __future__ import annotations

import torch


def exponential_lr(lrate: float, lrate_decay: float):
    """count -> lr; lrate_decay <= 0 means no decay."""
    if lrate_decay <= 0:
        return lambda count: lrate
    steps = max(int(lrate_decay * 1000), 1)
    return lambda count: lrate * 0.1 ** (count / steps)


class Optimizer:
    """Adam with the exponential schedule, an optional global-norm gradient
    clip (optax `clip_by_global_norm` semantics) and optional L2 decay of
    the hash tables (`table_wd`, added to their gradients after the clip and
    before Adam: L2 through Adam, not AdamW, as optax chains them).

    `step()` applies one update from the parameters' `.grad`; `count` is the
    number of updates applied so far."""

    def __init__(self, named_params, lrate: float, lrate_decay: float,
                 grad_clip: float | None = None, table_wd: float = 0.0):
        named_params = list(named_params)
        self.params = [p for _, p in named_params]
        self.schedule = exponential_lr(lrate, lrate_decay)
        self.grad_clip = grad_clip
        table = [p for n, p in named_params if "table" in n.lower()]
        rest = [p for n, p in named_params if "table" not in n.lower()]
        groups = [{"params": rest, "weight_decay": 0.0}]
        if table:
            groups.append({"params": table, "weight_decay": table_wd})
        # Adam skips a parameter whose .grad is None (`zero_grad` leaves
        # None where no loss reached it, e.g. the coarse field under
        # --no_coarse); optax decays a table whatever its gradient, so a
        # decayed table without one gets a zero gradient before the update
        self.decayed = table if table_wd > 0 else []
        self.adam = torch.optim.Adam(groups, lr=lrate, betas=(0.9, 0.999),
                                     eps=1e-8)
        self.count = 0

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def _clip(self):
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        for g in grads:
            g.mul_(scale)

    def step(self):
        for p in self.decayed:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip is not None:
            self._clip()
        lr = self.schedule(self.count)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        self.count += 1

    def state_dict(self):
        return {"count": self.count, "adam": self.adam.state_dict()}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self.adam.load_state_dict(state["adam"])


def make_optimizer(named_params, lrate: float, lrate_decay: float,
                   grad_clip: float | None = None,
                   table_wd: float = 0.0) -> Optimizer:
    """Adam with the reference's exponential decay over `named_params`
    ((name, parameter) pairs, as `Module.named_parameters()` gives)."""
    return Optimizer(named_params, lrate, lrate_decay, grad_clip, table_wd)
