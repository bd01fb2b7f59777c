"""Checkpoints: `torch.save` of {step, params, opt_state} every
`save_interval` steps under <exp_dir>/checkpoints, the newest restored on
resume, `--ft_path` loading and the frozen field of `--alpha_model_path`
(port of `spinnerf_tpu/train/checkpoints.py`, which uses orbax; the port
reads its own files, not orbax's).
"""
from __future__ import annotations

import os
import re
from pathlib import Path

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")
_MAX_TO_KEEP = 3


class CheckpointManager:
    def __init__(self, exp_dir, *, save_interval: int = 10000):
        self.dir = Path(exp_dir) / "checkpoints"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.save_interval = save_interval

    def steps(self):
        """Saved steps, newest first."""
        found = (_NAME.match(p.name) for p in self.dir.iterdir())
        return sorted((int(m.group(1)) for m in found if m), reverse=True)

    def path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}.pt"

    def maybe_save(self, step: int, params, opt_state):
        """Save when `step` is a positive multiple of the interval; params
        and opt_state are state dicts."""
        if not (self.save_interval and step % self.save_interval == 0
                and step > 0):
            return False
        tmp = self.path(step).with_suffix(".tmp")
        torch.save({"step": step, "params": params, "opt_state": opt_state},
                   tmp)
        os.replace(tmp, self.path(step))   # a crash never leaves a torn file
        for old in self.steps()[_MAX_TO_KEEP:]:
            self.path(old).unlink()
        return True

    def latest_step(self):
        steps = self.steps()
        return steps[0] if steps else None

    def restore(self, *, map_location=None):
        """(step, {"params", "opt_state"}) of the newest checkpoint; (None,
        None) when there is none. Saves are atomic (`maybe_save`), so the
        newest file is whole."""
        step = self.latest_step()
        if step is None:
            return None, None
        data = torch.load(self.path(step), map_location=map_location,
                          weights_only=True)
        return data["step"], {"params": data["params"],
                              "opt_state": data["opt_state"]}


def restore_from_path(path, *, map_location=None):
    """Resolve `--ft_path` (`run_nerf.py:1151-1157`: explicit weights
    override the experiment's own checkpoints): an experiment directory, its
    `checkpoints/` directory (the newest checkpoint of either) or one
    checkpoint file. Returns (step, {"params", "opt_state"}); a file without
    "opt_state" (parameters only) gives None there, and one without "step"
    the step in its name, else 0."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"--ft_path {p} does not exist")
    if p.is_dir():
        exp = p.parent if p.name == "checkpoints" else p
        step = restored = None
        if (exp / "checkpoints").is_dir():
            step, restored = CheckpointManager(exp).restore(
                map_location=map_location)
        if step is None:
            raise FileNotFoundError(f"--ft_path {p}: no checkpoint found")
        return step, restored
    data = torch.load(p, map_location=map_location, weights_only=True)
    m = re.search(r"(\d+)", p.stem)
    step = data.get("step", int(m.group(1)) if m else 0)
    return step, {"params": data["params"],
                  "opt_state": data.get("opt_state")}


def frozen_field_state(exp_dir, *, map_location=None):
    """The state dict of the field that `--alpha_model_path` freezes: the
    newest checkpoint of experiment `exp_dir`, its "fine" field where it has
    one, else its "coarse" (JAX `train/loop.py:287-306`). Raises
    FileNotFoundError when the experiment has no checkpoint."""
    exp = Path(exp_dir)
    step = None
    if (exp / "checkpoints").is_dir():
        step, restored = CheckpointManager(exp).restore(
            map_location=map_location)
    if step is None:
        raise FileNotFoundError(f"--alpha_model_path {exp}: no checkpoint")
    params = restored["params"]
    key = "fine" if any(k.startswith("fine.") for k in params) else "coarse"
    return {k[len(key) + 1:]: v for k, v in params.items()
            if k.startswith(key + ".")}
