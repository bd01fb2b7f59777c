"""Checkpoints: `torch.save` of {step, params, opt_state} every
`save_interval` steps under <exp_dir>/checkpoints, the newest restored on
resume, `--ft_path` loading, the frozen field of `--alpha_model_path` and
the parameters-only distribution file of `strip_checkpoint` (port of `spinnerf_tpu/train/checkpoints.py`, which uses orbax; the port
reads its own files, not orbax's).
"""
from __future__ import annotations

import os
import re
import shutil
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

    def maybe_save(self, step: int, params, opt_state, force: bool = False):
        """Save when `step` is a positive multiple of the interval, or when
        `force`; params and opt_state are state dicts."""
        if not (force or (self.save_interval and step % self.save_interval
                          == 0 and step > 0)):
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


def frozen_field_state(path, *, map_location=None):
    """The state dict of the field that `--alpha_model_path` freezes: the
    newest checkpoint of experiment `path` (or the file `strip_checkpoint`
    wrote), its "fine" field where it has one, else its "coarse" (JAX
    `train/loop.py:287-306`). Raises FileNotFoundError when the experiment
    has no checkpoint."""
    exp = Path(path)
    step = None
    if exp.is_file():
        step, restored = restore_from_path(exp, map_location=map_location)
    elif (exp / "checkpoints").is_dir():
        step, restored = CheckpointManager(exp).restore(
            map_location=map_location)
    if step is None:
        raise FileNotFoundError(f"--alpha_model_path {exp}: no checkpoint")
    params = restored["params"]
    key = "fine" if any(k.startswith("fine.") for k in params) else "coarse"
    return {k[len(key) + 1:]: v for k, v in params.items()
            if k.startswith(key + ".")}


def page_bounds_path(path) -> Path:
    """Where the `page_bounds.json` of a frozen field lies: in an
    experiment directory, or beside a file `strip_checkpoint` wrote."""
    p = Path(path)
    return (p.with_suffix(".page_bounds.json") if p.is_file()
            else p / "page_bounds.json")


def strip_checkpoint(exp_dir, out_dir, *, step=None):
    """Write a distribution checkpoint containing only the parameters
    (parity: `lama/bin/make_checkpoint.py` — strip optimizer/training state)
    of the newest checkpoint of `exp_dir`, or of `step`, to
    `<out_dir>/params_<step>.pt`, a file that `restore_from_path`
    (`--ft_path`) and `frozen_field_state` (`--alpha_model_path`) read as
    parameters only; the experiment's `page_bounds.json` goes beside it as
    `params_<step>.page_bounds.json`. Returns (step, out_path)."""
    src = CheckpointManager(exp_dir)
    steps = src.steps()
    if step is None and steps:
        step = steps[0]
    if step is None or step not in steps:
        raise FileNotFoundError(
            f"no checkpoint{'' if step is None else f' at step {step}'} "
            f"under {src.dir}")
    data = torch.load(src.path(step), map_location="cpu", weights_only=True)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    dst = out / f"params_{step}.pt"
    tmp = dst.with_suffix(".tmp")
    torch.save({"step": step, "params": data["params"]}, tmp)
    os.replace(tmp, dst)      # re-running the strip overwrites
    side = Path(exp_dir) / "page_bounds.json"
    if side.exists():
        shutil.copyfile(side, page_bounds_path(dst))
    return step, dst
