"""Numerical sanitizers and failure diagnostics (port of
`spinnerf_tpu/utils/debug.py`).

- The reference's always-on `torch.autograd.set_detect_anomaly(True)`
  (`run_nerf_helpers.py:5`) is opt-in here, `enable_nan_debug()`: it slows
  every backward down.
- The reference's DEBUG scan of render outputs for NaN / Inf
  (`run_nerf.py:733-736`) is `check_finite()`, over nested dicts, lists and
  tuples of tensors or arrays, with the JAX package's leaf paths and
  messages; `assert_finite_in_jit()` is its one-tensor form inside a step.
- LaMa's SIGUSR1 stack dump (`saicinpainting/utils.py:101-109`) is
  `install_signal_dump()`.
"""
from __future__ import annotations

import signal
import sys
import traceback

import numpy as np
import torch


def enable_nan_debug(enable: bool = True):
    """Make autograd raise where a backward produces NaN, naming the forward
    op (`torch.autograd.set_detect_anomaly`; debug only, it is slow)."""
    torch.autograd.set_detect_anomaly(enable)


def _leaves(tree, path=""):
    """(path, leaf) pairs in the JAX package's order and `keystr` form:
    dict keys sorted as `['key']`, sequence items as `[i]`, namedtuple
    fields as `.name`; None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _bad_counts(leaf):
    """(NaN count, Inf count) of a tensor (counted on its device) or of
    anything numpy takes."""
    if isinstance(leaf, torch.Tensor):
        if not (leaf.is_floating_point() or leaf.is_complex()):
            return 0, 0
        return int(torch.isnan(leaf).sum()), int(torch.isinf(leaf).sum())
    arr = np.asarray(leaf)
    if not np.issubdtype(arr.dtype, np.inexact):
        return 0, 0
    return int(np.isnan(arr).sum()), int(np.isinf(arr).sum())


def check_finite(tree, name: str = "tree", *, raise_error: bool = True):
    """Finite check over nested containers of tensors or arrays (reads the
    counts back to the host). Returns the list of (path, NaN count, Inf
    count) of each bad leaf; raises FloatingPointError naming them unless
    `raise_error=False`."""
    bad = []
    for path, leaf in _leaves(tree):
        n_nan, n_inf = _bad_counts(leaf)
        if n_nan or n_inf:
            bad.append((path, n_nan, n_inf))
    if bad and raise_error:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
    return bad


def assert_finite_in_jit(x, name: str = "x"):
    """Print the JAX package's message to stderr when `x` holds NaN or Inf,
    and return `x`. Eager: the check reads a flag back from the device, so
    it synchronises the card at every call (JAX defers it to a host
    callback after the step)."""
    if not bool(torch.isfinite(torch.as_tensor(x)).all()):
        print(f"! [Numerical Error] {name} contains nan or inf",
              file=sys.stderr)
    return x


def install_signal_dump(sig=signal.SIGUSR1):
    """Dump every thread's stack to stderr on `kill -USR1 <pid>` (LaMa's
    handler)."""
    def handler(signum, frame):
        print(f"=== stack dump (signal {signum}) ===", file=sys.stderr)
        for tid, fr in sys._current_frames().items():
            print(f"--- thread {tid} ---", file=sys.stderr)
            traceback.print_stack(fr, file=sys.stderr)
    signal.signal(sig, handler)
