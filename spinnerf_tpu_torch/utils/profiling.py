"""Profiling and step metrics (port of `spinnerf_tpu/utils/profiling.py`).

The reference times only with `time.time()` deltas and tqdm
(`DS_NeRF/run_nerf.py:1361`); here:
- `trace()` profiles a block with `torch.profiler` (CPU and, on the card,
  CUDA activity) and writes a Chrome / TensorBoard trace into a directory;
- `annotate()` names a region inside such a trace;
- `device_memory_stats()` reads the card's allocator counters;
- `StepTimer` keeps an EMA of the step time and rays a second and writes
  the JAX package's JSONL rows.
"""
from __future__ import annotations

import contextlib
import json
import time

import torch

from spinnerf_tpu_torch import resolve_device


@contextlib.contextmanager
def trace(log_dir, *, device=None):
    """Profile a block: `with trace("/tmp/trace") as prof: step(...)`.
    Records CUDA activity when the device is the card (the default; pass
    device="cpu" for the host alone). Writes `<host>_<pid>.<time>.pt.trace.
    json` into `log_dir`; yields the profiler (`prof.key_averages()`)."""
    device = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts, on_trace_ready=torch.profiler.
            tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def annotate(name: str):
    """A named region inside a trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)


def device_memory_stats():
    """Per card: bytes in use, their peak and the card's capacity, from
    `torch.cuda.memory_stats` (what this process's allocator holds). On a
    machine without a card this is an empty dict: the CPU has no such
    counters."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


class StepTimer:
    """EMA step timing and JSONL metric rows. `tock` waits for the card
    (`torch.cuda.synchronize`) before it reads the clock, so a row times
    the step's device work and not only its launches; device="cpu" reads
    the clock at once."""

    def __init__(self, jsonl_path=None, ema: float = 0.9, device=None):
        self.ema = ema
        self.avg = None
        self._last = None
        self._device = resolve_device(device)
        self._file = open(jsonl_path, "a") if jsonl_path else None

    def _sync(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def tick(self):
        self._sync()
        self._last = time.perf_counter()

    def tock(self, step: int, metrics: dict | None = None,
             rays_per_step: int | None = None):
        self._sync()
        dt = time.perf_counter() - self._last
        self.avg = dt if self.avg is None else \
            self.ema * self.avg + (1 - self.ema) * dt
        row = {"step": step, "step_time_s": dt, "step_time_ema_s": self.avg}
        if rays_per_step:
            row["rays_per_sec"] = rays_per_step / max(self.avg, 1e-9)
        if metrics:
            row.update({k: float(v) for k, v in metrics.items()})
        if self._file:
            self._file.write(json.dumps(row) + "\n")
            self._file.flush()
        return row

    def close(self):
        if self._file:
            self._file.close()
