"""The port's debug and profiling utilities (`spinnerf_tpu_torch/utils/
{debug,profiling}.py`) against the JAX package's: `check_finite`'s list
of bad leaves and its message on the same nested inputs (tensors on the
port's side, arrays on JAX's), `assert_finite_in_jit`'s message,
`StepTimer`'s JSONL keys, a profile written by `trace` on the CPU, and
`install_signal_dump` on SIGUSR1."""
import json
import os
import signal

import numpy as np
import pytest
import torch

from spinnerf_tpu.utils import debug as jdebug
from spinnerf_tpu.utils import profiling as jprofiling
from spinnerf_tpu_torch.utils import debug, profiling

torch.set_num_threads(1)


def _trees(seed):
    """The same nested input twice: numpy leaves for JAX, tensors (f32,
    bf16, int) and arrays for the port."""
    rng = np.random.RandomState(seed)
    a = rng.randn(4, 3).astype(np.float32)
    a[1, 2] = np.nan
    b = rng.randn(7).astype(np.float32)
    b[[0, 5]] = [np.inf, -np.inf]
    c = rng.randn(2, 2)
    d = np.arange(5, dtype=np.int32)
    e = rng.randn(3).astype(np.float32)
    e[:] = np.nan
    jtree = {"w": [a, {"bias": b}], "aux": (c, d, None), "loss": e,
             "ok": np.float32(1.0)}
    ttree = {"w": [torch.from_numpy(a), {"bias": torch.from_numpy(b)}],
             "aux": (c, torch.from_numpy(d), None),
             "loss": torch.from_numpy(e).to(torch.bfloat16),
             "ok": np.float32(1.0)}
    return jtree, ttree


@pytest.mark.parametrize("seed", [0, 1])
def test_check_finite_matches_jax(seed):
    jtree, ttree = _trees(seed)
    want = jdebug.check_finite(jtree, raise_error=False)
    got = debug.check_finite(ttree, raise_error=False)
    assert got == want == [("['loss']", 3, 0), ("['w'][0]", 1, 0),
                           ("['w'][1]['bias']", 0, 2)]
    with pytest.raises(FloatingPointError) as je:
        jdebug.check_finite(jtree, "params")
    with pytest.raises(FloatingPointError) as te:
        debug.check_finite(ttree, "params")
    assert str(te.value) == str(je.value)
    clean = {"a": [np.ones(3)], "b": (torch.zeros(2), None)}
    assert debug.check_finite(clean) == []
    assert debug.check_finite(torch.tensor([1.0, np.nan]),
                              raise_error=False) == [("", 1, 0)]


def test_assert_finite_in_jit_prints_the_message(capsys):
    x = torch.tensor([1.0, float("nan")])
    assert debug.assert_finite_in_jit(x, "rgb") is x
    assert "! [Numerical Error] rgb contains nan or inf" in \
        capsys.readouterr().err
    debug.assert_finite_in_jit(torch.ones(3), "rgb")
    assert capsys.readouterr().err == ""


def test_enable_nan_debug_toggles_anomaly_mode():
    try:
        debug.enable_nan_debug()
        assert torch.is_anomaly_enabled()
    finally:
        debug.enable_nan_debug(False)
    assert not torch.is_anomaly_enabled()


def test_step_timer_rows_match_jax(tmp_path):
    rows = {}
    for tag, mod, kw in (("jax", jprofiling, {}),
                         ("torch", profiling, {"device": "cpu"})):
        timer = mod.StepTimer(tmp_path / f"{tag}.jsonl", **kw)
        for step in (1, 2):
            timer.tick()
            row = timer.tock(step, {"loss": np.float32(0.5), "psnr": 20.0},
                             rays_per_step=1024)
        timer.close()
        lines = (tmp_path / f"{tag}.jsonl").read_text().splitlines()
        assert len(lines) == 2 and json.loads(lines[-1]) == row
        rows[tag] = row
    assert list(rows["torch"]) == list(rows["jax"]) == [
        "step", "step_time_s", "step_time_ema_s", "rays_per_sec", "loss",
        "psnr"]
    assert rows["torch"]["loss"] == 0.5 and rows["torch"]["step"] == 2


def test_trace_writes_a_cpu_profile(tmp_path):
    with profiling.trace(tmp_path / "prof", device="cpu") as prof:
        with profiling.annotate("my_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    assert "my_region" in files[0].read_text()
    assert any(e.key == "my_region" for e in prof.key_averages())


def test_device_memory_stats():
    """Empty without a card; per card the JAX package's three keys."""
    stats = profiling.device_memory_stats()
    assert len(stats) == torch.cuda.device_count()
    for s in stats.values():
        assert list(s) == ["bytes_in_use", "peak_bytes_in_use",
                           "bytes_limit"]


def test_install_signal_dump_handles_sigusr1(capfd):
    old = signal.getsignal(signal.SIGUSR1)
    try:
        debug.install_signal_dump()
        os.kill(os.getpid(), signal.SIGUSR1)
        err = capfd.readouterr().err
    finally:
        signal.signal(signal.SIGUSR1, old)
    assert "=== stack dump (signal" in err
    assert "test_install_signal_dump_handles_sigusr1" in err
