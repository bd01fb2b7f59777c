"""Tensor-core rate calibration and hash-encode kernel timings on one card
(port of `tools/kbench.py`).

    python -m spinnerf_tpu_torch.tools.kbench [--n 786432] [--skip-calib]

`calibrate` repeats bf16 [128, k] x [k, 512] products in the calibration
kernel (`csrc/kbench_cal.cu`, the counterpart of the TPU's `_cal_kernel`) and
reports its time and tensor-core rate in TFLOP/s, 2 * 128 * k * 512 * reps *
blocks / time, where the JAX harness reported MXU columns per cycle. `main`
also times the hash-grid encode (`hash_encode_win_fused`, the windowed index
with uniform page bounds) forward and forward+backward at N points x 16
levels x 2^19 entries, as the JAX `main` does. The JAX harness's last line,
the window-clamp alias fraction, has no counterpart: the port's kernels
gather every corner directly and never alias (ROADMAP.md queue C).

Every time is taken on the card with CUDA events; without a card the
harness raises.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses

import torch

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch.ops import cuda_build

ROWS, COLS, KMAX = 128, 512, 128   # a [blocks, 128, 128], b [blocks, 128, 512]

# Kernel launches by the wrapper, counted where it launches and nowhere else.
launches = {"cal": 0}

_VP = ctypes.c_void_p


def _lib():
    lib = cuda_build.load("kbench_cal")
    if not getattr(lib, "_kc_typed", False):
        lib.kc_run.argtypes = [_VP, _VP, _VP] + [ctypes.c_int] * 5 + [_VP]
        lib.kc_run.restype = ctypes.c_int
        lib.kc_error_string.argtypes = [ctypes.c_int]
        lib.kc_error_string.restype = ctypes.c_char_p
        lib._kc_typed = True
    return lib


# The kernel's schedule: compile-time constants of csrc/kbench_cal.cu,
# mirrored here to plan the launch.
UNIT_COLS = 128         # KC_NU: output columns of a unit
SLOTS = 3               # KC_SLOTS: stages of the ring
TILE_BYTES = 8192       # KC_TILE: a swizzled [64][64] bf16 tile
SMEM_MAX = 232448       # a block's shared memory on the H100


@dataclasses.dataclass(frozen=True)
class CalPlan:
    """How `kc_run` takes `blocks` blocks at depth k: persistent blocks
    (`grid`, at most one an SM, each walking units of (block, 128 output
    columns)), the bytes of a unit's A and B stage (A in whole [64][64]
    tiles, B as two [k][64] column tiles) and a block's shared memory (the
    ring's SLOTS stages, its barriers and the swizzle's alignment), which
    the CUDA source checks against its own count."""
    grid: int
    a_bytes: int
    b_bytes: int
    smem: int


def cal_plan(blocks: int, k: int, sms: int) -> CalPlan:
    """The calibration kernel's launch at `blocks` blocks, depth k, on a
    card of `sms` multiprocessors."""
    a_bytes = 2 * -(-k // 64) * TILE_BYTES
    b_bytes = 2 * k * 128
    smem = SLOTS * (a_bytes + b_bytes) + 16 * SLOTS + 1024
    if smem > SMEM_MAX:
        raise ValueError(f"k={k}: {smem} bytes of shared memory")
    return CalPlan(grid=max(1, min(blocks * COLS // UNIT_COLS, sms)),
                   a_bytes=a_bytes, b_bytes=b_bytes, smem=smem)


def cal_plain(a, b, k: int, reps: int):
    """What the calibration kernel computes: `reps` times the product
    a[:, :, :k] b[:, :k, :] of the bf16 values, each product in f32, added
    in f32 one after the other (the TPU kernel's `acc + dot`)."""
    a_k, b_k = a[:, :, :k].float(), b[:, :k, :].float()
    acc = torch.zeros((a.shape[0], ROWS, COLS), dtype=torch.float32,
                      device=a.device)
    for _ in range(reps):
        acc = acc + torch.bmm(a_k, b_k)
    return acc


def cal_kernel(a, b, k: int, reps: int):
    """One launch of the calibration kernel: a [blocks, 128, 128] and b
    [blocks, 128, 512] contiguous bf16 CUDA tensors, k a multiple of 16 up
    to 128 -> [blocks, 128, 512] f32."""
    blocks = a.shape[0]
    for t, shape in ((a, (blocks, ROWS, KMAX)), (b, (blocks, KMAX, COLS))):
        if (not t.is_cuda or t.dtype != torch.bfloat16
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"inputs must be contiguous bf16 CUDA tensors "
                             f"{shape}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if not (16 <= k <= KMAX and k % 16 == 0 and reps >= 1):
        raise ValueError(f"k must be a multiple of 16 in [16, {KMAX}] and "
                         f"reps >= 1, got k={k} reps={reps}")
    lib = _lib()
    plan = cal_plan(blocks, k, torch.cuda.get_device_properties(
        a.device).multi_processor_count)
    out = torch.empty((blocks, ROWS, COLS), dtype=torch.float32,
                      device=a.device)
    err = lib.kc_run(a.data_ptr(), b.data_ptr(), out.data_ptr(), blocks, k,
                     reps, plan.grid, plan.smem,
                     torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"kc_run launch failed: "
                           f"{lib.kc_error_string(err).decode()}")
    launches["cal"] += 1
    return out


def cal(a, b, k: int, reps: int):
    """The calibration product: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if a.is_cuda:
        return cal_kernel(a, b, k, reps)
    return cal_plain(a, b, k, reps)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of `fn` over `iters` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cal_flops(k: int, reps: int, blocks: int) -> int:
    return 2 * ROWS * k * COLS * reps * blocks


def calibrate(k: int, reps: int = 8, blocks: int = 4096, *, device=None,
              log=print):
    """Time the calibration kernel at depth k: returns (ms, TFLOP/s). The
    inputs are normal bf16 values from a fixed seed (the JAX harness used
    ones; the card's clock under its power limit depends on the data)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("calibrate times the card; got device "
                           f"{device}")
    gen = torch.Generator(device).manual_seed(0)
    a = torch.randn((blocks, ROWS, KMAX), generator=gen, device=device
                    ).to(torch.bfloat16)
    b = torch.randn((blocks, KMAX, COLS), generator=gen, device=device
                    ).to(torch.bfloat16)
    ms = cuda_ms(lambda: cal(a, b, k, reps))
    tflops = cal_flops(k, reps, blocks) / (ms * 1e-3) / 1e12
    log(f"calib K={k:3d} reps={reps:3d}: {ms:8.4f} ms  {tflops:7.1f} TFLOP/s")
    return ms, tflops


def main(argv=None):
    from spinnerf_tpu_torch.models.hashgrid import level_resolutions
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    ap = argparse.ArgumentParser("spinnerf_tpu_torch.tools.kbench")
    ap.add_argument("--n", type=int, default=786432)
    ap.add_argument("--skip-calib", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device()
    print(f"card: {torch.cuda.get_device_name(device)}")

    if not args.skip_calib:
        for k in (64, 128):
            calibrate(k, device=device)

    n, levels, t = args.n, 16, 1 << 19
    res = level_resolutions(levels, 16, 2048.0 * 100.0)
    gen = torch.Generator(device).manual_seed(0)
    x = torch.rand((n, 3), generator=gen, device=device)
    table = (torch.rand((levels, t, 2), generator=gen, device=device)
             * 2e-4 - 1e-4)
    print(f"hash encode fwd      "
          f"{cuda_ms(lambda: hw.hash_encode_win_fused(table, x, res)):8.3f} ms")
    tab = table.clone().requires_grad_()

    def fwd_bwd():
        tab.grad = None
        (hw.hash_encode_win_fused(tab, x, res) ** 2).sum().backward()

    print(f"hash encode fwd+bwd  {cuda_ms(fwd_bwd):8.3f} ms")


if __name__ == "__main__":
    main()
