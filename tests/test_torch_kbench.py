"""The port's calibration product (`spinnerf_tpu_torch/tools/kbench.py`)
against the JAX `_cal_kernel` of `tools/kbench.py`, run through its own
`pl.pallas_call` in interpret mode on the CPU at 2 blocks. Same numpy-made
bf16 inputs on both sides."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from spinnerf_tpu_torch.tools import kbench as tkb
from tools import kbench as jkb

torch.set_num_threads(1)

BLOCKS = 2


def _inputs(seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(BLOCKS, 128, 128).astype(np.float32)
    b = rng.randn(BLOCKS, 128, 512).astype(np.float32)
    # round to bf16 once, so that both sides read the same bf16 values
    a_t = torch.from_numpy(a).to(torch.bfloat16)
    b_t = torch.from_numpy(b).to(torch.bfloat16)
    return a_t, b_t


def _jax_cal(a_t, b_t, k, reps):
    a = jnp.asarray(a_t.float().numpy(), jnp.bfloat16)
    b = jnp.asarray(b_t.float().numpy(), jnp.bfloat16)
    f = pl.pallas_call(
        functools.partial(jkb._cal_kernel, k, reps),
        grid=(BLOCKS,),
        in_specs=[pl.BlockSpec((1, 128, 128), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, 128, jkb._B), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, 128, jkb._B), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((BLOCKS, 128, jkb._B), jnp.float32),
        interpret=True)
    return np.asarray(f(a, b))


# Products of bf16 values are exact in f32; the k-deep sums and the reps
# running sum are f32 on both sides in other orders: 1e-5 of max |value|
# (the bound chip_smoke.py holds the kernel to). Measured <= 2.5e-7.
@pytest.mark.parametrize("k,reps", [(64, 8), (128, 3)])
def test_plain_matches_jax_cal_kernel(k, reps):
    a, b = _inputs(k + reps)
    want = _jax_cal(a, b, k, reps)
    got = tkb.cal(a, b, k, reps).numpy()
    assert got.shape == want.shape == (BLOCKS, 128, tkb.COLS)
    assert jkb._B == tkb.COLS
    err = np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()
    assert err < 1e-5


def test_flop_count_and_kernel_wrapper_guards():
    assert tkb.cal_flops(128, 8, 4096) == 2 * 128 * 128 * 512 * 8 * 4096
    a, b = _inputs(0)
    with pytest.raises(ValueError, match="CUDA"):
        tkb.cal_kernel(a, b, 128, 8)
    with pytest.raises(RuntimeError, match="card"):
        tkb.calibrate(64, blocks=2, device="cpu")
    assert tkb.launches == {"cal": 0}


@pytest.mark.parametrize("k", list(range(16, tkb.KMAX + 1, 16)))
def test_cal_plan_fits_the_card(k):
    """The kernel's launch plan at every depth it takes: four units of 128
    output columns a block, at most one persistent block an SM, A in whole
    swizzled [64][64] tiles and B as two [k][64] column tiles, every tile
    1024-byte aligned (the 128-byte swizzle repeats every 1024 bytes), and
    three stages in a block's shared memory."""
    plan = tkb.cal_plan(4096, k, 132)
    assert plan.grid == 132 and tkb.cal_plan(10, k, 132).grid == 40
    assert plan.a_bytes == 128 * 64 * 2 * -(-k // 64)
    assert plan.b_bytes == 2 * k * 64 * 2
    assert plan.a_bytes % 1024 == 0 and (plan.b_bytes // 2) % 1024 == 0
    assert (plan.a_bytes + plan.b_bytes) % 1024 == 0
    assert plan.smem == tkb.SLOTS * (plan.a_bytes + plan.b_bytes) + 1072
    assert plan.smem <= tkb.SMEM_MAX
    # the MN-major descriptor's stride between B's column tiles, k * 128
    # bytes, fits its 14-bit field (in 16-byte units)
    assert (k * 128) >> 4 < 1 << 14
