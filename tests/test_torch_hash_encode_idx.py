"""The port's index-gather hash encode (`spinnerf_tpu_torch/ops/hash_encode.py`
and `hash_encode_win.hash_encode_win`) against the JAX package's: the plain
version against JAX's f32 oracles within 1.5e-6 (max-normalized), and
against the Pallas kernels in interpret mode within those tests' own bf16
tolerances. The CUDA kernels themselves run only on the card
(`chip_smoke.py` phase 9)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.ops import hash_encode as jhe
from spinnerf_tpu.ops import hash_encode_win as jhw
from spinnerf_tpu_torch.ops import hash_encode as the
from spinnerf_tpu_torch.ops import hash_encode_win as thw

torch.set_num_threads(1)

# (points, levels, log2 table size): N not a multiple of the TPU kernels'
# 512-point block, at T = 2^8 and 2^12
CASES = [(300, 3, 8), (4097, 2, 8), (700, 2, 12)]


def _mk(n, l, log2t, seed=0, features=2):
    rng = np.random.RandomState(seed)
    t = 1 << log2t
    table = (rng.randn(l, t, features) * 0.1).astype(np.float32)
    idx = rng.randint(0, t, (l, 8, n)).astype(np.int32)
    w = rng.rand(l, 8, n).astype(np.float32)
    g = rng.randn(n, l, features).astype(np.float32)
    return table, idx, w, g


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _port(table, idx, w, g):
    tab = torch.from_numpy(table).requires_grad_()
    out = the.hash_encode_mxu(tab, torch.from_numpy(idx), torch.from_numpy(w))
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), tab.grad.numpy()


def _jax(fn, table, idx, w, g):
    def loss(tb):
        return jnp.sum(fn(tb, jnp.asarray(idx), jnp.asarray(w))
                       * jnp.asarray(g))
    out = np.asarray(fn(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w)))
    return out, np.asarray(jax.grad(loss)(jnp.asarray(table)))


@pytest.mark.parametrize("n,l,log2t", CASES)
def test_plain_matches_jax_xla(n, l, log2t):
    """f32 gather and scatter in both: the forward and the table gradient
    agree within 1.5e-6 of max |value| (summation order only)."""
    table, idx, w, g = _mk(n, l, log2t)
    out_t, grad_t = _port(table, idx, w, g)
    out_j, grad_j = _jax(jhe.hash_encode_xla, table, idx, w, g)
    assert out_t.shape == out_j.shape == (n, l, 2)
    assert _rel(out_t, out_j) <= 1.5e-6
    assert _rel(grad_t, grad_j) <= 1.5e-6
    assert not any(the.launches.values())   # CPU: no kernel launched


@pytest.mark.parametrize("n,l,log2t", [(300, 2, 8), (700, 2, 12)])
def test_plain_vs_jax_mxu_interpret(n, l, log2t):
    """Against the Pallas kernel in interpret mode, at the bound of
    `tests/test_hash_encode.py`: its one-hot products round the table (and,
    backward, w * g) to bf16, which the port's f32 blend does not."""
    table, idx, w, g = _mk(n, l, log2t, seed=1)
    out_t, grad_t = _port(table, idx, w, g)
    out_j, grad_j = _jax(
        lambda tb, i, ww: jhe.hash_encode_mxu(tb, i, ww, True),
        table, idx, w, g)
    np.testing.assert_allclose(out_t, out_j, atol=5e-3, rtol=5e-2)
    np.testing.assert_allclose(grad_t, grad_j, atol=1e-2, rtol=5e-2)


def test_plain_features_4_matches_jax_xla():
    """features != 2 has no kernel, but the CPU's plain version takes it."""
    table, idx, w, g = _mk(200, 2, 8, seed=2, features=4)
    out_t, grad_t = _port(table, idx, w, g)
    out_j, grad_j = _jax(jhe.hash_encode_xla, table, idx, w, g)
    assert _rel(out_t, out_j) <= 1.5e-6
    assert _rel(grad_t, grad_j) <= 1.5e-6


def _win_points(seed, n):
    rng = np.random.RandomState(seed)
    x = np.concatenate([0.45 + 0.1 * rng.rand(n // 2, 3),
                        rng.rand(n - n // 2, 3)]).astype(np.float32)
    x[:4] = 1.0
    x[4:8] = 0.0
    return x


def test_hash_encode_win_matches_jax_exact():
    """The windowed index's encode from precomputed corners: the port's
    `hash_encode_win` (plain version) against JAX `hash_encode_exact`, f32,
    within 1.5e-6 of max |value|."""
    res, t = (4, 7, 16, 45, 300), 1 << 13
    x = _win_points(3, 900)
    idx, w = jhw.corner_indices_weights_win(jnp.asarray(x.T), res, t)
    rng = np.random.RandomState(4)
    table = rng.randn(len(res), t, 2).astype(np.float32)
    g = rng.randn(900, 2 * len(res)).astype(np.float32)
    idx, w = np.array(idx), np.array(w)
    out_j, grad_j = _jax(jhw.hash_encode_exact, table, idx, w, g)
    tab = torch.from_numpy(table).requires_grad_()
    out_t = thw.hash_encode_win(tab, torch.from_numpy(idx),
                                torch.from_numpy(w))
    (out_t * torch.from_numpy(g)).sum().backward()
    assert out_t.shape == (900, 2 * len(res))
    assert _rel(out_t.detach().numpy(), out_j) <= 1.5e-6
    assert _rel(tab.grad.numpy(), grad_j) <= 1.5e-6


def test_hash_encode_win_vs_jax_kernel_interpret():
    """Against the windowed Pallas kernel in interpret mode, on corners that
    stay inside each 512-point block's two-page window (so the kernel does
    not alias), at the bound of `tests/test_hash_encode_win.py`
    (`test_kernel_matches_oracle_fwd_bwd`): 2 % of max |value|, for the
    kernel's bf16 table pages and bf16 one-hot products."""
    rng = np.random.RandomState(5)
    l, t, n = 2, 8192, 1024
    base = np.sort(rng.randint(0, t - 1, (l, n // jhw._B)))
    idx = np.zeros((l, 8, n), np.int32)
    for li in range(l):
        for b in range(n // jhw._B):
            idx[li, :, b * jhw._B:(b + 1) * jhw._B] = (
                base[li, b] + rng.randint(0, jhw.WINDOW_ENTRIES // 2,
                                          (8, jhw._B)))
    idx = np.clip(idx, 0, t - 1)
    table = rng.randn(l, t, 2).astype(np.float32)
    w = rng.rand(l, 8, n).astype(np.float32)
    g = rng.randn(n, l * 2).astype(np.float32)
    pages, _ = jhw.window_offsets(jnp.asarray(idx), t)
    out_j, grad_j = _jax(
        lambda tb, i, ww: jhw.hash_encode_win(tb, i, ww, pages, True),
        table, idx, w, g)
    tab = torch.from_numpy(table).requires_grad_()
    out_t = thw.hash_encode_win(tab, torch.from_numpy(idx),
                                torch.from_numpy(w))
    (out_t * torch.from_numpy(g)).sum().backward()
    assert _rel(out_t.detach().numpy(), out_j) < 0.02
    assert _rel(tab.grad.numpy(), grad_j) < 0.02


def test_recommended_impl_matches_jax():
    for log2t in (8, 12, 13, 15, 19):
        for on_tpu in (True, False):
            assert (the.recommended_impl(log2t, on_tpu=on_tpu)
                    == jhe.recommended_impl(log2t, on_tpu=on_tpu))


def test_kernel_wrappers_take_only_cuda_tensors():
    """The kernel wrappers never run on CPU tensors (the entry points take
    the plain version there); features != 2 has no kernel."""
    table, idx, w, g = (torch.from_numpy(a) for a in _mk(64, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        the.hash_encode_idx_fwd_kernel(table, idx, w)
    with pytest.raises(ValueError, match="CUDA"):
        the.hash_encode_idx_bwd_kernel(g, idx, w, tuple(table.shape))
    with pytest.raises(ValueError, match="features=2"):
        the.hash_encode_idx_fwd_kernel(torch.zeros((2, 256, 4)), idx, w)
    assert not any(the.launches.values())
