"""The port's instant-NGP encode from points (`spinnerf_tpu_torch/ops/
hash_encode.py`: `corner_indices_weights_ngp`, `hash_encode_ngp_fused` and
the backward's plan `bwd_plan`) against the JAX package.

The index is held bit for bit against JAX `HashGridEncoding
.corner_indices_weights`; the encode's plain version against JAX
`hash_encode_xla` (f32, 1.5e-6 of max |value|) and the Pallas kernel in
interpret mode (its bf16 bound); the plan's regimes against the levels'
geometry; and a plain f32 emulation of the CUDA backward's schedule
(`csrc/hash_encode_idx.cu::hi_bwd_kernel`: blocks of a level's points,
warps summing the lanes that share an entry, shared sums staged whole or
in an open-addressing map and added once a block, direct adds of 16-byte
entry pairs on sparse levels) against JAX's gradient evaluated in float64,
within 1e-6 of its largest entry. The kernels themselves run only on the
card (`chip_smoke.py` phase 9)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.models.hashgrid import HashGridEncoding as JEnc
from spinnerf_tpu.models.hashgrid import level_resolutions
from spinnerf_tpu.ops import hash_encode as jhe
from spinnerf_tpu_torch.ops import hash_encode as the

torch.set_num_threads(1)

FINEST = 2048.0 * 100     # the default field: base 16, finest 2048 * bound


def _points(seed, n):
    """Clustered and uniform points, some exactly on 0.0 and 1.0 (a point
    at 1.0 reaches corner r+1, which the mask wraps)."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([0.47 + 0.06 * rng.rand(n // 2, 3),
                        rng.rand(n - n // 2, 3)]).astype(np.float32)
    x[:8] = 1.0
    x[8:16] = 0.0
    x[16:24, 0] = 1.0
    x[24:32, 2] = 1.0
    return x


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# (log2 T, levels, base, finest): dense coarse and hashed fine levels in
# each; the default field's geometry at 2^19
INDEX_SIZES = [(12, 16, 4, FINEST), (19, 16, 16, FINEST)]


@pytest.mark.parametrize("log2t,levels,base,finest", INDEX_SIZES)
def test_corner_indices_bit_identical_to_jax(log2t, levels, base, finest):
    t = 1 << log2t
    x = _points(log2t, 900)
    res = level_resolutions(levels, base, finest)
    dense = [the.level_is_dense(r, t) for r in res]
    assert any(dense) and not all(dense)
    idx_j, w_j = JEnc(n_levels=levels, log2_table_size=log2t, base_res=base,
                      finest_res=finest, impl="xla").corner_indices_weights(
        jnp.asarray(x))
    idx_t, w_t = the.corner_indices_weights_ngp(torch.from_numpy(x), res, t)
    assert idx_t.dtype == torch.int32 and idx_t.shape == (levels, 8, 900)
    assert w_t.dtype == torch.float32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))


def _inputs(seed, n, levels, log2t, base=4, finest=64.0):
    rng = np.random.RandomState(seed)
    x = _points(seed, n)
    res = tuple(level_resolutions(levels, base, finest))
    table = (rng.randn(levels, 1 << log2t, 2) * 0.1).astype(np.float32)
    g = rng.randn(n, levels, 2).astype(np.float32)
    return x, res, table, g


def _port_fused(x, res, table, g):
    tab = torch.from_numpy(table).requires_grad_()
    out = the.hash_encode_ngp_fused(tab, torch.from_numpy(x), res)
    (out * torch.from_numpy(g)).sum().backward()
    return out, tab.grad.numpy()


def _jax(fn, x, res, table, g):
    idx, w = the.corner_indices_weights_ngp(torch.from_numpy(x), res,
                                            table.shape[1])
    idx, w = jnp.asarray(idx.numpy()), jnp.asarray(w.numpy())

    def loss(tb):
        return jnp.sum(fn(tb, idx, w) * jnp.asarray(g))
    out = np.asarray(fn(jnp.asarray(table), idx, w))
    return out, np.asarray(jax.grad(loss)(jnp.asarray(table)))


# (points, levels, log2 T): dense and hashed levels, a power-of-two table
FUSED_CASES = [(700, 4, 8), (1500, 6, 12), (900, 6, 14)]


@pytest.mark.parametrize("n,levels,log2t", FUSED_CASES)
def test_fused_plain_is_the_index_then_the_gather(n, levels, log2t):
    """On CPU tensors `hash_encode_ngp_fused` is exactly
    `hash_encode_mxu(table, *corner_indices_weights_ngp(x))`, forward and
    table gradient, and launches nothing."""
    x, res, table, g = _inputs(n, n, levels, log2t)
    out, grad = _port_fused(x, res, table, g)
    tab = torch.from_numpy(table).requires_grad_()
    idx, w = the.corner_indices_weights_ngp(torch.from_numpy(x), res,
                                            1 << log2t)
    want = the.hash_encode_mxu(tab, idx, w)
    (want * torch.from_numpy(g)).sum().backward()
    assert out.shape == (n, levels, 2) and out.dtype == torch.float32
    assert torch.equal(out.detach(), want.detach())
    np.testing.assert_array_equal(grad, tab.grad.numpy())
    assert not any(the.launches.values())


@pytest.mark.parametrize("n,levels,log2t", FUSED_CASES)
def test_fused_matches_jax_xla(n, levels, log2t):
    """The forward and the table gradient against JAX `hash_encode_xla`
    and `jax.grad` of it on the same index: f32 in both, within 1.5e-6 of
    max |value| (summation order only)."""
    x, res, table, g = _inputs(n + 1, n, levels, log2t)
    out, grad = _port_fused(x, res, table, g)
    out_j, grad_j = _jax(jhe.hash_encode_xla, x, res, table, g)
    assert _rel(out.detach().numpy(), out_j) <= 1.5e-6
    assert _rel(grad, grad_j) <= 1.5e-6


def test_fused_vs_jax_mxu_interpret():
    """Against the Pallas kernel in interpret mode at a small size, at the
    bound of `tests/test_hash_encode.py`: its one-hot products round the
    table (and, backward, w * g) to bf16, which the port's f32 blend does
    not."""
    x, res, table, g = _inputs(3, 300, 2, 8)
    out, grad = _port_fused(x, res, table, g)
    out_j, grad_j = _jax(
        lambda tb, i, ww: jhe.hash_encode_mxu(tb, i, ww, True),
        x, res, table, g)
    np.testing.assert_allclose(out.detach().numpy(), out_j, atol=5e-3,
                               rtol=5e-2)
    np.testing.assert_allclose(grad, grad_j, atol=1e-2, rtol=5e-2)


@pytest.mark.parametrize("log2t", [12, 19])
def test_bwd_plan_follows_the_geometry(log2t):
    """At the default field's resolutions: a 2^12 table is staged whole at
    every level; at 2^19 the levels up to HOT_RES (the coarse ones, dense
    or hashed) take the shared map and the finer ones direct reductions.
    Idx mode, which knows no resolutions, maps every level of a large
    table. The plan depends on the geometry alone."""
    t = 1 << log2t
    res = tuple(level_resolutions(16, 16, FINEST))
    plan = the.bwd_plan(res, t)
    assert len(plan.regime) == len(plan.points) == len(plan.size) == 16
    if log2t == 12:
        assert plan.regime == (the.STAGED,) * 16
        assert plan.size == (t,) * 16
    else:
        hot = [r <= the.HOT_RES for r in res]
        assert hot == [True] * 5 + [False] * 11   # resolutions 16..199
        # dense and hashed levels among the hot ones
        assert the.level_is_dense(res[0], t)
        assert not the.level_is_dense(res[4], t)
        for h, reg, p, s in zip(hot, plan.regime, plan.points, plan.size):
            assert (reg, p, s) == ((the.MAP, the.MAP_POINTS, the.MAP_SLOTS)
                                   if h else (the.DIRECT,
                                              the.DIRECT_POINTS, 0))
        idx_plan = the.bwd_plan((None,) * 16, t)
        assert idx_plan.regime == (the.MAP,) * 16
        assert idx_plan.size == (the.MAP_CAP,) * 16
    # what a block holds fits: 8 blocks an SM for the map, 64 KB staged
    assert max(plan.size) * (12 if the.MAP in plan.regime else 8) <= 65536
    assert the.MAP_SLOTS * 12 * 8 <= 232448
    assert the.bwd_plan(res, t) is plan                  # cached


# --- a plain emulation of the CUDA backward's schedule ----------------------

THREADS, EMPTY = 256, 0xFFFFFFFF
MAP_PROBES = 8


def _warp_sums(keys, vals):
    """The groups of one warp's call of warp_add: lanes with equal keys
    summed in lane order (f32); EMPTY keys add nothing."""
    out = {}
    for k, v in zip(keys.tolist(), vals):
        if k == EMPTY:
            continue
        out[k] = out[k] + v if k in out else v.copy()
    return out.items()


def emulate_bwd(idx, w, g, t, plan):
    """The table gradient [L, T, 2] f32 of corners idx / w [L, 8, N] and
    cotangent g [N, L, 2], in the order and by the regimes of
    `hi_bwd_kernel` under `plan`. Returns it and how many updates the maps
    sent straight to the table."""
    levels, _, n = idx.shape
    dt = np.zeros((levels, t, 2), np.float32)
    overflow = 0
    for l in range(levels):
        regime, pts, size = (plan.regime[l], plan.points[l], plan.size[l])
        for p0 in range(0, n, pts):
            acc = np.zeros((max(size, 1), 2), np.float32)
            keys = np.full(max(size, 1), EMPTY, np.int64)
            for w0 in range(p0, min(n, p0 + pts), 32):
                lanes = np.arange(w0, min(w0 + 32, p0 + pts, n))
                ic = idx[l][:, lanes].astype(np.int64) & 0xFFFFFFFF
                ok = ic < t
                val = (w[l][:, lanes, None]
                       * g[lanes, l][None]).astype(np.float32)
                if regime == the.DIRECT:
                    for c in range(4):
                        e0, e1 = ic[c], ic[c + 4]
                        both = ((e0 ^ e1) == 1) & ok[c] & ok[c + 4]
                        v = np.zeros((len(lanes), 4), np.float32)
                        u = np.zeros((len(lanes), 4), np.float32)
                        for i in range(len(lanes)):
                            h0, h1 = 2 * (e0[i] & 1), 2 * (e1[i] & 1)
                            v[i, h0:h0 + 2] = val[c, i]
                            u[i, h1:h1 + 2] = val[c + 4, i]
                            if both[i]:
                                v[i, h1:h1 + 2] = val[c + 4, i]
                        for key, vals in (
                                (np.where(ok[c], e0 >> 1, EMPTY), v),
                                (np.where(~both & ok[c + 4], e1 >> 1,
                                          EMPTY), u)):
                            for k, s in _warp_sums(key, vals):
                                dt[l, 2 * k:2 * k + 2] += s.reshape(2, 2)
                    continue
                for c in range(8):
                    for k, s in _warp_sums(np.where(ok[c], ic[c], EMPTY),
                                           val[c]):
                        if regime == the.STAGED:
                            if k < size:
                                acc[k] += s
                            else:
                                dt[l, k] += s
                            continue
                        slot = ((k * 2654435761) & 0xFFFFFFFF) >> (
                            32 - (size.bit_length() - 1))
                        for _ in range(MAP_PROBES):
                            if keys[slot] in (EMPTY, k):
                                keys[slot] = k
                                acc[slot] += s
                                break
                            slot = (slot + 1) & (size - 1)
                        else:
                            dt[l, k] += s
                            overflow += 1
            if regime == the.STAGED:
                dt[l, :size] += acc[:size]
            elif regime == the.MAP:
                for slot in np.flatnonzero(keys != EMPTY):
                    dt[l, keys[slot]] += acc[slot]
    return dt, overflow


def _jax_grad64(idx, w, g, t):
    """JAX `hash_encode_xla`'s table gradient for the same f32 corners,
    evaluated in float64: the exact sum of the same f32 products, which
    any f32 summation order rounds."""
    with jax.enable_x64(True):
        table = jnp.zeros((idx.shape[0], t, 2), jnp.float64)
        return np.asarray(jax.grad(lambda tab: jnp.sum(
            jhe.hash_encode_xla(tab, jnp.asarray(idx),
                                jnp.asarray(w, jnp.float64))
            * jnp.asarray(g, jnp.float64)))(table))


def _bwd_case(name):
    """(idx, w, g, t, plan) of one emulation case: points clustered on a
    few rays' worth of cells (hot coarse levels) and spread (sparse fine
    levels)."""
    levels = 6
    if name == "idx_mode_invalid":
        rng = np.random.RandomState(9)
        t, n = 1 << 14, 1100
        idx = rng.randint(0, t, (levels, 8, n)).astype(np.int32)
        idx[:, :, :40] = rng.randint(0, 16, (levels, 8, 40))  # shared
        idx[0, 1, 50:60] = -1                # out of range: no gradient
        idx[2, 5, 60:70] = t + 7
        w = rng.rand(levels, 8, n).astype(np.float32)
        return idx, w, rng.randn(n, levels, 2).astype(np.float32), t, \
            the.bwd_plan((None,) * levels, t)
    log2t, n, base, finest = {
        "default_geometry": (19, 1300, 16, FINEST),
        "staged_2_12": (12, 4500, 16, FINEST),
        "map_overflow": (14, 1200, 4, 2000.0)}[name]
    t = 1 << log2t
    x = _points({"default_geometry": 0, "staged_2_12": 1,
                 "map_overflow": 2}[name], n)
    x[40:600] = 0.5 + 0.01 * np.linspace(0, 1, 560)[:, None]   # a "ray"
    res = tuple(level_resolutions(levels, base, finest))
    idx, w = the.corner_indices_weights_ngp(torch.from_numpy(x), res, t)
    plan = the.bwd_plan(res, t)
    if name == "map_overflow":
        # a 64-slot map for 1,024 points a block: most updates overflow
        plan = the.BwdPlan(
            tuple(the.MAP if r <= 200 else the.DIRECT for r in res),
            tuple(1024 if r <= 200 else 256 for r in res),
            tuple(64 if r <= 200 else 0 for r in res))
    g = np.random.RandomState(5).randn(n, levels, 2).astype(np.float32)
    return idx.numpy(), w.numpy(), g, t, plan


BWD_CASES = ["default_geometry", "staged_2_12", "map_overflow",
             "idx_mode_invalid"]


@pytest.mark.parametrize("case", BWD_CASES)
def test_emulated_schedule_matches_jax_grad(case):
    idx, w, g, t, plan = _bwd_case(case)
    dt, overflow = emulate_bwd(idx, w, g, t, plan)
    valid = (idx >= 0) & (idx < t)
    ref = _jax_grad64(np.where(valid, idx, 0), np.where(valid, w, 0), g, t)
    assert ref.dtype == np.float64
    np.testing.assert_allclose(dt, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    # each case exercises what it is named for
    regimes = set(plan.regime)
    if case == "default_geometry":
        assert regimes == {the.MAP, the.DIRECT}
    if case == "staged_2_12":
        assert regimes == {the.STAGED} and len(g) > the.STAGED_POINTS
    if case == "map_overflow":
        assert overflow > 0 and the.DIRECT in regimes
    if case == "idx_mode_invalid":
        assert regimes == {the.MAP} and not valid.all()


def test_kernel_wrappers_take_only_cuda_tensors():
    """The points-mode kernel wrappers never run on CPU tensors (the entry
    point takes the plain version there) and count no launch; features != 2
    and tables that are not a power of two have no kernel."""
    x, res, table, g = _inputs(0, 64, 2, 8)
    x, table, g = (torch.from_numpy(a) for a in (x, table, g))
    with pytest.raises(ValueError, match="CUDA"):
        the.hash_encode_ngp_fwd_kernel(table, x, res)
    with pytest.raises(ValueError, match="CUDA"):
        the.hash_encode_ngp_bwd_kernel(g, x, res, tuple(table.shape))
    with pytest.raises(ValueError, match="features=2"):
        the.hash_encode_ngp_fwd_kernel(torch.zeros((2, 256, 4)), x, res)
    with pytest.raises(ValueError, match="power-of-two"):
        the.hash_encode_ngp_bwd_kernel(g, x, res, (2, 300, 2))
    assert not any(the.launches.values())
