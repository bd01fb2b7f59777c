"""The generic fused MLP's backward on the tensor cores (the ft_ kernels of
csrc/fused_mlp_gen.cu), held on the CPU before any card runs it: the
three-part bf16 split of f32 (`split_bf16x3`), a six-product matmul with
f32 accumulation emulated against plain f32, the whole f32 backward with
its products emulated that way under phase 20's gates (each side against
float64 with its own ReLU masks), `gen_bwd_plan` against the constants of
the CUDA source, and the weight stages `gen_ring` packs. Seeded numpy
inputs and weights (through `convert.fused_weights`); the plain backward
that (c) is held beside stays held against JAX's."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.ops import fused_mlp as jfm
from spinnerf_tpu_torch import convert
from spinnerf_tpu_torch.ops import fused_mlp as tfm

torch.set_num_threads(1)

CSRC = Path(tfm.__file__).resolve().parents[1] / "csrc" / "fused_mlp_gen.cu"
# the six products of one k16 step, (A's part, B's part), smallest first
ORDER = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _parts(x):
    return [p.double() for p in tfm.split_bf16x3(x)]


def _six(a, b, stage=64):
    """a [M, K] @ b [K, N] as pass 1 computes it: both split in three bf16
    parts; each k16 step's six products (exact, summed in float64: 16
    products of 8-bit significands) added to an f32 accumulator that a
    stage of 64 starts afresh; the stages added in f32."""
    pa, pb = _parts(a), _parts(b)
    total = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for s0 in range(0, a.shape[1], stage):
        acc = torch.zeros_like(total)
        for k0 in range(s0, min(s0 + stage, a.shape[1]), 16):
            for qa, qb in ORDER:
                acc = (acc.double() + pa[qa][:, k0:k0 + 16]
                       @ pb[qb][k0:k0 + 16]).float()
        total = total + acc
    return total


def _six_dw(a, g):
    """a^T g over the points (rows) as pass 2 computes it: each stage of 64
    points as `_six`'s one stage, added to a float64 sum."""
    total = torch.zeros(a.shape[1], g.shape[1], dtype=torch.float64)
    for p0 in range(0, a.shape[0], 64):
        total += _six(a[p0:p0 + 64].t(), g[p0:p0 + 64]).double()
    return total.float()


@pytest.mark.parametrize("seed", [0, 1])
def test_split_bf16x3_is_exact(seed):
    """(a) hi + mid + lo == x bit for bit for |x| from 2^-100 to 2^100 of
    either sign (every f32 significand pattern at random exponents), and
    ±0 to a zero; each part a bf16 value, each at most 2^-8 of the part
    before."""
    rng = np.random.RandomState(seed)
    n = 50000
    bits = (rng.randint(0, 1 << 23, n).astype(np.uint32)
            | (rng.randint(127 - 100, 127 + 101, n).astype(np.uint32) << 23)
            | (rng.randint(0, 2, n).astype(np.uint32) << 31))
    x = np.concatenate([bits.view(np.float32), np.float32(
        [0.0, -0.0, 2.0 ** -100, -2.0 ** 100, 1.0, -1.0, np.pi])])
    t = torch.from_numpy(x)
    hi, mid, lo = tfm.split_bf16x3(t)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, t.double())
    nz = t != 0             # -0 splits to parts that sum to +0
    assert torch.equal(total.float().view(torch.int32)[nz],
                       t.view(torch.int32)[nz])
    for a, b in ((hi, mid), (mid, lo)):
        assert bool((b.double().abs() <= a.double().abs() * 2.0 ** -8).all())
    # a bf16 value: its f32 bits end in 16 zeros
    for part in (hi, mid, lo):
        assert int((part.float().view(torch.int32) & 0xFFFF).abs().max()) == 0


@pytest.mark.parametrize("k", [128, 256, 512])
def test_six_product_matmul_within_twice_f32(k):
    """(b) the six-product matmul with f32 accumulation lies within 2 x the
    plain f32 matmul's error against float64 (relative to max |value|)."""
    rng = np.random.RandomState(k)
    a = torch.from_numpy(rng.randn(96, k).astype(np.float32))
    b = torch.from_numpy((rng.randn(k, 80) / np.sqrt(k)).astype(np.float32))
    ref = a.double() @ b.double()
    err_six, err_f32 = _rel(_six(a, b), ref), _rel(a @ b, ref)
    assert err_six <= 2 * err_f32, (err_six, err_f32)


def _dims():
    return tfm.dims_for_field(multires=4, multires_views=2, width=64,
                              depth=3, skip=1)._replace(
                                  compute_dtype="float32")


def _seeded(dims, seed, p):
    """Seeded numpy weights (lecun-normal on the unpadded fan-in, padding
    rows zero, biases non-zero) through `convert.fused_weights`, points
    and a cotangent."""
    rng = np.random.RandomState(seed)
    raw_x = 3 * (1 + 2 * dims.multires)
    raw_d = 3 * (1 + 2 * dims.multires_views)
    jw = {}
    for n, shape in tfm.weight_shapes(dims).items():
        if n.endswith("_b") or n.startswith("tb"):
            jw[n] = (rng.randn(*shape) * 0.1).astype(np.float32)
            continue
        w = rng.randn(*shape).astype(np.float32)
        if n == "tw0":
            w[raw_x:] = 0.0
        elif n == f"tw{dims.skip + 1}" and shape[0] > dims.width:
            w[raw_x:dims.in_dim] = 0.0
        elif n == "view_w":
            w[dims.width + raw_d:] = 0.0
        fan_in = int(np.count_nonzero(np.abs(w).sum(1)))
        jw[n] = w / np.float32(np.sqrt(max(fan_in, 1)))
    xd = np.zeros((p, 8), np.float32)
    xd[:, :3] = rng.randn(p, 3) * 1.5
    vd = rng.randn(p, 3)
    xd[:, 3:6] = vd / np.linalg.norm(vd, axis=-1, keepdims=True)
    g = rng.randn(p, 4 + dims.out_extra).astype(np.float32)
    return jw, convert.fused_weights(jw), xd, g


def _emulated_backward(w, x, d, g, dims, pre):
    """The tensor-core backward's f32 arithmetic on the CPU, as the kernels
    order it: the recompute and the back-propagation through `_six`, the
    weight gradients through `_six_dw`, the bias sums in float64, the rgb
    head's gradient and the heads' terms in f32. Returns (weight gradients
    in `_weight_order`, dx, dd, its own ReLU masks)."""
    sk = dims.skip + 1 < dims.depth
    acts, zs, h = [], [], x
    for i in range(dims.depth):
        a = (x if i == 0 else torch.cat([x, h], 1) if sk and i == dims.skip + 1
             else h)
        acts.append(a)
        zs.append(_six(a, w[f"tw{i}"]) + w[f"tb{i}"])
        h = torch.relu(zs[-1])
    hl = h
    hv = torch.cat([_six(hl, w["feat_w"]) + w["feat_b"], d], 1)
    vz = _six(hv, w["view_w"]) + w["view_b"]
    v = torch.relu(vz)
    out = {"rgb_w": _six_dw(v, g[:, :3]),
           "sigma_w": _six_dw(hl, g[:, 3:4])}
    col = {"rgb_b": g[:, :3].double().sum(0, keepdim=True).float(),
           "sigma_b": g[:, 3:4].double().sum(0, keepdim=True).float()}
    g_v = (g[:, :3] @ w["rgb_w"].t()) * (vz > 0)
    out["view_w"] = _six_dw(hv, g_v)
    col["view_b"] = g_v.double().sum(0, keepdim=True).float()
    g_hv = _six(g_v, w["view_w"].t() if pre else w["view_w"][:dims.width].t())
    g_feat, dd = g_hv[:, :dims.width], (g_hv[:, dims.width:] if pre else None)
    out["feat_w"] = _six_dw(hl, g_feat)
    col["feat_b"] = g_feat.double().sum(0, keepdim=True).float()
    g_h = _six(g_feat, w["feat_w"].t()) + g[:, 3:4] * w["sigma_w"].t()
    dx = torch.zeros_like(x)
    for i in range(dims.depth - 1, -1, -1):
        if i == dims.skip and sk:
            if pre:
                dx = dx + g_h[:, :dims.in_dim]
            g_h = g_h[:, dims.in_dim:]
        g_z = g_h * (zs[i] > 0)
        out[f"tw{i}"] = _six_dw(acts[i], g_z)
        col[f"tb{i}"] = g_z.double().sum(0, keepdim=True).float()
        if i > 0 or pre:
            g_h = _six(g_z, w[f"tw{i}"].t())
    out.update(col)
    masks = ([z > 0 for z in zs], vz > 0)
    return ({n: out[n] for n in tfm._weight_order(dims)},
            dx + g_h if pre else None, dd, masks)


def _flips(a, b):
    out = a[1].ne(b[1]).any(1)
    for x, y in zip(a[0], b[0]):
        out |= x.ne(y).any(1)
    return int(out.sum())


def _own_masks(w, x, d, dims, dt):
    _, zs, _, _, vz, _ = tfm._forward_acts(w, x, d, dims, dt)
    return [z > 0 for z in zs], vz > 0


@pytest.mark.parametrize("pre", [False, True])
def test_emulated_f32_backward_holds_phase_20s_gates(pre):
    """(c) the whole f32 backward at depth 3, width 64, its products
    emulated as the tensor cores take them: every gradient (v1: also dx,
    dd) within 2 x the plain f32 version's error against float64, each
    side against the float64 evaluation with its own ReLU masks; the points
    whose masks differ from float64's at most max(4 x plain's, P / 1000).
    The plain f32 backward held beside it matches JAX's (1e-5, as
    tests/test_torch_fused_mlp_geom.py)."""
    dims = _dims()
    p = 256
    jw, w, xd, g_np = _seeded(dims, 5 + pre, p)
    xd_t, g = torch.from_numpy(xd), torch.from_numpy(g_np)
    x, d = tfm._encodings(xd_t, dims)

    def plain(dt, masks=None):
        if pre:
            res = tfm.fused_mlp_bwd_plain(w, x, d, g, dims, dt, masks=masks)
            return dict(res[0], dx=res[1], dd=res[2])
        return tfm.fused_mlp_pe_bwd_plain(w, xd_t, g, dims, dt, masks=masks)

    emu = _emulated_backward(w, x, d, g, dims, pre)
    got = dict(emu[0], **({"dx": emu[1], "dd": emu[2]} if pre else {}))
    m_p = _own_masks(w, x, d, dims, torch.float32)
    m_64 = _own_masks(w, x, d, dims, torch.float64)
    flips = {"kernel": _flips(emu[3], m_64), "plain": _flips(m_p, m_64)}
    assert flips["kernel"] <= max(4 * flips["plain"], p // 1000), flips
    ref_k, ref_p, res_p = plain(torch.float64, emu[3]), plain(
        torch.float64, m_p), plain(torch.float32)
    for n in ref_k:
        k_err, p_err = _rel(got[n], ref_k[n]), _rel(res_p[n], ref_p[n])
        assert k_err <= 2 * p_err, (n, k_err, p_err)

    # the plain backward against JAX's (its Pallas kernel in interpret mode)
    jdims = jfm.MLPDims(**dims._asdict())
    jws = {n: jnp.asarray(v) for n, v in jw.items()}
    if pre:
        _, vjp = jax.vjp(lambda ws, a, b: jfm.fused_mlp(jdims, 64, ws, a, b),
                         jws, jnp.asarray(x.numpy()), jnp.asarray(d.numpy()))
        jg, jdx, jdd = vjp(jnp.asarray(g_np))
        want = dict(jg, dx=jdx, dd=jdd)
    else:
        _, vjp = jax.vjp(lambda ws: jfm.fused_mlp_pe(jdims, 64, ws,
                                                     jnp.asarray(xd)), jws)
        (want,) = vjp(jnp.asarray(g_np))
    for n, v in want.items():
        assert _rel(res_p[n], torch.from_numpy(np.array(v))) < 1e-5, n


def _consts():
    src = CSRC.read_text()
    pairs = re.findall(r"#define ((?:FT|FG)_\w+) (\d+)\b", src)
    return {k: int(v) for k, v in pairs}


def test_gen_bwd_plan_mirrors_the_cuda_source():
    """(d) `_FT` holds the CUDA source's FT_ constants; the plan's shared
    memory is the source note's sum (slots x parts x 8 KB + 256 (wp + 8) +
    256 (max(in, dir) + 8) + 2,048 + 16 slots + 1,024) with the most slots
    (2-8) under 232,448; widths padded to 64; every width 8-512 taken with
    128-lane encodings in both types, f32 to 384 and bf16 to 512 with
    256-lane ones; wider ones left to the layer-streamed kernels."""
    c = _consts()
    for k in ("BM", "T", "PLANE", "PAD", "MIN_SLOTS", "MAX_SLOTS", "ALIGN"):
        assert tfm._FT[k] == c[f"FT_{k}"], k
    assert tfm._FT["SMEM_MAX"] == c["FG_SMEM_MAX"] == 232448
    assert c["FT_PLANE"] == 2 * c["FT_T"] * c["FT_T"]
    for dt, parts in (("float32", 3), ("bfloat16", 1)):
        for mr, e in ((10, 128), (21, 256)):
            top = {("float32", 128): 512, ("float32", 256): 384,
                   ("bfloat16", 128): 640, ("bfloat16", 256): 512}[dt, e]
            for width in list(range(8, top + 1, 8)) + [top + 64, 1024, 2048]:
                dims = tfm.dims_for_field(multires=mr, width=width)._replace(
                    compute_dtype=dt)
                if tfm.route(dims) != "gen":
                    continue
                plan = tfm.gen_bwd_plan(dims)
                if width > top:
                    assert plan is None, (dt, e, width)
                    continue
                wp, vwp = -(-width // 64) * 64, -(-(width // 2) // 64) * 64
                assert (plan["parts"], plan["wp"], plan["vwp"]) == (parts, wp,
                                                                    vwp)

                def smem(s):
                    return (s * parts * 8192 + 256 * (wp + 8) + 256 * (e + 8)
                            + 2048 + 16 * s + 1024)

                s = plan["slots"]
                assert plan["smem"] == smem(s) <= 232448
                assert s == 8 or smem(s + 1) > 232448
                assert plan["ring_bytes"] == plan["stages"] * parts * 8192


def test_gen_bwd_plan_products_and_stages():
    """(d) the products at the reference's 8 x 256 in f32: the recompute
    (8 trunk layers, the skip layer on [x, h]), the view layer on [feat,
    d], then the gradients down to layer 1 (v2) or 0 (v1, dx), and their
    weight stages, 292 / 312 (7.2 / 7.7 MB)."""
    dims = tfm.dims_for_field()._replace(compute_dtype="float32")
    for pre, stages in ((False, 292), (True, 312)):
        plan = tfm.gen_bwd_plan(dims, pre)
        kinds = [k for k, *_ in plan["products"]]
        assert kinds == (["trunk"] * 8 + ["feat", "view", "gfeat", "gtop"]
                         + ["gtrunk"] * (8 if pre else 7))
        assert plan["products"][5] == ("trunk", 5, 6, 2, True, 256)
        assert plan["products"][9] == ("view", 0, 6, 2, False, 128)
        assert plan["stages"] == stages
        assert plan["ring_bytes"] == stages * 3 * 8192
    assert tfm.gen_bwd_plan(tfm.dims_for_field()) is None     # wgmma route


def _unswizzle(stage):
    sw = torch.from_numpy(tfm._ft_swizzle())
    return stage[sw].view(64, 64)


@pytest.mark.parametrize("dtype,pre", [("float32", False), ("float32", True),
                                       ("bfloat16", True)])
def test_gen_ring_stages(dtype, pre):
    """(e) `gen_ring`: its parts sum to each weight exactly (f32) or are
    the weight's bf16 rounding (bf16, as the plain version rounds); taken
    in the producer's order (output-tile pairs, chunks, the pair's tiles) and
    unswizzled, the stages rebuild each product's matrix: the recompute's
    layers transposed, the back-propagation's as they are, zero in the
    padding, [x, h] and [feat, d] in the kernel's chunk order."""
    dims = tfm.dims_for_field(multires=4, multires_views=2, width=72,
                              depth=4, skip=1)._replace(compute_dtype=dtype)
    _, w, _, _ = _seeded(dims, 11, 64)
    plan = tfm.gen_bwd_plan(dims, pre)
    ring = tfm.gen_ring(w, dims, pre)
    assert ring.dtype == torch.bfloat16 and ring.numel() * 2 == plan[
        "ring_bytes"]
    parts = ring.view(plan["stages"], plan["parts"], 4096).double()
    vals = parts.sum(1)
    r = tfm._rounding(dims, torch.float32)
    wp, vwp, e, ed = plan["wp"], plan["vwp"], dims.in_dim, dims.dir_dim
    W, VW = dims.width, dims.view_width

    def pad(m, rows, cols):
        out = torch.zeros(rows, cols, dtype=torch.float64)
        out[:m.shape[0], :m.shape[1]] = m.double()
        return out

    def expected(kind, i, n):
        rw = {k: r(v) for k, v in w.items()}
        if kind in ("trunk", "gtrunk"):
            tw = rw[f"tw{i}"]
            if i == 0:
                m = pad(tw, e, wp)
            elif tw.shape[0] > W:       # [x, h]
                m = torch.cat([pad(tw[:e], e, wp), pad(tw[e:], wp, wp)])
            else:
                m = pad(tw, wp, wp)
            if kind == "trunk":
                return m.t()
            if not pre:
                m = m[e:] if tw.shape[0] > W else m
            return m
        if kind in ("feat", "gtop"):
            m = pad(rw["feat_w"], wp, wp)
            return m.t() if kind == "feat" else m
        vw_ = torch.cat([pad(rw["view_w"][:W], wp, vwp),
                         pad(rw["view_w"][W:], ed, vwp)])
        if kind == "view":
            return vw_.t()
        return vw_ if pre else vw_[:wp]

    s = 0
    for kind, i, nk, nx, x_first, n in plan["products"]:
        nt = n // 64
        got = torch.zeros(n, nk * 64, dtype=torch.float64)
        for tp in range((nt + 1) // 2):
            for kc in range(nk):
                for wg in range(min(2, nt - 2 * tp)):
                    t = 2 * tp + wg
                    got[64 * t:64 * t + 64, 64 * kc:64 * kc + 64] = \
                        _unswizzle(vals[s])
                    s += 1
        assert torch.equal(got, expected(kind, i, n)), (kind, i)
    assert s == plan["stages"]
    if dtype == "bfloat16":
        assert plan["parts"] == 1
    else:
        hi = ring.view(plan["stages"], 3, 4096)[:, 0]
        assert torch.equal(hi, vals.float().to(torch.bfloat16))
        assert torch.equal(torch.stack(tfm.split_bf16x3(vals.float()), 1),
                           ring.view(plan["stages"], 3, 4096))
