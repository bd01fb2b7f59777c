"""The generic fused MLP's layer-streamed kernels (the ls_ kernels of
csrc/fused_mlp_gen.cu), held on the CPU before any card runs them: the
route each direction takes over a grid spanning `GEN_LIMITS` (the fused
tensor-core kernels or the layer-streamed ones, exactly one, and nothing
else); `gen_layer_plan` against the constants, the shared-memory sum and
the product order of the CUDA source; the weight stages `gen_ls_ring`
packs; and the route's f32 arithmetic emulated on the CPU from those
stages and that product order (operand parts stored between layers, six
exact bf16 products a k16 step in a fresh accumulator added to an f32 sum,
the weight gradients' 64-point stages added in float64), held against
JAX's `fused_mlp_pe` / `fused_mlp` (their Pallas kernels in interpret
mode) and against float64 under phase 20's gates. Seeded numpy weights
through `convert.fused_weights`."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from spinnerf_tpu.ops import fused_mlp as jfm
from spinnerf_tpu_torch import convert
from spinnerf_tpu_torch.ops import fused_mlp as tfm

torch.set_num_threads(1)

CSRC = Path(tfm.__file__).resolve().parents[1] / "csrc" / "fused_mlp_gen.cu"
# the six products of one k16 step, (A's part, B's part), smallest first
ORDER = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]


def _rel(a, b):
    a, b = torch.as_tensor(np.asarray(a)).double(), torch.as_tensor(
        np.asarray(b)).double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _dims(dtype, width, multires=10, depth=8, skip=4, views=4,
          semantic=False):
    return tfm.dims_for_field(multires=multires, multires_views=views,
                              width=width, depth=depth, skip=skip,
                              semantic=semantic)._replace(compute_dtype=dtype)


def _source():
    src = CSRC.read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"#define ((?:LS|FT|FG)_\w+) (\d+)\b", src)}
    return src, consts


# -----------------------------------------------------------------------------
# the route and the plan
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("multires", [10, 21], ids=["enc128", "enc256"])
def test_every_geometry_takes_one_kernel_set(dtype, multires, pre):
    """Over widths 8-2,048 (every multiple of 8 to 1,024, then of 64) at
    depths 1, 3, 8 and 32 with and without the skip layer: each direction
    of every geometry on the generic route takes exactly one of the fused
    tensor-core kernels (`gen_fwd_plan`, `gen_bwd_plan`) and the
    layer-streamed ones (`gen_layer_plan`), whose keys are the only
    generic counters; the layer-streamed forward takes f32 width 1,024 and
    512, its backward f32 width 1,024 (the bound's geometries)."""
    assert set(tfm.launches_gen) == set(tfm.launches_gen_v1) == {
        "fwd_tc", "fwd_ls", "bwd_tc", "bwd_ls"}
    widths = list(range(8, 1025, 8)) + list(range(1088, 2049, 64))
    seen = {"tc": 0, "ls": 0}
    for depth, skip in ((1, 4), (3, 1), (8, 4), (32, 4)):
        for width in widths:
            dims = _dims(dtype, width, multires=multires, depth=depth,
                         skip=skip)
            if tfm.route(dims, pre) != "gen":
                continue
            for forward in (True, False):
                fused = (tfm.gen_fwd_plan if forward
                         else tfm.gen_bwd_plan)(dims, pre)
                ls = tfm.gen_layer_plan(dims, pre, forward)
                assert (fused is None) != (ls is None), (depth, width,
                                                         forward)
                seen["tc" if ls is None else "ls"] += 1
                if ls is not None:
                    assert len(ls["products"]) == (
                        depth + 2 if forward else
                        len(tfm._ls_products(dims, pre, ls["wp"],
                                             ls["vwp"])))
    assert seen["tc"] > 100 and seen["ls"] > 100, seen
    for width, forward in ((1024, True), (1024, False), (512, True)):
        dims = _dims("float32", width)
        assert tfm.gen_layer_plan(dims, pre, forward) is not None
    assert tfm.gen_layer_plan(tfm.dims_for_field(), pre) is None   # wgmma


def test_layer_plan_mirrors_the_cuda_source():
    """`_LS` holds the CUDA source's LS_ constants; the plan's shared
    memory is `ls_smem`'s expression (slots x parts x (2 x 8 KB + 16 KB) +
    16 slots + 1,024) with the most slots (2-8) under 232,448: 2 at f32, 7
    at bf16; `ls_geom` refuses exactly what the fused kernels take and runs
    the forward's first depth + 2 products; the product kinds come in the
    order of the source's `ls_products`."""
    src, c = _source()
    assert set(tfm._LS) == {"BN", "T", "APLANE", "BPLANE", "MIN_SLOTS",
                            "MAX_SLOTS"}
    for k in tfm._LS:
        assert tfm._LS[k] == c[f"LS_{k}"], k
    assert c["LS_APLANE"] == 2 * c["LS_T"] * c["LS_T"]
    assert c["LS_BPLANE"] == 2 * c["LS_BN"] * c["LS_T"]
    m = re.search(r"static int ls_smem\(int np, int slots\) \{\s*return "
                  r"(.*?);\s*\}", src, re.S)
    expr = " ".join(m.group(1).split())
    assert re.fullmatch(r"[\w\s()*+]+", expr), expr

    def smem(**kw):
        return eval(expr, {}, dict(c, **kw))

    for dt, parts, slots in (("float32", 3, 2), ("bfloat16", 1, 7)):
        plan = tfm.gen_layer_plan(_dims(dt, 1024))
        assert (plan["parts"], plan["slots"]) == (parts, slots)
        assert plan["smem"] == smem(np=parts, slots=slots) <= 232448
        assert slots == c["LS_MAX_SLOTS"] or smem(np=parts,
                                                  slots=slots + 1) > 232448
        assert plan["ring_bytes"] == plan["stages"] * parts * 16384
    geom = re.search(r"static int ls_geom\(.*?\n\}", src, re.S).group(0)
    assert ("if (forward ? ft_fwd_geom(p, &F) : ft_geom(p, pre, &F)) "
            "return 0;") in geom
    assert "G->n_prods = forward ? p->depth + 2 : all;" in geom
    body = re.search(r"static int ls_products\(.*?\n\}", src, re.S).group(0)
    kinds_c = [k.lower() for k in re.findall(r"add\(LS_(\w+),", body)]
    py = Path(tfm.__file__).read_text()
    body_py = re.search(r"def _ls_products\(.*?\n    return out", py,
                        re.S).group(0)
    kinds_py = re.findall(r'add\("(\w+)",', body_py)
    assert kinds_c == kinds_py == ["trunk"] * 3 + [
        "feat", "view", "gfeat", "dd", "gtop", "dx", "gtrunk", "dx"]


def test_layer_plan_products_and_stages():
    """The products at f32 8 x 1,024 (view width 512): the recompute (the
    skip layer on [x, h] in 18 chunks), the view layer on [feat, d], then
    from G_v in h0 the gradients down to layer 1 in alternate buffers, v1
    with dd and dx's two products; 1,128 forward stages, 2,216 / 2,256
    backward (v2 / v1), each 48 KB (108 / 110 MB)."""
    dims = _dims("float32", 1024)
    fwd = tfm.gen_layer_plan(dims, forward=True)
    assert fwd["stages"] == 1128 and len(fwd["products"]) == 10
    for pre, stages in ((False, 2216), (True, 2256)):
        plan = tfm.gen_layer_plan(dims, pre)
        prods = plan["products"]
        assert prods[:10] == fwd["products"]
        assert prods[0] == ("trunk", 0, 1024, 8, 2, 2, "x", None, "h0")
        assert prods[5] == ("trunk", 5, 1024, 8, 18, 2, "x", "h0", "h1")
        assert prods[8] == ("feat", 0, 1024, 8, 16, 16, "h1", None, "h0")
        assert prods[9] == ("view", 0, 512, 4, 18, 16, "h0", "d", None)
        assert prods[10] == ("gfeat", 0, 1024, 8, 8, 8, "h0", None, "h1")
        kinds = [p[0] for p in prods[10:]]
        if pre:
            assert kinds == ["gfeat", "dd", "gtop", "gtrunk", "gtrunk",
                             "dx", "gtrunk", "gtrunk", "gtrunk", "gtrunk",
                             "gtrunk", "dx"]
            assert prods[11] == ("dd", 0, 128, 1, 8, 8, "h0", None, None)
            assert prods[-1] == ("dx", 0, 128, 1, 16, 16, "h1", None, None)
        else:
            assert kinds == ["gfeat", "gtop"] + ["gtrunk"] * 7
        # each gradient product reads the buffer the one before it wrote
        back = [p for p in prods[10:] if p[0] in ("gfeat", "gtop",
                                                  "gtrunk")]
        for a, b in zip(back, back[1:]):
            assert b[6] == a[8], (a, b)
        assert plan["stages"] == stages
        assert plan["ring_bytes"] == stages * 3 * 16384


def _seeded(dims, seed, p):
    """Seeded numpy weights (lecun-normal on the unpadded fan-in, padding
    rows zero, biases non-zero) as JAX takes them and through
    `convert.fused_weights`, points xd [p, 8] and a cotangent."""
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


def _stage_matrices(ring, plan):
    """Each product's B^T [N padded][K padded] rebuilt from the ring's
    stages (column tiles of 128, chunks of 64, unswizzled), as its parts
    (float64)."""
    sw = torch.from_numpy(tfm._ls_swizzle())
    st = ring.view(plan["stages"], plan["parts"], 8192).double()
    out, s = [], 0
    for prod in plan["products"]:
        ntn, nk = prod[3], prod[4]
        m = torch.zeros(plan["parts"], ntn * 128, nk * 64,
                        dtype=torch.float64)
        for tn in range(ntn):
            for kc in range(nk):
                m[:, 128 * tn:128 * tn + 128, 64 * kc:64 * kc + 64] = \
                    st[s][:, sw].view(-1, 128, 64)
                s += 1
        out.append(m)
    assert s == plan["stages"]
    return out


@pytest.mark.parametrize("dtype,pre", [("float32", False),
                                       ("float32", True),
                                       ("bfloat16", True)])
def test_ls_ring_stages(dtype, pre):
    """`gen_ls_ring` at width 520 (columns padded to 640, K to 576) with
    256-lane encodings, depth 4, skip 1, the semantic head: its parts sum
    to each weight exactly (f32) or are the weight's bf16 rounding (bf16);
    unswizzled in the producers' order (column tiles, chunks) they rebuild
    each product's matrix: the recompute's layers transposed, the
    back-propagation's as they are, zero in the padding, [x, h] and
    [feat, d] in the source's chunk order; the forward's ring is the
    backward's first stages."""
    dims = _dims(dtype, 520, multires=21, depth=4, skip=1, semantic=True)
    _, w, _, _ = _seeded(dims, 11, 64)
    plan = tfm.gen_layer_plan(dims, pre)
    ring = tfm.gen_ls_ring(w, dims, pre)
    assert ring.dtype == torch.bfloat16 and 2 * ring.numel() == plan[
        "ring_bytes"]
    fwd = tfm.gen_ls_ring(w, dims, pre, forward=True)
    assert torch.equal(fwd, ring[:fwd.numel()])
    r = tfm._rounding(dims, torch.float32)
    rw = {k: r(v).double() for k, v in w.items()}
    W, e, wp, vwp = dims.width, dims.in_dim, plan["wp"], plan["vwp"]

    def pad(m, rows, cols):
        out = torch.zeros(rows, cols, dtype=torch.float64)
        out[:m.shape[0], :m.shape[1]] = m
        return out

    cat = dims.skip + 1
    for prod, got in zip(plan["products"], _stage_matrices(ring, plan)):
        kind, i, _, ntn, nk = prod[:5]
        npad, kpad = ntn * 128, nk * 64
        if kind == "trunk":
            tw = rw[f"tw{i}"]
            k = (tw if i == 0 else torch.cat([tw[:e], pad(tw[e:], wp, W)])
                 if i == cat else pad(tw, wp, W))
            want = pad(k, kpad, npad).t()
        elif kind == "feat":
            want = pad(pad(rw["feat_w"], wp, W), kpad, npad).t()
        elif kind == "view":
            vw_ = rw["view_w"]
            want = pad(torch.cat([pad(vw_[:W], wp, vw_.shape[1]),
                                  vw_[W:]]), kpad, npad).t()
        elif kind == "gfeat":
            want = pad(rw["view_w"][:W], npad, kpad)
        elif kind == "dd":
            want = pad(rw["view_w"][W:], npad, kpad)
        elif kind == "gtop":
            want = pad(rw["feat_w"], npad, kpad)
        elif kind == "gtrunk":
            tw = rw[f"tw{i}"]
            want = pad(tw[e:] if i == cat else tw, npad, kpad)
        else:
            want = pad(rw[f"tw{i}"][:e], npad, kpad)
        assert torch.equal(got.sum(0), want), (kind, i)
        if dtype == "float32":
            assert torch.equal(
                torch.stack(tfm.split_bf16x3(want.float())).double(), got)


# -----------------------------------------------------------------------------
# the arithmetic, emulated
# -----------------------------------------------------------------------------

def _k16(pa, pb):
    """a @ b from their parts (float64, [M, K] and [K, N]) as the kernel
    sums it: each k16 step's products (`ORDER`; one at bf16) added to a
    fresh f32 accumulator (each product exact, its 16 terms summed in
    float64), the steps in order into an f32 sum."""
    order = ORDER if len(pa) == 3 else [(0, 0)]
    total = torch.zeros(pa[0].shape[0], pb[0].shape[1], dtype=torch.float32)
    for k0 in range(0, pa[0].shape[1], 16):
        acc = torch.zeros_like(total)
        for qa, qb in order:
            acc = (acc.double() + pa[qa][:, k0:k0 + 16]
                   @ pb[qb][k0:k0 + 16]).float()
        total = total + acc
    return total


def _parts(x):
    return [p.double() for p in tfm.split_bf16x3(x)]


def _dw(a, g):
    """a^T g over the points as ft_dw_kernel sums it: each stage of 64
    points through `_k16` (its steps' f32 sums), the stages added in
    float64."""
    total = torch.zeros(a.shape[1], g.shape[1], dtype=torch.float64)
    for p0 in range(0, a.shape[0], 64):
        total += _k16(_parts(a[p0:p0 + 64].t()),
                      _parts(g[p0:p0 + 64])).double()
    return total.float()


def _emulate(w, dims, x, d, g, pre, backward):
    """The layer-streamed kernels at f32 on the CPU, driven by
    `gen_layer_plan`'s products and `gen_ls_ring`'s stages: every operand
    buffer holds its values' three bf16 parts, each product sums over its
    segments' chunks through `_k16`, each epilogue is the kernel's (bias,
    ReLU; the heads as per-tile f32 partial sums added in tile order;
    G_v's 3-deep product, the heads' terms of the last trunk layer's G,
    the ReLU masks of the stored outputs). Returns the raw output, or (the
    weight gradients in `_weight_order` through `_dw` with float64 bias
    sums, dx, dd, the ReLU masks)."""
    plan = tfm.gen_layer_plan(dims, pre, forward=not backward)
    mats = _stage_matrices(tfm.gen_ls_ring(w, dims, pre,
                                           forward=not backward), plan)
    W, VW, D = dims.width, dims.view_width, dims.depth
    wp = plan["wp"]
    buf = {"x": x, "d": d}
    saved = {}             # the scratch: each layer's f32 output
    heads = {}
    dx = torch.zeros_like(x)
    dd = None

    def cols(a, n):
        return nn.functional.pad(a, (0, n - a.shape[1]))

    for pi, prod in enumerate(plan["products"]):
        kind, i, n, ntn, nk, nseg0, s0, s1, dst = prod
        if pi == D + 2:     # the cotangent: G_v into h0
            gv = (g[:, :3] @ w["rgb_w"].t()) * (saved["v"] > 0)
            saved["gv"] = gv
            buf["h0"] = gv
        a = buf[s0][:, :nseg0 * 64]
        if s1:
            a = torch.cat([a, buf[s1][:, :(nk - nseg0) * 64]], 1)
        b = mats[pi]
        z = _k16(_parts(cols(a, nk * 64)), [m.t() for m in b])[:, :n]
        out = None
        if kind == "trunk":
            out = torch.relu(z + w[f"tb{i}"])
            saved[f"h{i}"] = out
            if i == D - 1 and not backward:
                heads["sigma"] = [out[:, t:t + 128] @ w["sigma_w"][t:t + 128]
                                  for t in range(0, W, 128)]
                if dims.out_extra:
                    heads["sem"] = [out[:, t:t + 128]
                                    @ w["sem_w"][t:t + 128]
                                    for t in range(0, W, 128)]
        elif kind == "feat":
            out = z + w["feat_b"]
            saved["feat"] = out
        elif kind == "view":
            v = torch.relu(z + w["view_b"])
            saved["v"] = v
            heads["rgb"] = [v[:, t:t + 128] @ w["rgb_w"][t:t + 128]
                            for t in range(0, VW, 128)]
        elif kind == "gfeat":
            out = saved["gfeat"] = z
        elif kind == "dd":
            dd = z
        elif kind == "gtop":
            s = z + g[:, 3:4] * w["sigma_w"].t()
            if dims.out_extra:
                s = s + g[:, 4:5] * w["sem_w"].t()
            out = saved[f"gz{D - 1}"] = s * (saved[f"h{D - 1}"] > 0)
        elif kind == "gtrunk":
            out = saved[f"gz{i - 1}"] = z * (saved[f"h{i - 1}"] > 0)
        else:
            dx = dx + z
        if dst:
            buf[dst] = cols(out, wp)
    if not backward:
        parts = [heads["rgb"], heads["sigma"]] + (
            [heads["sem"]] if dims.out_extra else [])
        total = []
        for tiles in parts:
            acc = torch.zeros_like(tiles[0])
            for t in tiles:
                acc = acc + t
            total.append(acc)
        bias = torch.cat([w["rgb_b"], w["sigma_b"]] + (
            [w["sem_b"]] if dims.out_extra else []), 1)
        return torch.cat(total, 1) + bias
    cat = dims.skip + 1 if dims.skip + 1 < D else -1
    hl = saved[f"h{D - 1}"]
    grads = {"rgb_w": _dw(saved["v"], g[:, :3]),
             "sigma_w": _dw(hl, g[:, 3:4]),
             "view_w": _dw(torch.cat([saved["feat"], d], 1), saved["gv"]),
             "feat_w": _dw(hl, saved["gfeat"])}
    col = {"rgb_b": g[:, :3], "sigma_b": g[:, 3:4], "view_b": saved["gv"],
           "feat_b": saved["gfeat"]}
    if dims.out_extra:
        grads["sem_w"], col["sem_b"] = _dw(hl, g[:, 4:5]), g[:, 4:5]
    for i in range(D):
        a = (x if i == 0 else torch.cat([x, saved[f"h{i - 1}"]], 1)
             if i == cat else saved[f"h{i - 1}"])
        grads[f"tw{i}"] = _dw(a, saved[f"gz{i}"])
        col[f"tb{i}"] = saved[f"gz{i}"]
    for k, v in col.items():
        grads[k] = v.double().sum(0, keepdim=True).float()
    masks = ([saved[f"h{i}"] > 0 for i in range(D)], saved["v"] > 0)
    return ({k: grads[k] for k in tfm._weight_order(dims)},
            dx if pre else None, dd, masks)


def _ls_case(width, pre, seed):
    dims = _dims("float32", width, multires=10, depth=3, skip=1)
    jw, w, xd, g = _seeded(dims, seed, 256)
    xd_t, g_t = torch.from_numpy(xd), torch.from_numpy(g)
    x, d = tfm._encodings(xd_t, dims)
    return dims, jw, w, xd, xd_t, g, g_t, x, d


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("width", [640, 1024])
def test_emulated_forward_holds_against_jax_and_float64(width, pre):
    """The layer-streamed forward's f32 arithmetic (`_emulate`) at depth 3
    (the skip layer on [x, h]), 256 points, on v2's in-kernel encodings or
    v1's given ones: within 1e-5 (relative to max |raw|) of JAX's
    `fused_mlp_pe` / `fused_mlp` (interpret mode: two f32 evaluations of
    one function in other orders, the bound tests/test_torch_fused_mlp.py
    holds the plain version to) and, phase 20's gate, within 2 x the plain
    f32 version's error against the float64 evaluation."""
    dims, jw, w, xd, xd_t, _, _, x, d = _ls_case(width, pre, 40 + pre)
    assert tfm.gen_layer_plan(dims, pre, forward=True) is not None
    jdims = jfm.MLPDims(**dims._asdict())
    jws = {n: jnp.asarray(v) for n, v in jw.items()}
    if pre:
        want = jfm.fused_mlp(jdims, 64, jws, jnp.asarray(x.numpy()),
                             jnp.asarray(d.numpy()))
        plain = lambda dt: tfm.fused_mlp_fwd_plain(w, x, d, dims, dt)
    else:
        want = jfm.fused_mlp_pe(jdims, 64, jws, jnp.asarray(xd))
        plain = lambda dt: tfm.fused_mlp_pe_plain(w, xd_t, dims, dt)
    got = _emulate(w, dims, x, d, None, pre, backward=False)
    ref = plain(torch.float64)
    assert got.shape == (256, 4)
    assert _rel(got, np.array(want)) < 1e-5
    assert _rel(got, ref) <= 2 * _rel(plain(torch.float32), ref)


def _flips(a, b):
    out = a[1].ne(b[1]).any(1)
    for x, y in zip(a[0], b[0]):
        out |= x.ne(y).any(1)
    return int(out.sum())


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("width", [640, 1024])
def test_emulated_backward_holds_phase_20s_gates(width, pre):
    """The layer-streamed backward's f32 arithmetic (`_emulate`: pass 1's
    products and epilogues, then ft_dw_kernel's stages) at depth 3, 256
    points: every gradient (v1: also dx, dd) within 2 x the plain f32
    version's error against float64, each side against the float64
    evaluation with its own ReLU masks; the points whose masks differ from
    float64's at most max(4 x plain's, P / 1000); and within 1e-5 of JAX's
    gradients (its Pallas backward in interpret mode; two f32 evaluations
    of one function, as tests/test_torch_fused_mlp_geom.py holds the plain
    version)."""
    dims, jw, w, xd, xd_t, g_np, g, x, d = _ls_case(width, pre, 50 + pre)
    assert tfm.gen_layer_plan(dims, pre) is not None

    def plain(dt, masks=None):
        if pre:
            res = tfm.fused_mlp_bwd_plain(w, x, d, g, dims, dt, masks=masks)
            return dict(res[0], dx=res[1], dd=res[2])
        return tfm.fused_mlp_pe_bwd_plain(w, xd_t, g, dims, dt, masks=masks)

    grads, dx, dd, m_k = _emulate(w, dims, x, d, g, pre, backward=True)
    got = dict(grads, **({"dx": dx, "dd": dd} if pre else {}))

    def own(dt):
        _, zs, _, _, vz, _ = tfm._forward_acts(w, x, d, dims, dt)
        return [z > 0 for z in zs], vz > 0

    m_p, m_64 = own(torch.float32), own(torch.float64)
    flips = {"kernel": _flips(m_k, m_64), "plain": _flips(m_p, m_64)}
    assert flips["kernel"] <= max(4 * flips["plain"], 256 // 1000), flips
    ref_k, ref_p, res_p = (plain(torch.float64, m_k),
                           plain(torch.float64, m_p), plain(torch.float32))
    assert set(ref_k) == set(got)
    for n in ref_k:
        k_err, p_err = _rel(got[n], ref_k[n]), _rel(res_p[n], ref_p[n])
        assert k_err <= 2 * p_err, (n, k_err, p_err)

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
        assert _rel(got[n], np.array(v)) < 1e-5, n


def test_entries_refuse_cpu_tensors_at_wide_geometries():
    """At f32 8 x 1,024 (both directions layer-streamed) and f32 8 x 512
    (the forward alone), the forward and backward entries and the pass
    timers raise on CPU tensors before packing anything, and count
    nothing."""
    for c in (tfm.launches_gen, tfm.launches_gen_v1):
        c.update({k: 0 for k in c})
    for width in (1024, 512):
        dims = _dims("float32", width)
        w = {n: torch.zeros(s) for n, s in tfm.weight_shapes(dims).items()}
        xd, g = torch.zeros(64, 8), torch.zeros(64, 4)
        x, d = torch.zeros(64, 128), torch.zeros(64, 128)
        for call in (lambda: tfm.fwd_fn(w, (xd,), dims, pre=False),
                     lambda: tfm.fused_mlp_fwd_kernel(w, x, d, dims),
                     lambda: tfm.fused_mlp_pe_bwd_kernel(w, xd, g, dims),
                     lambda: tfm.fused_mlp_bwd_kernel(w, x, d, g, dims),
                     lambda: tfm.bwd_pass_fns(w, (x, d), g, dims, pre=True)):
            with pytest.raises(ValueError, match="CUDA"):
                call()
    zero = {"fwd_tc": 0, "fwd_ls": 0, "bwd_tc": 0, "bwd_ls": 0}
    assert tfm.launches_gen == tfm.launches_gen_v1 == zero


def test_ctypes_signatures_match_the_cuda_source():
    """`_gen_signatures` declares every `extern "C"` entry of the CUDA
    source with its parameters in order: a pointer (the struct, a device
    buffer, the stream, the sizes) where the source has one, a 64-bit
    integer for `long long`, a 32-bit one for `int` (ctypes passes an
    undeclared or mistyped pointer cut to 32 bits)."""
    import ctypes
    from types import SimpleNamespace

    src = CSRC.read_text()
    sigs = dict(re.findall(r'extern "C" (?:int|const char\*) (fg_\w+)\((.*?)\)'
                           r'\s*\{', src, re.S))
    names = [n for n in sigs]
    lib = SimpleNamespace(**{n: SimpleNamespace() for n in names})
    tfm._gen_signatures(lib)
    assert set(names) == {n for n in vars(lib)
                          if hasattr(getattr(lib, n), "argtypes")}
    for name, params in sigs.items():
        want = []
        for prm in " ".join(params.split()).split(","):
            kind = prm.strip().rsplit(" ", 1)[0]
            want.append("ptr" if "*" in prm else {"long long": "i64",
                                                  "int": "i32"}[kind])
        got = ["ptr" if t is ctypes.c_void_p or hasattr(t, "_type_")
               and issubclass(t, ctypes._Pointer) else
               {ctypes.c_longlong: "i64", ctypes.c_int: "i32"}[t]
               for t in getattr(lib, name).argtypes]
        assert got == want, name
