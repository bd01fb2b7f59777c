"""The generic fused MLP's forward on the tensor cores (`ft_fwd_kernel` of
csrc/fused_mlp_gen.cu), held on the CPU before any card runs it:
`gen_fwd_plan` against the arithmetic and constants of the CUDA source
(`ft_fwd_smem`, `ft_fwd_geom`), the forward's weight stages against the
first stages of the backward's ring, and the kernel's f32 arithmetic (six
exact bf16 products a k16 step, each step in a fresh f32 accumulator added
to an f32 sum) emulated on the CPU and held against JAX's `fused_mlp_pe` and
`fused_mlp` (their Pallas kernels in interpret mode) and against float64
under phase 20's gate. Seeded numpy weights through `convert.fused_weights`.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from spinnerf_tpu.ops import fused_mlp as jfm
from spinnerf_tpu_torch import convert
from spinnerf_tpu_torch.ops import fused_mlp as tfm
from spinnerf_tpu_torch.tools import fwd_variants

torch.set_num_threads(1)

CSRC = Path(tfm.__file__).resolve().parents[1] / "csrc" / "fused_mlp_gen.cu"
# the six products of one k16 step, (A's part, B's part), smallest first
ORDER = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _source_smem(name):
    """The return expression of `static int <name>(int np, int wp, int emax,
    int slots)` in the CUDA source, as a Python function of those four, its
    FT_ / FG_ constants read from the source's #defines."""
    src = CSRC.read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"#define ((?:FT|FG)_\w+) (\d+)\b", src)}
    m = re.search(rf"static int {name}\(int np, int wp, int emax, int slots\)"
                  r" \{\s*return (.*?);\s*\}", src, re.S)
    expr = " ".join(m.group(1).split())
    assert re.fullmatch(r"[\w\s()*+]+", expr), expr
    return lambda **kw: eval(expr, {}, dict(consts, **kw)), consts


def _dims(dtype, width, multires=10, depth=8, skip=4, views=4,
          semantic=False):
    return tfm.dims_for_field(multires=multires, multires_views=views,
                              width=width, depth=depth, skip=skip,
                              semantic=semantic)._replace(compute_dtype=dtype)


@pytest.mark.parametrize("forward", [True, False])
def test_plan_smem_is_the_cuda_sources_arithmetic(forward):
    """`gen_fwd_plan` (`gen_bwd_plan`) against `ft_fwd_smem` (`ft_smem`) of
    the CUDA source, its expression evaluated here: at every width 8-1,024
    in both types and with 128- and 256-lane encodings, the plan takes the
    most slots (2-8) whose bytes fit 232,448, or is None where 2 do not;
    the widths padded to 64, its parts 3 at f32 and 1 at bf16."""
    smem, c = _source_smem("ft_fwd_smem" if forward else "ft_smem")
    assert (tfm._FT["MIN_SLOTS"], tfm._FT["MAX_SLOTS"], tfm._FT["SMEM_MAX"],
            tfm._FT["PLANE"], tfm._FT["PAD"], tfm._FT["ALIGN"]) == (
        c["FT_MIN_SLOTS"], c["FT_MAX_SLOTS"], c["FG_SMEM_MAX"],
        c["FT_PLANE"], c["FT_PAD"], c["FT_ALIGN"])
    assert tfm._FT["FWD_TILES"] == c["FT_FWD_TILES"]
    plan_of = tfm.gen_fwd_plan if forward else tfm.gen_bwd_plan
    taken = 0
    for dt, parts in (("float32", 3), ("bfloat16", 1)):
        for mr, e in ((10, 128), (21, 256)):
            for width in range(8, 1025, 8):
                dims = _dims(dt, width, multires=mr)
                if tfm.route(dims) != "gen":
                    continue
                wp = -(-width // 64) * 64
                emax = max(e, 128)
                fit = [s for s in range(8, 1, -1)
                       if smem(np=parts, wp=wp, emax=emax, slots=s) <= 232448]
                plan = plan_of(dims)
                if not fit:
                    assert plan is None, (dt, e, width)
                    continue
                taken += 1
                assert (plan["parts"], plan["wp"], plan["slots"]) == (
                    parts, wp, fit[0]), (dt, e, width)
                assert plan["smem"] == smem(np=parts, wp=wp, emax=emax,
                                            slots=fit[0])
                assert plan["vwp"] == -(-(width // 2) // 64) * 64
                assert plan["ring_bytes"] == plan["stages"] * parts * 8192
    assert taken > 100


def test_fwd_plan_takes_phase_20s_cases():
    """Every configuration phase 20's trainers, `full_run --smoke --model
    mlp` and (a)1 run (f32 8 x 256 with and without the semantic head, bf16
    8 x 128, f32 2 x 32 at 4 / 2 octaves), v1 and v2, with the recompute's
    products of the CUDA source's `ft_fwd_geom` (the first depth + 2 of
    the backward's) and its limit of 2 x FT_FWD_TILES output tiles; f32 at
    width 1,024 (and 512) refused; the backward's plan takes whatever the
    forward's takes."""
    body = re.search(r"static int ft_fwd_geom\(.*?\n\}", CSRC.read_text(),
                     re.S).group(0)
    assert "pi < p->depth + 2" in body
    assert "G->wp > 2 * FT_FWD_TILES * FT_T" in body
    cases = [_dims("float32", 256), _dims("float32", 256, semantic=True),
             _dims("bfloat16", 128),
             _dims("float32", 32, multires=4, depth=2, views=2)]
    for dims in cases:
        for pre in (False, True):
            plan, bwd = tfm.gen_fwd_plan(dims, pre), tfm.gen_bwd_plan(dims,
                                                                     pre)
            assert plan is not None and bwd is not None, (dims, pre)
            assert plan["products"] == bwd["products"][:dims.depth + 2]
            assert plan["stages"] == sum(n // 64 * nk for _, _, nk, _, _, n
                                         in plan["products"])
    main = tfm.gen_fwd_plan(cases[0])
    assert (main["slots"], main["smem"], main["stages"]) == (2, 220192, 156)
    for width in (512, 1024):
        assert tfm.gen_fwd_plan(_dims("float32", width)) is None
    assert tfm.gen_fwd_plan(tfm.dims_for_field()) is None     # wgmma route


def _seeded(dims, seed, p):
    """Seeded numpy weights (lecun-normal on the unpadded fan-in, padding
    rows zero, biases non-zero) as JAX takes them and through
    `convert.fused_weights`, and points xd [p, 8]."""
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
    return jw, convert.fused_weights(jw), xd


@pytest.mark.parametrize("dtype,pre,width,depth", [
    ("float32", False, 256, 8), ("float32", True, 256, 8),
    ("float32", False, 72, 4), ("bfloat16", True, 128, 3)])
def test_forward_ring_is_the_backward_rings_prefix(dtype, pre, width, depth):
    """The forward's weight stages (`gen_ring_index(forward=True)`, built
    from `gen_fwd_plan`'s products) are the first `stages` rows of the
    backward's, and `gen_ring(forward=True)` packs exactly those rows of
    the backward's ring, parts and all."""
    dims = _dims(dtype, width, depth=depth, skip=1 if depth < 5 else 4)
    fwd = tfm.gen_ring_index(dims, pre, forward=True)
    bwd = tfm.gen_ring_index(dims, pre)
    plan = tfm.gen_fwd_plan(dims, pre)
    assert fwd.shape == (plan["stages"], 4096)
    assert bwd.shape[0] > plan["stages"]
    assert torch.equal(fwd, bwd[:plan["stages"]])
    _, w, _ = _seeded(dims, 3, 64)
    ring = tfm.gen_ring(w, dims, pre, forward=True)
    assert ring.numel() * 2 == plan["ring_bytes"]
    assert torch.equal(ring, tfm.gen_ring(w, dims, pre)[:ring.numel()])


def _mm_k16(a, b):
    """a [M, K] @ b [K, N] as `ft_tile` computes it at f32: both split in
    three bf16 parts (`split_bf16x3`); each k16 step's six products
    (exact, summed in float64: 16 products of 8-bit significands) added in
    `ORDER` to a fresh f32 accumulator, rounding each sum to f32; the steps
    added in order to an f32 sum."""
    pa = [p.double() for p in tfm.split_bf16x3(a)]
    pb = [p.double() for p in tfm.split_bf16x3(b)]
    total = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 16):
        acc = torch.zeros_like(total)
        for qa, qb in ORDER:
            acc = (acc.double() + pa[qa][:, k0:k0 + 16]
                   @ pb[qb][k0:k0 + 16]).float()
        total = total + acc
    return total


def _emulated_forward(w, x, d, dims):
    """The tensor-core forward at f32 on the CPU, as `ft_fwd_kernel` orders
    it: every product over the padded K of its ring stages (the encodings'
    lanes, the width padded to 64 with zeros; [x, h] and [feat, d]) through
    `_mm_k16`, bias then ReLU; the heads in f32."""
    wp = -(-dims.width // 64) * 64
    e, sk = dims.in_dim, dims.skip + 1 < dims.depth

    def cols(a):
        return nn.functional.pad(a, (0, wp - a.shape[1]))

    def rows(m):
        return nn.functional.pad(m, (0, 0, 0, wp - m.shape[0]))

    h = None
    for i in range(dims.depth):
        m = w[f"tw{i}"]
        if i == 0:
            a = x
        elif sk and i == dims.skip + 1:
            a, m = torch.cat([x, cols(h)], 1), torch.cat([m[:e], rows(m[e:])])
        else:
            a, m = cols(h), rows(m)
        h = torch.relu(_mm_k16(a, m) + w[f"tb{i}"])
    heads = [h @ w["sigma_w"] + w["sigma_b"]]
    if dims.out_extra:
        heads.append(h @ w["sem_w"] + w["sem_b"])
    feat = _mm_k16(cols(h), rows(w["feat_w"])) + w["feat_b"]
    vw = w["view_w"]
    v = torch.relu(_mm_k16(torch.cat([cols(feat), d], 1), torch.cat(
        [rows(vw[:dims.width]), vw[dims.width:]])) + w["view_b"])
    return torch.cat([v @ w["rgb_w"] + w["rgb_b"]] + heads, 1)


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("geom", [(256, 8, 4, 10, 4, False),
                                  (72, 3, 1, 4, 2, True),
                                  (32, 2, 4, 4, 2, False)],
                         ids=["8x256", "3x72-semantic", "2x32"])
def test_emulated_forward_holds_against_jax_and_float64(pre, geom):
    """The tensor-core forward's f32 arithmetic (`_emulated_forward`) on
    the v2 path's in-kernel encodings or, with `pre`, on v1's given ones:
    within 1e-5 (relative to max |raw|) of JAX's `fused_mlp_pe` /
    `fused_mlp` (interpret mode: two f32 evaluations of one function in
    other orders, the bound tests/test_torch_fused_mlp.py holds the plain
    version to) and, phase 20's gate, within 2 x the plain f32 version's
    error against the float64 evaluation."""
    width, depth, skip, mr, mv, semantic = geom
    dims = _dims("float32", width, multires=mr, depth=depth, skip=skip,
                 views=mv, semantic=semantic)
    jw, w, xd = _seeded(dims, 20 + width + pre, 128)
    xd_t = torch.from_numpy(xd)
    x, d = tfm._encodings(xd_t, dims)
    jdims = jfm.MLPDims(**dims._asdict())
    jws = {n: jnp.asarray(v) for n, v in jw.items()}
    if pre:
        want = jfm.fused_mlp(jdims, 64, jws, jnp.asarray(x.numpy()),
                             jnp.asarray(d.numpy()))
        plain = lambda dt: tfm.fused_mlp_fwd_plain(w, x, d, dims, dt)
    else:
        want = jfm.fused_mlp_pe(jdims, 64, jws, jnp.asarray(xd))
        plain = lambda dt: tfm.fused_mlp_pe_plain(w, xd_t, dims, dt)
    got = _emulated_forward(w, x, d, dims)
    ref = plain(torch.float64)
    assert got.shape == (128, 4 + dims.out_extra)
    assert _rel(got, np.array(want)) < 1e-5
    assert _rel(got, ref) <= 2 * _rel(plain(torch.float32), ref)


def test_fwd_variants_edit_the_current_source():
    """`tools/fwd_variants.py`'s edited copies of the CUDA source still
    apply to it (each edit finds its text once) and each differs from it;
    the tool refuses the CPU."""
    src = CSRC.read_text()
    v = fwd_variants.variants(src)
    assert list(v) == ["as_is", "loop_runtime", "one_buffer_regs",
                       "one_buffer_staged", "no_epilogue", "no_heads",
                       "one_product", "no_fold"]
    assert v["as_is"] == src
    assert all(text != src for k, text in v.items() if k != "as_is")
    # ft_k16: bf16's one product, and f32's hi.hi alone of its six
    assert v["one_product"].count("wgmma_rs64(acc,") == 2
    with pytest.raises(RuntimeError, match="card"):
        fwd_variants.main([], device="cpu")


def test_cpu_path_launches_nothing():
    """On CPU tensors the entry points take the plain version, with
    gradients recorded or not (the forward-only branch of `fused_mlp_pe`
    and `fused_mlp` is for CUDA tensors alone), and count no launch; the
    kernel entries refuse CPU tensors."""
    dims = _dims("float32", 32, multires=4, depth=2, views=2)
    _, w, xd = _seeded(dims, 7, 64)
    xd_t = torch.from_numpy(xd)
    x, d = tfm._encodings(xd_t, dims)
    want, want_v1 = (tfm.fused_mlp_pe_plain(w, xd_t, dims),
                     tfm.fused_mlp_fwd_plain(w, x, d, dims))
    for c in (tfm.launches_gen, tfm.launches_gen_v1, tfm.launches,
              tfm.launches_v1):
        c.update({k: 0 for k in c})
    leaves = {n: v.clone().requires_grad_() for n, v in w.items()}
    with torch.no_grad():
        assert torch.equal(tfm.fused_mlp_pe(w, xd_t, dims), want)
        assert torch.equal(tfm.fused_mlp(dims, 64, w, x, d), want_v1)
    out = tfm.fused_mlp_pe(leaves, xd_t, dims)
    assert torch.equal(out.detach(), want) and out.requires_grad
    out.sum().backward()
    assert tfm.fused_mlp(dims, 64, leaves, x, d).requires_grad
    for call in (lambda: tfm.fwd_fn(w, (xd_t,), dims, pre=False),
                 lambda: tfm.fwd_fn(w, (x, d), dims, pre=True),
                 lambda: tfm.fused_mlp_pe_fwd_kernel(w, xd_t, dims)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    zero = {"fwd_tc": 0, "fwd_ls": 0, "bwd_tc": 0, "bwd_ls": 0}
    assert tfm.launches_gen == tfm.launches_gen_v1 == zero
    assert tfm.launches == tfm.launches_v1 == {"fwd": 0, "bwd": 0}
