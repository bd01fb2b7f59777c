"""The fused MLP at other compute types and geometries than the wgmma
kernels' bf16 8 x 256: the port's plain v2 (`fused_mlp_pe`) and v1
(`fused_mlp`) versions, which the generic kernels (`csrc/fused_mlp_gen.cu`)
compute, against the JAX functions, whose Pallas kernels run in interpret
mode on the CPU; the route each configuration takes on the card and the
limits past which it raises; the struct the generic kernels read
(`gen_params`); and the Trainer at `tools/full_run.py --smoke`'s MLP
configuration against the JAX Trainer. Same numpy-made weights, inputs and
cotangents on both sides; every tensor compared relative to its largest
|value| (tolerances stated per case)."""
import ctypes
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.config import Config as JConfig
from spinnerf_tpu.data import llff, synthetic
from spinnerf_tpu.ops import fused_mlp as jfm
from spinnerf_tpu.train.loop import Trainer as JTrainer
from spinnerf_tpu_torch.config import Config
from spinnerf_tpu_torch.data import llff as tllff
from spinnerf_tpu_torch.ops import fused_mlp as tfm
from spinnerf_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

BLOCK = 64
P = 128
CSRC = Path(tfm.__file__).resolve().parents[1] / "csrc" / "fused_mlp_gen.cu"

# (compute type, depth, width, octaves, semantic head): every depth of 2,
# 3, 6, 10 in both compute types, each with the other width, octave pair
# and head setting in the other type, so that every value of each factor
# meets every depth and both types.
GRID = [("float32", 2, 32, (4, 2), False), ("float32", 3, 128, (12, 6), True),
        ("float32", 6, 32, (12, 6), True), ("float32", 10, 128, (4, 2), False),
        ("bfloat16", 2, 128, (12, 6), False), ("bfloat16", 3, 32, (4, 2), True),
        ("bfloat16", 6, 128, (4, 2), True), ("bfloat16", 10, 32, (12, 6), False)]
# f32: both sides compute the same f32 products in another summation order,
# within 1e-5 of max |value| (tests/test_torch_fused_mlp.py). bf16: the
# same file's bounds, 5e-4 on the forward and 5e-3 on the gradients (the
# JAX v2 kernel rounds each block's bias-gradient sum to bf16, 2^-9 of a
# bias gradient, which the port does not). An f32 sum taken in another
# order can also cross a bf16 rounding boundary and move that activation
# by one bf16 step (2^-8), which moves its own point's row only (measured:
# one point of 128 at 1.08e-3, the others <= 8.4e-8, at bf16 depth 2 width
# 128 in v1). So in bf16 a per-point tensor (the forward, v1's dx and dd)
# may have FLIPPED_ROWS rows past its bound, each within 1e-2; a dropped
# rounding moves every row (>= 1.3e-3 on the forward, the same file).
TOLS = {"float32": (1e-5, 1e-5), "bfloat16": (5e-4, 5e-3)}
FLIPPED_ROWS = 2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _dims(dtype, depth, width, octaves, semantic):
    return jfm.dims_for_field(multires=octaves[0], multires_views=octaves[1],
                              width=width, depth=depth,
                              semantic=semantic)._replace(
                                  compute_dtype=dtype)


def _weights(dims, rng):
    """Weights in the fused layout: lecun-normal matrices on their unpadded
    fan-in with the encodings' padding rows zero (`params_to_fused`'s
    layout), biases non-zero so that every bias path carries signal."""
    raw_x = 3 * (1 + 2 * dims.multires)
    raw_d = 3 * (1 + 2 * dims.multires_views)
    out = {}
    for n, shape in tfm.weight_shapes(tfm.MLPDims(**dims._asdict())).items():
        if n.endswith("_b") or n.startswith("tb"):
            out[n] = (rng.randn(*shape) * 0.1).astype(np.float32)
            continue
        w = rng.randn(*shape).astype(np.float32)
        if n == "tw0":
            w[raw_x:] = 0.0
        elif n == f"tw{dims.skip + 1}" and shape[0] > dims.width:
            w[raw_x:dims.in_dim] = 0.0
        elif n == "view_w":
            w[dims.width + raw_d:] = 0.0
        fan_in = int(np.count_nonzero(np.abs(w).sum(1)))
        out[n] = w / np.float32(np.sqrt(max(fan_in, 1)))
    return out


def _rows_within(a, b, tol, dtype):
    """A per-point tensor [P, n] within `tol` of max |b|, but in bf16 for
    up to FLIPPED_ROWS rows, which stay within 1e-2."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max(axis=1) / max(np.abs(b).max(), 1e-30)
    if dtype == "float32":
        return err.max() < tol
    return (err >= tol).sum() <= FLIPPED_ROWS and err.max() < 1e-2


def _compare(got, want, dtype):
    tol, grad_tol = TOLS[dtype]
    out_t, grads_t = got[0], got[1]
    out_j, grads_j = want[0], want[1]
    assert out_t.shape == out_j.shape
    assert _rows_within(out_t, out_j, tol, dtype)
    assert set(grads_t) == set(grads_j)
    for n in grads_j:
        assert grads_t[n].shape == grads_j[n].shape, n
        assert _rel(grads_t[n], grads_j[n]) < grad_tol, n
    for a, b in zip(got[2:], want[2:]):      # v1's input gradients
        assert a.shape == b.shape
        assert _rows_within(a, b, grad_tol, dtype)


@pytest.mark.parametrize("case", GRID, ids=lambda c: "-".join(map(str, c)))
def test_plain_pe_matches_jax_at_geometry(case):
    """v2 (#9 / #10): the encode and the MLP from xd [P, 8]; the forward
    and every weight gradient."""
    dims = _dims(*case)
    rng = np.random.RandomState(case[1])
    jw = _weights(dims, rng)
    xd = np.zeros((P, 8), np.float32)
    xd[:, :3] = rng.randn(P, 3) * 1.5
    vd = rng.randn(P, 3)
    xd[:, 3:6] = vd / np.linalg.norm(vd, axis=-1, keepdims=True)
    g = rng.randn(P, 4 + dims.out_extra).astype(np.float32)

    out, vjp = jax.vjp(lambda w: jfm.fused_mlp_pe(dims, BLOCK, w,
                                                  jnp.asarray(xd)),
                       {n: jnp.asarray(v) for n, v in jw.items()})
    (grads,) = vjp(jnp.asarray(g))
    want = (np.asarray(out), {n: np.asarray(v) for n, v in grads.items()})

    w = {n: torch.from_numpy(v).requires_grad_() for n, v in jw.items()}
    out_t = tfm.fused_mlp_pe(w, torch.from_numpy(xd),
                             tfm.MLPDims(**dims._asdict()))
    out_t.backward(torch.from_numpy(g))
    got = (out_t.detach().numpy(), {n: v.grad.numpy() for n, v in w.items()})
    assert got[0].shape == (P, 4 + dims.out_extra)
    _compare(got, want, case[0])


@pytest.mark.parametrize("case", GRID, ids=lambda c: "-".join(map(str, c)))
def test_plain_v1_matches_jax_at_geometry(case):
    """v1 (#7 / #8): the MLP on given encodings x_enc [P, in_dim], d_enc
    [P, dir_dim] (numpy-made, zero in the padding lanes); the forward,
    every weight gradient and the encodings' gradients dx, dd."""
    dims = _dims(*case)
    rng = np.random.RandomState(100 + case[1])
    jw = _weights(dims, rng)
    x = np.zeros((P, dims.in_dim), np.float32)
    d = np.zeros((P, dims.dir_dim), np.float32)
    x[:, :3 * (1 + 2 * dims.multires)] = rng.uniform(
        -1, 1, (P, 3 * (1 + 2 * dims.multires)))
    d[:, :3 * (1 + 2 * dims.multires_views)] = rng.uniform(
        -1, 1, (P, 3 * (1 + 2 * dims.multires_views)))
    g = rng.randn(P, 4 + dims.out_extra).astype(np.float32)

    out, vjp = jax.vjp(lambda w, a, b: jfm.fused_mlp(dims, BLOCK, w, a, b),
                       {n: jnp.asarray(v) for n, v in jw.items()},
                       jnp.asarray(x), jnp.asarray(d))
    grads, dx, dd = vjp(jnp.asarray(g))
    want = (np.asarray(out), {n: np.asarray(v) for n, v in grads.items()},
            np.asarray(dx), np.asarray(dd))

    w = {n: torch.from_numpy(v).requires_grad_() for n, v in jw.items()}
    x_t = torch.from_numpy(x).requires_grad_()
    d_t = torch.from_numpy(d).requires_grad_()
    out_t = tfm.fused_mlp(tfm.MLPDims(**dims._asdict()), BLOCK, w, x_t, d_t)
    out_t.backward(torch.from_numpy(g))
    got = (out_t.detach().numpy(), {n: v.grad.numpy() for n, v in w.items()},
           x_t.grad.numpy(), d_t.grad.numpy())
    _compare(got, want, case[0])


# (dims changes from the reference's bf16 8 x 256 at 10 / 4 octaves, v1,
# route or the message a ValueError names)
ROUTES = [
    ({}, False, "wgmma"),
    ({}, True, "wgmma"),
    (dict(multires=6), True, "wgmma"),      # v1 reads no octaves
    (dict(multires=6), False, "gen"),
    (dict(compute_dtype="float32"), False, "gen"),
    (dict(compute_dtype="float32"), True, "gen"),
    (dict(width=128, view_width=64), False, "gen"),           # the parity nets
    (dict(depth=2, width=32, view_width=16, multires=4, multires_views=2,
          compute_dtype="float32"), False, "gen"),            # full_run --smoke
    (dict(multires=21, in_dim=256), False, "gen"),
    (dict(depth=3), False, "gen"),                            # no skip concat
    (dict(depth=32, width=2048, view_width=1024, in_dim=256, dir_dim=256),
     True, "gen"),
    (dict(depth=5), False, "depth != skip"),
    (dict(depth=33), False, "depth 1-32"),
    (dict(width=4), False, "width 8-2048"),
    (dict(width=4096, view_width=2048), True, "width 8-2048"),
    (dict(view_width=512), False, "view width"),
    (dict(in_dim=384), True, "encoding widths"),
    (dict(multires=21), False, "octaves"),
    (dict(out_extra=2), False, "out_extra"),
    (dict(compute_dtype="float16"), False, "compute_dtype"),
]


@pytest.mark.parametrize("change,pre,want", ROUTES,
                         ids=[f"{i}-{r[2]}" for i, r in enumerate(ROUTES)])
def test_route(change, pre, want):
    dims = tfm.dims_for_field()._replace(**change)
    if want in ("wgmma", "gen"):
        assert tfm.route(dims, pre) == want
    else:
        with pytest.raises(ValueError, match=want):
            tfm.route(dims, pre)


@pytest.mark.parametrize("case", GRID[:2] + GRID[4:5],
                         ids=lambda c: "-".join(map(str, c)))
def test_kernel_entries_refuse_cpu_tensors(case):
    """On the generic route too, the four kernel entries and the two
    backward timers raise on CPU tensors; nothing is counted."""
    dims = tfm.MLPDims(**_dims(*case)._asdict())
    assert tfm.route(dims) == tfm.route(dims, True) == "gen"
    w = {n: torch.from_numpy(v) for n, v in
         _weights(dims, np.random.RandomState(0)).items()}
    xd, g = torch.zeros(64, 8), torch.zeros(64, 4 + dims.out_extra)
    x, d = torch.zeros(64, dims.in_dim), torch.zeros(64, dims.dir_dim)
    for call in (lambda: tfm.fused_mlp_pe_fwd_kernel(w, xd, dims),
                 lambda: tfm.fused_mlp_pe_bwd_kernel(w, xd, g, dims),
                 lambda: tfm.fused_mlp_fwd_kernel(w, x, d, dims),
                 lambda: tfm.fused_mlp_bwd_kernel(w, x, d, g, dims),
                 lambda: tfm.bwd_pass_fns(w, (xd,), g, dims, pre=False),
                 lambda: tfm.fwd_fn(w, (x, d), dims, pre=True)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert tfm.launches_gen == tfm.launches_gen_v1 == {
        "fwd_tc": 0, "fwd_ls": 0, "bwd_tc": 0, "bwd_ls": 0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gen_heads_layout(dtype):
    """`gen_heads`: the heads' matrices one after another, rounded as the
    plain version rounds them; `gen_params` points at them and at the
    biases, with the gradients' offsets in the weights' order, and refuses
    any other buffer."""
    dims = tfm.MLPDims(**_dims(dtype, 6, 32, (4, 2), True)._asdict())
    w = {n: torch.from_numpy(v) for n, v in
         _weights(dims, np.random.RandomState(3)).items()}
    heads = tfm.gen_heads(w, dims)
    offs, total = tfm._gen_heads_offsets(dims)
    assert list(offs) == ["rgb_w", "sigma_w", "sem_w"]
    assert heads.dtype == torch.float32 and heads.numel() == total
    r = tfm._rounding(dims, torch.float32)
    shapes = tfm.weight_shapes(dims)
    for n, off in offs.items():
        got = heads[off:off + w[n].numel()].view(shapes[n])
        assert torch.equal(got, r(w[n])), n

    prm = tfm.gen_params(w, dims, heads)
    base = heads.data_ptr()
    for n, off in offs.items():
        assert getattr(prm, n) == base + 4 * off, n
    assert prm.tb[2] == w["tb2"].data_ptr()
    for n in ("feat_b", "view_b", "rgb_b", "sigma_b", "sem_b"):
        assert getattr(prm, n) == w[n].data_ptr(), n
    assert not prm.tb[6]
    flat, n_flat = tfm._flat_offsets(dims)
    assert prm.n_params == n_flat == sum(v.numel() for v in w.values())
    jobs = [f"tw{i}" for i in range(6)] + ["feat_w", "view_w", "rgb_w",
                                           "sigma_w", "sem_w"]
    for j, n in enumerate(jobs):
        assert prm.gw[j] == flat[n]
        assert prm.gb[j] == flat[n.replace("tw", "tb").replace("_w", "_b")]
    assert (prm.depth, prm.skip, prm.width, prm.view_width, prm.in_dim,
            prm.dir_dim, prm.out_extra, prm.multires, prm.multires_views,
            prm.bf16) == (6, dims.skip, 32, 16, 128, dims.dir_dim, 1, 4, 2,
                          int(dtype == "bfloat16"))
    for bad in (heads[:-1], heads.double()):
        with pytest.raises(ValueError, match="gen_heads"):
            tfm.gen_params(w, dims, bad)


def test_gen_params_mirrors_the_cuda_struct():
    """`_FgParams` declares the fields of `FgParams` in
    csrc/fused_mlp_gen.cu in its order, with its array lengths."""
    src = CSRC.read_text()
    consts = {k: v for k, v in re.findall(r"#define (FG_\w+) (\d+)\b", src)}
    consts["FG_MAX_JOBS"] = str(int(consts["FG_MAX_DEPTH"]) + 5)
    body = re.search(r"struct FgParams \{(.*?)\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        m = re.match(r"\s*(const float\*|long long|int) (\w+)(?:\[(\w+)\])?;",
                     line)
        if m:
            kind, name, n = m.groups()
            fields.append((name, kind, int(consts[n]) if n else None))
    assert len(fields) == len(tfm._FgParams._fields_)
    ctype = {"const float*": ctypes.c_void_p, "long long": ctypes.c_longlong,
             "int": ctypes.c_int}
    for (name, kind, n), (pname, ptype) in zip(fields, tfm._FgParams._fields_):
        assert name == pname
        if n is None:
            assert ptype is ctype[kind], name
        else:
            assert ptype._type_ is ctype[kind] and ptype._length_ == n, name
    assert tfm.GEN_LIMITS["depth"][1] == int(consts["FG_MAX_DEPTH"])


def test_build_flags_take_the_generic_source():
    """The generic source builds like the others (no fast math: the
    encoding's full-range sinf)."""
    from spinnerf_tpu_torch.ops import cuda_build
    flags = cuda_build.NVCC_FLAGS["fused_mlp_gen"]
    assert "arch=compute_90a,code=sm_90a" in flags
    assert not any("fast_math" in f for f in flags)
    assert CSRC.exists() and cuda_build.library_path(
        "fused_mlp_gen").name.startswith("libfused_mlp_gen-")


@pytest.fixture(scope="module")
def scene_pair(tmp_path_factory):
    d = synthetic.make_scene(tmp_path_factory.mktemp("scene"),
                             n_views=5, h=32, w=40, factor=1)
    sc = llff.load_scene(d, factor=1, prepare=True)
    tsc = tllff.Scene(**{f.name: getattr(sc, f.name)
                         for f in dataclasses.fields(llff.Scene)})
    return d, sc, tsc


def _smoke_mlp(cls, tmp_path, datadir):
    """`tools/full_run.py --smoke --model mlp`'s field and sampling (depth 2,
    width 32, 4 / 2 octaves, f32, 64 rays x 8 + 4 samples, lrate 5e-4 /
    decay 250) on a small scene, with perturb and density noise off so
    that a step is a function of its batch on both sides."""
    return cls(expname="smoke_mlp", basedir=str(tmp_path),
               datadir=str(datadir), factor=1, no_ndc=True, prepare=True,
               no_tcnn=True, netdepth=2, netwidth=32, netdepth_fine=2,
               netwidth_fine=32, multires=4, multires_views=2, N_samples=8,
               N_importance=4, N_rand=64, lrate=5e-4, lrate_decay=250,
               compute_dtype="float32", perturb=0.0, raw_noise_std=0.0,
               use_viewdirs=True, i_print=0, i_weights=0, i_video=0,
               i_testset=0, i_feat=0, llffhold=1000000)


def test_trainer_at_full_run_smoke_mlp_matches_jax(scene_pair, tmp_path):
    """The port's Trainer takes the fused MLP field on the generic route
    (its plain version on the CPU), JAX's the flax NeRFField (its fused
    field needs a TPU); from the same weights, two steps each: every
    metric of both steps within 1e-5 relative (the bound of
    tests/test_torch_train_step.py; measured <= 1.04e-7) and the
    parameters after Adam within 1e-6 (measured 6.0e-8)."""
    d, _, tsc = scene_pair
    tr = Trainer(_smoke_mlp(Config, tmp_path / "t", d), scene=tsc,
                 device="cpu", log=lambda *a: None)
    jt = JTrainer(_smoke_mlp(JConfig, tmp_path / "j", d),
                  log=lambda *a: None)
    dims = tr.fields["fine"].dims
    assert type(tr.fields["fine"]).__name__ == "FusedMLPField"
    assert (dims.depth, dims.width, dims.multires, dims.multires_views,
            dims.compute_dtype) == (2, 32, 4, 2, "float32")
    assert tfm.route(dims) == "gen"

    def fused(params):
        # JAX's Trainer takes the flax NeRFField on the CPU (its fused
        # field needs a TPU): its tree in the fused layout, padding rows 0
        return {k: tfm.params_to_fused(jax.tree.map(np.asarray, params[k]),
                                       dims, raw_in_dim=27, raw_dir_dim=15)
                for k in ("coarse", "fine")}

    with torch.no_grad():
        for k, ws in fused(jt.state.params).items():
            for n, p in tr.fields[k].weights.items():
                p.copy_(ws[n])
    for step in (1, 2):
        # the JAX Trainer's fit, one step (it returns no metrics)
        jt.key, key = jax.random.split(jt.key)
        jt.state.params, jt.state.opt_state, jm = jt.step_fn(
            jt.state.params, jt.state.opt_state, key, step)
        jt.state.step = step
        tm = tr.fit(step, hooks=False)
        assert set(tm) == set(jm)
        for name in tm:
            want = float(jm[name])
            assert abs(float(tm[name]) - want) <= 1e-5 * abs(want), \
                (step, name)
    for k, ws in fused(jt.state.params).items():
        for n, p in tr.fields[k].weights.items():
            np.testing.assert_allclose(p.detach().numpy(), ws[n].numpy(),
                                       rtol=0, atol=1e-6, err_msg=f"{k}.{n}")


@pytest.mark.parametrize("pre", [False, True])
def test_plain_backward_takes_given_masks(pre):
    """`masks=` (phase 20 holds the generic backward against float64 with
    the kernel's own ReLU masks): the evaluation's own masks give its
    result bit for bit; the view layer's units all switched off zero the
    view layer's gradients (and v1's dd) and leave the rgb head's."""
    dims = tfm.MLPDims(**_dims("float32", 6, 32, (4, 2), True)._asdict())
    rng = np.random.RandomState(7)
    w = {n: torch.from_numpy(v) for n, v in _weights(dims, rng).items()}
    xd = torch.zeros(64, 8)
    xd[:, :6] = torch.from_numpy(rng.randn(64, 6).astype(np.float32))
    g = torch.from_numpy(rng.randn(64, 5).astype(np.float32))
    x, d = tfm._encodings(xd, dims)
    inputs = (x, d) if pre else tfm._encodings(xd, dims)
    _, zs, _, _, vz, _ = tfm._forward_acts(w, *inputs, dims, torch.float32)

    def bwd(masks=None):
        if pre:
            return tfm.fused_mlp_bwd_plain(w, x, d, g, dims, masks=masks)
        return (tfm.fused_mlp_pe_bwd_plain(w, xd, g, dims, masks=masks),)

    own = bwd(([z > 0 for z in zs], vz > 0))
    for a, b in zip(bwd(), own):
        for k in (a if isinstance(a, dict) else {"t": a}):
            got = a[k] if isinstance(a, dict) else a
            want = b[k] if isinstance(b, dict) else b
            assert torch.equal(got, want), k
    off = bwd(([z > 0 for z in zs], torch.zeros_like(vz, dtype=torch.bool)))
    for n in ("view_w", "view_b"):
        assert float(off[0][n].abs().max()) == 0.0, n
        assert float(own[0][n].abs().max()) > 0.0, n
    assert torch.equal(off[0]["rgb_w"], own[0]["rgb_w"])
    if pre:
        assert float(off[2].abs().max()) == 0.0


@pytest.mark.parametrize("depth", [8, 3])
def test_gen_scratch_columns(depth):
    """The generic backward's scratch columns (`fg_layout` in the CUDA
    source): a partition of `cols` = in + dir + 2 (depth + 1) width + 2 view
    width + 4 + e (5,124 at the reference's 8 x 256, the source note's
    count), the skip layer's input [x, h_skip] and the view layer's [feat,
    d] contiguous."""
    dims = tfm.MLPDims(**_dims("float32", depth, 256, (10, 4), False)
                       ._asdict())
    c = tfm.gen_scratch_columns(dims)
    w, vw = dims.width, dims.view_width
    assert c["cols"] == (dims.in_dim + dims.dir_dim + 2 * (depth + 1) * w
                         + 2 * vw + 4)
    if depth == 8:
        assert c["cols"] == 5124
        assert c["xe"] + dims.in_dim == c["h"][dims.skip]
    else:
        assert c["xe"] == c["h"][-1] + w          # no skip concat
    assert c["de"] == c["feat"] + w
    sections = ([(c["xe"], dims.in_dim), (c["feat"], w), (c["de"],
                                                          dims.dir_dim),
                 (c["v"], vw), (c["gfeat"], w), (c["gv"], vw), (c["gin"], 4)]
                + [(h, w) for h in c["h"]] + [(z, w) for z in c["gz"]])
    cover = np.zeros(c["cols"], int)
    for start, n in sections:
        cover[start:start + n] += 1
    assert (cover == 1).all()
