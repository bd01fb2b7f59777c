"""What the generic fused-MLP forward on the tensor cores (`ft_fwd_kernel`,
#9 gen) spends its time on, and why its layout: the kernel built as it is
and from edited copies of `csrc/fused_mlp_gen.cu`, each timed on the card.

    python -m spinnerf_tpu_torch.tools.fwd_variants [--points 262144]
        [--out fwd_variants.json]

Variants (the forward only; every other kernel of the source as it is):
  as_is               the source
  loop_runtime        the tile loop with a runtime trip count instead of
                      one unrolled over FT_FWD_TILES
  one_buffer_regs     one activation buffer: each warpgroup holds its
                      finished tiles (two) in registers until both
                      warpgroups have read the buffer, then writes them
                      over it (more ring slots: 5 at f32 width 256)
  one_buffer_staged   one buffer, the first tile of each warpgroup staged
                      in shared memory, the second held in registers (3
                      slots at f32 width 256)
  no_epilogue         no bias, ReLU, rounding or write of a tile (wrong
                      results: timing only)
  no_heads            no sigma, semantic or rgb head (timing only)
  one_product         f32's hi.hi product alone, one of six a k16 step
                      (timing only)
  no_fold             the k16 accumulators not added to the tile's sum
                      (timing only)

Each variant is compiled with nvcc in its own process, all together,
into `build/fwd_variants/`; ptxas's registers and spills of
`ft_fwd_kernel<false, *>` are reported. Each is then timed with CUDA events
at f32 8 x 256 and bf16 8 x 128 on seeded points (v2, in-kernel encoding),
as-is first and last and the others in between, twice over in turns; the
layout variants' outputs must equal the source's bit for bit (the same
arithmetic). The card's name and power limit are printed beside the
numbers. Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import time
from pathlib import Path

import torch

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch.ops import cuda_build
from spinnerf_tpu_torch.ops import fused_mlp as fm

# the forward's tile loop and its buffer swap, as in the source
_LOOP = '''#pragma unroll
    for (int tp = 0; tp < FT_FWD_TILES; ++tp) {
      const int tile = 2 * tp + wg;
      if (tile < nt) {
        float sum[32], b[32], o[32];
        ft_tile<NP>(sum, pr, tp, nt - 2 * tp < 2 ? 1 : 2, gbase, buf, bs, xs,
                    xst, ring_s, full, empty, G);
        ft_bias(p, pr, tile, b);
        ft_fwd_epi(p, pr, tile, sum, b, o);
        ft_put(nbuf, bs, FT_T * tile, o);
      }
    }
    gbase += nt * pr.nk;
    consumers_sync();   // the output is whole, the input read
    float* in = buf;
    buf = nbuf;
    nbuf = in;
'''
_TILE = '''ft_tile<NP>(sum, pr, {tp}, nt - 2 * {tp} < 2 ? 1 : 2, gbase, buf,
                    bs, xs, xst, ring_s, full, empty, G);
        ft_bias(p, pr, {tile}, b);
        ft_fwd_epi(p, pr, {tile}, sum, b, {o});'''
_CARVE = '''  float* nbuf = buf + FT_BM * bs;
  float* xs = nbuf + FT_BM * bs;
  const uint32_t full = smem_u32(xs + FT_BM * xst), empty = full + 8 * G.slots;
'''
_SMEM = "2 * FT_BM * 4 * (wp + FT_PAD)"
_STAGE = "FT_BM * (FT_T + FT_PAD)"          # a staged tile's floats
_LIMIT = "if (G->wp > 2 * FT_FWD_TILES * FT_T) return 0;"


def _one_buffer(src: str, staged: bool) -> str:
    """The source with one activation buffer (and, `staged`, a staging
    tile of shared memory for each warpgroup): widths to 256."""
    src = _sub(src, _SMEM, "FT_BM * 4 * (wp + FT_PAD)" + (
        f" + 2 * 4 * {_STAGE}" if staged else ""))
    src = _sub(src, _LIMIT, "if (G->wp > 4 * FT_T) return 0;")
    src = _sub(src, _CARVE, f'''  float* nbuf = buf;
  float* xs = buf + FT_BM * bs;
  float* stg = xs + FT_BM * xst;
  const uint32_t full = smem_u32(stg + {2 if staged else 0} * {_STAGE}),
                 empty = full + 8 * G.slots;
''')
    if staged:
        body = f'''    float last[32];
    int lt = -1;
    if (nt <= 2) {{
      if (wg < nt) {{
        float sum[32], b[32];
        {_TILE.format(tp=0, tile="wg", o="last")}
        lt = wg;
      }}
    }} else {{
      {{
        float sum[32], b[32], o[32];
        {_TILE.format(tp=0, tile="wg", o="o")}
        ft_put(stg + wg * {_STAGE}, FT_T + FT_PAD, 0, o);
      }}
      if (2 + wg < nt) {{
        float sum[32], b[32];
        {_TILE.format(tp=1, tile="2 + wg", o="last")}
        lt = 2 + wg;
      }}
    }}
    gbase += nt * pr.nk;
    consumers_sync();
    if (nt > 2)
      for (int i = t & 127; i < FT_BM * (FT_T / 4); i += 128) {{
        const int row = i / (FT_T / 4), c4 = (i % (FT_T / 4)) * 4;
        st4(buf + row * bs + FT_T * wg + c4,
            ld4(stg + wg * {_STAGE} + row * (FT_T + FT_PAD) + c4));
      }}
    if (lt >= 0) ft_put(buf, bs, FT_T * lt, last);
    consumers_sync();
'''
    else:
        body = f'''    float hold[2][32];
#pragma unroll
    for (int tp = 0; tp < 2; ++tp) {{
      const int tile = 2 * tp + wg;
      if (tile < nt) {{
        float sum[32], b[32];
        {_TILE.format(tp="tp", tile="tile", o="hold[tp]")}
      }}
    }}
    gbase += nt * pr.nk;
    consumers_sync();
#pragma unroll
    for (int tp = 0; tp < 2; ++tp)
      if (2 * tp + wg < nt) ft_put(buf, bs, FT_T * (2 * tp + wg), hold[tp]);
    consumers_sync();
'''
    return _sub(src, _LOOP, body)


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"the source no longer holds {old[:60]!r}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    """name -> edited source (see the module's note)."""
    six = re.search(r"  \} else \{\n(    wgmma_rs64\(acc, a\[2\]"
                    r".*?B\(0\), 1\);\n)  \}", src, re.S)
    if six is None:
        raise RuntimeError("the source no longer holds ft_k16's six products")
    fold = '''          for (int i = 0; i < 32; ++i) sum[i] += acc[i];
        });
    __syncwarp();'''
    return {
        "as_is": src,
        "loop_runtime": _sub(src, '''#pragma unroll
    for (int tp = 0; tp < FT_FWD_TILES; ++tp) {
      const int tile = 2 * tp + wg;
      if (tile < nt) {''', '''    for (int tp = 0; 2 * tp + wg < nt; ++tp) {
      const int tile = 2 * tp + wg;
      {'''),
        "one_buffer_regs": _one_buffer(src, staged=False),
        "one_buffer_staged": _one_buffer(src, staged=True),
        "no_epilogue": _sub(src, '''        ft_bias(p, pr, tile, b);
        ft_fwd_epi(p, pr, tile, sum, b, o);
        ft_put(nbuf, bs, FT_T * tile, o);''',
            "        if (sum[0] == 12345.0f) ft_put(nbuf, bs, FT_T * tile, "
            "sum);"),
        "no_heads": _sub(_sub(
            src, "for (int idx = t; idx < FT_BM * (1 + p.out_extra);",
            "for (int idx = t; D < 0 && idx < FT_BM * (1 + p.out_extra);"),
            "for (int idx = t; idx < FT_BM * 3;",
            "for (int idx = t; D < 0 && idx < FT_BM * 3;"),
        "one_product": src.replace(
            six.group(1), "    wgmma_rs64(acc, a[0][0], a[0][1], a[0][2], "
            "a[0][3], B(0), !fresh);\n"),
        "no_fold": _sub(src, fold, '''          sum[0] += acc[0];
        });
    __syncwarp();'''),
    }


def _resources(log: str) -> dict:
    """ptxas -v's registers, stack and spills of each ft_fwd_kernel<false,
    *> in `log`."""
    res, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            res[name] = [0, *map(int, m.groups())]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in res:
            res[name][0] = int(m.group(1))
    return {("f32" if "Li3E" in n else "bf16"): tuple(r)
            for n, r in res.items() if "ft_fwd_kernel" in n and "Lb0E" in n}


def _compile(out_dir: Path) -> dict[str, tuple]:
    """Compile every variant into out_dir, one nvcc each, all started
    together: name -> (library path, `_resources`)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (cuda_build.CSRC / "fused_mlp_gen.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS["fused_mlp_gen"],
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        out[name] = (so, _resources(log))
    return out


def _ms(fn, iters=20, warmup=3) -> float:
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


def _launcher(lib, w, xd, dims):
    """A function that launches `lib`'s fg_fwd_tc on xd (the variant's own
    plan, read from the library) and returns the output."""
    lib.fg_fwd_tc.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                                      ctypes.c_int,
                                                      ctypes.c_void_p]
    lib.fg_fwd_tc.restype = ctypes.c_int
    flat = fm.gen_heads(w, dims)
    prm = fm.gen_params(w, dims, flat)
    ring = fm.gen_ring(w, dims, False, forward=True)
    out = torch.empty((xd.shape[0], 4 + dims.out_extra), device=xd.device)
    stream = torch.cuda.current_stream(xd.device).cuda_stream

    def run():
        err = lib.fg_fwd_tc(ctypes.byref(prm), xd.data_ptr(), out.data_ptr(),
                            ring.data_ptr(), 2 * ring.numel(), xd.shape[0],
                            stream)
        if err:
            raise RuntimeError(f"fg_fwd_tc failed: {err}")
        return out

    run.keep = (flat, ring, prm)
    return run


def _inputs(dims, points: int, dev, seed: int):
    gen = torch.Generator().manual_seed(seed)
    w = {n: (torch.randn(s, generator=gen) / (s[0] ** 0.5 if s[0] > 1
                                              else 10.0)).to(dev)
         for n, s in fm.weight_shapes(dims).items()}
    xd = torch.cat([torch.rand((points, 3), generator=gen) * 3 - 1.5,
                    torch.nn.functional.normalize(
                        torch.randn((points, 3), generator=gen), dim=-1),
                    torch.zeros(points, 2)], -1).to(dev).contiguous()
    return w, xd


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=262144)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("fwd_variants times kernels on a card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    built = _compile(cuda_build.BUILD_DIR / "fwd_variants")
    result = {"card": card, "build_s": time.perf_counter() - t0,
              "resources": {k: r for k, (_, r) in built.items()}, "ms": {},
              "equal_to_as_is": {}}
    print(f"[fwd_variants] {card}; built in {result['build_s']:.1f} s")
    for k, (_, r) in built.items():
        print(f"[fwd_variants] {k}: registers, stack, spill stores, spill "
              f"loads {r}")
    libs = {k: ctypes.CDLL(str(so)) for k, (so, _) in built.items()}
    for tag, dtype, width in (("f32 8x256", "float32", 256),
                              ("bf16 8x128", "bfloat16", 128)):
        dims = fm.dims_for_field(width=width)._replace(compute_dtype=dtype)
        w, xd = _inputs(dims, args.points, dev, 0)
        runs = {k: _launcher(lib, w, xd, dims) for k, lib in libs.items()}
        ref = runs["as_is"]().clone()
        result["equal_to_as_is"][tag] = {
            k: torch.equal(runs[k](), ref) for k in
            ("loop_runtime", "one_buffer_regs", "one_buffer_staged")}
        order = list(runs) + list(runs)[::-1]
        ms = {k: [] for k in runs}
        for k in order + order:
            ms[k].append(_ms(runs[k]))
        result["ms"][tag] = ms
        print(f"[fwd_variants] {tag}, {args.points} points, v2: equal to "
              f"as_is {result['equal_to_as_is'][tag]}")
        for k, v in ms.items():
            print(f"[fwd_variants]   {k}: " + ", ".join(f"{x:.4f}" for x in v)
                  + " ms")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
