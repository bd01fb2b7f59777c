"""The generic fused MLP's kernels at the wide geometries against the same
functions in another checkout of the port, on one card.

    python -m spinnerf_tpu_torch.tools.gen_speed --baseline DIR
        [--iters 3] [--out gen_speed.json]

DIR is a checkout of the port with `ops/fused_mlp.py`'s public kernel
entries (for example one whose wide geometries ran on the CUDA-core
kernels that the layer-streamed ones replaced). Seeded weights and inputs
are made here once and saved: f32 and bf16 8 x 1,024 and f32 8 x 512, v2
(#9 / #10) and v1 (#7 / #8), 262,144 points (2,048 rays of 128 samples,
the MLP arm's fine pass). Each checkout then times, in a process of its
own, on those same tensors: the forward kernel alone (`fwd_fn`), the
backward through its counted entry (`fused_mlp_pe_bwd_kernel` /
`fused_mlp_bwd_kernel`, packing included) and its two passes
(`bwd_pass_fns`), each the mean over `iters` calls after one, with CUDA
events; the f32 8 x 512 case forwards only. The processes run baseline,
this checkout, this checkout, baseline. Each process's ms and the launch
counters its entries left are printed as one JSON line (and written to
`--out`), beside the card's `nvidia-smi` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
POINTS = 2048 * 128
# (tag, compute type, width, forward only)
CASES = (("f32 8x1024", "float32", 1024, False),
         ("bf16 8x1024", "bfloat16", 1024, False),
         ("f32 8x512", "float32", 512, True))


def make_cases(path: Path, seed: int = 0):
    """Save each case's dims, weights and inputs (xd, g, x_enc, d_enc) on
    the CPU to `path`."""
    import torch

    from spinnerf_tpu_torch.ops import fused_mlp as fm
    gen = torch.Generator().manual_seed(seed)
    pts = torch.rand((POINTS // 128, 128, 3), generator=gen) * 2 - 1
    vd = torch.nn.functional.normalize(
        torch.randn((POINTS // 128, 3), generator=gen), dim=-1)
    xd = torch.cat([pts.reshape(-1, 3), vd[:, None].expand(pts.shape)
                    .reshape(-1, 3), torch.zeros((POINTS, 2))], -1)
    cases = {}
    for j, (tag, compute, width, fwd_only) in enumerate(CASES):
        field = fm.FusedMLPField(depth=8, width=width,
                                 compute_dtype=getattr(torch, compute),
                                 device="cpu")
        field.reset_parameters(torch.Generator().manual_seed(seed + 1 + j))
        w = {n: p.detach().clone() for n, p in field.weights.items()}
        for n in w:      # non-zero biases, so that every bias path counts
            if n.endswith("_b") or n.startswith("tb"):
                w[n] = torch.randn(w[n].shape, generator=gen) * 0.1
        dims = field.dims
        g = torch.randn((POINTS, 4 + dims.out_extra), generator=gen)
        x, d = fm.field_encodings(pts, vd, dims)
        cases[tag] = (dims._asdict(), w, (xd, g, x, d), fwd_only)
    torch.save(cases, path)


def worker(path: str, iters: int):
    """In the checkout on `sys.path`: time every case saved at `path` and
    print one line "GEN_SPEED {json}"."""
    import torch

    from spinnerf_tpu_torch.ops import fused_mlp as fm
    torch.backends.cuda.matmul.allow_tf32 = False

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    out = {}
    for tag, (dims, w, inputs, fwd_only) in torch.load(path).items():
        dims = fm.MLPDims(**dims)
        xd, g, x, d = (t.cuda() for t in inputs)
        w = {n: v.cuda() for n, v in w.items()}
        for pre in (False, True):
            ins = (x, d) if pre else (xd,)
            for c in (fm.launches_gen, fm.launches_gen_v1):
                c.update({k: 0 for k in c})
            m = {"fwd": ms(fm.fwd_fn(w, ins, dims, pre=pre))}
            if not fwd_only:
                m["bwd"] = ms(
                    (lambda: fm.fused_mlp_bwd_kernel(w, x, d, g, dims))
                    if pre else
                    (lambda: fm.fused_mlp_pe_bwd_kernel(w, xd, g, dims)))
                r1, r2, _ = fm.bwd_pass_fns(w, ins, g, dims, pre=pre)
                m["bwd_pass1"], m["bwd_pass2"] = ms(r1), ms(r2)
                del r1, r2
            m["launches"] = dict(fm.launches_gen_v1 if pre
                                 else fm.launches_gen)
            out[f"{tag} {'v1' if pre else 'v2'}"] = m
        del w, xd, g, x, d
        torch.cuda.empty_cache()
    print("GEN_SPEED " + json.dumps(out), flush=True)


def run_in(checkout: Path, path: Path, iters: int) -> dict:
    """`worker` in a process of its own with `checkout` first on its
    path."""
    env = dict(os.environ, PYTHONPATH=str(checkout))
    proc = subprocess.run([sys.executable, __file__, "--worker", str(path),
                           "--iters", str(iters)], cwd=checkout, env=env,
                          capture_output=True, text=True, timeout=1800)
    line = [s for s in proc.stdout.splitlines() if s.startswith("GEN_SPEED ")]
    if proc.returncode or not line:
        raise RuntimeError(f"the timing in {checkout} failed:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(line[0][len("GEN_SPEED "):])


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no card"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.iters)
        return 0
    if args.baseline is None:
        ap.error("--baseline is required")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gen_speed needs a CUDA card")
    base = args.baseline.resolve()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cases.pt"
        make_cases(path)
        runs = [(name, run_in(where, path, args.iters))
                for name, where in (("baseline", base), ("this", ROOT),
                                    ("this", ROOT), ("baseline", base))]
    res = {"card": card(), "points": POINTS, "iters": args.iters,
           "baseline": str(base), "runs": runs}
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
