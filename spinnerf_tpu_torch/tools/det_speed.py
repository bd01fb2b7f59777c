"""The hash encodes' table-gradient kernels (#2, #6, #4) timed in turns in
one process, on one card: each checkout's atomic kernel (where it has one)
and its fixed-order variant, on the same inputs.

    python -m spinnerf_tpu_torch.tools.det_speed [--baseline DIR]
        [--points DIR] [--cases hash,patch,...] [--profile]
        [--out det_speed.json]

The inputs are made here once, from seeds: the default hash-grid trainer
(`Config(prepare=True)`, 16 x 2^19 x 2) on a 12-view synthetic world at
252 x 336 calibrates its index, and its fine pass gives 262,144 points
(2,048 bank rays x 128 stratified depths, as `chip_smoke.py` phase 3 draws
them). Cases: "hash" (#2 on those points), "patch" (#2 on 666,624 points:
four 31 x 42-pixel patches of four views around the ball, 128 depths a
ray, as the fit arm's patch render concentrates its points), "2^25" (#2 at
16 x 2^25 x 2, bounds and boxes calibrated on every fourth point), "xor"
(#6, points mode, the instant-NGP index at 2^19) and "idx" (#4, idx mode,
the windowed index at 2^19). `--points DIR` adds a #2 case for each file
there that `chip_smoke.py` saves beside its holds of #2
(build/chip_smoke/points/: the points, index and cotangent of the hash,
disk and fit arms' held sets).

`--baseline DIR` also imports DIR's `spinnerf_tpu_torch` (another checkout,
for example the parent commit unpacked with `git archive`) in the same
process under another name, so that its kernels run in the same turns.
Every function of a case is launched ITERS (20) times back to back between
two CUDA events, in ROUNDS (4) rounds whose order alternates (forward,
then reversed); the ms of each round are printed. Each variant is held
bit-equal over its launches and within 1e-5 (of max |dtable|) of the first
atomic kernel. `--profile` adds each function's device time by kernel
name over 5 launches (torch.profiler). One JSON object is printed last
(and written to `--out`), with the card's `nvidia-smi` name and power
limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

H, W, N_VIEWS = 252, 336, 12
N_POINTS = 2048 * 128
PATCH = (31, 42)         # the fit arm's patch: H / 16 x W / 16 at 504 x 672
PKG = "spinnerf_tpu_torch"
ITERS, ROUNDS = 20, 4     # launches a function a round; rounds


def import_checkout(root: Path, alias: str):
    """The encode modules of the checkout at `root`, imported under the
    package name `alias` (its modules keep their own references to each
    other), leaving this checkout's modules as they were."""
    def ours():
        return {k: v for k, v in sys.modules.items()
                if k == PKG or k.startswith(PKG + ".")}
    saved = ours()
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, str(root))
    try:
        mods = {n: importlib.import_module(f"{PKG}.ops.{n}")
                for n in ("hash_encode", "hash_encode_win")}
    finally:
        sys.path.remove(str(root))
        for k in list(ours()):
            sys.modules[alias + k[len(PKG):]] = sys.modules.pop(k)
        sys.modules.update(saved)
    return mods


def synthetic_trainer(dev):
    """The default hash-grid trainer on a 12-view synthetic world."""
    from spinnerf_tpu_torch.config import Config
    from spinnerf_tpu_torch.data import llff, synthetic
    from spinnerf_tpu_torch.train.loop import Trainer
    focal = 1.2 * W
    views = []
    for v in range(N_VIEWS):
        th = 2 * np.pi * v / N_VIEWS
        pos = np.array([3.5 * np.cos(th), 3.5 * np.sin(th),
                        2.0 + 0.3 * np.sin(3 * th)])
        c2w = synthetic.look_at_pose(pos, target=(0, 0, 0.3))
        rgb, z, _ = synthetic.render_view(c2w, H, W, focal)
        z = z[np.isfinite(z)]
        views.append((c2w.astype(np.float32), rgb,
                      [np.percentile(z, 1), np.percentile(z, 99.5)]))
    poses = np.stack([v[0] for v in views])
    scene = llff.Scene(images=np.stack([v[1] for v in views]), poses=poses,
                       bounds=np.asarray([v[2] for v in views], np.float32),
                       render_poses=poses, hwf=(H, W, focal), i_holdout=0)
    cfg = Config(prepare=True, expname="det_speed", basedir="build/det_speed",
                 no_ndc=True, no_reload=True, i_print=0, i_weights=0,
                 i_video=0, i_testset=0, i_feat=0)
    return Trainer(cfg, scene=scene, device=dev, log=lambda *a: None)


def to_unit(trainer, pts):
    b = trainer.model.bound
    import torch
    return torch.clamp((pts.reshape(-1, 3) + b) / (2 * b), 0, 1).contiguous()


def fine_pass_points(trainer):
    """2,048 bank rays x 128 stratified depths, in [0, 1]."""
    import torch

    from spinnerf_tpu_torch.core import sampling
    from spinnerf_tpu_torch.data import raybank
    gen = torch.Generator(trainer.device).manual_seed(1)
    batch, _ = raybank.sample_group(trainer.bank, "clf", 2048, step=1)
    z = sampling.stratified_z_vals(batch["near"], batch["far"], 128,
                                   generator=gen)
    return to_unit(trainer, sampling.ray_points(batch["origins"],
                                                batch["directions"], z))


def patch_points(trainer):
    """Four 31 x 42-pixel patches around the image centre (the ball) of
    views 0, 3, 6 and 9, 128 stratified depths a ray: 666,624 points."""
    import torch

    from spinnerf_tpu_torch.core import rays, sampling
    dev = trainer.device
    h, w, focal = trainer.scene.hwf
    gen = torch.Generator(dev).manual_seed(2)
    ph, pw = PATCH
    yy, xx = torch.meshgrid(torch.arange(ph), torch.arange(pw),
                            indexing="ij")
    out = []
    for v, (dy, dx) in zip((0, 3, 6, 9), ((-ph, -pw), (-ph, 0), (0, -pw),
                                         (0, 0))):
        coords = torch.stack([xx.reshape(-1) + w // 2 + dx + 0.5,
                              yy.reshape(-1) + h // 2 + dy + 0.5],
                             -1).float().to(dev)
        c2w = torch.as_tensor(trainer.scene.poses[v][:3, :4], device=dev)
        o, d = rays.get_rays_at_coords(h, w, focal, c2w, coords)
        near = torch.full((o.shape[0],), trainer.bank.near, device=dev)
        far = torch.full_like(near, trainer.bank.far)
        z = sampling.stratified_z_vals(near, far, 128, generator=gen)
        out.append(to_unit(trainer, sampling.ray_points(o, d, z)))
    return torch.cat(out).contiguous()


def saved_cases(where: Path, dev):
    """{"saved <name>": #2's case} from chip_smoke.py's saved point sets."""
    import torch
    out = {}
    for f in sorted(where.glob("*.pt")):
        d = torch.load(f)
        res = tuple(d["res"])
        out[f"saved {f.stem}"] = dict(
            kind="win", x=d["x"].to(dev), res=res,
            bounds=d["bounds"].to(dev), boxes=d["boxes"],
            shape=(len(res), d["t"], 2), g=d["g"].to(dev))
    return out


def make_cases(dev):
    """{case: dict of inputs} on the card (see the module docstring)."""
    import torch

    from spinnerf_tpu_torch.models import hashgrid as hg
    from spinnerf_tpu_torch.ops import hash_encode as he
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    tr = synthetic_trainer(dev)
    enc = tr.model.encoder
    res, bounds, boxes = enc.resolutions, enc.bounds, enc._boxes
    l, t, _ = enc.table.shape
    x = fine_pass_points(tr)
    xp = patch_points(tr)
    gen = torch.Generator().manual_seed(3)
    cases = {}
    for tag, pts in (("hash", x), ("patch", xp)):
        cases[tag] = dict(kind="win", x=pts, res=res, bounds=bounds,
                          boxes=boxes, shape=(l, t, 2),
                          g=torch.randn((pts.shape[0], 2 * l),
                                        generator=gen).to(dev))
    big = 25
    sample = x[::4].cpu().numpy()
    cases["2^25"] = dict(kind="win", x=x, res=res,
                         bounds=hg.calibrate_page_bounds(sample, big),
                         boxes=hg.calibrate_dense_box(sample, res, big),
                         shape=(l, 1 << big, 2), g=cases["hash"]["g"])
    cases["xor"] = dict(kind="pts", x=x, res=res, shape=(l, t, 2),
                        g=cases["hash"]["g"])
    # the same on the levels of each of the backward's regimes alone
    plan = he.bwd_plan(tuple(res), t)
    for name, code in (("map", he.MAP), ("direct", he.DIRECT)):
        lv = [i for i, r in enumerate(plan.regime) if r == code]
        cases[f"xor {name}"] = dict(
            kind="pts", x=x, res=tuple(res[i] for i in lv),
            shape=(len(lv), t, 2),
            g=cases["hash"]["g"].reshape(-1, l, 2)[:, lv].contiguous())
    idx, w = hw.corner_indices_weights_win(x, res, t, bounds, boxes)
    cases["idx"] = dict(kind="idx", idx=idx.to(torch.int32).contiguous(),
                        w=w.contiguous(), shape=(l, t, 2),
                        g=cases["hash"]["g"])
    del tr
    return cases


def case_fns(case, impls):
    """[(name, fn)] of a case: for each checkout (`impls`: tag -> its
    modules) the atomic kernel where its wrapper still takes the
    `deterministic` switch, and the fixed-order variant."""
    import inspect
    import torch
    out = []
    for tag, m in impls.items():
        hw, he = m["hash_encode_win"], m["hash_encode"]
        if case["kind"] == "win":
            t = case["shape"][1]
            rows = hw.level_scalars(case["res"], t, case["boxes"])
            bt = hw.bounds_tensor(t, case["bounds"], case["x"].device)
            # the forward's sort, which the backward reads (its layout is
            # the checkout's own)
            table = torch.zeros(case["shape"], device=case["x"].device)
            _, _, work = hw.hash_encode_win_fwd_kernel(table, case["x"], bt,
                                                       rows)
            del table
            fn = hw.hash_encode_win_bwd_kernel
            args = (case["g"], case["x"], work, rows, case["shape"])
        elif case["kind"] == "pts":
            fn = he.hash_encode_ngp_bwd_kernel
            args = (case["g"].reshape(-1, case["shape"][0], 2), case["x"],
                    case["res"], case["shape"])
        else:
            fn = he.hash_encode_idx_bwd_kernel
            args = (case["g"].reshape(-1, case["shape"][0], 2), case["idx"],
                    case["w"], case["shape"])
        if "deterministic" in inspect.signature(fn).parameters:
            # the atomic kernel reads its own copy of the windowed sort: a
            # variant may sort the split segments' ids in place
            a_args = args if case["kind"] != "win" else (
                args[:2] + (args[2].clone(),) + args[3:])
            out.append((f"{tag} atomic",
                        lambda fn=fn, a=a_args: fn(*a, deterministic=False)))
            out.append((f"{tag} fixed-order",
                        lambda fn=fn, a=args: fn(*a, deterministic=True)))
        else:
            out.append((f"{tag} fixed-order", lambda fn=fn, a=args: fn(*a)))
    return out


def time_case(fns, iters=ITERS, rounds=ROUNDS):
    """ms of each function per round, the rounds alternating in order."""
    import torch
    for _, fn in fns:
        fn()
    torch.cuda.synchronize()
    ms = {name: [] for name, _ in fns}
    for r in range(rounds):
        for name, fn in (fns if r % 2 == 0 else fns[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            torch.cuda.synchronize()
            ms[name].append(a.elapsed_time(b) / iters)
    return ms


def hold_case(fns):
    """Each variant bit-equal over 5 launches; every function within 1e-5
    of max |dtable| of the first one."""
    import torch
    ref = fns[0][1]()
    scale = float(ref.abs().max())
    out = {}
    for name, fn in fns:
        a = fn()
        rel = float((a - ref).abs().max()) / scale
        same = all(torch.equal(a, fn()) for _ in range(5))
        out[name] = {"rel_to_first": rel, "bit_equal_5": same}
        if rel > 1e-5 or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: {rel:.3e} from {fns[0][0]}")
        if "fixed-order" in name and not same:
            raise AssertionError(f"{name}: launches not bit-equal")
    return out


def profile_case(fns, n=5):
    """Device ms per launch of each function, by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, fn in fns:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            if us > 0:
                rows[e.key[:60]] = round(us / 1e3 / n, 5)
        out[name] = dict(sorted(rows.items(), key=lambda kv: -kv[1]))
    return out


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
    ap.add_argument("--cases", default="hash,patch,2^25,xor,xor map,xor direct,idx")
    ap.add_argument("--points", type=Path)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("det_speed needs a CUDA card")
    dev = torch.device("cuda:0")
    impls = {}
    if args.baseline:
        impls["baseline"] = import_checkout(args.baseline.resolve(),
                                            "det_speed_baseline")
    impls["this"] = {n: importlib.import_module(f"{PKG}.ops.{n}")
                     for n in ("hash_encode", "hash_encode_win")}
    # each checkout's two libraries, all four nvcc processes at once
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(impls)) as pool:
        for f in [pool.submit(m["hash_encode"].cuda_build.build,
                              ["hash_encode_win", "hash_encode_idx"])
                  for m in impls.values()]:
            f.result()
    cases = make_cases(dev)
    tags = args.cases.split(",")
    if args.points:
        saved = saved_cases(args.points, dev)
        cases.update(saved)
        tags += list(saved)
    res = {"card": card(), "iters": ITERS, "rounds": ROUNDS,
           "baseline": str(args.baseline) if args.baseline else None,
           "cases": {}}
    for tag in tags:
        case = cases[tag]
        fns = case_fns(case, impls)
        n = int(case["x"].shape[0] if "x" in case else case["idx"].shape[2])
        entry = {"points": n, "shape": list(case["shape"]),
                 "held": hold_case(fns),
                 "ms": time_case(fns)}
        entry["mean_ms"] = {k: float(np.mean(v)) for k, v in
                            entry["ms"].items()}
        if args.profile:
            entry["kernels"] = profile_case(fns)
        res["cases"][tag] = entry
        print(f"[det_speed {tag}] {json.dumps(entry)}", flush=True)
        del fns
        torch.cuda.empty_cache()
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
