#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`spinnerf_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py              # the whole smoke run, one card
    python3 chip_smoke.py --profile    # adds a torch.profiler breakdown of
                                       # a few train steps

Phases, each fatal on failure (no phase's error is caught):
  1. a card must be present; print its name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with nvcc (timed);
  3. hold the hash-grid encode kernels (forward and backward) against their
     plain PyTorch version at the main path's full shape: a 16 x 2^19 x 2
     table, 262,144 points from the trainer's calibrated ray distribution;
     time kernel and plain version with CUDA events;
  4. the main path: `Trainer` at the default prepare configuration
     (`Config(prepare=True)`: hash grid 16 x 2^19 x 2, bf16 MLPs, 1024 rays
     x 64+64 samples) on an in-memory synthetic scene of 12 views at
     252 x 336, for 200 steps, with the kernel launch counts set to 0 just
     before and read just after;
  5. render a held-out view with `render_rays_chunked` and check it.
It prints a `kernels` JSON line, then the nvidia-smi line, then as its last
line {"ok": true, "device": {...}}. It exits non-zero, and prints no result,
when no card is present or the port is not importable beside it.
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

N_VIEWS, H, W = 12, 252, 336
STEPS = 200
N_POINTS = 2048 * 128          # the fine pass of one step: 2 groups x 1024 rays
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores


def log(msg):
    print(msg, flush=True)


def synthetic_scene():
    """12 training views on a circle around the plane-and-ball world plus one
    held-out view between two of them; bounds as `make_scene` takes them
    (1st and 99.5th percentile of each view's hit depths)."""
    import numpy as np

    from spinnerf_tpu_torch.data import llff, synthetic
    focal = 1.2 * W

    def view(th):
        pos = np.array([3.5 * np.cos(th), 3.5 * np.sin(th),
                        2.0 + 0.3 * np.sin(3 * th)])
        c2w = synthetic.look_at_pose(pos, target=(0, 0, 0.3))
        rgb, z, _ = synthetic.render_view(c2w, H, W, focal)
        z = z[np.isfinite(z)]
        return (c2w.astype(np.float32), rgb,
                [np.percentile(z, 1), np.percentile(z, 99.5)])

    views = [view(2 * np.pi * v / N_VIEWS) for v in range(N_VIEWS)]
    poses = np.stack([v[0] for v in views])
    scene = llff.Scene(images=np.stack([v[1] for v in views]), poses=poses,
                       bounds=np.asarray([v[2] for v in views], np.float32),
                       render_poses=poses, hwf=(H, W, focal), i_holdout=0)
    held_out = view(2 * np.pi * 2.5 / N_VIEWS)
    return scene, held_out[0], held_out[1]


def cuda_ms(fn, iters=20, warmup=3):
    import torch
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


def compare_kernels(trainer):
    """Phase 3: kernels vs plain version at the main path's shapes. Returns
    the per-kernel records (without launch counts)."""
    import torch

    from spinnerf_tpu_torch.core import sampling
    from spinnerf_tpu_torch.data import raybank
    from spinnerf_tpu_torch.ops import hash_encode_win as hw

    dev = trainer.device
    enc = trainer.model.encoder
    res, bounds, boxes = enc.resolutions, enc.bounds, enc._boxes
    l, t, _ = enc.table.shape
    # points as the fine pass draws them: 2048 bank rays x 128 depths
    gen = torch.Generator(dev).manual_seed(1)
    batch, _ = raybank.sample_group(trainer.bank, "clf", 2048, step=1)
    z = sampling.stratified_z_vals(batch["near"], batch["far"], 128,
                                   generator=gen)
    pts = sampling.ray_points(batch["origins"], batch["directions"], z)
    x = torch.clamp((pts.reshape(-1, 3) + trainer.model.bound)
                    / (2 * trainer.model.bound), 0, 1).contiguous()
    if x.shape != (N_POINTS, 3):
        raise AssertionError(f"points {tuple(x.shape)}, want ({N_POINTS}, 3)")
    table = torch.randn((l, t, 2), generator=torch.Generator().manual_seed(2)
                        ).to(dev)
    g = torch.randn((N_POINTS, 2 * l), generator=torch.Generator()
                    .manual_seed(3)).to(dev)
    rows = hw.level_scalars(res, t, boxes)
    base = hw.point_base(x, t, bounds)

    # forward
    out_k = hw.hash_encode_win_fwd_kernel(table, x, base, rows)
    out_p = hw.hash_encode_plain(table, x, res, bounds, boxes)
    torch.cuda.synchronize()
    fwd_err = float((out_k - out_p).abs().max())
    fwd_rel = fwd_err / float(out_p.abs().max())
    log(f"[kernels] fwd max|kernel - plain| = {fwd_err:.3e} "
        f"(relative {fwd_rel:.3e}, bound 1e-6)")
    if not (torch.isfinite(out_k).all() and fwd_rel <= 1e-6):
        raise AssertionError("forward kernel disagrees with the plain version")

    # backward. Atomics add in an order that varies between runs, so the
    # kernel is held against the plain version evaluated in float64 (the
    # exact sum of the same f32 weights and cotangents); the f32 plain
    # version's own error against it is printed beside.
    tab64 = table.double().requires_grad_()
    (dtab_64,) = torch.autograd.grad(
        hw.hash_encode_plain(tab64, x, res, bounds, boxes), tab64, g.double())
    scale = float(dtab_64.abs().max())

    def bwd_rel(d):
        return float((d.double() - dtab_64).abs().max()) / scale

    dtab_k = hw.hash_encode_win_bwd_kernel(g, x, base, rows, table.shape)
    tab = table.clone().requires_grad_()
    out_g = hw.hash_encode_plain(tab, x, res, bounds, boxes)
    (dtab_p,) = torch.autograd.grad(out_g, tab, g, retain_graph=True)
    torch.cuda.synchronize()
    bwd_err = float((dtab_k.double() - dtab_64).abs().max())
    log(f"[kernels] bwd max|kernel - plain f64| = {bwd_err:.3e} (relative "
        f"{bwd_rel(dtab_k):.3e}, bound 1e-5); plain f32 relative "
        f"{bwd_rel(dtab_p):.3e}; max|dtable| {scale:.3e}")
    if not (torch.isfinite(dtab_k).all() and bwd_rel(dtab_k) <= 1e-5):
        raise AssertionError("backward kernel disagrees with the plain version")

    # the autograd wrapper on CUDA tensors goes through the kernels
    tab2 = table.clone().requires_grad_()
    out_a = hw.hash_encode_win_fused(tab2, x, res, bounds, boxes)
    out_a.backward(g)
    if not torch.equal(out_a.detach(), out_k):
        raise AssertionError("autograd wrapper forward differs from kernel")
    if bwd_rel(tab2.grad) > 1e-5:
        raise AssertionError("autograd wrapper backward differs from plain")
    del tab64, dtab_64, tab2, out_a

    # times (CUDA events, back-to-back launches)
    fwd_ms = cuda_ms(lambda: hw.hash_encode_win_fwd_kernel(table, x, base,
                                                           rows))
    fwd_plain_ms = cuda_ms(lambda: hw.hash_encode_plain(table, x, res, bounds,
                                                        boxes))
    bwd_ms = cuda_ms(lambda: hw.hash_encode_win_bwd_kernel(g, x, base, rows,
                                                           table.shape))
    bwd_plain_ms = cuda_ms(lambda: torch.autograd.grad(out_g, tab, g,
                                                       retain_graph=True))

    # least time: each input read once, each output written once. The
    # forward reads only the table entries this run's points touch.
    idx, _ = hw.corner_indices_weights_win(x, res, t, bounds, boxes)
    lvl = torch.arange(l, device=dev)[:, None, None] * t
    touched = int(torch.unique(idx + lvl).numel())
    n = N_POINTS
    fwd_bytes = touched * 8 + n * 12 + n * 4 + n * l * 8
    bwd_bytes = n * l * 8 + n * 12 + n * 4 + l * t * 8
    # per (point, level): 3 axes x 5 geometry ops, 8 corners x (2 weight
    # products + ~10 integer hash ops), and the blend's 8 x 2 x 2 (fwd) or
    # the update's 8 x 2 products and 8 x 2 atomic adds (bwd)
    ops = n * l * (15 + 8 * 12 + 32)
    records = []
    for name, src_line, ms, plain_ms, nbytes, err in (
            ("hash_encode_win_fwd", 580, fwd_ms, fwd_plain_ms, fwd_bytes,
             fwd_err),
            ("hash_encode_win_bwd", 593, bwd_ms, bwd_plain_ms, bwd_bytes,
             bwd_err)):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        records.append({
            "name": name, "route": "cuda",
            "source": "spinnerf_tpu_torch/csrc/hash_encode_win.cu",
            "replaces": f"spinnerf_tpu/ops/hash_encode_win.py:{src_line}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None})
    log(f"[kernels] N={n} L={l} T={t}: touched table entries {touched}; "
        f"fwd {fwd_ms:.4f} ms (plain {fwd_plain_ms:.4f}), "
        f"bwd {bwd_ms:.4f} ms (plain {bwd_plain_ms:.4f}); "
        f"library: no single PyTorch call computes this encode")
    return records


def profile_steps(trainer, step_ms, n_steps=5):
    """torch.profiler over a few steps: device time by kernel, and the
    device's busy share of the unprofiled step time `step_ms`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    start = trainer.step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.fit(start + n_steps, hooks=False)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # kernels only: a record_function range (the optimizer step) also
        # shows on the device timeline and would count its kernels twice
        if (str(getattr(ev, "device_type", "")).endswith("CUDA")
                and not getattr(ev, "is_user_annotation", False)
                and "#" not in ev.key):
            rows.append((ev.self_device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3 / n_steps
    log(json.dumps({"profile": {
        "steps": n_steps, "device_ms_per_step": device_ms,
        "step_ms_unprofiled": step_ms,
        "device_busy_share": device_ms / step_ms,
        "top": [{"name": k[:90], "ms_per_step": us / 1e3 / n_steps,
                 "launches_per_step": c / n_steps}
                for us, k, c in rows[:15]]}}))


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np

    from spinnerf_tpu_torch.config import Config
    from spinnerf_tpu_torch.core.losses import mse, mse_to_psnr
    from spinnerf_tpu_torch.core.rendering import render_rays_chunked
    from spinnerf_tpu_torch.data import raybank
    from spinnerf_tpu_torch.ops import cuda_build
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    from spinnerf_tpu_torch.train.loop import Trainer, render_config

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    build_logs = cuda_build.build(["hash_encode_win"])
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        log(f"[build] csrc/{name}.cu:\n{text.strip()}")

    # the trainer at the default prepare configuration
    scene, held_pose, held_rgb = synthetic_scene()
    exp_root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(exp_root, ignore_errors=True)
    cfg = Config(prepare=True, expname="default_prepare",
                 basedir=str(exp_root), no_ndc=True, no_reload=True,
                 N_iters=STEPS, i_print=50, i_weights=0, i_video=0,
                 i_testset=0, i_feat=0)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, scene=scene, log=log)
    log(f"[setup] trainer on {trainer.device} in "
        f"{time.perf_counter() - t0:.1f} s: table "
        f"{tuple(trainer.model.encoder.table.shape)}, resolutions "
        f"{trainer.model.encoder.resolutions}, dense levels "
        f"{sum(b is not None for b in trainer.model.encoder._boxes)}, "
        f"groups x rays {trainer._batches_per_step()} x {cfg.N_rand}")

    # 3. kernels against the plain version
    records = compare_kernels(trainer)

    # 4. the main path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hw.launches.update(fwd=0, bwd=0)
    m1 = trainer.fit(1)
    psnr_1 = float(m1["psnr"])
    trainer.fit(10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_end = trainer.fit(STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(hw.launches)
    step_ms = dt * 1e3 / (STEPS - 10)
    rays = cfg.N_rand * trainer._batches_per_step()
    loss_end, psnr_end = float(m_end["loss"]), float(m_end["psnr"])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] {STEPS} steps: psnr step 1 {psnr_1:.3f} -> step {STEPS} "
        f"{psnr_end:.3f}, loss {loss_end:.5f}; {step_ms:.3f} ms/step "
        f"(steps 11-{STEPS}), {rays / step_ms * 1e3:.0f} rays/s; "
        f"peak memory {peak_gib:.2f} GiB; launches {counts}")
    if not math.isfinite(loss_end):
        raise AssertionError("loss is not finite")
    if not psnr_end > psnr_1:
        raise AssertionError("PSNR did not rise")
    for k in ("fwd", "bwd"):
        if counts[k] < 2 * STEPS:
            raise AssertionError(f"{k} kernel launched {counts[k]} times in "
                                 f"{STEPS} steps (want >= 2 per step)")

    # 5. a held-out view
    coarse, fine = trainer.field_fns()
    with torch.no_grad():
        batch, (h, w) = raybank.frame_ray_batch(
            trainer.bank.hwf, torch.as_tensor(held_pose, device=trainer.device),
            trainer.bank.near, trainer.bank.far)
        t0 = time.perf_counter()
        res = render_rays_chunked(batch, coarse, render_config(cfg, train=False),
                                  cfg.chunk, fine_field_fn=fine)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
    rgb = res.fine.rgb.reshape(h, w, 3)
    if rgb.shape != (H, W, 3) or not torch.isfinite(rgb).all():
        raise AssertionError("held-out render is not finite or has a wrong shape")
    gt = torch.as_tensor(held_rgb, device=trainer.device)
    held_psnr = float(mse_to_psnr(mse(rgb, gt)))
    log(f"[render] held-out {H}x{W} view: PSNR {held_psnr:.3f} dB in "
        f"{render_s:.3f} s (chunk {cfg.chunk} rays)")
    if not np.isfinite(held_psnr):
        raise AssertionError("held-out PSNR is not finite")

    if "--profile" in argv:
        profile_steps(trainer, step_ms)

    for r in records:
        r["launches"] = counts[r["name"].rsplit("_", 1)[1]]
    log(json.dumps({"kernels": records}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
