#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`spinnerf_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py              # the whole smoke run, one card
    python3 chip_smoke.py --profile    # adds a torch.profiler breakdown of
                                       # a few train steps of each arm

Phases, each fatal on failure (no phase's error is caught):
  1. a card must be present; print its name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with nvcc, one process per source,
     started together (timed); ptxas's registers and spills of both
     fm_fwd_kernel instantiations, of hf_fwd_kernel (#1) and of
     kc_wgmma_kernel (#11) (none may spill);
  3. hold the hash-grid encode kernels (forward and backward) against their
     plain PyTorch version at the main path's full shape: a 16 x 2^19 x 2
     table, 262,144 points from the trainer's calibrated ray distribution,
     and the backward again with one level's dense box widened to a morton
     span of 32,768; the forward's page bases equal to `point_base`'s, and
     `hash_encode_win_fused` on CUDA tensors launching the forward kernel
     alone, with the plain page lookup made to raise; time kernel, plain
     version and `point_base` with CUDA events; print the scatter's census
     (a JSON line: per level the regime, distinct entries touched,
     contributions per entry; points per segment); then both again at 16
     x 2^25 x 2 (B1c: 32,768 segments, the largest table JAX's windowed
     kernel takes) on the same points, under uniform bounds and under
     bounds and dense boxes calibrated at 2^25, with the same gates. Every
     hold of #2 (here and in phases 13 and 14) also holds its fixed-order
     variant (B1e): within the same 1e-5 of float64, bit-equal over 5 more
     launches on the same inputs, and taken, once and bit-equal, by
     `hash_encode_win_fused`'s backward under
     `torch.use_deterministic_algorithms(True)`; both timed;
  4. the hash arm of the main path: `Trainer` at the default prepare
     configuration (`Config(prepare=True)`: hash grid 16 x 2^19 x 2, bf16
     MLPs, 1024 rays x 64+64 samples) on an in-memory synthetic scene of 12
     views at 252 x 336, for 200 steps, with the kernel launch counts set to
     0 just before and read just after;
 4b. the same Trainer at `log2_hashmap_size=25` (two 16 x 2^25 x 2 tables)
     for 50 steps, after phase 6: the PSNR at step 1 and at the end (it
     must rise), the step time, the peak device memory, #1 / #2 twice a
     step;
  5. render a held-out view with `render_rays_chunked` and check it;
  6. hold the fused encode+MLP kernels (forward and backward) against their
     plain version evaluated in float64 at the fine pass's shape (262,144
     points, 8 x 256, skip 4) and, with the semantic head, at 131,072
     points; the autograd wrapper must pack the weight ring once for its
     forward and backward; time kernel, plain version and a chain of bf16
     torch.matmul calls (the yardstick) with CUDA events, the forward's
     executed TFLOP/s and the rate at which it streams its ring stages,
     and the backward's two kernels apart (fm_bwd_kernel's executed
     TFLOP/s, fm_dw_kernel's GB/s against reading its scratch once); the
     backward, whose sums run in a fixed order (B1e), bit-equal over 5 more
     launches on the same inputs and through the autograd wrapper;
  7. the MLP arm of the main path: `Trainer` at
     `Config(prepare=True, no_tcnn=True, lrate=5e-4, lrate_decay=250)`
     (8 x 256 fields, 64+64 samples, 2 groups x 1024 rays) on the same
     scene for 200 steps, launch counts set to 0 just before, read after;
  8. render the held-out view with the MLP fields;
  9. hold the index-gather kernels (`csrc/hash_encode_idx.cu`, forward and
     backward) against their plain version at three shapes, on the 262,144
     points of phase 3: (a) the instant-NGP (dense / XOR-prime) index at
     16 x 2^19 x 2, (b) the same at 2^12, where `auto` takes it and the
     backward stages whole levels in shared memory, both with the corners
     read from idx / w (idx mode) and rebuilt from the points (points mode:
     the forward bit-equal to idx mode's, `hash_encode_ngp_fused` reaching
     both kernels), (c) the windowed index at 2^19 through
     `hash_encode_win` (idx mode); the card's instant-NGP indices equal to
     the CPU's; print the census of (a)'s scatter (a JSON line: per level
     dense or hashed, distinct entries, contributions per entry, distinct
     entries per block of 1,024 and 4,096 points); time kernels, plain
     version and the yardsticks: `embedding_bag` with per-sample weights
     for the forward, its autograd backward and `index_add_` of the
     precomputed w * g for the backward (idx mode; points mode has none);
     each backward's fixed-order variant (both modes, every shape) within
     1e-5 of float64, bit-equal over 5 more launches, taken once and
     bit-equal by its autograd entry in deterministic mode, and timed;
 10. the XOR-prime hash arm of the main path: `Trainer` at
     `Config(prepare=True, hash_impl="mxu", llffhold=8, i_feat=200,
     i_testset=200)` (16 x 2^19 x 2, bf16 MLPs, 1024 rays x 64+64 samples)
     on the scene with its ball masks: steps 1-199 without hooks (launch
     counts set to 0 just before; points-mode kernels at least twice a
     step, idx-mode kernels never), then step 200 through the Trainer's own
     testset hook and prepare dump (timed), the dump's PNGs checked, and the
     held-out view rendered;
 11. hold the v1 fused MLP kernels (`fused_mlp`: encodings computed outside,
     input gradients returned) against their plain version evaluated in
     float64 at the fine pass's shape (262,144 points of the MLP arm's rays)
     and, with the semantic head, at 131,072 points: output, every weight
     gradient, dx and dd, padded lanes exactly 0; then `make_fused_field_fn`
     on CUDA tensors with the points' gradient, counting its launches and
     its ring packs (one); time kernel, plain version and the bf16 matmul
     chain with its autograd backward, the forward's rates as in phase 6,
     and the backward's two kernels apart; the backward bit-equal over 5
     more launches;
 12. hold the calibration kernel (`csrc/kbench_cal.cu`, wgmma) against its
     plain version at k = 64 and 128, reps 8 and 64, 4096 blocks; time it
     through the port's `tools.kbench.calibrate` (TFLOP/s) beside
     `torch.bmm` and the plain version;
 13. the disk arm: `data.synthetic.make_scene` writes 12 views at 504 x 672
     with masks and a COLMAP model of 3000 points; one image decoded and
     checked against its in-memory render; `Trainer` built with no scene at
     the reference's DS-NeRF prepare configuration (factor 2, COLMAP sparse
     depth with the depth loss, lindisp, white background, density noise,
     hash grid 16 x 2^19 x 2 at lr 0.03 / decay 10) loads the directory,
     phase 3's census, forward and backward checks and phase 9's
     instant-NGP census run on its points, #6's fixed-order variant on
     them and #10 and #8 on its rays (each within its phase's bound and
     bit-equal over 5 more launches), and it
     trains 200 steps (hash kernel counts set to 0 just before, read after):
     the depth loss falls, the PSNR rises; then the prepare dump, its PNGs
     decoded with the port's reader;
 14. the fit arm: `make_scene` writes 12 views at 504 x 672 (factor 1, two
     object-removed ground-truth views, every view masked, the exact hole
     masks in label_full/; lama_images/ and depth/ are the analytic
     object-removed renders) and `pipeline.stages.stage_fit` trains the
     reference's DS-NeRF fit configuration (hash grid 16 x 2^19 x 2 at
     lr 0.03 / decay 10, COLMAP depth, 4 x 31 x 42 LPIPS patches) for 400
     steps, each step's metrics and the hash kernels' launches recorded
     around the step function: lpips_loss exactly 0 up to step 300 and
     finite and > 0 after, the training PSNR rising, the hash kernels'
     launches a step higher after step 300 (the patch renders); the step-200
     sanity panel decoded; the patch loss at fixed views and anchors through
     the kernels and with the plain encode on the same CUDA tensors; #1
     and #2 held against their plain version, as in phase 3, on that patch
     render's fine-pass points (666,624, all in the mask boxes) and on one
     training batch's; the LPIPS of a full frame on the card against float64 on the CPU (TF32
     off); `stage_eval` (PSNR, SSIM, LPIPS and their masked forms for both
     ground-truth views); then a Trainer with --alpha_model_path on the
     fit's checkpoint trains 20 steps: its density is the frozen field's,
     bit for bit, and the checkpoint's bytes are unchanged;
 15. LaMa and the whole pipeline: `make_scene` writes 12 views at 504 x
     672 (two ground-truth views, masks on views 2, 6 and 10 only, the
     exact masks in label_full/). The big-lama generator (ngf 64, 18
     blocks; seeded random weights unless big-lama.ckpt is in
     $SPINNERF_WEIGHTS_DIR) on view 2: its f32 forward (TF32 off) against
     the same module in float64 on the card, logits within 1e-5 of the
     largest and the sigmoid output within a quarter of that (its slope
     is at most 1/4); its time (CUDA events, 20 runs), launches, peak
     memory and bound (operations counted from the shapes), TF32's error
     and time beside; one block's FourierUnit ([1, 192, 63, 84]) against
     float64 on the card and against the CPU (the explicit inverse FFT is
     device-independent), beside what torch.fft.irfft2 makes of the same
     non-Hermitian spectrum on each; `refine_predict` at two levels (15
     Adam steps at 504 x 672), the known region unchanged, one step's
     latent gradient against float64. Then `pipeline.stages.run_pipeline`
     (MVSeg 200 steps, prepare 200, the guidance, the fit 310, the eval)
     at the fit arm's configuration, the hash counts set to 0 just before:
     every stage's trainer launches #1 and #2, no plain encode on the
     card, one generator on the card, one PNG per view in label/, depth/
     and lama_images/, lama_images/ within 1 LSB of the images outside the
     dilated masks, `stage_seconds` and `pipeline_results.json`, MVSeg's
     IoU on its mask views against label_full/, the fit's PSNR rising;
 16. the command-line entry point (`spinnerf_tpu_torch.cli`) on a fresh
     12-view 504 x 672 scene with a COLMAP model and masks on every view:
     `--help` and `poses` as `python -m spinnerf_tpu_torch.cli` (exit code
     0; the poses within 1e-5 of make_scene's), then in this process
     `train` at the disk arm's DS-NeRF prepare configuration at factor 1
     (200 steps, #1 and #2 at least twice a step, loss finite, PSNR up,
     depth loss down), `render` of the test views (the tree, #1 launched
     and #2 not), of the orbit at 1/4 and of the sigma plot, `refine_masks`
     on the test views' tree (beside `refine_all` on the card and on the
     CPU: masks bit-equal, maps within 1e-12, each refined mask inside its
     dilated input, some pixel un-masked; seconds a view, candidates, the
     un-masked share in the dilation ring), `eval` (within 1e-5 of the
     metrics on the CPU) and `strip_ckpt` (the step's parameters, bit for
     bit, through `restore_from_path`); each command's seconds;
 17. the other scene readers and the full-scale pipeline tool: (a) a
     Blender scene (24 RGBA views at 800 x 800 of the world from
     pose_spherical(theta, -30, 4), alpha on the ball and a table of
     radius 1.5, whose z-depths lie inside near / far 2 / 6) trained
     through `train --dataset_type blender --half_res --white_bkgd` for
     200 steps on the default hash-grid field, (b) a DTU scene (16 views
     at 800 x 600 with cameras.npz, cut from DTU's 49 at 1600 x 1200; test
     views 3 and 11 left out) through `train --dataset_type dtu`, each
     with #1 and #2 launched 400 times, the training PSNR rising, the
     bank's near / far the dataset's, NDC off, and a held-out view's PSNR;
     (c) the native COLMAP reader (`data/colmap_fast.py`, built by g++):
     its sparse depth equal to `colmap.sparse_depth_for_views` on the disk
     arm's scene and on a 10^5-point model, both readers timed there; (d)
     `tools.full_run` in this process at 12 views, 2016 x 1134 at factor 2
     (the full 1008 x 567) and `--iters-scale 40`, once per model on
     copies of one scene: every trainer stage launches #1 / #2 (hash grid)
     or #9 / #10 (MLP), the fit's PSNR rises, `summary` and
     `stage_seconds` printed; the phase's seconds;
 18. LaMa training and its tools (no kernel of the table): 16 views at
     504 x 672 from `make_scene`, 12 to train on and 4 made into a
     validation set by `gen_masks`. (a) `lama_train` in this process at
     big-lama's width (ngf 64, 18 blocks; `NLayerDiscriminator` ndf 64, 4
     layers), batch 8, crop 256, `--perceptual resnet_pl` (seeded random
     ADE20k weights unless the MIT file is in $SPINNERF_WEIGHTS_DIR), 40
     steps with validation at step 20, each step's metrics and seconds
     recorded: every metric finite, g_l1's mean over steps 31-40 below
     step 0's, the visualizer grid decoded, the checkpoint written, and a
     second call to 45 steps resuming from it; images/s, peak memory,
     and (`utils/profiling.py`) the device time, kernel launches and busy
     share a step over 3 steady steps; (b) one step at batch 2, crop 128,
     in f32 (TF32 off) and in float64 from identical weights: every loss,
     every gradient before clipping (cosine, relative L2) and the BN
     running statistics, the L2 gate shown to refuse the same step with
     TF32 on; (c) `inception_pool3` at 299 and the dilated ResNet50's
     four stages against float64; (d) `gen_masks` for every kind,
     predictions by `inpaint2d.predict`, `eval_inpainting --fid` (keyed
     `fid_random_inception` without weights; the FID held against the
     same images' float64 pool3 features), `side_by_side`,
     `analyze_errors`, `inner_features`, `report` on (a)'s metrics and
     `export` (the traced generator reloaded and held against the module);
     each command's seconds;
 19. data parallelism (`spinnerf_tpu_torch.parallel`), no kernel of its
     own: (a) `dryrun_data_parallel(2, device="cuda:0")`, two ranks over
     gloo on this card against one rank on it: the hash-grid prepare step
     (16 x 2^19 x 2, calibrated index, f32, 1024 rays a group x 64+64,
     stratified jitter; #1 / #2 launched on each rank's shard and
     counted), the big-lama G + D step (ngf 64, 18 blocks, batch 8 as 4 +
     4, crop 256, resnet_pl, TF32 off) and a frame rendered pixel-sharded
     at 252 x 336, each against its gate (loss 1e-5 relative, parameters
     1e-5; G within 5e-3, the metrics of the step's starting state within
     1e-5 relative, G's and D's BatchNorm running statistics within 1e-5
     of max(1, |value|), their averaged gradients before the clip within
     1e-2 relative L2; the frame within 1e-6 of its largest value) and
     the replicas bit-equal; the LaMa step also under two controls, each
     of which must fail its gates: BatchNorm statistics of each rank's
     shard (the metrics and statistics gates) and gradients summed, not
     averaged (the gradient gate) (a launch whose rank raises fails, not
     hangs: the CPU tests hold that); (b) a process group of one rank over
     NCCL: the hash, MLP and XOR arms' Trainers each train 20 steps in it
     under `torch.use_deterministic_algorithms(True)` (the kernels'
     fixed-order variants; CUBLAS_WORKSPACE_CONFIG is set at the script's
     start), its all-reduces counted (and the gradient all-reduce shown to
     leave a tensor bit for bit), beside two runs of 20 steps without a
     group in the same mode: the two runs and the group bit-equal (every
     parameter after step 1 and after 20 steps, and step 1's metrics), the
     variants launched (counts set to 0 before and read after: the kernels
     line's launches of #2's, #6's and #10's variants); as a control, two
     runs with the mode off report how many tensors differ (not gated);
     with --profile, each arm's device time and launches a step in both
     modes;
     (c) `train
     --mesh_shape 2` through `cli.__main__.main(..., device="cuda:0")` on
     phase 13's scene for 50 steps: two ranks, one checkpoint (rank 0's),
     the ranks' parameters bit-equal at the end, the PSNR rising; the
     seconds of each part.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# cuBLAS is reproducible under torch.use_deterministic_algorithms (phase
# 19 (b)) only with a fixed workspace, set before the first cuBLAS handle
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

N_VIEWS, H, W = 12, 252, 336
STEPS = 200
N_POINTS = 2048 * 128          # the fine pass of one step: 2 groups x 1024 rays
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
DET_REPEATS = 5                # launches of a fixed-order variant held equal
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 on the tensor cores
N_POINTS_SEM = 1024 * 128      # the semantic-head check


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
        rgb, z, hit = synthetic.render_view(c2w, H, W, focal)
        z = z[np.isfinite(z)]
        return (c2w.astype(np.float32), rgb,
                [np.percentile(z, 1), np.percentile(z, 99.5)], hit)

    views = [view(2 * np.pi * v / N_VIEWS) for v in range(N_VIEWS)]
    poses = np.stack([v[0] for v in views])
    scene = llff.Scene(images=np.stack([v[1] for v in views]), poses=poses,
                       bounds=np.asarray([v[2] for v in views], np.float32),
                       render_poses=poses, hwf=(H, W, focal), i_holdout=0)
    masks = np.stack([v[3] for v in views]).astype(np.float32)
    held_out = view(2 * np.pi * 2.5 / N_VIEWS)
    return scene, masks, held_out[0], held_out[1]


def cuda_ms(fn, iters=20, warmup=3, queue_ahead=False):
    """Mean ms of `fn` over `iters` back-to-back calls, CUDA events. With
    queue_ahead, a spin kernel of at least twice the calls' host time runs
    first, so that the host has enqueued every call before the card
    reaches them: the events then time the card alone, not the host's
    launch pace (for a call of several launches)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2 * host_s * 2e9))   # cycles, <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def deterministic_mode(on=True):
    """torch.use_deterministic_algorithms(on) within the block: the kernel
    wrappers take their fixed-order variants where on."""
    import torch
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def tensors_of(out):
    """The tensors of a kernel wrapper's result (a tensor, a dict, or a
    tuple of those and None), in order."""
    import torch
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, dict):
        return list(out.values())
    return [t for o in out if o is not None for t in tensors_of(o)]


def repeats_equal(fn, first, n=DET_REPEATS):
    """fn() n more times on the same inputs: is every result bit-equal to
    `first`, fn()'s earlier result?"""
    import torch
    ref = tensors_of(first)
    for _ in range(n):
        out = tensors_of(fn())
        if len(out) != len(ref) or not all(torch.equal(a, b)
                                           for a, b in zip(ref, out)):
            return False
    return True


# Fixed-order variants held in this run: tag -> {max_abs_err, ms, ...}
DET_HELD = {}


def fine_pass_points(trainer):
    """[N_POINTS, 3] points in [0, 1] as the fine pass draws them: 2048 bank
    rays x 128 stratified depths, normalized by the field's bound."""
    import torch

    from spinnerf_tpu_torch.core import sampling
    from spinnerf_tpu_torch.data import raybank
    gen = torch.Generator(trainer.device).manual_seed(1)
    batch, _ = raybank.sample_group(trainer.bank, "clf", 2048, step=1)
    z = sampling.stratified_z_vals(batch["near"], batch["far"], 128,
                                   generator=gen)
    pts = sampling.ray_points(batch["origins"], batch["directions"], z)
    x = torch.clamp((pts.reshape(-1, 3) + trainer.model.bound)
                    / (2 * trainer.model.bound), 0, 1).contiguous()
    if x.shape != (N_POINTS, 3):
        raise AssertionError(f"points {tuple(x.shape)}, want ({N_POINTS}, 3)")
    return x


def scatter_census(tag, x, res, t, bounds, boxes):
    """The backward's scatter on points x, level by level (printed as one
    JSON line): the regime (paged, or dense with its morton span), the
    distinct table entries the corners touch, and the mean and largest
    number of (point, corner) contributions per touched entry; for paged
    levels the distinct entries per segment (mean, largest). Once for the
    point set: points per segment (mean, largest, empty segments), and the
    sort's chunks (count, points each, full ones) and the forward's blocks
    (with points, launched, their mean fill)."""
    import torch

    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    idx, _ = hw.corner_indices_weights_win(x, res, t, bounds, boxes)
    n_seg = hw.n_segments(t)
    seg = hw.point_base(x, t, bounds).long() // hw.PAGE_ENTRIES
    per_seg = torch.bincount(seg, minlength=n_seg)
    levels = []
    for l, (r, box) in enumerate(zip(res, hw.normalize_dense_box(res, t,
                                                                boxes))):
        u, c = torch.unique(idx[l].reshape(-1), return_counts=True)
        row = {"level": l, "res": int(r),
               "regime": "paged" if box is None else "dense",
               "span": (hw.PAGE_ENTRIES if box is None
                        else hw.box_morton_span(box[3:])),
               "distinct": int(u.numel()),
               "mean_per_entry": round(float(c.double().mean()), 2),
               "max_per_entry": int(c.max())}
        if box is None:
            d = torch.bincount(u // hw.PAGE_ENTRIES, minlength=n_seg)
            row["distinct_per_segment"] = [round(float(d.double().mean()), 1),
                                           int(d.max())]
        levels.append(row)
    # the forward's blocks: chunks of at most CHUNK_POINTS points of one
    # segment (an empty segment is one empty chunk), cut into blocks of
    # FWD_BLOCK_POINTS
    n_ch = torch.clamp(-(-per_seg // hw.CHUNK_POINTS), min=1)
    sizes = torch.cat([torch.clamp(c - hw.CHUNK_POINTS * torch.arange(
        int(k), device=c.device), max=hw.CHUNK_POINTS)
        for c, k in zip(per_seg, n_ch)])
    blocks = int((-(-sizes // FWD_BLOCK_POINTS)).sum())
    launched = ((-(-x.shape[0] // hw.CHUNK_POINTS) + n_seg)
                * (hw.CHUNK_POINTS // FWD_BLOCK_POINTS))
    log(json.dumps({"census": {
        "points": tag, "n": int(x.shape[0]), "segments": n_seg,
        "points_per_segment": {"mean": float(per_seg.double().mean()),
                               "max": int(per_seg.max()),
                               "empty": int((per_seg == 0).sum())},
        "chunks": {"n": int(sizes.numel()),
                   "points_mean": float(sizes.double().mean()),
                   "points_max": int(sizes.max()),
                   "full": int((sizes == hw.CHUNK_POINTS).sum()),
                   "forward_blocks_with_points": blocks,
                   "forward_blocks_launched": launched,
                   "forward_block_fill": x.shape[0] / (blocks
                                                       * FWD_BLOCK_POINTS)},
        "levels": levels}}))
    del idx


def ngp_census(tag, x, res, t):
    """The instant-NGP index's scatter on points x at table size t, level by
    level (one JSON line): dense or hashed, the distinct table entries the
    corners touch, the mean and largest number of (point, corner)
    contributions per touched entry, the share of (point, corner) pairs
    whose entry equals the previous point's (what a warp's pre-sum can
    merge), and the distinct entries of a block of 1,024 and of 4,096
    consecutive points (mean, largest)."""
    import torch

    from spinnerf_tpu_torch.ops import hash_encode as he
    idx, _ = he.corner_indices_weights_ngp(x, res, t)
    n = x.shape[0]
    levels = []
    for l, r in enumerate(res):
        keys = idx[l]                                        # [8, N]
        u, c = torch.unique(keys.reshape(-1), return_counts=True)
        row = {"level": l, "res": int(r),
               "regime": "dense" if he.level_is_dense(r, t) else "hashed",
               "distinct": int(u.numel()),
               "mean_per_entry": round(float(c.double().mean()), 2),
               "max_per_entry": int(c.max()),
               "adjacent_equal": round(float(
                   (keys[:, 1:] == keys[:, :-1]).double().mean()), 4)}
        for p in (1024, 4096):
            nb = n // p
            if not nb:
                continue
            blk = (keys[:, :nb * p].reshape(8, nb, p).permute(1, 0, 2)
                   .reshape(nb, 8 * p))
            s = torch.sort(blk, dim=1).values
            d = (s[:, 1:] != s[:, :-1]).sum(1) + 1
            row[f"distinct_per_{p}"] = [round(float(d.double().mean()), 1),
                                        int(d.max())]
        levels.append(row)
    log(json.dumps({"census_ngp": {"points": tag, "n": int(n), "t": int(t),
                                   "levels": levels}}))
    del idx


def hold_bwd(tag, x, res, bounds, boxes, table, g):
    """#2 (the encode's backward, from the forward's sort) on points x
    with the index (res, bounds, boxes): held against the plain version
    evaluated in float64 (atomics add in an order that varies between
    runs; float64 is the exact sum of the same f32 weights and cotangents)
    within 1e-5 of max |dtable|, the f32 plain version's own error printed
    beside; then kernel and plain version timed with CUDA events; the
    autograd wrapper's table gradient held at the same bound. Its
    fixed-order variant likewise, and bit-equal over DET_REPEATS more
    launches and through the autograd wrapper in deterministic mode (its
    error and time in DET_HELD[tag]). Returns (max abs error, ms, plain
    ms)."""
    import torch

    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    t = table.shape[1]
    rows = hw.level_scalars(res, t, boxes)
    _, _, work = hw.hash_encode_win_fwd_kernel(table, x, bounds, rows)
    tab64 = table.double().requires_grad_()
    (dtab_64,) = torch.autograd.grad(
        hw.hash_encode_plain(tab64, x, res, bounds, boxes), tab64, g.double())
    del tab64
    scale = float(dtab_64.abs().max())

    def abs_err(d):   # level by level: no float64 copy of a 2^25 table
        return max(float((d[l].double() - dtab_64[l]).abs().max())
                   for l in range(d.shape[0]))

    def bwd_rel(d):
        return abs_err(d) / scale

    dtab_k = hw.hash_encode_win_bwd_kernel(g, x, work, rows, table.shape,
                                           deterministic=False)
    tab = table.clone().requires_grad_()
    out_g = hw.hash_encode_plain(tab, x, res, bounds, boxes)
    (dtab_p,) = torch.autograd.grad(out_g, tab, g, retain_graph=True)
    tab_a = table.clone().requires_grad_()
    hw.hash_encode_win_fused(tab_a, x, res, bounds, boxes).backward(g)
    torch.cuda.synchronize()
    err = abs_err(dtab_k)
    rel, rel_p, rel_a = bwd_rel(dtab_k), bwd_rel(dtab_p), bwd_rel(tab_a.grad)
    del dtab_p, tab_a, dtab_k
    log(f"[kernels {tag}] bwd max|kernel - plain f64| = {err:.3e} (relative "
        f"{rel:.3e}, bound 1e-5; autograd wrapper {rel_a:.3e}); plain f32 "
        f"relative {rel_p:.3e}; max|dtable| {scale:.3e}")
    if not (math.isfinite(err) and rel <= 1e-5):
        raise AssertionError(f"backward kernel disagrees with the plain "
                             f"version ({tag})")
    if rel_a > 1e-5:
        raise AssertionError(f"autograd wrapper backward differs from plain "
                             f"({tag})")

    # the fixed-order variant: the same bound, bit-equal launches, and the
    # autograd wrapper takes it in deterministic mode
    def variant():
        return hw.hash_encode_win_bwd_kernel(g, x, work, rows, table.shape,
                                             deterministic=True)

    dtab_d = variant()
    err_d = abs_err(dtab_d)
    same = repeats_equal(variant, dtab_d)
    before = hw.launches_det["bwd"]
    tab_d = table.clone().requires_grad_()
    with deterministic_mode():
        hw.hash_encode_win_fused(tab_d, x, res, bounds, boxes).backward(g)
    wrapped = (hw.launches_det["bwd"] - before == 1
               and torch.equal(tab_d.grad, dtab_d))
    del tab_d, dtab_d, dtab_64
    log(f"[kernels {tag}] bwd fixed-order variant: max|variant - plain f64| "
        f"= {err_d:.3e} (relative {err_d / scale:.3e}, bound 1e-5); "
        f"{DET_REPEATS} more launches bit-equal: {same}; the autograd "
        f"wrapper in deterministic mode launched it once, bit-equal: "
        f"{wrapped}")
    if not (math.isfinite(err_d) and err_d / scale <= 1e-5):
        raise AssertionError(f"fixed-order backward disagrees with the plain "
                             f"version ({tag})")
    if not (same and wrapped):
        raise AssertionError(f"fixed-order backward not reproducible or not "
                             f"taken by the wrapper ({tag})")
    ms = cuda_ms(lambda: hw.hash_encode_win_bwd_kernel(
        g, x, work, rows, table.shape, deterministic=False), queue_ahead=True)
    ms_d = cuda_ms(variant, queue_ahead=True)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(out_g, tab, g,
                                                   retain_graph=True))
    log(f"[kernels {tag}] bwd {ms:.4f} ms (fixed-order variant {ms_d:.4f}, "
        f"{ms_d / ms:.3f}x; plain {plain_ms:.4f})")
    DET_HELD[tag] = {"max_abs_err": err_d, "ms": ms_d, "atomic_ms": ms,
                     "plain_ms": plain_ms}
    return err, ms, plain_ms


FWD_BLOCK_POINTS = 256   # HF_PTS: sorted points of a chunk a block takes


def hold_fwd(tag, x, res, bounds, boxes, table):
    """#1 (the encode's forward: page lookup, sort by segment, gather) on
    points x with the index (res, bounds, boxes): its output within 1e-6 of
    max |value| of the plain version, its page bases equal to
    `point_base`'s; the autograd wrapper on CUDA tensors must call the
    forward once and run no tensor operation but allocations, with the
    page lookup's plain functions made to raise; then the forward (queued
    ahead: it is five launches), the plain version and `point_base` (the
    lookup the kernels took in, as PyTorch ops) timed with CUDA events,
    and its kernel launches counted. Returns (max abs error, ms, plain ms,
    point_base ms, point_base launches)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    t = table.shape[1]
    rows = hw.level_scalars(res, t, boxes)
    out_k, base_k, _ = hw.hash_encode_win_fwd_kernel(table, x, bounds, rows)
    out_p = hw.hash_encode_plain(table, x, res, bounds, boxes)
    base_p = hw.point_base(x, t, bounds)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    rel = err / float(out_p.abs().max())
    base_equal = torch.equal(base_k, base_p)
    log(f"[kernels {tag}] fwd max|kernel - plain| = {err:.3e} (relative "
        f"{rel:.3e}, bound 1e-6); page bases equal to point_base's: "
        f"{base_equal}")
    if not (torch.isfinite(out_k).all() and rel <= 1e-6):
        raise AssertionError(f"forward kernel disagrees with the plain "
                             f"version ({tag})")
    if not base_equal:
        raise AssertionError(f"forward kernel's page bases differ from "
                             f"point_base ({tag})")
    del out_p, base_p

    # the autograd wrapper: one call of the forward and no other tensor
    # operation than allocations (every aten op recorded below the
    # autograd layer), the plain page lookup made to raise
    tab = table.clone().requires_grad_()
    saved = {k: getattr(hw, k) for k in ("point_base", "page_lookup",
                                          "zkey27")}

    def refuse(*_a, **_k):
        raise AssertionError("the card path called the plain page lookup")

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func)
            return func(*args, **(kwargs or {}))

    ops, before = [], hw.launches["fwd"]
    try:
        for k in saved:
            setattr(hw, k, refuse)
        with Ops():
            out_a = hw.hash_encode_win_fused(tab, x, res, bounds, boxes)
    finally:
        for k, v in saved.items():
            setattr(hw, k, v)
    names = sorted({str(o) for o in ops})
    log(f"[kernels {tag}] hash_encode_win_fused on CUDA tensors: "
        f"{hw.launches['fwd'] - before} call of the forward; tensor "
        f"operations {names}")
    if hw.launches["fwd"] - before != 1 or any(
            not n.startswith("aten.empty") for n in names):
        raise AssertionError(f"hash_encode_win_fused ran {names} beside "
                             f"the forward ({tag})")
    if not torch.equal(out_a.detach(), out_k):
        raise AssertionError("autograd wrapper forward differs from kernel")
    del out_a, tab, out_k
    # what the lookup launched when it ran outside the kernels: its tensor
    # operations other than views, a kernel each
    ops.clear()
    with Ops():
        hw.point_base(x, t, bounds)
    base_launches = sum(not o.is_view for o in ops)
    log(f"[kernels {tag}] point_base on CUDA tensors: {base_launches} "
        f"operations that launch a kernel ({len(ops)} with views)")

    ms = cuda_ms(lambda: hw.hash_encode_win_fwd_kernel(table, x, bounds,
                                                       rows),
                 queue_ahead=True)
    plain_ms = cuda_ms(lambda: hw.hash_encode_plain(table, x, res, bounds,
                                                    boxes))
    base_ms = cuda_ms(lambda: hw.point_base(x, t, bounds))
    log(f"[kernels {tag}] fwd {ms:.4f} ms (plain {plain_ms:.4f}; "
        f"point_base alone {base_ms:.4f})")
    return err, ms, plain_ms, base_ms, base_launches


def box_32768(x, res, t, boxes):
    """The dense boxes `boxes` with one more: the first paged level of
    resolution >= 32 gets a calibrated-style box of 20 x 20 x 20 cells
    around the points' median cell, whose morton span is 32,768 (the
    largest the index admits)."""
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    out = list(hw.normalize_dense_box(res, t, boxes))
    l32 = next(l for l, (r, b) in enumerate(zip(res, out))
               if b is None and r >= 32)
    r = res[l32]
    mid = (x.median(0).values * r).floor().long().tolist()
    out[l32] = tuple(min(max(c - 10, 0), r - 21) for c in mid) + (20,) * 3
    if hw.box_morton_span(out[l32][3:]) != 32768:
        raise AssertionError(f"box {out[l32]} does not span 32768")
    return tuple(out), l32


def compare_kernels(trainer, x):
    """Phase 3: kernels vs plain version at the main path's shapes, on the
    points x of `fine_pass_points`, and the backward once more with a
    dense box of span 32,768. Returns the per-kernel records (without
    launch counts)."""
    import torch

    from spinnerf_tpu_torch.ops import hash_encode_win as hw

    dev = trainer.device
    enc = trainer.model.encoder
    res, bounds, boxes = enc.resolutions, enc.bounds, enc._boxes
    l, t, _ = enc.table.shape
    table, g = hash_inputs(enc.table.shape, dev)
    scatter_census("hash", x, res, t, bounds, boxes)

    # forward
    fwd_err, fwd_ms, fwd_plain_ms, base_ms, base_launches = hold_fwd(
        "hash", x, res, bounds, boxes, table)

    # backward
    bwd_err, bwd_ms, bwd_plain_ms = hold_bwd("hash", x, res, bounds, boxes,
                                             table, g)

    # a dense level of span 32,768, whatever the scene calibrated
    boxes32, l32 = box_32768(x, res, t, boxes)
    log(f"[kernels dense 32768] level {l32} (res {res[l32]}) box "
        f"{boxes32[l32]}")
    err32, ms32, _ = hold_bwd("dense 32768", x, res, bounds, boxes32, table,
                              g)
    big = big_table_holds(x, res)

    # least time: each input read once, each output written once. The
    # forward reads only the table entries this run's points touch.
    idx, _ = hw.corner_indices_weights_win(x, res, t, bounds, boxes)
    lvl = torch.arange(l, device=dev)[:, None, None] * t
    touched = int(torch.unique(idx + lvl).numel())
    del idx, lvl
    n = N_POINTS
    fwd_bytes = touched * 8 + n * 12 + n * 4 + n * l * 8
    bwd_bytes = n * l * 8 + n * 12 + n * 4 + l * t * 8
    # per (point, level): 3 axes x 5 geometry ops, 8 corners x (2 weight
    # products + ~10 integer hash ops), and the blend's 8 x 2 x 2 (fwd) or
    # the update's 8 x 2 products and 8 x 2 adds (bwd)
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
    records[0].update(point_base_ms=base_ms,
                      point_base_launches=base_launches)
    records[1].update(dense32768_ms=ms32, dense32768_max_abs_err=err32)
    for tag, (fwd, bwd) in big.items():
        records[0].update({f"t2_25_{tag}_ms": fwd[1],
                           f"t2_25_{tag}_plain_ms": fwd[2],
                           f"t2_25_{tag}_max_abs_err": fwd[0]})
        records[1].update({f"t2_25_{tag}_ms": bwd[1],
                           f"t2_25_{tag}_plain_ms": bwd[2],
                           f"t2_25_{tag}_max_abs_err": bwd[0]})
    log(f"[kernels] N={n} L={l} T={t}: touched table entries {touched}; "
        f"fwd {fwd_ms:.4f} ms (plain {fwd_plain_ms:.4f}; the page lookup "
        f"it took in, point_base, {base_ms:.4f} as PyTorch ops), "
        f"bwd {bwd_ms:.4f} ms (plain {bwd_plain_ms:.4f}); "
        f"library: no single PyTorch call computes this encode")
    return records


BIG_LOG2_T = 25        # JAX's largest windowed table (_pack_pages)


def big_table_holds(x, res):
    """Phase 3 at 16 x 2^25 x 2 (B1c): #1 and #2 held as at 2^19 on the
    points x, under uniform bounds with the default dense boxes and under
    bounds and boxes calibrated at 2^25 on every fourth point. Returns
    {"uniform" / "calibrated": (hold_fwd's, hold_bwd's results)}."""
    import torch

    from spinnerf_tpu_torch.models import hashgrid as hg
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    t = 1 << BIG_LOG2_T
    sample = x[::4].cpu().numpy()
    cal = (hg.calibrate_page_bounds(sample, BIG_LOG2_T),
           hg.calibrate_dense_box(sample, res, BIG_LOG2_T))
    # made on the card: 2^30 normal draws take seconds on the host
    table = torch.randn((len(res), t, 2), device=x.device,
                        generator=torch.Generator(x.device).manual_seed(2))
    _, g = hash_inputs((len(res), 1024, 2), x.device)
    out = {}
    for tag, (bounds, boxes) in (("uniform", (None, None)),
                                 ("calibrated", cal)):
        bt = hw.bounds_tensor(t, bounds, x.device)
        log(f"[kernels 2^25 {tag}] table {tuple(table.shape)} "
            f"({table.numel() * 4 / 2 ** 30:.1f} GiB), {hw.n_segments(t)} "
            f"segments, dense levels "
            f"{sum(b is not None for b in hw.normalize_dense_box(res, t, boxes))}")
        out[tag] = (hold_fwd(f"2^25 {tag}", x, res, bt, boxes, table),
                    hold_bwd(f"2^25 {tag}", x, res, bt, boxes, table, g))
    del table, g
    torch.cuda.empty_cache()
    return out


def hash_inputs(shape, dev, n=N_POINTS):
    """The random table and the cotangent of n points that phase 3 holds
    #1/#2 with."""
    import torch
    table = torch.randn(shape, generator=torch.Generator().manual_seed(2)
                        ).to(dev)
    g = torch.randn((n, 2 * shape[0]), generator=torch.Generator()
                    .manual_seed(3)).to(dev)
    return table, g


@contextlib.contextmanager
def recorded_encodes():
    """Within the block, each call of the windowed encode
    (`hash_encode_win_fused`, as the hash-grid field makes it) also appends
    a copy of its points [N, 3] to the list it yields."""
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    calls, fused = [], hw.hash_encode_win_fused

    def record(table, x, res, bounds=None, boxes=None):
        calls.append(x.detach().clone())
        return fused(table, x, res, bounds, boxes)
    hw.hash_encode_win_fused = record
    try:
        yield calls
    finally:
        hw.hash_encode_win_fused = fused


def bank_points(trainer, n_rays, seed):
    """(pts [n_rays, 128, 3], viewdirs [n_rays, 3]) as the fine pass draws
    them: bank rays of the 'clf' group x 128 stratified depths."""
    import torch

    from spinnerf_tpu_torch.core import sampling
    from spinnerf_tpu_torch.data import raybank
    gen = torch.Generator(trainer.device).manual_seed(seed)
    batch, _ = raybank.sample_group(trainer.bank, "clf", n_rays, step=1)
    z = sampling.stratified_z_vals(batch["near"], batch["far"], 128,
                                   generator=gen)
    return (sampling.ray_points(batch["origins"], batch["directions"], z),
            batch["viewdirs"])


def mlp_flops(dims, input_grads=False):
    """(forward, backward) multiply-add FLOPs per point that the fused MLP's
    function needs: the encodings counted at their unpadded widths (the
    products on the zero padding lanes are the kernel's, not the
    function's). The forward's products; the backward's recompute (all but
    the heads), weight gradients (every product) and the gradients of the
    activations it needs (the trunk's hidden part, the feature, the view
    layer's feature part, the heads), and with `input_grads` (the v1
    kernels) the encodings' gradients: layer 0's input, the skip layer's
    encoding slice and the view layer's direction slice."""
    w, vw = dims.width, dims.view_width
    enc_x = 3 * (1 + 2 * dims.multires)
    enc_d = 3 * (1 + 2 * dims.multires_views)
    heads = [(w, 1)] * (1 + dims.out_extra) + [(vw, 3)]
    body = [(enc_x if i == 0 else
             enc_x + w if i == dims.skip + 1 else w, w)
            for i in range(dims.depth)]
    body += [(w, w), (w + enc_d, vw)]
    dx = [(w, w)] * (dims.depth - 1) + [(w, w), (w, vw)] + heads
    if input_grads:
        dx += [(enc_x, w), (enc_x, w), (enc_d, vw)]
    fwd = 2 * sum(k * n for k, n in body + heads)
    bwd = (2 * sum(k * n for k, n in body) + fwd
           + 2 * sum(k * n for k, n in dx))
    return fwd, bwd


def library_chain(weights, dims, *, pre):
    """The yardstick: the same MLP as a chain of bf16 torch.matmul calls
    (cuBLAS) with f32 biases. Returns (fwd(inputs), the bf16 leaves it
    differentiates): inputs are (xd,), encoded in PyTorch, or with `pre`
    the v1 encodings (x_enc, d_enc). Timed only; the port never calls it."""
    import torch

    from spinnerf_tpu_torch.ops import fused_mlp as fm
    leaves = {n: (w.to(torch.bfloat16) if n.endswith("_w")
                  or n.startswith("tw") else w.clone()).requires_grad_()
              for n, w in weights.items()}

    def dense(a, w, b):
        return torch.matmul(a, leaves[w]).float() + leaves[b]

    def fwd(inputs):
        if pre:
            x, d = (a.bfloat16() for a in inputs)
        else:
            x = fm.encode(inputs[0], dims.multires, 0, dims.in_dim).bfloat16()
            d = fm.encode(inputs[0], dims.multires_views, 3,
                          dims.dir_dim).bfloat16()
        h = x
        for i in range(dims.depth):
            h = torch.relu(dense(h, f"tw{i}", f"tb{i}")).bfloat16()
            if i == dims.skip:
                h = torch.cat([x, h], dim=-1)
        heads = [dense(h, "sigma_w", "sigma_b")]
        if dims.out_extra:
            heads.append(dense(h, "sem_w", "sem_b"))
        feat = dense(h, "feat_w", "feat_b").bfloat16()
        v = torch.relu(dense(torch.cat([feat, d], -1), "view_w",
                             "view_b")).bfloat16()
        return torch.cat([dense(v, "rgb_w", "rgb_b")] + heads, dim=-1)

    return fwd, leaves


def out_of_bound(errs):
    """Names whose kernel error (relative to max |value| of the float64
    evaluation) exceeds twice the plain f32 version's own, or 1e-2.
    errs: name -> (kernel error, plain error, ...)."""
    return [n for n, (k, q, *_) in errs.items()
            if not (k <= 2 * q and k <= 1e-2)]


def relu_flips(weights, x, d, dims):
    """[P] bool: the points where a trunk or view ReLU mask of the v1 plain
    version in f32 differs from its float64 evaluation's. There the
    gradient of a point moves by a whole term between two evaluations."""
    import torch

    from spinnerf_tpu_torch.ops import fused_mlp as fm
    _, z32, _, _, v32, _ = fm._forward_acts(weights, x, d, dims,
                                            torch.float32)
    _, z64, _, _, v64, _ = fm._forward_acts(weights, x, d, dims,
                                            torch.float64)
    flip = (v32 > 0).ne(v64 > 0).any(1)
    for a, b in zip(z32, z64):
        flip |= (a > 0).ne(b > 0).any(1)
    return flip


def point_errs(k_, p_, ref, flip):
    """The errors of a per-point gradient [P, n] of the kernel (k_) and the
    plain f32 version (p_) against the float64 evaluation `ref`, relative
    to max |ref|: largest entry and normwise, ||a - ref|| / ||ref||; the
    plain version's largest entry on the points whose ReLU masks agree with
    float64 (`agree`) and on the `flip` points; the number of points where
    the kernel's largest entry is above min(2 x agree, 1e-2) (`over`), and
    how many of those are `flip` points."""
    den = ref.abs().max()
    e_k = (k_.double() - ref).abs().amax(1) / den
    e_p = (p_.double() - ref).abs().amax(1) / den
    agree = float(e_p[~flip].max())
    over = e_k > min(2 * agree, 1e-2)
    return {"max": (float(e_k.max()), float(e_p.max())),
            "norm": tuple(float((a.double() - ref).norm() / ref.norm())
                          for a in (k_, p_)),
            "agree": agree,
            "flipped": float(e_p[flip].max()) if flip.any() else 0.0,
            "n_flip": int(flip.sum()), "over": int(over.sum()),
            "over_flip": int((over & flip).sum())}


def point_out_of_bound(errs):
    """Names of per-point gradients out of bound. On all points: the
    kernel's largest-entry error at most twice the plain f32 version's, and
    its normwise error at most twice the plain version's and 1e-2. Point by
    point: the points where the kernel's largest entry breaks the 2x and
    1e-2 rule against the plain version's error on the points whose masks
    agree number at most twice the plain version's flipped points (the
    kernel flips masks of its own, which no evaluation can read back).
    errs: name -> `point_errs`."""
    return [n for n, e in errs.items()
            if not (e["max"][0] <= 2 * e["max"][1]
                    and e["norm"][0] <= 2 * e["norm"][1]
                    and e["norm"][0] <= 1e-2
                    and e["over"] <= 2 * e["n_flip"])]


def log_point_errs(errs):
    for n, e in errs.items():
        log(f"  {n}: largest entry kernel / plain f32 {e['max'][0]:.3e} / "
            f"{e['max'][1]:.3e}, normwise {e['norm'][0]:.3e} / "
            f"{e['norm'][1]:.3e}; ReLU masks f32 vs float64 differ at "
            f"{e['n_flip']} points, plain f32's largest entry there "
            f"{e['flipped']:.3e} and {e['agree']:.3e} on the others; the "
            f"kernel above min(2 x {e['agree']:.3e}, 1e-2) at {e['over']} "
            f"points ({e['over_flip']} of them flipped in plain f32)")


def time_bwd_passes(w, inputs, g, dims, *, pre, tag):
    """The fused MLP backward's two kernels timed apart with CUDA events:
    fm_bwd_kernel's executed rate (its products at the widths it multiplies,
    `ring_matrices`; the heads on the CUDA cores not counted) and
    fm_dw_kernel's rate reading the scratch, against reading it once at the
    HBM rate; each pass includes its fixed-order sums. Returns (ms of pass
    1, ms of pass 2)."""
    from spinnerf_tpu_torch.ops import fused_mlp as fm
    p = inputs[0].shape[0]
    run1, run2, scratch = fm.bwd_pass_fns(w, inputs, g, dims, pre=pre)
    ms1 = cuda_ms(run1)
    ms2 = cuda_ms(run2)
    flop = p * sum(2 * m.shape[0] * m.shape[1]
                   for m in fm.ring_matrices(w, dims, pre))
    floor = scratch / HBM_BYTES_PER_S * 1e3
    log(f"[{tag}] P={p} backward passes: fm_bwd_kernel {ms1:.4f} ms, "
        f"{flop / ms1 / 1e9:.1f} TFLOP/s executed ({flop:.4e} FLOP); "
        f"fm_dw_kernel {ms2:.4f} ms, {scratch / ms2 / 1e6:.1f} GB/s over "
        f"the {scratch:.4e}-byte scratch (read once: {floor:.4f} ms)")
    return ms1, ms2


def count_ring_packs(fn):
    """fn() with `fused_mlp.gather_ring` counted: (its result, how many
    times the fused MLP's weight ring was packed)."""
    from spinnerf_tpu_torch.ops import fused_mlp as fm
    real, calls = fm.gather_ring, []

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    fm.gather_ring = counted
    try:
        out = fn()
    finally:
        fm.gather_ring = real
    return out, len(calls)


def time_fwd(w, inputs, dims, out_k, *, pre, tag):
    """The fused MLP forward kernel alone (ring and heads packed once, its
    output equal to the kernel's `out_k` bit for bit) timed with CUDA
    events: its executed rate (its products at the widths it multiplies,
    the ring's first depth + 2 matrices; the heads on the CUDA cores not
    counted) and the rate at which its blocks stream those stages from L2.
    Returns its ms."""
    import torch

    from spinnerf_tpu_torch.ops import fused_mlp as fm
    p = inputs[0].shape[0]
    flop = p * sum(2 * m.shape[0] * m.shape[1]
                   for m in fm.ring_matrices(w, dims, pre)[:dims.depth + 2])
    ring_bytes = p // 64 * 2 * fm.forward_ring_elems(dims)
    run = fm.fwd_fn(w, inputs, dims, pre=pre)
    if not torch.equal(run(), out_k):
        raise AssertionError("the pre-packed forward differs from the kernel")
    ms = cuda_ms(run)
    log(f"[{tag}] P={p} forward kernel alone: {ms:.4f} ms, "
        f"{flop / ms / 1e9:.1f} TFLOP/s executed ({flop:.4e} FLOP), ring "
        f"stages {ring_bytes / ms / 1e6:.1f} GB/s ({ring_bytes:.4e} bytes a "
        f"launch)")
    return ms


def kernel_resources(build_log):
    """ptxas -v's report of each kernel entry in `build_log`: {mangled
    name: (registers, stack bytes, spill store bytes, spill load bytes)}."""
    import re
    res, name, frame = {}, None, (0, 0, 0)
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, frame = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            res[name] = (int(m.group(1)),) + frame
            name = None
    return res


def compare_mlp_kernels(trainer):
    """Phase 6: the fused MLP kernels against their plain version evaluated
    in float64 (same bf16 roundings). Returns the per-kernel records
    (without launch counts)."""
    import torch

    from spinnerf_tpu_torch.ops import fused_mlp as fm
    dev = trainer.device
    ms = {}
    for semantic, n_rays in ((False, N_POINTS // 128),
                             (True, N_POINTS_SEM // 128)):
        field = fm.FusedMLPField(semantic=semantic, device=dev)
        field.reset_parameters(torch.Generator().manual_seed(4))
        dims = field.dims
        gen = torch.Generator().manual_seed(5)
        w = {n: p.detach().clone() for n, p in field.weights.items()}
        for n in w:     # non-zero biases, so that every bias path counts
            if n.endswith("_b") or n.startswith("tb"):
                w[n] = (torch.randn(w[n].shape, generator=gen) * 0.1).to(dev)
        pts, vd = bank_points(trainer, n_rays, seed=1)
        p = pts.shape[0] * pts.shape[1]
        xd = torch.cat([pts.reshape(-1, 3),
                        vd[:, None].expand(pts.shape).reshape(-1, 3),
                        torch.zeros((p, 2), device=dev)], -1).contiguous()
        g = torch.randn((p, 4 + dims.out_extra), generator=gen).to(dev)

        out_k = fm.fused_mlp_pe_fwd_kernel(w, xd, dims)
        d_k = fm.fused_mlp_pe_bwd_kernel(w, xd, g, dims)
        out_p = fm.fused_mlp_pe_plain(w, xd, dims)
        d_p = fm.fused_mlp_pe_bwd_plain(w, xd, g, dims)
        out_64 = fm.fused_mlp_pe_plain(w, xd, dims, torch.float64)
        d_64 = fm.fused_mlp_pe_bwd_plain(w, xd, g, dims, torch.float64)
        torch.cuda.synchronize()

        # bound: the kernel's error relative to max |value| at most twice
        # the plain f32 version's own error against the float64 evaluation,
        # and at most 1e-2
        def rel(a, b):
            return float((a.double() - b).abs().max() / b.abs().max())

        errs = {"out": (rel(out_k, out_64), rel(out_p, out_64),
                        float((out_k.double() - out_64).abs().max()))}
        errs.update({n: (rel(d_k[n], d_64[n]), rel(d_p[n], d_64[n]),
                         float((d_k[n].double() - d_64[n]).abs().max()))
                     for n in d_64})
        log(f"[mlp kernels] P={p} out_extra={dims.out_extra}: relative "
            f"error vs the plain version in float64, kernel / plain f32:")
        log("  " + ", ".join(f"{n} {k:.3e}/{q:.3e}"
                             for n, (k, q, _) in errs.items()))
        bad = out_of_bound(errs)
        finite = torch.isfinite(out_k).all() and all(
            torch.isfinite(v).all() for v in d_k.values())
        if bad or not finite:
            raise AssertionError(f"fused MLP kernels disagree with the plain "
                                 f"version (bound: 2 x plain f32 and 1e-2): "
                                 f"{bad}, finite {bool(finite)}")

        # the autograd wrapper on CUDA tensors goes through the kernels, on
        # one weight ring
        leaves = {n: v.clone().requires_grad_() for n, v in w.items()}

        def autograd_call():
            out = fm.fused_mlp_pe(leaves, xd, dims)
            out.backward(g)
            return out

        out_a, packs = count_ring_packs(autograd_call)
        if packs != 1:
            raise AssertionError(f"forward and backward packed the weight "
                                 f"ring {packs} times, want once")
        if not torch.equal(out_a.detach(), out_k):
            raise AssertionError("autograd wrapper forward differs from kernel")
        if out_of_bound({n: (rel(leaves[n].grad, d_64[n]), errs[n][1])
                         for n in d_64}):
            raise AssertionError("autograd wrapper backward out of bound")

        # the backward's sums run in a fixed order: launches on the same
        # inputs, the autograd wrapper's included, are bit-equal
        same = repeats_equal(lambda: fm.fused_mlp_pe_bwd_kernel(w, xd, g,
                                                                dims), d_k)
        wrapped = all(torch.equal(leaves[n].grad, d_k[n]) for n in d_k)
        log(f"[mlp kernels] bwd: {DET_REPEATS} more launches bit-equal: "
            f"{same}; the autograd wrapper's gradients bit-equal: {wrapped}")
        if not (same and wrapped):
            raise AssertionError("the MLP backward is not reproducible")
        del d_p, out_64, d_64, leaves, out_a
        if semantic:
            continue

        lib_fwd, lib_leaves = library_chain(w, dims, pre=False)
        with torch.no_grad():
            ms["lib_fwd"] = cuda_ms(lambda: lib_fwd((xd,)))
        out_l = lib_fwd((xd,))
        ms["lib_bwd"] = cuda_ms(lambda: torch.autograd.grad(
            out_l, list(lib_leaves.values()), g, retain_graph=True))
        del out_l
        ms["fwd"] = cuda_ms(lambda: fm.fused_mlp_pe_fwd_kernel(w, xd, dims))
        ms["bwd"] = cuda_ms(lambda: fm.fused_mlp_pe_bwd_kernel(w, xd, g,
                                                               dims))
        time_fwd(w, (xd,), dims, out_k, pre=False, tag="mlp kernels")
        time_bwd_passes(w, (xd,), g, dims, pre=False, tag="mlp kernels")
        ms["plain_fwd"] = cuda_ms(lambda: fm.fused_mlp_pe_plain(w, xd, dims))
        ms["plain_bwd"] = cuda_ms(lambda: fm.fused_mlp_pe_bwd_plain(w, xd, g,
                                                                   dims))
        fwd_flops, bwd_flops = (f * p for f in mlp_flops(dims))
        n_w = sum(v.numel() for v in w.values())
        nbytes = {"fwd": p * 32 + n_w * 4 + out_k.numel() * 4,
                  "bwd": p * 32 + g.numel() * 4 + 2 * n_w * 4}
        flops = {"fwd": fwd_flops, "bwd": bwd_flops}
        main_errs = errs
    records = []
    for k, src_line in (("fwd", 411), ("bwd", 424)):
        bytes_ms = nbytes[k] / HBM_BYTES_PER_S * 1e3
        ops_ms = flops[k] / BF16_OPS_PER_S * 1e3
        err = (main_errs["out"][2] if k == "fwd" else
               max(e[2] for n, e in main_errs.items() if n != "out"))
        records.append({
            "name": f"fused_mlp_pe_{k}", "route": "cuda",
            "source": "spinnerf_tpu_torch/csrc/fused_mlp_pe.cu",
            "replaces": f"spinnerf_tpu/ops/fused_mlp.py:{src_line}",
            "max_abs_err": err, "ms": ms[k], "plain_ms": ms[f"plain_{k}"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": ms[f"lib_{k}"]})
    log(f"[mlp kernels] P={N_POINTS}: fwd {ms['fwd']:.4f} ms (plain "
        f"{ms['plain_fwd']:.4f}, bf16 matmul chain {ms['lib_fwd']:.4f}, "
        f"bound {records[0]['bound_ms']:.4f}: {flops['fwd']:.4e} FLOP); "
        f"bwd {ms['bwd']:.4f} ms (plain {ms['plain_bwd']:.4f}, chain's "
        f"autograd backward {ms['lib_bwd']:.4f}, bound "
        f"{records[1]['bound_ms']:.4f}: {flops['bwd']:.4e} FLOP)")
    return records


def train_arm(trainer, launches, tag):
    """Phases 4 and 7: train to STEPS with `launches` set to 0 just before
    and read just after; check loss, PSNR and >= 2 launches of each kernel
    per step. Returns (step_ms, launch counts)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.update(fwd=0, bwd=0)
    m1 = trainer.fit(1)
    psnr_1 = float(m1["psnr"])
    trainer.fit(10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_end = trainer.fit(STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(launches)
    step_ms = dt * 1e3 / (STEPS - 10)
    rays = trainer.cfg.N_rand * trainer._batches_per_step()
    loss_end, psnr_end = float(m_end["loss"]), float(m_end["psnr"])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train {tag}] {STEPS} steps: psnr step 1 {psnr_1:.3f} -> step "
        f"{STEPS} {psnr_end:.3f}, loss {loss_end:.5f}; {step_ms:.3f} ms/step "
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
    return step_ms, counts


BIG_STEPS = 50


def big_table_arm(scene, common):
    """Phase 4b (B1c): the hash arm's Trainer at `Config(prepare=True,
    log2_hashmap_size=25)` (16 x 2^25 x 2: a 4 GiB table, its gradient and
    two Adam moments) for BIG_STEPS steps: the PSNR at step 1 and at the
    end (it must rise), the step time over steps 2-BIG_STEPS, the peak
    device memory, and #1 / #2 at least twice a step. Returns a summary."""
    import torch

    from spinnerf_tpu_torch.config import Config
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    from spinnerf_tpu_torch.train.loop import Trainer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(Config(expname="prepare_2_25", log2_hashmap_size=BIG_LOG2_T,
                        **common), scene=scene, log=log)
    setup_s = time.perf_counter() - t0
    hw.launches.update(fwd=0, bwd=0)
    psnr_1 = float(tr.fit(1)["psnr"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_end = tr.fit(BIG_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (BIG_STEPS - 1)
    out = {"table": list(tr.model.encoder.table.shape), "setup_s": setup_s,
           "psnr_1": psnr_1, f"psnr_{BIG_STEPS}": float(m_end["psnr"]),
           "loss_end": float(m_end["loss"]), "step_ms": step_ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": dict(hw.launches)}
    log(json.dumps({"big_table_trainer": out}))
    del tr
    torch.cuda.empty_cache()
    if not (math.isfinite(out["loss_end"]) and out[f"psnr_{BIG_STEPS}"]
            > psnr_1):
        raise AssertionError("the 2^25 trainer's PSNR did not rise")
    if min(out["launches"].values()) < 2 * BIG_STEPS:
        raise AssertionError(f"the 2^25 trainer launched {out['launches']}")
    return out


def render_held_out(trainer, pose, gt_rgb, tag):
    """Phases 5 and 8: render the held-out view and check it."""
    import numpy as np
    import torch

    from spinnerf_tpu_torch.core.losses import mse, mse_to_psnr
    from spinnerf_tpu_torch.core.rendering import render_rays_chunked
    from spinnerf_tpu_torch.data import raybank
    from spinnerf_tpu_torch.train.loop import render_config
    cfg = trainer.cfg
    coarse, fine = trainer.field_fns()
    with torch.no_grad():
        batch, (h, w) = raybank.frame_ray_batch(
            trainer.bank.hwf, torch.as_tensor(pose, device=trainer.device),
            trainer.bank.near, trainer.bank.far)
        t0 = time.perf_counter()
        res = render_rays_chunked(batch, coarse,
                                  render_config(cfg, train=False), cfg.chunk,
                                  fine_field_fn=fine)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
    rgb = res.fine.rgb.reshape(h, w, 3)
    if rgb.shape != (H, W, 3) or not torch.isfinite(rgb).all():
        raise AssertionError("held-out render is not finite or has a wrong shape")
    gt = torch.as_tensor(gt_rgb, device=trainer.device)
    held_psnr = float(mse_to_psnr(mse(rgb, gt)))
    log(f"[render {tag}] held-out {H}x{W} view: PSNR {held_psnr:.3f} dB in "
        f"{render_s:.3f} s (chunk {cfg.chunk} rays)")
    if not np.isfinite(held_psnr):
        raise AssertionError("held-out PSNR is not finite")


def compare_idx_shape(tag, table, idx, w, plain, entry, g, entry_launches,
                      x=None, res=None):
    """Phase 9, one shape: the index-gather kernels with corners from idx / w
    (idx mode) against `plain` (table, idx, w) -> [N, L*2]-compatible
    output; `entry` is the autograd entry point that must reach them (its
    launches are added to `entry_launches`; the checks and the timing call
    the kernels directly). With
    points x and resolutions `res` (the instant-NGP index), points mode too:
    its forward bit-equal to idx mode's, its backward and its autograd
    entry `hash_encode_ngp_fused` held as idx mode's are. Returns (errors,
    times in ms, bound terms), keyed by mode."""
    import torch

    from spinnerf_tpu_torch.ops import hash_encode as he
    l, t, _ = table.shape
    n = idx.shape[2]
    idx32 = idx.to(torch.int32).contiguous()
    g3 = g.reshape(n, l, 2)

    out_k = he.hash_encode_idx_fwd_kernel(table, idx32, w)
    out_p = plain(table, idx, w).reshape(n, l, 2)
    torch.cuda.synchronize()
    err = {"fwd": float((out_k - out_p).abs().max())}
    fwd_rel = err["fwd"] / float(out_p.abs().max())

    # backward against the plain version evaluated in float64
    tab64 = table.double().requires_grad_()
    out64 = plain(tab64, idx, w)
    (dtab_64,) = torch.autograd.grad(out64, tab64,
                                     g3.double().reshape(out64.shape))
    del tab64, out64
    scale = float(dtab_64.abs().max())

    def bwd_rel(d):
        return float((d.double() - dtab_64).abs().max()) / scale

    dtab_k = he.hash_encode_idx_bwd_kernel(g3, idx32, w, table.shape)
    tab = table.clone().requires_grad_()
    out_g = plain(tab, idx, w)
    g_p = g3.reshape(out_g.shape)
    (dtab_p,) = torch.autograd.grad(out_g, tab, g_p, retain_graph=True)
    torch.cuda.synchronize()
    err["bwd"] = float((dtab_k.double() - dtab_64).abs().max())
    log(f"[idx kernels {tag}] L={l} T={t} N={n}: fwd max|kernel - plain| = "
        f"{err['fwd']:.3e} (relative {fwd_rel:.3e}, bound 1e-6); bwd "
        f"max|kernel - plain f64| = {err['bwd']:.3e} (relative "
        f"{bwd_rel(dtab_k):.3e}, bound 1e-5); plain f32 relative "
        f"{bwd_rel(dtab_p):.3e}; max|dtable| {scale:.3e}")
    if not (torch.isfinite(out_k).all() and fwd_rel <= 1e-6):
        raise AssertionError(f"{tag}: forward kernel disagrees with plain")
    if not (torch.isfinite(dtab_k).all() and bwd_rel(dtab_k) <= 1e-5):
        raise AssertionError(f"{tag}: backward kernel disagrees with plain")
    del dtab_p

    def hold_entry(fn, keys, *args):
        """The autograd entry point `fn` on CUDA tensors launches the
        forward and backward kernels counted under `keys` once each; its
        output equals the forward kernel's, its gradient is in bound."""
        launched = dict(he.launches)
        tab2 = table.clone().requires_grad_()
        out_a = fn(tab2, *args)
        out_a.backward(g3.reshape(out_a.shape))
        if any(he.launches[k] != launched[k] + 1 for k in keys):
            raise AssertionError(f"{tag}: {fn.__name__} missed the kernels")
        if not torch.equal(out_a.detach().reshape(n, l, 2), out_k):
            raise AssertionError(f"{tag}: {fn.__name__} forward differs "
                                 f"from the kernel")
        if bwd_rel(tab2.grad) > 1e-5:
            raise AssertionError(f"{tag}: {fn.__name__} backward out of "
                                 f"bound")
        for k in keys:
            entry_launches[k] += 1

    def hold_variant(key, variant, fn, *args):
        """The backward's fixed-order variant under `key` ("bwd": idx mode,
        "bwd_pts": points mode): within 1e-5 of float64, bit-equal over
        DET_REPEATS more launches, and taken once, bit-equal, by the
        autograd entry `fn` in deterministic mode; then timed."""
        d = variant()
        err[f"{key}_det"] = float((d.double() - dtab_64).abs().max())
        same = repeats_equal(variant, d)
        before = he.launches_det[key]
        tab2 = table.clone().requires_grad_()
        with deterministic_mode():
            out_a = fn(tab2, *args)
            out_a.backward(g3.reshape(out_a.shape))
        wrapped = (he.launches_det[key] - before == 1
                   and torch.equal(tab2.grad, d))
        log(f"[idx kernels {tag}] {key} fixed-order variant: max|variant - "
            f"plain f64| = {err[f'{key}_det']:.3e} (relative "
            f"{bwd_rel(d):.3e}, bound 1e-5); {DET_REPEATS} more launches "
            f"bit-equal: {same}; {fn.__name__} in deterministic mode took "
            f"it once, bit-equal: {wrapped}")
        if not (math.isfinite(err[f"{key}_det"]) and bwd_rel(d) <= 1e-5
                and same and wrapped):
            raise AssertionError(f"{tag}: the fixed-order {key} is out of "
                                 f"bound, not reproducible or not taken")
        entry_launches[f"{key}_det"] += 1
        ms[f"{key}_det"] = cuda_ms(variant)

    hold_entry(entry, ("fwd", "bwd"), idx, w)
    ms = {"fwd": cuda_ms(lambda: he.hash_encode_idx_fwd_kernel(table, idx32,
                                                               w)),
          "bwd": cuda_ms(lambda: he.hash_encode_idx_bwd_kernel(
              g3, idx32, w, table.shape)),
          "plain_fwd": cuda_ms(lambda: plain(table, idx, w)),
          "plain_bwd": cuda_ms(lambda: torch.autograd.grad(
              out_g, tab, g_p, retain_graph=True))}
    del out_g, tab
    hold_variant("bwd", lambda: he.hash_encode_idx_bwd_kernel(
        g3, idx32, w, table.shape, deterministic=True), entry, idx, w)

    # the yardsticks, one PyTorch call each, on flat indices into the
    # [L*T, 2] table laid out before the timed region: the forward as
    # embedding_bag (one bag of 8 weighted corners per (point, level), in
    # out's [N, L] order) and its autograd backward; the scatter alone as
    # one index_add_ of the precomputed w * g
    lvl = torch.arange(l, device=idx.device)[:, None, None] * t
    flat_idx = idx.long() + lvl                               # [L, 8, N]
    bag_idx = flat_idx.permute(2, 0, 1).reshape(n * l, 8).contiguous()
    bag_w = w.permute(2, 0, 1).reshape(n * l, 8).contiguous()
    flat_tab = table.reshape(l * t, 2)

    def bag(tb):
        return torch.nn.functional.embedding_bag(
            bag_idx, tb, per_sample_weights=bag_w, mode="sum")

    lib_rel = float((bag(flat_tab).reshape(n, l, 2) - out_p).abs().max()
                    ) / float(out_p.abs().max())
    ms["lib_fwd"] = cuda_ms(lambda: bag(flat_tab))
    tab_b = flat_tab.clone().requires_grad_()
    out_b = bag(tab_b)
    g_b = g3.reshape(n * l, 2)
    (dtab_b,) = torch.autograd.grad(out_b, tab_b, g_b, retain_graph=True)
    lib_bwd_rel = bwd_rel(dtab_b.reshape(table.shape))
    ms["lib_bag_bwd"] = cuda_ms(lambda: torch.autograd.grad(
        out_b, tab_b, g_b, retain_graph=True))
    del bag_idx, bag_w, tab_b, out_b, dtab_b
    flat_idx = flat_idx.reshape(-1)
    vals = (w[..., None] * g3.permute(1, 0, 2)[:, None]).reshape(-1, 2)
    flat = torch.zeros((l * t, 2), device=table.device)
    ms["lib_bwd"] = cuda_ms(lambda: flat.index_add_(0, flat_idx, vals))
    touched = int(torch.unique(flat_idx).numel())
    del flat_idx, vals, flat
    log(f"[idx kernels {tag}] touched table entries {touched}; fwd "
        f"{ms['fwd']:.4f} ms (plain {ms['plain_fwd']:.4f}, embedding_bag "
        f"{ms['lib_fwd']:.4f}, its relative error {lib_rel:.3e}), bwd "
        f"{ms['bwd']:.4f} ms (plain {ms['plain_bwd']:.4f}, index_add_ "
        f"{ms['lib_bwd']:.4f}, embedding_bag backward {ms['lib_bag_bwd']:.4f}"
        f", its relative error {lib_bwd_rel:.3e})")
    # a check that the yardstick computes this function, not a gate on its
    # rounding: its scatter order is its own
    if lib_rel > 1e-5 or lib_bwd_rel > 1e-4:
        raise AssertionError(f"{tag}: embedding_bag is not the same function")
    # least time: each input read once, each output written once; the
    # forward reads the table entries these corners touch. 32 flops a
    # (point, level): 8 corners x 2 features x (product + sum)
    corner_bytes = idx32.numel() * 4 + w.numel() * 4
    bound = {"fwd": (corner_bytes + n * l * 8 + touched * 8, n * l * 32),
             "bwd": (corner_bytes + n * l * 8 + l * t * 8, n * l * 32)}
    if x is None:
        return err, ms, bound

    # points mode: the corners rebuilt from x in the kernels
    plan = he.bwd_plan(tuple(res), t)
    out_x = he.hash_encode_ngp_fwd_kernel(table, x, res)
    dtab_x = he.hash_encode_ngp_bwd_kernel(g3, x, res, table.shape)
    torch.cuda.synchronize()
    err["fwd_pts"] = float((out_x - out_p).abs().max())
    err["bwd_pts"] = float((dtab_x.double() - dtab_64).abs().max())
    log(f"[idx kernels {tag}] points mode: fwd bit-equal to idx mode "
        f"{torch.equal(out_x, out_k)}; bwd max|kernel - plain f64| = "
        f"{err['bwd_pts']:.3e} (relative {bwd_rel(dtab_x):.3e}, bound 1e-5); "
        f"plan regime {plan.regime}, points {plan.points}, size {plan.size}")
    if not torch.equal(out_x, out_k):
        raise AssertionError(f"{tag}: points-mode forward differs from idx "
                             f"mode's")
    if not (torch.isfinite(dtab_x).all() and bwd_rel(dtab_x) <= 1e-5):
        raise AssertionError(f"{tag}: points-mode backward disagrees with "
                             f"plain")
    hold_entry(he.hash_encode_ngp_fused, ("fwd_pts", "bwd_pts"), x, res)
    hold_variant("bwd_pts", lambda: he.hash_encode_ngp_bwd_kernel(
        g3, x, res, table.shape, deterministic=True),
        he.hash_encode_ngp_fused, x, res)
    del dtab_x, dtab_64
    ms["fwd_pts"] = cuda_ms(lambda: he.hash_encode_ngp_fwd_kernel(table, x,
                                                                  res))
    ms["bwd_pts"] = cuda_ms(lambda: he.hash_encode_ngp_bwd_kernel(
        g3, x, res, table.shape))
    # the backward's regimes apart: the same kernel (zero fill included) on
    # the levels of each regime alone
    for name, code in (("staged", he.STAGED), ("map", he.MAP),
                       ("direct", he.DIRECT)):
        lv = [i for i, r in enumerate(plan.regime) if r == code]
        if lv:
            g_lv = g3[:, lv].contiguous()
            res_lv = tuple(res[i] for i in lv)
            ms[f"bwd_pts_{name}"] = cuda_ms(
                lambda: he.hash_encode_ngp_bwd_kernel(g_lv, x, res_lv,
                                                      (len(lv), t, 2)))
            log(f"[idx kernels {tag}] points-mode bwd, {name} levels {lv} "
                f"alone: {ms[f'bwd_pts_{name}']:.4f} ms")
    # its plain version: the index function, then the gather and blend

    def plain_pts(tb):
        return he.hash_encode_xla(tb, *he.corner_indices_weights_ngp(x, res,
                                                                    t))

    tab = table.clone().requires_grad_()
    out_g = plain_pts(tab)
    ms["plain_fwd_pts"] = cuda_ms(lambda: plain_pts(table))
    ms["plain_bwd_pts"] = cuda_ms(lambda: torch.autograd.grad(
        out_g, tab, g3, retain_graph=True))
    del out_g, tab
    # points mode's least time: x, not the corners; 32 flops a (point,
    # level) as above, and the index's ~130 integer and float operations
    pts_ops = n * l * (32 + 130)
    bound["fwd_pts"] = (n * 12 + n * l * 8 + touched * 8, pts_ops)
    bound["bwd_pts"] = (n * 12 + n * l * 8 + l * t * 8, pts_ops)
    log(f"[idx kernels {tag}] points mode: fwd {ms['fwd_pts']:.4f} ms "
        f"(idx mode {ms['fwd']:.4f}), bwd {ms['bwd_pts']:.4f} ms (idx mode "
        f"{ms['bwd']:.4f}); library: no single PyTorch call computes the "
        f"encode from the points")
    return err, ms, bound


def compare_idx_kernels(x, geom):
    """Phase 9: the index-gather kernels at (a) 16 x 2^19 x 2 with the
    instant-NGP index, (b) the same at 2^12, both in idx and in points
    mode, (c) the windowed index at 2^19 in idx mode; the census of (a)'s
    scatter. `geom` carries the default field's resolutions and
    calibration. Returns the records of shape (a) (points mode: the main
    path's; idx mode: launch counts from this phase's entry points)."""
    import torch

    from spinnerf_tpu_torch.ops import hash_encode as he
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    dev = x.device
    res = geom["res"]
    l = len(res)
    g = torch.randn((N_POINTS, 2 * l), generator=torch.Generator()
                    .manual_seed(7)).to(dev)
    ngp_census("phase 3", x, res, 1 << 19)
    entry_launches = dict.fromkeys(list(he.launches)
                                   + ["bwd_det", "bwd_pts_det"], 0)
    results = {}
    for tag, log2t in (("a: XOR 2^19", 19), ("b: XOR 2^12", 12)):
        idx, w = he.corner_indices_weights_ngp(x, res, 1 << log2t)
        # the card's int32 index arithmetic against the CPU's, bit for bit
        idx_c, w_c = he.corner_indices_weights_ngp(x[:8192].cpu(), res,
                                                   1 << log2t)
        if not (torch.equal(idx[..., :8192].cpu(), idx_c)
                and torch.equal(w[..., :8192].cpu(), w_c)):
            raise AssertionError(f"{tag}: corner indices differ from the CPU")
        table = torch.randn((l, 1 << log2t, 2), generator=torch.Generator()
                            .manual_seed(8)).to(dev)
        results[tag] = compare_idx_shape(tag, table, idx, w,
                                         he.hash_encode_xla,
                                         he.hash_encode_mxu, g,
                                         entry_launches, x, res)
        del idx, w, table
    t = 1 << 19
    idx, w = hw.corner_indices_weights_win(x, res, t, geom["bounds"],
                                           geom["boxes"])
    table = torch.randn((l, t, 2), generator=torch.Generator()
                        .manual_seed(9)).to(dev)
    compare_idx_shape("c: windowed 2^19", table, idx, w,
                      hw.hash_encode_exact, hw.hash_encode_win, g,
                      entry_launches)
    del idx, w, table
    torch.cuda.empty_cache()

    err, ms, bound = results["a: XOR 2^19"]
    records = []
    for name, k, lines, lib in (
            ("hash_encode_ngp_fwd", "fwd_pts", ":78", None),
            ("hash_encode_ngp_bwd", "bwd_pts", ":113", None),
            ("hash_encode_idx_fwd", "fwd", ":78, spinnerf_tpu/ops/"
             "hash_encode_win.py:316", "lib_fwd"),
            ("hash_encode_idx_bwd", "bwd", ":113, spinnerf_tpu/ops/"
             "hash_encode_win.py:359", "lib_bwd")):
        nbytes, ops = bound[k]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        records.append({
            "name": name, "route": "cuda",
            "source": "spinnerf_tpu_torch/csrc/hash_encode_idx.cu",
            "replaces": f"spinnerf_tpu/ops/hash_encode.py{lines}",
            "max_abs_err": err[k], "ms": ms[k],
            "plain_ms": ms[f"plain_{k}"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": ms[lib] if lib else None})
    # idx mode is on no main path: its launches are those of this phase's
    # calls of its entry points (a, b, c); the backward's second yardstick
    for r, k in zip(records[2:], ("fwd", "bwd")):
        r.update(launches=entry_launches[k], launches_from="phase 9's "
                 "hash_encode_mxu (a, b) and hash_encode_win (c)")
    records[3]["embedding_bag_bwd_ms"] = ms["lib_bag_bwd"]
    # the fixed-order variants (points mode's launches: phase 19 (b)'s XOR
    # arm; idx mode's: this phase's entry calls in deterministic mode)
    for key, rec in (("bwd_pts", records[1]), ("bwd", records[3])):
        DET_HELD[f"idx {key}"] = {
            "max_abs_err": err[f"{key}_det"], "ms": ms[f"{key}_det"],
            "atomic_ms": ms[key], "plain_ms": rec["plain_ms"],
            "ms_2_12": results["b: XOR 2^12"][1][f"{key}_det"],
            "launches_phase9": entry_launches[f"{key}_det"]}
    b = results["b: XOR 2^12"][1]
    records[0]["ms_2_12"], records[1]["ms_2_12"] = b["fwd_pts"], b["bwd_pts"]
    records[1]["regime_ms"] = {k[8:]: v for k, v in ms.items()
                               if k.startswith("bwd_pts_")
                               and not k.endswith("_det")}
    log(f"[idx kernels] shape a bound: points mode fwd "
        f"{records[0]['bound_ms']:.4f} ms ({bound['fwd_pts'][0]:.4e} bytes), "
        f"bwd {records[1]['bound_ms']:.4f} ms ({bound['bwd_pts'][0]:.4e} "
        f"bytes); idx mode fwd {records[2]['bound_ms']:.4f} ms "
        f"({bound['fwd'][0]:.4e} bytes), bwd {records[3]['bound_ms']:.4f} "
        f"ms ({bound['bwd'][0]:.4e} bytes); library: embedding_bag (idx "
        f"fwd), index_add_ (idx bwd), none (points mode)")
    return records


def xor_arm(scene, held_pose, held_rgb, common, argv):
    """Phase 10: the XOR-prime hash arm with its hooks. Returns the launch
    counts of the index-gather kernels over the run."""
    import numpy as np
    import torch

    from spinnerf_tpu_torch.config import Config
    from spinnerf_tpu_torch.eval.render import read_png
    from spinnerf_tpu_torch.ops import hash_encode as he
    from spinnerf_tpu_torch.train.loop import Trainer
    stamps = []

    def stamped_log(msg):
        stamps.append((time.perf_counter(), msg))
        log(msg)

    cfg = Config(expname="xor_prepare", hash_impl="mxu", llffhold=8,
                 **dict(common, i_feat=STEPS, i_testset=STEPS))
    tr = Trainer(cfg, scene=scene, log=stamped_log)
    enc = tr.model.encoder
    log(f"[setup xor] encoder impl {enc.impl}, table "
        f"{tuple(enc.table.shape)}, test views {tr.i_test.tolist()}")
    if enc.impl != "mxu" or tuple(enc.table.shape) != (16, 1 << 19, 2):
        raise AssertionError("the XOR arm is not the 16 x 2^19 x 2 mxu field")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    he.launches.update(fwd=0, bwd=0, fwd_pts=0, bwd_pts=0)
    psnr_1 = float(tr.fit(1, hooks=False)["psnr"])
    tr.fit(10, hooks=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.fit(STEPS - 1, hooks=False)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (STEPS - 11)
    timed_counts = dict(he.launches)
    peak_train = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    # step STEPS through the Trainer's hooks: the testset dump (i_testset)
    # and the LaMa staging (i_feat; forced at the last step)
    t0 = time.perf_counter()
    m_end = tr.fit(STEPS)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = dict(he.launches)
    t_test = next(t for t, m in stamps if "testset PSNR" in m)
    t_dump = next(t for t, m in stamps if "LaMa guidance" in m)
    psnr_end, loss_end = float(m_end["psnr"]), float(m_end["loss"])
    rays = cfg.N_rand * tr._batches_per_step()
    peak_hooks = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train xor] {STEPS} steps: psnr step 1 {psnr_1:.3f} -> step "
        f"{STEPS} {psnr_end:.3f}, loss {loss_end:.5f}; {step_ms:.3f} ms/step "
        f"(steps 11-{STEPS - 1}), {rays / step_ms * 1e3:.0f} rays/s; step "
        f"{STEPS} + testset {t_test - t0:.3f} s, prepare dump "
        f"{t_dump - t_test:.3f} s (total {t_end - t0:.3f} s); peak memory "
        f"{peak_train:.2f} GiB training, {peak_hooks:.2f} GiB in step "
        f"{STEPS} and its hooks; launches steps 1-{STEPS - 1} "
        f"{timed_counts}, with step {STEPS} and its hooks {counts}")
    if not math.isfinite(loss_end):
        raise AssertionError("loss is not finite")
    if not psnr_end > psnr_1:
        raise AssertionError("PSNR did not rise")
    # the field rebuilds its corners in the kernels: points mode only
    for k in ("fwd_pts", "bwd_pts"):
        if timed_counts[k] < 2 * (STEPS - 1):
            raise AssertionError(f"{k} kernel launched {timed_counts[k]} "
                                 f"times in {STEPS - 1} steps")
    if timed_counts["fwd"] or timed_counts["bwd"]:
        raise AssertionError(f"idx-mode kernels launched in steps 1-"
                             f"{STEPS - 1}: {timed_counts}")

    # the dump: one PNG per view and per mask, 336 x 252 8-bit grayscale
    out = tr.exp_dir / "lama_input"
    names = [f"img{i:03}.png" for i in range(N_VIEWS)]
    for d in (out, out / "label"):
        if sorted(p.name for p in d.glob("*.png")) != names:
            raise AssertionError(f"{d} does not hold one PNG per view")
        for name in names:
            shape = read_png(d / name).shape
            if shape != (H, W):
                raise AssertionError(f"{d / name}: {shape}, want ({H}, {W})")
    _, disps = tr.render_poses_list(scene.poses[:1])
    d0 = disps[0]
    png0 = read_png(out / "img000.png")
    if not (np.isfinite(d0).all() and d0.std() > 0 and png0.std() > 0):
        raise AssertionError("dumped disparity not finite or constant")
    # the same render again: one 8-bit level of slack for a last-bit change
    want0 = np.clip(d0 * 255, 0, 255).astype(np.uint8).astype(np.int64)
    if np.abs(png0.astype(np.int64) - want0).max() > 1:
        raise AssertionError("img000.png is not the view's disparity")
    lbl0 = read_png(out / "label" / "img000.png")
    if not np.array_equal(lbl0, (scene.masks[0] * 255).astype(np.uint8)):
        raise AssertionError("label/img000.png is not the view's mask")
    ps = json.loads((tr.exp_dir / f"testset_{STEPS:06d}" / "psnr.json")
                    .read_text())
    log(f"[hooks xor] lama_input/ and label/: {N_VIEWS} PNGs each, {W} x {H};"
        f" disparity range {d0.min():.4f}-{d0.max():.4f}; testset PSNR "
        f"{ps['per_view']} (mean {ps['mean']:.3f})")
    if not math.isfinite(ps["mean"]):
        raise AssertionError("testset PSNR is not finite")
    render_held_out(tr, held_pose, held_rgb, "xor")
    if "--profile" in argv:
        profile_steps(tr, step_ms)
    return counts


def compare_mlp_v1_kernels(points):
    """Phase 11: the v1 fused MLP kernels (#7/#8: encodings computed outside,
    input gradients returned) against their plain version evaluated in
    float64, at the fine pass's shape and, with the semantic head, at
    131,072 points; then `make_fused_field_fn` on CUDA tensors with the
    points' gradient. points: semantic -> (pts [R, 128, 3], viewdirs [R, 3]).
    Returns the per-kernel records with the launch counts of the entry
    point's call at the fine pass's shape."""
    import torch

    from spinnerf_tpu_torch.ops import fused_mlp as fm
    dev = points[False][0].device
    ms = {}
    for semantic in (False, True):
        field = fm.FusedMLPField(semantic=semantic, device=dev)
        field.reset_parameters(torch.Generator().manual_seed(4))
        dims = field.dims
        gen = torch.Generator().manual_seed(6)
        w = {n: p.detach().clone() for n, p in field.weights.items()}
        for n in w:     # non-zero biases, so that every bias path counts
            if n.endswith("_b") or n.startswith("tb"):
                w[n] = (torch.randn(w[n].shape, generator=gen) * 0.1).to(dev)
        pts, vd = points[semantic]
        b, s = pts.shape[0], pts.shape[1]
        x, d = fm.field_encodings(pts, vd, dims)
        p = x.shape[0]
        g = torch.randn((p, 4 + dims.out_extra), generator=gen).to(dev)

        out_k = fm.fused_mlp_fwd_kernel(w, x, d, dims)
        d_k, dx_k, dd_k = fm.fused_mlp_bwd_kernel(w, x, d, g, dims)
        out_p = fm.fused_mlp_fwd_plain(w, x, d, dims)
        d_p, dx_p, dd_p = fm.fused_mlp_bwd_plain(w, x, d, g, dims)
        out_64 = fm.fused_mlp_fwd_plain(w, x, d, dims, torch.float64)
        d_64, dx_64, dd_64 = fm.fused_mlp_bwd_plain(w, x, d, g, dims,
                                                    torch.float64)
        torch.cuda.synchronize()

        def rel(a, ref):
            return float((a.double() - ref).abs().max() / ref.abs().max())

        def err(name, k_, p_, ref):
            return name, (rel(k_, ref), rel(p_, ref),
                          float((k_.double() - ref).abs().max()))

        errs = dict([err("out", out_k, out_p, out_64)]
                    + [err(n, d_k[n], d_p[n], d_64[n]) for n in d_64])
        # the per-point input gradients: a ReLU unit whose pre-activation
        # lies within rounding of 0 flips its mask between two evaluations
        # and moves that point's gradient by a whole term, so their largest
        # entry error is large for the plain f32 version too; the points
        # where the plain version flips are counted
        flip = relu_flips(w, x, d, dims)
        pt_errs = {n: point_errs(k_, p_, ref, flip)
                   for n, k_, p_, ref in (("dx", dx_k, dx_p, dx_64),
                                          ("dd", dd_k, dd_p, dd_64))}
        log(f"[mlp v1 kernels] P={p} out_extra={dims.out_extra}: relative "
            f"error vs the plain version in float64, kernel / plain f32:")
        log("  " + ", ".join(f"{n} {k:.3e}/{q:.3e}"
                             for n, (k, q, _) in errs.items()))
        log_point_errs(pt_errs)
        bad = out_of_bound(errs) + point_out_of_bound(pt_errs)
        finite = all(torch.isfinite(v).all() for v in
                     [out_k, dx_k, dd_k, *d_k.values()])
        if bad or not finite:
            raise AssertionError(f"v1 fused MLP kernels disagree with the "
                                 f"plain version (bound: 2 x plain f32 and "
                                 f"1e-2): {bad}, finite {bool(finite)}")
        # the backward's sums run in a fixed order: bit-equal launches
        same = repeats_equal(lambda: fm.fused_mlp_bwd_kernel(w, x, d, g,
                                                             dims),
                             (d_k, dx_k, dd_k))
        log(f"[mlp v1 kernels] bwd: {DET_REPEATS} more launches bit-equal: "
            f"{same}")
        if not same:
            raise AssertionError("the v1 MLP backward is not reproducible")
        errs.update({n: e["max"] + (float((k_.double() - ref).abs().max()),)
                     for (n, e), k_, ref in zip(pt_errs.items(),
                                                (dx_k, dd_k),
                                                (dx_64, dd_64))})
        pad = {"dx[:, 63:]": dx_k[:, 63:], "dd[:, 27:]": dd_k[:, 27:],
               "dtw0[63:]": d_k["tw0"][63:]}
        if any(float(v.abs().max()) != 0.0 for v in pad.values()):
            raise AssertionError(f"padded lanes not exactly 0: "
                                 f"{ {n: float(v.abs().max()) for n, v in pad.items()} }")

        # the entry point on CUDA tensors, with the points' gradient: it
        # must go through #7 and #8; its point gradients are held against
        # the encodings' backward of the float64 plain dx (and of the f32
        # plain dx beside it)
        fm.launches_v1.update(fwd=0, bwd=0)
        pts_a = pts.clone().requires_grad_()
        leaves = {n: v.clone().requires_grad_() for n, v in w.items()}

        def entry_call():
            out = fm.make_fused_field_fn(dims)(leaves, pts_a, vd)
            out.backward(g[:b * s].reshape(b, s, -1))
            return out

        out_a, packs = count_ring_packs(entry_call)
        torch.cuda.synchronize()
        counts = dict(fm.launches_v1)
        if counts != {"fwd": 1, "bwd": 1} or packs != 1:
            raise AssertionError(f"make_fused_field_fn launched {counts} and "
                                 f"packed the ring {packs} times, want #7 "
                                 f"and #8 once each on one ring")
        if not torch.equal(out_a.detach().reshape(b * s, -1),
                           out_k[:b * s]):
            raise AssertionError("entry point forward differs from kernel")
        pts_r = pts.clone().requires_grad_()
        x_r, _ = fm.field_encodings(pts_r, vd, dims)
        (dpts_64,) = torch.autograd.grad(x_r, pts_r, dx_64.float(),
                                         retain_graph=True)
        (dpts_p,) = torch.autograd.grad(x_r, pts_r, dx_p)
        pts_errs = {"dpts": point_errs(pts_a.grad.reshape(-1, 3),
                                       dpts_p.reshape(-1, 3),
                                       dpts_64.double().reshape(-1, 3),
                                       flip[:b * s])}
        log(f"[mlp v1 kernels] make_fused_field_fn: launches {counts}, "
            f"ring packs {packs}; the points' gradients:")
        log_point_errs(pts_errs)
        if point_out_of_bound(pts_errs):
            raise AssertionError("point gradients out of bound")
        del d_p, out_64, d_64, dx_64, dd_64, leaves, out_a, pts_a, pts_r
        if semantic:
            continue
        main_counts, main_errs = counts, errs

        lib_fwd, lib_leaves = library_chain(w, dims, pre=True)
        with torch.no_grad():
            ms["lib_fwd"] = cuda_ms(lambda: lib_fwd((x, d)))
        x_l, d_l = x.clone().requires_grad_(), d.clone().requires_grad_()
        out_l = lib_fwd((x_l, d_l))
        wrt = list(lib_leaves.values()) + [x_l, d_l]
        ms["lib_bwd"] = cuda_ms(lambda: torch.autograd.grad(
            out_l, wrt, g, retain_graph=True))
        del out_l, x_l, d_l
        ms["fwd"] = cuda_ms(lambda: fm.fused_mlp_fwd_kernel(w, x, d, dims))
        ms["bwd"] = cuda_ms(lambda: fm.fused_mlp_bwd_kernel(w, x, d, g, dims))
        time_fwd(w, (x, d), dims, out_k, pre=True, tag="mlp v1 kernels")
        time_bwd_passes(w, (x, d), g, dims, pre=True, tag="mlp v1 kernels")
        ms["plain_fwd"] = cuda_ms(lambda: fm.fused_mlp_fwd_plain(w, x, d,
                                                                 dims))
        ms["plain_bwd"] = cuda_ms(lambda: fm.fused_mlp_bwd_plain(w, x, d, g,
                                                                 dims))
        fwd_flops, bwd_flops = (f * p for f in mlp_flops(dims, True))
        n_w = sum(v.numel() for v in w.values())
        enc_bytes = (x.numel() + d.numel()) * 4     # the padded 128 lanes
        nbytes = {"fwd": enc_bytes + n_w * 4 + out_k.numel() * 4,
                  "bwd": 2 * enc_bytes + g.numel() * 4 + 2 * n_w * 4}
        flops = {"fwd": fwd_flops, "bwd": bwd_flops}
    records = []
    for k, src_line in (("fwd", 106), ("bwd", 115)):
        bytes_ms = nbytes[k] / HBM_BYTES_PER_S * 1e3
        ops_ms = flops[k] / BF16_OPS_PER_S * 1e3
        err = (main_errs["out"][2] if k == "fwd" else
               max(e[2] for n, e in main_errs.items() if n != "out"))
        records.append({
            "name": f"fused_mlp_{k}", "route": "cuda",
            "source": "spinnerf_tpu_torch/csrc/fused_mlp_pe.cu",
            "replaces": f"spinnerf_tpu/ops/fused_mlp.py:{src_line}",
            "launches": main_counts[k], "max_abs_err": err, "ms": ms[k],
            "plain_ms": ms[f"plain_{k}"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": ms[f"lib_{k}"]})
    log(f"[mlp v1 kernels] P={N_POINTS}: fwd {ms['fwd']:.4f} ms (plain "
        f"{ms['plain_fwd']:.4f}, bf16 matmul chain {ms['lib_fwd']:.4f}, "
        f"bound {records[0]['bound_ms']:.4f}: {flops['fwd']:.4e} FLOP, "
        f"{nbytes['fwd']:.4e} bytes); bwd {ms['bwd']:.4f} ms (plain "
        f"{ms['plain_bwd']:.4f}, chain's autograd backward "
        f"{ms['lib_bwd']:.4f}, bound {records[1]['bound_ms']:.4f}: "
        f"{flops['bwd']:.4e} FLOP, {nbytes['bwd']:.4e} bytes)")
    return records


CAL_BLOCKS = 4096
CAL_CASES = ((64, 8), (128, 8), (64, 64), (128, 64))   # (k, reps)


def compare_calibration(device):
    """Phase 12: the calibration kernel (#11) against its plain version on
    random bf16 inputs at k = 64 and 128, reps 8 and 64, 4096 blocks (within
    1e-5 relative); then the port's `calibrate` entry point at each case,
    with the launch count set to 0 just before and read just after; then
    the plain version and the library yardstick (reps torch.bmm calls in
    bf16) timed. Returns the kernel's record (k 128, reps 8, the JAX
    defaults) with every case's numbers under "cases"."""
    import torch

    from spinnerf_tpu_torch.tools import kbench
    gen = torch.Generator(device).manual_seed(10)
    a = torch.randn((CAL_BLOCKS, 128, 128), generator=gen, device=device
                    ).to(torch.bfloat16)
    b = torch.randn((CAL_BLOCKS, 128, 512), generator=gen, device=device
                    ).to(torch.bfloat16)
    errs = {}
    for k, reps in CAL_CASES:
        out_k = kbench.cal_kernel(a, b, k, reps)
        out_p = kbench.cal_plain(a, b, k, reps)
        torch.cuda.synchronize()
        errs[k, reps] = (float((out_k.double() - out_p).abs().max()),
                         float((out_k.double() - out_p).abs().max()
                               / out_p.abs().max()))
        del out_k, out_p
        if not errs[k, reps][1] <= 1e-5:
            raise AssertionError(f"calibration kernel disagrees with its "
                                 f"plain version at k={k} reps={reps}: "
                                 f"{errs[k, reps][1]:.3e} > 1e-5")
    kbench.launches["cal"] = 0
    timed = {c: kbench.calibrate(*c, blocks=CAL_BLOCKS, device=device,
                                 log=lambda m: log(f"[calibration] {m}"))
             for c in CAL_CASES}
    torch.cuda.synchronize()
    launches = kbench.launches["cal"]
    cases = []
    for k, reps in CAL_CASES:
        a_k, b_k = a[:, :, :k], b[:, :k, :]
        plain_ms = cuda_ms(lambda: kbench.cal_plain(a, b, k, reps), iters=5,
                           warmup=1)
        lib_ms = cuda_ms(lambda: [torch.bmm(a_k, b_k) for _ in range(reps)])
        flops = kbench.cal_flops(k, reps, CAL_BLOCKS)
        nbytes = CAL_BLOCKS * (128 * k * 2 + k * 512 * 2 + 128 * 512 * 4)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_OPS_PER_S * 1e3
        ms, tflops = timed[k, reps]
        cases.append({"k": k, "reps": reps, "ms": ms, "tflops": tflops,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "library_tflops": flops / (lib_ms * 1e-3) / 1e12,
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": ("bytes" if bytes_ms >= ops_ms
                                   else "operations"),
                      "max_abs_err": errs[k, reps][0],
                      "rel_err": errs[k, reps][1]})
        log(f"[calibration] k={k} reps={reps}: kernel {ms:.4f} ms = "
            f"{tflops:.1f} TFLOP/s (nominal {BF16_OPS_PER_S / 1e12:.0f}); "
            f"torch.bmm bf16 x {reps} {lib_ms:.4f} ms = "
            f"{cases[-1]['library_tflops']:.1f} TFLOP/s; plain f32 "
            f"{plain_ms:.4f} ms; bound {cases[-1]['bound_ms']:.4f} ms "
            f"({cases[-1]['bound_by']}: {nbytes:.4e} bytes, {flops:.4e} "
            f"FLOP); relative error {errs[k, reps][1]:.3e}")
    if launches < len(CAL_CASES):
        raise AssertionError(f"calibrate launched the kernel {launches} "
                             f"times")
    main = next(c for c in cases if (c["k"], c["reps"]) == (128, 8))
    return {"name": "kbench_cal", "route": "cuda",
            "source": "spinnerf_tpu_torch/csrc/kbench_cal.cu",
            "replaces": "tools/kbench.py:63", "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "cases": cases}


DISK_H, DISK_W, DISK_FACTOR = 504, 672, 2   # written; loaded at 252 x 336


def det_holds_on(tag, tr, x):
    """Reproducibility on an arm's own points (#2's variant is held by
    hold_bwd): #6's fixed-order variant (the instant-NGP points-mode
    backward) on the fine-pass points x at the arm's table size, within
    1e-5 of float64; #10 and #8, whose sums always run in a fixed order,
    with phase 6's MLP weights on the fine pass of the arm's bank rays,
    their weight gradients within phase 6's bound; each bit-equal over
    DET_REPEATS more launches."""
    import torch

    from spinnerf_tpu_torch.ops import fused_mlp as fm
    from spinnerf_tpu_torch.ops import hash_encode as he
    dev = tr.device
    res = tr.model.encoder.resolutions
    shape = (len(res), tr.model.encoder.table.shape[1], 2)
    table, g = hash_inputs(shape, dev)
    g3 = g.reshape(-1, len(res), 2)
    idx, w = he.corner_indices_weights_ngp(x, res, shape[1])
    tab64 = table.double().requires_grad_()
    (d64,) = torch.autograd.grad(he.hash_encode_xla(tab64, idx, w), tab64,
                                 g3.double())
    del tab64, idx, w

    def v6():
        return he.hash_encode_ngp_bwd_kernel(g3, x, res, shape,
                                             deterministic=True)

    d = v6()
    rel6 = float((d.double() - d64).abs().max() / d64.abs().max())
    same6 = repeats_equal(v6, d)
    del d, d64, table, g, g3

    field = fm.FusedMLPField(device=dev)
    field.reset_parameters(torch.Generator().manual_seed(4))
    dims = field.dims
    gen = torch.Generator().manual_seed(5)
    w = {n: p.detach().clone() for n, p in field.weights.items()}
    for n in w:
        if n.endswith("_b") or n.startswith("tb"):
            w[n] = (torch.randn(w[n].shape, generator=gen) * 0.1).to(dev)
    pts, vd = bank_points(tr, N_POINTS // 128, seed=1)
    p = pts.shape[0] * pts.shape[1]
    xd = torch.cat([pts.reshape(-1, 3),
                    vd[:, None].expand(pts.shape).reshape(-1, 3),
                    torch.zeros((p, 2), device=dev)], -1).contiguous()
    xe, de = fm.field_encodings(pts, vd, dims)
    gm = torch.randn((p, 4), generator=gen).to(dev)

    def rel(a, ref):
        return float((a.double() - ref).abs().max() / ref.abs().max())

    out = {"ngp_bwd": (rel6, same6)}
    for name, variant, plain in (
            ("fused_mlp_pe_bwd",
             lambda: fm.fused_mlp_pe_bwd_kernel(w, xd, gm, dims),
             lambda dt: fm.fused_mlp_pe_bwd_plain(w, xd, gm, dims, dt)),
            ("fused_mlp_bwd",
             lambda: fm.fused_mlp_bwd_kernel(w, xe, de, gm, dims)[0],
             lambda dt: fm.fused_mlp_bwd_plain(w, xe, de, gm, dims, dt)[0])):
        d_d = variant()
        d_p, d_64 = plain(torch.float32), plain(torch.float64)
        errs = {n: (rel(d_d[n], d_64[n]), rel(d_p[n], d_64[n]))
                for n in d_64}
        same = repeats_equal(variant, d_d)
        out[name] = (max(e[0] for e in errs.values()), same)
        if out_of_bound(errs) or not same:
            raise AssertionError(f"{tag}: {name} is out of bound or not "
                                 f"reproducible: {errs}")
        del d_d, d_p, d_64
    log(f"[det {tag}] #6's fixed-order variant, #10 and #8 on this arm's "
        f"points (largest relative error vs float64, {DET_REPEATS} more "
        f"launches bit-equal): {out}")
    if not (rel6 <= 1e-5 and same6):
        raise AssertionError(f"{tag}: the fixed-order instant-NGP backward "
                             f"is out of bound or not reproducible")
    DET_HELD[f"{tag} points"] = out
    torch.cuda.empty_cache()


def disk_arm(exp_root, argv):
    """Phase 13: a scene written to disk by the port's `make_scene`, loaded
    by `Trainer` (no scene handed in) at the reference's DS-NeRF prepare
    configuration with COLMAP sparse depth; 200 steps, then the prepare
    dump. Before training, phase 3's census and forward and backward
    checks on this arm's points. Returns the launch counts of the hash
    kernels over the 200 steps, and the forward's (max abs error, ms, plain
    ms, point_base ms, point_base launches) and the backward's (max abs
    error, ms, plain ms)."""
    import numpy as np
    import torch

    from spinnerf_tpu_torch.config import Config
    from spinnerf_tpu_torch.data import synthetic
    from spinnerf_tpu_torch.eval.render import read_png
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    from spinnerf_tpu_torch.train.loop import Trainer

    # 1. the scene directory
    scene_dir = exp_root / "disk_scene"
    shutil.rmtree(scene_dir, ignore_errors=True)
    t0 = time.perf_counter()
    synthetic.make_scene(scene_dir, n_views=N_VIEWS, h=DISK_H, w=DISK_W,
                         factor=DISK_FACTOR, n_points=3000)
    write_s = time.perf_counter() - t0

    # 2. one written image against its in-memory render (the file holds
    # the render truncated to 8 bits)
    th = 2 * np.pi * 5 / N_VIEWS
    pos = np.array([3.5 * np.cos(th), 3.5 * np.sin(th),
                    2.0 + 0.3 * np.sin(3 * th)])
    focal = 1.2 * DISK_W / DISK_FACTOR
    rgb, _, _ = synthetic.render_view(
        synthetic.look_at_pose(pos, target=(0, 0, 0.3)),
        DISK_H // DISK_FACTOR, DISK_W // DISK_FACTOR, focal)
    png = read_png(scene_dir / f"images_{DISK_FACTOR}" / "view005.png")
    png_err = float(np.abs(png / 255.0 - rgb).max())
    if png.shape != (H, W, 3) or not png_err < 1 / 255:
        raise AssertionError(f"view005.png: shape {png.shape}, largest "
                             f"difference from its render {png_err}")

    # 3. the DS-NeRF prepare configuration (`tools/full_run.py:128-147`,
    # the hash grid's lr 0.03 / decay 10), loaded from the directory
    cfg = Config(expname="disk_prepare", basedir=str(exp_root),
                 datadir=str(scene_dir), dataset_type="llff",
                 factor=DISK_FACTOR, prepare=True, N_rand=1024, N_samples=64,
                 N_importance=64, use_viewdirs=True, raw_noise_std=1.0,
                 colmap_depth=True, depth_loss=True, depth_lambda=0.1,
                 no_ndc=True, lindisp=True, render_factor=1, feat_weight=0.1,
                 lrate=0.03, lrate_decay=10, white_bkgd=True, no_reload=True,
                 N_iters=STEPS, i_print=50, i_weights=0, i_video=0,
                 i_testset=0, i_feat=0)
    t0 = time.perf_counter()
    tr = Trainer(cfg, log=log)
    setup_s = time.perf_counter() - t0
    n_depth = tr.bank.depth_group.count if tr.bank.depth_group else 0
    rays = cfg.N_rand * tr._batches_per_step()
    log(f"[setup disk] scene written in {write_s:.3f} s ({N_VIEWS} views at "
        f"{DISK_W} x {DISK_H}, factor {DISK_FACTOR}); view005.png vs its "
        f"render: largest difference {png_err:.5f}; Trainer in "
        f"{setup_s:.3f} s, of which scene load {tr.load_s['scene']:.3f} s and "
        f"sparse-depth read {tr.load_s['sparse_depth']:.4f} s; images "
        f"{tr.scene.images.shape}, depth rays {n_depth}, rays per step "
        f"{rays}, encoder {tr.model.encoder.impl} "
        f"{tuple(tr.model.encoder.table.shape)}")
    if not n_depth > 0:
        raise AssertionError("the depth group holds no rays")
    if tr.scene.images.shape != (N_VIEWS, H, W, 3):
        raise AssertionError(f"loaded images {tr.scene.images.shape}")

    # phase 3's forward and backward checks on this arm's points: the
    # loaded scene's recentred, rescaled world and its own calibration
    enc = tr.model.encoder
    x = fine_pass_points(tr)
    scatter_census("disk", x, enc.resolutions, enc.table.shape[1],
                   enc.bounds, enc._boxes)
    ngp_census("disk", x, enc.resolutions, enc.table.shape[1])
    table, g = hash_inputs(enc.table.shape, tr.device)
    held_fwd = hold_fwd("disk", x, enc.resolutions, enc.bounds, enc._boxes,
                        table)
    held = hold_bwd("disk", x, enc.resolutions, enc.bounds, enc._boxes,
                    table, g)
    del table, g
    det_holds_on("disk", tr, x)
    del x

    # 4.-5. 200 steps: steps 1-10 and 191-200 one call each, for their
    # losses
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hw.launches.update(fwd=0, bwd=0)
    first = [tr.fit(i, hooks=False) for i in range(1, 11)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.fit(STEPS - 10, hooks=False)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (STEPS - 20)
    last = [tr.fit(i, hooks=False) for i in range(STEPS - 9, STEPS + 1)]
    torch.cuda.synchronize()
    counts = dict(hw.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def mean(ms, k):
        return float(np.mean([float(m[k]) for m in ms]))

    d_first, d_last = mean(first, "depth_loss"), mean(last, "depth_loss")
    p_first, p_last = mean(first, "psnr"), mean(last, "psnr")
    log(f"[train disk] {STEPS} steps: depth loss mean of steps 1-10 "
        f"{d_first:.5f} -> steps {STEPS - 9}-{STEPS} {d_last:.5f}; PSNR "
        f"{p_first:.3f} -> {p_last:.3f} (same windows), step {STEPS} "
        f"{float(last[-1]['psnr']):.3f}; loss {float(last[-1]['loss']):.5f}; "
        f"{step_ms:.3f} ms/step (steps 11-{STEPS - 10}), "
        f"{rays / step_ms * 1e3:.0f} rays/s; peak memory {peak:.2f} GiB; "
        f"launches {counts}")
    if not all(math.isfinite(float(m["depth_loss"])) for m in first + last):
        raise AssertionError("the depth loss is not finite")
    if not d_last < d_first:
        raise AssertionError("the depth loss did not fall")
    if not p_last > p_first:
        raise AssertionError("PSNR did not rise")
    for k in ("fwd", "bwd"):
        if counts[k] < 2 * STEPS:
            raise AssertionError(f"hash {k} kernel launched {counts[k]} "
                                 f"times in {STEPS} steps")

    # 6. the prepare dump, read back with the port's reader
    t0 = time.perf_counter()
    out = tr._prepare_hook(STEPS)
    torch.cuda.synchronize()
    dump_s = time.perf_counter() - t0
    names = [f"img{i:03}.png" for i in range(N_VIEWS)]
    for d in (out, out / "label"):
        if sorted(p.name for p in d.glob("*.png")) != names:
            raise AssertionError(f"{d} does not hold one PNG per view")
    disp0 = read_png(out / "img000.png")
    lbl0 = read_png(out / "label" / "img000.png")
    want_lbl = (np.clip(np.abs(tr.scene.masks[0]), 0, 1) * 255).astype(
        np.uint8)
    if disp0.shape != (H, W) or not disp0.std() > 0:
        raise AssertionError(f"img000.png: {disp0.shape}, constant or wrong")
    if not np.array_equal(lbl0, want_lbl):
        raise AssertionError("label/img000.png is not the view's mask")
    log(f"[hooks disk] prepare dump of {N_VIEWS} views in {dump_s:.3f} s; "
        f"img000.png {disp0.shape}, values {int(disp0.min())}-"
        f"{int(disp0.max())}")
    if "--profile" in argv:
        profile_steps(tr, step_ms)
    return counts, held_fwd, held


FIT_H, FIT_W = 504, 672     # written and trained at factor 1
FIT_STEPS, LPIPS_START = 400, 300
FIT_PATCH_RTOL = 1e-4       # the patch loss, kernels against plain version
LPIPS_F64_RTOL = 1e-5       # the card's LPIPS against float64 on the CPU


class StepRecorder:
    """Wraps the step function that `Trainer` builds (`train.loop.
    make_train_step`): keeps each step's metrics (device tensors, read after
    the run) and, on entering or leaving the steps named in `edges`,
    synchronises and notes the host clock and the hash kernels' launch
    counts. It also keeps the patch-LPIPS function the Trainer passed."""

    def __init__(self, edges):
        self.edges = set(edges)
        self.metrics = {}
        self.marks = {}
        self.lpips_fn = None

    def mark(self, key):
        import torch

        from spinnerf_tpu_torch.ops import hash_encode_win as hw
        if key in self.edges:
            torch.cuda.synchronize()
            self.marks[key] = (time.perf_counter(), dict(hw.launches))

    def wrap(self, make_train_step):
        def make(*args, **kw):
            self.lpips_fn = kw.get("lpips_fn")
            step = make_train_step(*args, **kw)

            def recorded(i, generator=None):
                self.mark(("enter", i))
                self.metrics[i] = step(i, generator)
                self.mark(("exit", i))
                return self.metrics[i]
            recorded.loss_fn = step.loss_fn
            recorded.field_fns = step.field_fns
            return recorded
        return make

    def window(self, first, last, skip=None):
        """(host seconds, {kernel: launches}) from entering step `first` to
        leaving step `last`, less the gap between leaving and entering the
        steps of `skip` (a hook between them)."""
        t0, c0 = self.marks[("enter", first)]
        t1, c1 = self.marks[("exit", last)]
        dt = t1 - t0
        counts = {k: c1[k] - c0[k] for k in c1}
        if skip is not None:
            s0, d0 = self.marks[("exit", skip[0])]
            s1, d1 = self.marks[("enter", skip[1])]
            dt -= s1 - s0
            counts = {k: counts[k] - (d1[k] - d0[k]) for k in counts}
        return dt, counts


def fit_arm(exp_root, argv):
    """Phase 14: the inpainting fit stage from a scene directory through
    `pipeline.stages.stage_fit` (400 steps; the patch-LPIPS term from step
    301) and `stage_eval`, then a frozen-density Trainer on the fit's
    checkpoint. #1 and #2 are held against their plain version on the
    points of the patch render's fine pass and of one training batch's.
    Returns the hash kernels' launches a step over steps 1-300 and
    301-400, and {"patch" or "train": (hold_fwd's, hold_bwd's results)}."""
    import hashlib

    import numpy as np
    import torch

    from spinnerf_tpu_torch.config import Config
    from spinnerf_tpu_torch.core import sampling
    from spinnerf_tpu_torch.data import raybank, synthetic
    from spinnerf_tpu_torch.eval.render import read_png
    from spinnerf_tpu_torch.models import lpips as lpips_lib
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    from spinnerf_tpu_torch.pipeline import stages
    from spinnerf_tpu_torch.train import loop, lpips_patch

    # 1. the scene: 2 object-removed ground-truth views, every view masked,
    # the exact hole masks in label_full/; lama_images/ and depth/ are the
    # analytic object-removed renders (`tools/full_run.py
    # --analytic-guidance`)
    scene_dir = exp_root / "fit_scene"
    shutil.rmtree(scene_dir, ignore_errors=True)
    t0 = time.perf_counter()
    synthetic.make_scene(scene_dir, n_views=N_VIEWS, h=FIT_H, w=FIT_W,
                         factor=1, n_points=3000, n_gt=2,
                         gt_mask_subdir="label_full")
    write_s = time.perf_counter() - t0

    # 2. the reference's DS-NeRF fit configuration (`tools/full_run.py:
    # 128-147`, the hash grid's lr 0.03 / decay 10); stage_fit sets
    # lpips=True and prepare=False
    cfg = Config(expname="fit", basedir=str(exp_root), datadir=str(scene_dir),
                 dataset_type="llff", N_gt=2, factor=1, N_rand=1024,
                 N_samples=64, N_importance=64, use_viewdirs=True,
                 raw_noise_std=1.0, colmap_depth=True, depth_loss=True,
                 depth_lambda=0.1, no_ndc=True, lindisp=True, render_factor=1,
                 i_feat=200, feat_weight=0.1, lrate=0.03, lrate_decay=10,
                 white_bkgd=True, masks_gt_subdir="label_full", i_weights=400,
                 i_video=0, i_testset=0, i_print=100, lpips_batch_size=4,
                 lpips_render_factor=2, patch_len_factor=8, no_reload=True,
                 N_iters=FIT_STEPS)

    # 3. stage_fit, its steps recorded
    rec = StepRecorder([("enter", 1), ("enter", 11), ("exit", 200),
                        ("enter", 201), ("exit", LPIPS_START),
                        ("enter", LPIPS_START + 1), ("exit", FIT_STEPS)])
    make_train_step = loop.make_train_step
    loop.make_train_step = rec.wrap(make_train_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        tr = stages.stage_fit(cfg, n_iters=FIT_STEPS, log=log)
    finally:
        loop.make_train_step = make_train_step
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak_fit = torch.cuda.max_memory_allocated() / 2 ** 30
    enc = tr.model.encoder
    setup_s = rec.marks[("enter", 1)][0] - t0
    ph, pw = lpips_patch.patch_size(tr.scene.hwf, cfg.lpips_render_factor,
                                    cfg.patch_len_factor)
    log(f"[setup fit] scene written in {write_s:.3f} s ({N_VIEWS} views at "
        f"{FIT_W} x {FIT_H}, factor 1, 2 ground-truth views); stage_fit's "
        f"Trainer in {setup_s:.3f} s (scene load {tr.load_s['scene']:.3f} s,"
        f" sparse depth {tr.load_s['sparse_depth']:.4f} s); images "
        f"{tr.scene.images.shape}, train views {tr.i_train.tolist()}, test "
        f"views {tr.i_test.tolist()}, rays per step "
        f"{cfg.N_rand * tr._batches_per_step()}, encoder {enc.impl} "
        f"{tuple(enc.table.shape)}, LPIPS patches {cfg.lpips_batch_size} x "
        f"{ph} x {pw}")
    if tuple(enc.table.shape) != (16, 1 << 19, 2) or enc.impl != "win":
        raise AssertionError("the fit arm is not the 16 x 2^19 x 2 win field")
    if rec.lpips_fn is None or list(tr.i_test) != [0, 1]:
        raise AssertionError("the fit has no patch term or other test views")

    ms = {i: {k: float(v) for k, v in m.items()}
          for i, m in sorted(rec.metrics.items())}
    if sorted(ms) != list(range(1, FIT_STEPS + 1)):
        raise AssertionError(f"recorded steps {sorted(ms)[:3]}...")
    lp_before = [ms[i]["lpips_loss"] for i in range(1, LPIPS_START + 1)]
    lp_after = [ms[i]["lpips_loss"]
                for i in range(LPIPS_START + 1, FIT_STEPS + 1)]
    dt_a, c_a = rec.window(11, LPIPS_START, skip=(200, 201))
    dt_b, c_b = rec.window(LPIPS_START + 1, FIT_STEPS)
    _, c_1 = rec.window(1, LPIPS_START, skip=(200, 201))
    hook_s = rec.marks[("enter", 201)][0] - rec.marks[("exit", 200)][0]
    step_a = dt_a * 1e3 / (LPIPS_START - 10)
    step_b = dt_b * 1e3 / (FIT_STEPS - LPIPS_START)
    per_a = {k: v / LPIPS_START for k, v in c_1.items()}
    per_b = {k: v / (FIT_STEPS - LPIPS_START) for k, v in c_b.items()}
    p_first = float(np.mean([ms[i]["psnr"] for i in range(1, 11)]))
    p_last = float(np.mean([ms[i]["psnr"]
                            for i in range(FIT_STEPS - 9, FIT_STEPS + 1)]))
    log(f"[train fit] {FIT_STEPS} steps in {fit_s:.3f} s: {step_a:.3f} "
        f"ms/step (steps 11-{LPIPS_START}, step 200's panel hook "
        f"{hook_s:.3f} s left out), {step_b:.3f} ms/step (steps "
        f"{LPIPS_START + 1}-{FIT_STEPS}, with the patch term); PSNR mean of "
        f"steps 1-10 {p_first:.3f} -> steps {FIT_STEPS - 9}-{FIT_STEPS} "
        f"{p_last:.3f}; lpips_loss steps {LPIPS_START + 1}-{FIT_STEPS} "
        f"{min(lp_after):.6f}-{max(lp_after):.6f} (mean "
        f"{np.mean(lp_after):.6f}); loss step {FIT_STEPS} "
        f"{ms[FIT_STEPS]['loss']:.5f}; hash launches a step {per_a} (steps "
        f"1-{LPIPS_START}) and {per_b} (steps {LPIPS_START + 1}-"
        f"{FIT_STEPS}); peak memory {peak_fit:.2f} GiB")
    if any(v != 0.0 for v in lp_before):
        raise AssertionError("lpips_loss is not 0 before its start step")
    if not all(math.isfinite(v) and v > 0 for v in lp_after):
        raise AssertionError("lpips_loss is not finite and > 0 after 300")
    if not all(math.isfinite(m["loss"]) for m in ms.values()):
        raise AssertionError("the fit's loss is not finite")
    if not p_last > p_first:
        raise AssertionError("the fit's PSNR did not rise")
    for k in ("fwd", "bwd"):
        if not 0 < per_a[k] < per_b[k]:
            raise AssertionError(f"hash {k} launches a step {per_a[k]} then "
                                 f"{per_b[k]}: the patch renders must add")

    # 4. the step-200 sanity panel
    panel = read_png(tr.exp_dir / "test_renders" / "fit_fit_000200.png")
    if panel.shape != (FIT_H, 3 * FIT_W, 3) or not panel.std() > 0:
        raise AssertionError(f"sanity panel {panel.shape}, constant or wrong")
    log(f"[hooks fit] step-200 sanity panel {panel.shape}")

    # 5. the patch term at fixed views and anchors, through the kernels and
    # with the hash encode's plain version on the same CUDA tensors
    lpips_fn = rec.lpips_fn
    views = torch.arange(cfg.lpips_batch_size)
    u = torch.as_tensor(np.random.RandomState(0).rand(
        cfg.lpips_batch_size, 2), dtype=torch.float32)
    fused = hw.hash_encode_win_fused
    with torch.no_grad():
        n0 = dict(hw.launches)
        with recorded_encodes() as patch_x:
            lp_k = float(lpips_fn(views=views, u=u))
        n1 = dict(hw.launches)
        hw.hash_encode_win_fused = (
            lambda table, x, res, pb=None, db=None:
            hw.hash_encode_plain(table, x, res, pb, db))
        try:
            lp_p = float(lpips_fn(views=views, u=u))
        finally:
            hw.hash_encode_win_fused = fused
        n2 = dict(hw.launches)
    patch_rel = abs(lp_k - lp_p) / abs(lp_p)
    gen = torch.Generator(tr.device).manual_seed(1)
    for _ in range(3):
        lpips_fn(gen).backward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        lpips_fn(gen).backward()
    torch.cuda.synchronize()
    patch_ms = (time.perf_counter() - t0) * 1e3 / 10
    tr.optimizer.zero_grad()
    log(f"[patch fit] views {views.tolist()}, u {u.tolist()}: loss through "
        f"the kernels {lp_k:.8f} ({n1['fwd'] - n0['fwd']} forward "
        f"launches), plain {lp_p:.8f}: {patch_rel:.3e} relative (bound "
        f"{FIT_PATCH_RTOL}); the patch term forward + backward "
        f"{patch_ms:.3f} ms (host clock, 10 calls)")
    if n1["fwd"] - n0["fwd"] < 2 or n2 != n1:
        raise AssertionError(f"patch render launches: {n0} -> {n1} -> {n2}")
    if not patch_rel <= FIT_PATCH_RTOL:
        raise AssertionError("the patch loss's kernels and plain version "
                             "disagree")

    # #1 and #2 on the points of that patch render's fine pass (all in the
    # mask boxes) and of one training batch's fine pass (step 300's draw,
    # no patch term), as phase 3 holds them on its own points
    with torch.no_grad(), recorded_encodes() as train_x:
        tr.step_fn.loss_fn(LPIPS_START,
                           torch.Generator(tr.device).manual_seed(2))
    n_samples = cfg.N_samples + cfg.N_importance
    want = {"patch": cfg.lpips_batch_size * ph * pw * n_samples,
            "train": cfg.N_rand * tr._batches_per_step() * n_samples}
    held = {}
    for tag, calls in (("patch", patch_x), ("train", train_x)):
        x = max(calls, key=len)
        if x.shape != (want[tag], 3):
            raise AssertionError(f"the {tag} fine pass encodes "
                                 f"{tuple(x.shape)} points")
        scatter_census(f"fit {tag}", x, enc.resolutions, enc.table.shape[1],
                       enc.bounds, enc._boxes)
        table, g = hash_inputs(enc.table.shape, tr.device, len(x))
        held[tag] = (hold_fwd(f"fit {tag}", x, enc.resolutions, enc.bounds,
                              enc._boxes, table),
                     hold_bwd(f"fit {tag}", x, enc.resolutions, enc.bounds,
                              enc._boxes, table, g))
        del x, table, g
    del patch_x, train_x
    torch.cuda.empty_cache()

    # 6. LPIPS of one full frame on the card against float64 on the CPU
    rgbs, _ = tr.render_poses_list(tr.scene.poses[tr.i_test[:1]])
    pred = torch.as_tensor(rgbs[0])
    gt = torch.as_tensor(tr.scene.images[tr.i_test[0]])
    lp_card = lpips_lib.load_lpips(device=tr.device)
    pred_c, gt_c = pred.to(tr.device), gt.to(tr.device)
    with torch.no_grad():
        d32 = float(lp_card(pred_c, gt_c))
        conv_ctx = lpips_lib._f32_convs
        lpips_lib._f32_convs = contextlib.nullcontext
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            d_tf32 = float(lp_card(pred_c, gt_c))
        finally:
            lpips_lib._f32_convs = conv_ctx
            torch.backends.cudnn.allow_tf32 = tf32
        t0 = time.perf_counter()
        d64 = float(lpips_lib.load_lpips(device="cpu").double()(
            pred.double(), gt.double()))
        cpu_s = time.perf_counter() - t0
    lp_rel = abs(d32 - d64) / abs(d64)
    log(f"[lpips fit] view {tr.i_test[0]} {FIT_W} x {FIT_H}: card {d32:.9f}, "
        f"float64 on the CPU {d64:.9f} ({cpu_s:.1f} s): {lp_rel:.3e} relative"
        f" (bound {LPIPS_F64_RTOL}); with TF32 convolutions {d_tf32:.9f}: "
        f"{abs(d_tf32 - d64) / abs(d64):.3e}")
    if not lp_rel <= LPIPS_F64_RTOL:
        raise AssertionError("the card's LPIPS is not float64's")

    # 7. stage_eval
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = stages.stage_eval(cfg, tr, log=log)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    peak_eval = torch.cuda.max_memory_allocated() / 2 ** 30
    summary = res["summary"]
    keys = [f"{m}{k}" for m in ("", "masked_")
            for k in ("psnr", "ssim", "lpips_random_vgg")]
    log(json.dumps({"eval_fit": {"seconds": eval_s, "peak_gib": peak_eval,
                                 "summary": summary,
                                 "per_view": res["per_view"]}}))
    if sorted(summary) != sorted(keys) or not all(
            math.isfinite(summary[k]) for k in keys):
        raise AssertionError(f"eval summary {summary}")
    if not all(set(keys) <= set(r) for r in res["per_view"]) or len(
            res["per_view"]) != 2:
        raise AssertionError("eval has not a masked row for both GT views")
    if "--profile" in argv:
        # 5 steps without the patch term (its start moved past them), then
        # 5 with it
        lpips_fn.start_iter = 10 ** 9
        profile_steps(tr, step_a, tag="fit, steps <= 300")
        lpips_fn.start_iter = LPIPS_START
        profile_steps(tr, step_b, tag="fit, steps > 300")

    # 8. the frozen-density run on the fit's checkpoint
    ckpts = sorted((tr.exp_dir / "checkpoints").glob("*.pt"))
    digest = [hashlib.sha256(p.read_bytes()).hexdigest() for p in ckpts]
    cfg2 = dataclasses.replace(tr.cfg, expname="fit_frozen",
                               alpha_model_path=str(tr.exp_dir), i_feat=0,
                               i_weights=0)
    t0 = time.perf_counter()
    tr2 = loop.Trainer(cfg2, log=log)
    loss2 = float(tr2.fit(20, hooks=False)["loss"])
    torch.cuda.synchronize()
    frozen_s = time.perf_counter() - t0
    state = torch.load(ckpts[-1], map_location=tr.device, weights_only=True)
    fine = {k[5:]: v for k, v in state["params"].items()
            if k.startswith("fine.")}
    for name, p in tr2.frozen.state_dict().items():
        if not torch.equal(p, fine[name]):
            raise AssertionError(f"the frozen field's {name} moved")
    if [hashlib.sha256(p.read_bytes()).hexdigest() for p in ckpts] != digest:
        raise AssertionError("the frozen checkpoint's bytes changed")
    batch, _ = raybank.sample_group(tr2.bank, "clf", 1024, step=1)
    z = sampling.stratified_z_vals(batch["near"], batch["far"], 64,
                                   lindisp=True, perturb=False)
    pts = sampling.ray_points(batch["origins"], batch["directions"], z)
    with torch.no_grad():
        want = tr2.frozen(pts, batch["viewdirs"])[..., 3]
        got = [fn(pts, batch["viewdirs"])[..., 3]
               for fn in tr2.step_fn.field_fns]
        own = tr2.fields["fine"](pts, batch["viewdirs"])[..., 3]
    log(f"[frozen fit] Trainer with --alpha_model_path and 20 steps in "
        f"{frozen_s:.3f} s, loss at step 20 {loss2:.5f}; density of both "
        f"passes equal to the frozen "
        f"field's at {pts.shape[0] * pts.shape[1]} points: "
        f"{[bool(torch.equal(g, want)) for g in got]}; the trained field's "
        f"own density differs at {int((own != want).sum())} of them; "
        f"checkpoint {ckpts[-1].name} unchanged")
    if not math.isfinite(loss2) or not all(torch.equal(g, want)
                                           for g in got):
        raise AssertionError("the frozen run's density is not the frozen "
                             "field's")
    return per_a, per_b, held


MVSEG_VIEWS = [2, 6, 10]     # the views whose masks MVSeg lifts
PIPE_ITERS = dict(mvseg_iters=200, prepare_iters=200, fit_iters=310)
# the fit arm's DS-NeRF configuration, MVSeg's panel at its last step
PIPE_CFG = dict(dataset_type="llff", N_gt=2, factor=1, N_rand=1024,
                N_samples=64, N_importance=64, use_viewdirs=True,
                raw_noise_std=1.0, colmap_depth=True, depth_loss=True,
                depth_lambda=0.1, no_ndc=True, lindisp=True, render_factor=1,
                i_feat=200, feat_weight=0.1, lrate=0.03, lrate_decay=10,
                white_bkgd=True, masks_gt_subdir="label_full", i_weights=0,
                i_video=0, i_testset=0, i_print=100, i_img=200,
                lpips_batch_size=4, lpips_render_factor=2, patch_len_factor=8,
                no_reload=True)
CARD = "cuda"
LAMA_F64_RTOL = 1e-5        # the generator's logits against float64
FU_RTOL = 1e-5              # FourierUnit against float64 and the CPU
REFINE_GRAD_RMS, REFINE_GRAD_MAX = 1e-2, 5e-2   # the latent gradient
MVSEG_IOU_MIN = 0.5         # MVSeg's IoU on its mask views, predicted


def lama_flops(gen, x):
    """(convolution MACs, FFT flops) of one forward of `gen` on x, counted
    from the shapes by forward hooks on a copy on the meta device: a conv
    takes out elements x in channels / groups x kh x kw, a transpose conv
    in elements x out channels x kh x kw; a FourierUnit's rfft2 2.5 N
    log2 N a channel (N = H W), its inverse a complex ifft over H and a
    real one over W."""
    import copy

    import torch
    from torch import nn

    from spinnerf_tpu_torch.models import lama
    meta = copy.deepcopy(gen).to("meta")
    count = {"macs": 0, "fft": 0.0}

    def conv(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        count["macs"] += (inp[0].numel() * m.out_channels * k
                          if isinstance(m, nn.ConvTranspose2d) else
                          out.numel() * m.in_channels // m.groups * k)

    def fourier(m, inp, out):
        n, c, h, w = inp[0].shape
        c_out = m.conv_layer.out_channels // 2
        count["fft"] += n * (c * 2.5 * h * w * math.log2(h * w) + c_out * (
            5 * h * math.log2(h) * (w // 2 + 1)
            + 2.5 * w * math.log2(w) * h))
    for m in meta.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.register_forward_hook(conv)
        elif isinstance(m, lama.FourierUnit):
            m.register_forward_hook(fourier)
    with torch.no_grad():
        meta(x.to("meta"))
    return count["macs"], count["fft"]


def kernel_launches(fn, top=8):
    """(CUDA kernel launches, their device ms, the `top` kernels by device
    ms as [name, ms, launches]) of one call of fn, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total / 1e3, ev.key[:80], ev.count)
                   for ev in prof.key_averages()
                   if str(getattr(ev, "device_type", "")).endswith("CUDA")
                   and not getattr(ev, "is_user_annotation", False)
                   and "#" not in ev.key), reverse=True)
    return (sum(r[2] for r in rows), sum(r[0] for r in rows),
            [[k, ms, c] for ms, k, c in rows[:top]])


def rel_err(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


class StageRecorder:
    """Wraps the step function of each Trainer built while it is installed
    (`train.loop.make_train_step`): one record per Trainer, in order, with
    each step's metrics and the launch counts (`launches`, by default the
    hash kernels') at its first step and after its last."""

    def __init__(self, launches=None):
        self.runs = []
        self.launches = launches

    def wrap(self, make_train_step):
        from spinnerf_tpu_torch.ops import hash_encode_win as hw
        launches = hw.launches if self.launches is None else self.launches

        def make(*args, **kw):
            step = make_train_step(*args, **kw)
            run = {"metrics": {}, "first": None, "last": None}
            self.runs.append(run)

            def recorded(i, generator=None):
                if run["first"] is None:
                    run["first"] = dict(launches)
                run["metrics"][i] = step(i, generator)
                run["last"] = dict(launches)
                return run["metrics"][i]
            recorded.loss_fn = step.loss_fn
            recorded.field_fns = step.field_fns
            return recorded
        return make


def lama_arm(exp_root):
    """Phase 15: the scene; the LaMa generator and refiner on its view 2
    (`lama_checks`); then `run_pipeline` with MVSeg (`pipeline_arm`)."""
    import numpy as np

    from spinnerf_tpu_torch.data import synthetic
    from spinnerf_tpu_torch.eval.render import read_png

    # 2 object-removed ground-truth views, masks on the MVSEG_VIEWS (and,
    # as make_scene writes them, on the ground-truth views), every view's
    # exact mask in label_full/
    scene_dir = exp_root / "pipe_scene"
    shutil.rmtree(scene_dir, ignore_errors=True)
    synthetic.make_scene(scene_dir, n_views=N_VIEWS, h=FIT_H, w=FIT_W,
                         factor=1, n_points=3000, n_gt=2,
                         mask_views=MVSEG_VIEWS, gt_mask_subdir="label_full")
    img_dir = scene_dir / "images"
    image = read_png(img_dir / "view002.png").astype(np.float32) / 255.0
    hole = (read_png(img_dir / "label" / "view002.png") > 127).astype(
        np.float32)
    lama_checks(image, hole)
    pipeline_arm(exp_root, scene_dir)


def lama_checks(image, hole):
    """The generator at big-lama width on one view: its f32 forward
    against float64 on the card (logits and output), TF32's error, time,
    launches, memory and bound; one block's FourierUnit against float64 on
    the card and against the CPU; `refine_predict` at two levels and one
    step's latent gradient against float64."""
    import contextlib
    import copy

    import numpy as np
    import torch

    from spinnerf_tpu_torch import weights
    from spinnerf_tpu_torch.models import lama
    from spinnerf_tpu_torch.pipeline import inpaint2d
    from spinnerf_tpu_torch.utils.resize import area_resize

    h_img, w_img = image.shape[:2]

    # the generator: its forward against float64 on the card, TF32's
    # error, time, launches and memory
    t0 = time.perf_counter()
    gen = inpaint2d.load_generator()
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in gen.parameters())
    dev = next(gen.parameters()).device
    inp, _, _, _ = inpaint2d._net_input(image, hole)
    x = torch.as_tensor(inp, device=dev)
    macs, fft_flops = lama_flops(gen, x)
    flops = 2 * macs + fft_flops
    n_bytes = 4 * (n_params + x.numel() + 3 * h_img * w_img)
    bound_ms = max(flops / F32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3

    def logits(g, a):
        with lama._f32_convs():
            return g.model[:-1](a)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        y = gen(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = cuda_ms(lambda: gen(x))
        launches, device_ms, top = kernel_launches(lambda: gen(x))
        lg = logits(gen, x)
        g64 = copy.deepcopy(gen).double()
        x64 = x.double()
        y64, lg64 = g64(x64), logits(g64, x64)
        f32_ctx, tf32 = lama._f32_convs, torch.backends.cudnn.allow_tf32
        lama._f32_convs = contextlib.nullcontext
        torch.backends.cudnn.allow_tf32 = True
        try:
            lg_tf32 = logits(gen, x)
            tf32_ms = cuda_ms(lambda: gen(x))
            tf32_launches, tf32_device_ms, tf32_top = kernel_launches(
                lambda: gen(x))
        finally:
            lama._f32_convs = f32_ctx
            torch.backends.cudnn.allow_tf32 = tf32
    lg_max = float(lg64.abs().max())
    lg_err, tf32_err = rel_err(lg, lg64), rel_err(lg_tf32, lg64)
    out_err = float((y.double() - y64).abs().max())
    out_bound = 0.25 * LAMA_F64_RTOL * lg_max
    saturated = float(((y64 < 1e-4) | (y64 > 1 - 1e-4)).double().mean())
    log(json.dumps({"lama_generator": {
        "weights": weights.find("big_lama") or "seeded random",
        "params": n_params, "load_s": load_s, "input": list(x.shape),
        "ms": ms, "device_ms_profiled": device_ms, "launches": launches,
        "peak_gib": peak, "conv_gmac": macs / 1e9, "fft_gflop": fft_flops / 1e9,
        "bound_ms": bound_ms, "bound_by": "operations",
        "logits_max_abs": lg_max, "logits_rel_err_f64": lg_err,
        "out_max_abs_err_f64": out_err, "out_bound": out_bound,
        "saturated_share": saturated, "top": top, "tf32_ms": tf32_ms,
        "tf32_logits_rel_err_f64": tf32_err,
        "tf32_device_ms_profiled": tf32_device_ms,
        "tf32_launches": tf32_launches, "tf32_top": tf32_top}}))
    if dev.type != CARD:
        raise AssertionError("the generator is not on the card")
    if not (lg_err <= LAMA_F64_RTOL and out_err <= out_bound):
        raise AssertionError("the generator's f32 forward is not float64's")

    # one block's FourierUnit ([1, 192, 63, 84] in, 384 interleaved
    # channels) against float64 on the card and against the CPU; and what
    # torch.fft.irfft2 makes of its non-Hermitian spectrum on each
    fu = gen.model[gen.n_front].conv1.ffc.convg2g.fu
    xf = torch.as_tensor(np.random.RandomState(11).randn(
        1, 192, h_img // 8, w_img // 8).astype(np.float32))
    with torch.no_grad(), lama._f32_convs():
        a = fu(xf.to(dev)).cpu()
        b = copy.deepcopy(fu).double()(xf.to(dev).double()).cpu()
        c = copy.deepcopy(fu).cpu()(xf)
        f = torch.fft.rfft2(xf.to(dev), norm="ortho")
        f = torch.stack((f.real, f.imag), 2).reshape(1, 384, h_img // 8, -1)
        f = torch.relu(fu.bn(fu.conv_layer(f))).reshape(
            1, 192, 2, h_img // 8, -1)
        spec = torch.complex(f[:, :, 0], f[:, :, 1])
        naive = [torch.fft.irfft2(sp, s=xf.shape[-2:], norm="ortho").cpu()
                 for sp in (spec, spec.cpu())]
    fu_f64, fu_cpu = rel_err(a, b), rel_err(a, c)
    log(f"[lama fu] FourierUnit {tuple(xf.shape)}: card against float64 "
        f"{fu_f64:.3e}, against the CPU {fu_cpu:.3e} (bound {FU_RTOL}); "
        f"the spectrum's DC column has |imag| up to "
        f"{float(spec[..., 0].imag.abs().max()):.4f}; torch.fft.irfft2 of it"
        f" on the card against the CPU {rel_err(naive[0], naive[1]):.3e}, "
        f"against this inverse {rel_err(naive[0], b):.3e}")
    if not (fu_f64 <= FU_RTOL and fu_cpu <= FU_RTOL):
        raise AssertionError("FourierUnit's inverse is not device-independent")

    # refine_predict: two levels (252 x 336, 504 x 672), 15 Adam steps at
    # the finest through rear's backward; one step's latent gradient
    # against float64
    inpainter = inpaint2d.Inpainter(gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = inpaint2d.refine_predict(gen, image, hole, min_side=h_img // 2,
                                   inpainter=inpainter)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    levels = inpaint2d._build_pyramid(image, hole, min_side=h_img // 2)
    known = inpaint2d.dilate_mask(hole) == 0
    (img0, m0), (img1, m1) = levels
    prev = inpaint2d.predict(gen, img0, inpaint2d.dilate_mask(m0),
                             inpainter=inpainter)
    inp1, m_p, _, (h, w) = inpaint2d._net_input(img1,
                                                inpaint2d.dilate_mask(m1))
    m_ref = area_resize(m_p[:h, :w, 0], *prev.shape[:2]) > 1e-6
    arrays = [prev.transpose(2, 0, 1), m_ref[None].astype(np.float32),
              img1.transpose(2, 0, 1), m_p[:h, :w].transpose(2, 0, 1)]
    z = inpainter.front(inpainter.tensor(inp1))
    grads = []
    for ip, dt in ((inpainter, torch.float32),
                   (inpaint2d.Inpainter(g64), torch.float64)):
        zz = tuple(t.detach().to(dt).requires_grad_() for t in z)
        args = [torch.as_tensor(np.ascontiguousarray(a_), dtype=dt,
                                device=dev) for a_ in arrays]
        loss = ip.refine_loss(zz, *args)
        with lama._f32_convs():
            grads.append(torch.autograd.grad(loss, zz))
    g_max = [rel_err(g, g_) for g, g_ in zip(*grads)]
    g_rms = [float(((g.double() - g_).pow(2).mean()
                    / g_.pow(2).mean()).sqrt()) for g, g_ in zip(*grads)]
    del g64, grads
    torch.cuda.empty_cache()
    log(f"[lama refine] refine_predict {w_img} x {h_img}, levels "
        f"{[lv[0].shape[:2] for lv in levels]}, 15 Adam steps: "
        f"{refine_s:.3f} s; the known region unchanged: "
        f"{bool(np.array_equal(out[known], image[known]))}; one step's "
        f"latent gradient (z_l, z_g) against float64: max {g_max}, rms "
        f"{g_rms} (bounds {REFINE_GRAD_MAX}, {REFINE_GRAD_RMS})")
    if [lv[0].shape[:2] for lv in levels] != [(h_img // 2, w_img // 2),
                                               (h_img, w_img)]:
        raise AssertionError("the pyramid is not two levels")
    if out.shape != image.shape or not np.array_equal(out[known],
                                                      image[known]):
        raise AssertionError("refine_predict changed the known region")
    if max(g_max) > REFINE_GRAD_MAX or max(g_rms) > REFINE_GRAD_RMS:
        raise AssertionError("the refiner's latent gradient is not "
                             "float64's")
    del gen, inpainter
    torch.cuda.empty_cache()


def pipeline_arm(exp_root, scene_dir):
    """`run_pipeline` (MVSeg -> prepare -> LaMa guidance -> fit -> eval) on
    the scene at PIPE_CFG, the hash counts set to 0 just before and read
    just after: every stage's trainer launches #1 and #2 and no plain
    encode runs on the card; one generator, on the card; each stage's
    products, `stage_seconds` and `pipeline_results.json`; MVSeg's IoU on
    its mask views; the fit's PSNR rises."""
    import numpy as np
    import torch

    from spinnerf_tpu_torch.config import Config
    from spinnerf_tpu_torch.eval.render import read_png
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    from spinnerf_tpu_torch.pipeline import inpaint2d, mvseg, stages
    from spinnerf_tpu_torch.train import loop

    img_dir = scene_dir / "images"
    names = sorted(p.name for p in img_dir.glob("*.png"))
    cfg = Config(expname="pipe", basedir=str(exp_root),
                 datadir=str(scene_dir), **PIPE_CFG)
    rec = StageRecorder()
    gens, plain_on_card = [], []
    make_train_step, load_generator = (loop.make_train_step,
                                       inpaint2d.load_generator)
    plain = hw.hash_encode_plain

    def loaded(*a, **kw):
        gens.append(load_generator(*a, **kw))
        return gens[-1]

    def guarded_plain(table, *a, **kw):
        if table.is_cuda:
            plain_on_card.append(tuple(table.shape))
        return plain(table, *a, **kw)
    loop.make_train_step = rec.wrap(make_train_step)
    inpaint2d.load_generator = loaded
    hw.hash_encode_plain = guarded_plain
    hw.launches.update(fwd=0, bwd=0)
    t0 = time.perf_counter()
    try:
        tr, res = stages.run_pipeline(cfg, log=log, **PIPE_ITERS)
    finally:
        loop.make_train_step = make_train_step
        inpaint2d.load_generator = load_generator
        hw.hash_encode_plain = plain
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    counts = dict(hw.launches)
    per_stage = [{k: run["last"][k] - run["first"][k] for k in counts}
                 for run in rec.runs]
    fit_ms = rec.runs[-1]["metrics"]
    n_fit = PIPE_ITERS["fit_iters"]
    p_first = float(np.mean([float(fit_ms[i]["psnr"]) for i in range(1, 11)]))
    p_last = float(np.mean([float(fit_ms[i]["psnr"])
                            for i in range(n_fit - 9, n_fit + 1)]))
    secs = res["stage_seconds"]
    pred = np.stack([read_png(img_dir / "label" / names[v]) / 255.0
                     for v in MVSEG_VIEWS])
    gt = np.stack([read_png(img_dir / "label_full" / names[v]) / 255.0
                   for v in MVSEG_VIEWS])
    seg = mvseg.evaluate_masks(pred, gt)
    rest = [v for v in range(2, N_VIEWS) if v not in MVSEG_VIEWS]
    seg_rest = mvseg.evaluate_masks(
        np.stack([read_png(img_dir / "label" / names[v]) / 255.0
                  for v in rest]),
        np.stack([read_png(img_dir / "label_full" / names[v]) / 255.0
                  for v in rest]))
    log(json.dumps({"pipeline": {
        "seconds": pipe_s, "stage_seconds": secs,
        "guidance_s_per_view": secs["inpaint_guidance"] / (2 * N_VIEWS),
        "steps": PIPE_ITERS, "hash_launches_per_stage": per_stage,
        "hash_launches": counts,
        "mvseg_mask_views": {"views": MVSEG_VIEWS, **seg},
        "mvseg_other_views": {"views": rest, **seg_rest},
        "fit_psnr_steps_1_10": p_first,
        f"fit_psnr_steps_{n_fit - 9}_{n_fit}": p_last,
        "eval_summary": res["summary"]}}))

    if len(rec.runs) != 3 or any(
            c["fwd"] <= 0 or c["bwd"] <= 0 for c in per_stage):
        raise AssertionError(f"a stage's trainer did not launch #1 and #2: "
                             f"{per_stage}")
    if plain_on_card:
        raise AssertionError(f"the plain encode ran on the card: "
                             f"{plain_on_card}")
    if len(gens) != 1 or not all(p.device.type == CARD
                                 for p in gens[0].parameters()):
        raise AssertionError("the guidance's generator is not one, on the "
                             "card")
    for sub in ("label", "depth", "lama_images"):
        got = sorted(p.name for p in (img_dir / sub).glob("*.png"))
        if got != names:
            raise AssertionError(f"{sub}/ holds {got}")
    panel = read_png(exp_root / "pipe_mvseg" / "test_renders" /
                     f"pipe_mvseg_seg_{PIPE_ITERS['mvseg_iters']:06d}.png")
    worst = 0
    for n in names:
        src = read_png(img_dir / n).astype(int)
        m = read_png(img_dir / "label" / n) > 127
        keep = inpaint2d.dilate_mask(m.astype(np.float32)) == 0
        worst = max(worst, int(np.abs(
            read_png(img_dir / "lama_images" / n).astype(int) - src)[keep]
            .max(initial=0)))
    log(f"[pipeline] lama_images/ outside the dilated masks: at most "
        f"{worst} LSB from the images; MVSeg's panel {panel.shape}")
    if worst > 1:
        raise AssertionError("LaMa changed pixels outside the masks")
    if set(secs) != {"mvseg", "prepare", "inpaint_guidance", "fit", "eval"}:
        raise AssertionError(f"stage_seconds {secs}")
    saved = json.loads((exp_root / "pipe" / "pipeline_results.json")
                       .read_text())
    if saved != json.loads(json.dumps(res)):
        raise AssertionError("pipeline_results.json is not the summary")
    if not seg["iou"] >= MVSEG_IOU_MIN:
        raise AssertionError(f"MVSeg's IoU {seg['iou']}")
    if not p_last > p_first:
        raise AssertionError("the pipeline's fit PSNR did not rise")


CLI_HOLD = 4                # --llffhold: the test views 0, 4 and 8
CLI_POSE_TOL = 1e-5         # poses_bounds.npy's poses against make_scene's
CLI_EVAL_TOL = 1e-5         # the eval JSON against metrics in-process
REFINE_TOL = 1e-12          # the card's refined maps against the CPU's
# the disk arm's DS-NeRF prepare configuration at factor 1, as flags
CLI_FLAGS = ["--dataset_type", "llff", "--factor", "1", "--prepare", "True",
             "--N_rand", "1024", "--N_samples", "64", "--N_importance", "64",
             "--use_viewdirs", "True", "--raw_noise_std", "1.0",
             "--colmap_depth", "True", "--depth_loss", "True",
             "--depth_lambda", "0.1", "--no_ndc", "True", "--lindisp",
             "True", "--render_factor", "1", "--feat_weight", "0.1",
             "--lrate", "0.03", "--lrate_decay", "10", "--white_bkgd",
             "True", "--llffhold", str(CLI_HOLD), "--N_iters", str(STEPS),
             "--i_print", "50", "--i_weights", str(STEPS), "--i_video", "0",
             "--i_testset", "0", "--i_feat", "0"]


def cli_arm(exp_root):
    """Phase 16: the commands of `spinnerf_tpu_torch.cli` on a fresh scene,
    in this process (`main`) so that the launch counts can be read, and
    `--help` and `poses` as `python -m spinnerf_tpu_torch.cli`: poses,
    train, render (test, mypath, test_ray), refine_masks (beside
    `refine_all` on the card and on the CPU), eval, strip_ckpt. Returns
    each command's seconds."""
    import contextlib
    import io

    import numpy as np
    import torch

    from spinnerf_tpu_torch.cli.__main__ import main as cli_main
    from spinnerf_tpu_torch.data import synthetic
    from spinnerf_tpu_torch.data.llff import (dilate_mask, imread_float,
                                              imread_gray8)
    from spinnerf_tpu_torch.eval import metrics
    from spinnerf_tpu_torch.eval.render import read_png
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    from spinnerf_tpu_torch.pipeline import mask_refine
    from spinnerf_tpu_torch.train import loop
    from spinnerf_tpu_torch.train.checkpoints import (CheckpointManager,
                                                      restore_from_path)
    secs = {}

    def run(name, argv):
        t0 = time.perf_counter()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"[cli] {name}: {secs[name]:.3f} s")
        if rc != 0:
            raise AssertionError(f"`{name}` returned {rc}")

    scene = exp_root / "cli_scene"
    shutil.rmtree(scene, ignore_errors=True)
    synthetic.make_scene(scene, n_views=N_VIEWS, h=FIT_H, w=FIT_W, factor=1,
                         n_points=3000)
    written = np.load(scene / "poses_bounds.npy")

    # 1. --help and poses as `python -m spinnerf_tpu_torch.cli`, the two
    # processes started together
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "spinnerf_tpu_torch.cli", *argv],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, argv in (("help", ["--help"]),
                           ("poses", ["poses", str(scene)]))}
    outs = {name: p.communicate(timeout=300) for name, p in procs.items()}
    secs["help_and_poses"] = time.perf_counter() - t0
    for name, p in procs.items():
        log(f"[cli] python -m spinnerf_tpu_torch.cli {name}: exit code "
            f"{p.returncode}")
        if p.returncode != 0:
            raise AssertionError(f"`{name}` exited {p.returncode}: "
                                 f"{outs[name][1][-2000:]}")
    if "python -m spinnerf_tpu_torch.cli" not in outs["help"][0]:
        raise AssertionError("--help does not print the usage")
    got = np.load(scene / "poses_bounds.npy")
    pose_err = float(np.abs(got[:, :15] - written[:, :15]).max())
    log(f"[cli] poses_bounds.npy {got.shape}: poses and hwf within "
        f"{pose_err:.3g} of make_scene's; (near, far) of view 0 from the "
        f"sparse points {got[0, 15:].round(4).tolist()}, make_scene's depth "
        f"percentiles {written[0, 15:].round(4).tolist()}")
    if got.shape != written.shape or not pose_err <= CLI_POSE_TOL:
        raise AssertionError("poses_bounds.npy's poses are not make_scene's")

    # 2. train, each step's metrics recorded around the step function
    exp = exp_root / "cli"
    exp_args = ["--expname", "cli", "--basedir", str(exp_root), "--datadir",
                str(scene)] + CLI_FLAGS
    rec = StageRecorder()
    make_train_step = loop.make_train_step
    loop.make_train_step = rec.wrap(make_train_step)
    hw.launches.update(fwd=0, bwd=0)
    try:
        run("train", ["train"] + exp_args)
    finally:
        loop.make_train_step = make_train_step
    train_counts = dict(hw.launches)
    ms = rec.runs[0]["metrics"]

    def mean(k, steps):
        return float(np.mean([float(ms[i][k]) for i in steps]))

    first, last = range(1, 11), range(STEPS - 9, STEPS + 1)
    p_first, p_last = mean("psnr", first), mean("psnr", last)
    d_first, d_last = mean("depth_loss", first), mean("depth_loss", last)
    log(f"[cli] train: {len(ms)} steps, PSNR {p_first:.3f} -> {p_last:.3f}, "
        f"depth loss {d_first:.5f} -> {d_last:.5f} (steps 1-10, "
        f"{STEPS - 9}-{STEPS}); hash launches {train_counts}")
    if sorted(ms) != list(range(1, STEPS + 1)) or not all(
            math.isfinite(float(m["loss"])) for m in ms.values()):
        raise AssertionError("train: steps missing or a loss not finite")
    if not (p_last > p_first and d_last < d_first):
        raise AssertionError("train: PSNR did not rise or the depth loss "
                             "did not fall")
    if min(train_counts.values()) < 2 * STEPS:
        raise AssertionError(f"train: #1 / #2 not launched twice a step: "
                             f"{train_counts}")
    torch.cuda.empty_cache()

    # 3. render: the test views (their tree), the orbit, the sigma plot
    render = ["render"] + exp_args + ["--render_only", "True"]
    test_views = list(range(0, N_VIEWS, CLI_HOLD))
    hw.launches.update(fwd=0, bwd=0)
    run("render_test", render + ["--render_test", "True"])
    render_counts = dict(hw.launches)
    rdir = exp / f"renderonly_test_{STEPS:06d}"
    for sub, ext in (("rgb", "png"), ("depth", "npy"), ("disp", "npy"),
                     ("weight", "npy"), ("z", "npy"), ("alpha", "npy"),
                     ("pose", "txt"), ("images", "png")):
        if len(list((rdir / sub).glob(f"*.{ext}"))) != len(test_views):
            raise AssertionError(f"render_test: {sub}/ is not one file a "
                                 f"test view")
    if not (rdir / "intrinsics.txt").exists():
        raise AssertionError("render_test: no intrinsics.txt")
    log(f"[cli] render_test: {len(test_views)} views, hash launches "
        f"{render_counts}")
    if render_counts["fwd"] < 1 or render_counts["bwd"] != 0:
        raise AssertionError("render_test: #1 not launched, or #2 launched")
    run("render_mypath", render + ["--render_mypath", "True",
                                   "--render_factor", "4"])
    orbit = sorted((exp / f"renderonly_mypath_{STEPS:06d}" / "rgb")
                   .glob("*.png"))
    if len(orbit) != 40 or read_png(orbit[0]).shape != (FIT_H // 4,
                                                        FIT_W // 4, 3):
        raise AssertionError("render_mypath: not 40 frames at 1/4")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run("render_test_ray", render + ["--render_test_ray", "True"])
    text = buf.getvalue()
    log(text.strip())
    if "colmap depth:" not in text or "estimated depth:" not in text or \
            not (exp / f"renderonly_ray_{STEPS:06d}" / "rays.png").exists():
        raise AssertionError("render_test_ray: no depths or no plot")

    # 4. refine_masks on the test views' tree with their masks; then
    # refine_all on the same dumps on the card and on the CPU
    mask_dir = exp_root / "cli_masks"
    shutil.rmtree(mask_dir, ignore_errors=True)
    mask_dir.mkdir()
    for v in test_views:
        shutil.copy(scene / "images" / "label" / f"view{v:03d}.png", mask_dir)
    out_dir = exp_root / "cli_refined"
    run("refine_masks", ["refine_masks", "--render_dir", str(rdir),
                         "--mask_dir", str(mask_dir), "--out_dir",
                         str(out_dir)])
    files = sorted(mask_dir.glob("*.png"))
    orig = [imread_gray8(f) > 127 for f in files]
    masks = []
    for f in files:     # as the command reads them
        m = imread_gray8(f).astype(np.float32)
        m = (m / max(m.max(), 1) > 0.5).astype(np.float32)
        masks.append(dilate_mask(m, iterations=5))
    intr = np.loadtxt(rdir / "intrinsics.txt")
    kw = dict(focal=float(intr[0, 0]), cx=float(intr[0, 2]),
              cy=float(intr[1, 2]))
    views = {}
    for dev in (CARD, "cpu"):
        dumps = mask_refine.load_view_dumps(rdir, masks, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        views[dev] = mask_refine.refine_all(dumps, **kw)
        torch.cuda.synchronize()
        secs[f"refine_all_{dev}"] = time.perf_counter() - t0
    n_samples = dumps[0].z.shape[-1]
    del dumps
    # the first of several valid samples, on the card
    valid = torch.rand((1 << 20, n_samples), device=CARD) < 0.05
    first = torch.argmax(valid.to(torch.int32), dim=-1).cpu().numpy()
    if not np.array_equal(first, np.argmax(valid.cpu().numpy(), axis=-1)):
        raise AssertionError("argmax on the card is not the first maximum")
    img_err = disp_err = 0.0
    n_freed = n_ring = n_cand = 0
    for i, ((ic, mc, dc), (ip, mp, dp)) in enumerate(zip(views[CARD],
                                                        views["cpu"])):
        if not torch.equal(mc.cpu(), mp):
            raise AssertionError(f"view {i}: the card's refined mask is not "
                                 f"the CPU's")
        img_err = max(img_err, float((ic.cpu().double() - ip.double())
                                     .abs().max()))
        disp_err = max(disp_err, float((dc.cpu().double() - dp.double())
                                       .abs().max()))
        dilated, refined = masks[i] > 0.5, mp.numpy() > 0.5
        if (refined & ~dilated).any():
            raise AssertionError(f"view {i}: refined mask outside its "
                                 f"dilated input")
        freed = dilated & ~refined
        n_freed += int(freed.sum())
        n_ring += int((freed & ~orig[i]).sum())
        n_cand += int(dilated.sum()) * n_samples
        label = read_png(out_dir / "refined_images" / "label" / files[i].name)
        if not np.array_equal(label, (mp.numpy() * 255).astype(np.uint8)):
            raise AssertionError(f"view {i}: the command's label PNG is not "
                                 f"the refined mask")
    log(json.dumps({"refine_masks": {
        "views": len(files), "size": [FIT_H, FIT_W],
        "masked_pixels_x_samples": n_cand,
        "card_s_per_view": secs[f"refine_all_{CARD}"] / len(files),
        "cpu_s_per_view": secs["refine_all_cpu"] / len(files),
        "command_s": secs["refine_masks"], "unmasked": n_freed,
        "unmasked_share_in_ring": n_ring / max(n_freed, 1),
        "card_vs_cpu_image_err": img_err, "card_vs_cpu_disp_err": disp_err}}))
    if not (img_err <= REFINE_TOL and disp_err <= REFINE_TOL):
        raise AssertionError("the card's refined maps are not the CPU's")
    if n_freed < 1:
        raise AssertionError("refine_masks un-masked no pixel")
    del views
    torch.cuda.empty_cache()

    # 5. eval of the rendered test views against the scene's images
    run("eval", ["eval", "--pred_dir", str(rdir / "rgb"), "--gt_dir",
                 str(rdir / "images"), "--json_out",
                 str(exp_root / "cli_eval.json")])
    rows = json.loads((exp_root / "cli_eval.json").read_text())["per_image"]
    eval_err = 0.0
    for row in rows:
        pred = torch.from_numpy(imread_float(rdir / "rgb" / row["name"]))
        gt = torch.from_numpy(imread_float(rdir / "images" / row["name"]))
        eval_err = max(eval_err,
                       abs(row["psnr"] - float(metrics.psnr(pred, gt))),
                       abs(row["ssim"] - float(metrics.ssim(pred, gt))))
    log(f"[cli] eval: {[(r['psnr'], r['ssim']) for r in rows]}, within "
        f"{eval_err:.3g} of the metrics on the CPU")
    if len(rows) != len(test_views) or not eval_err <= CLI_EVAL_TOL:
        raise AssertionError("eval's JSON is not the metrics")

    # 6. strip_ckpt: parameters only, loaded by --ft_path's reader
    run("strip_ckpt", ["strip_ckpt", "--exp_dir", str(exp), "--out_dir",
                       str(exp_root / "cli_stripped")])
    step, restored = restore_from_path(exp_root / "cli_stripped" /
                                       f"params_{STEPS}.pt")
    full = torch.load(CheckpointManager(exp).path(STEPS), map_location="cpu",
                      weights_only=True)["params"]
    if step != STEPS or restored["opt_state"] is not None or \
            restored["params"].keys() != full.keys() or not all(
                torch.equal(restored["params"][k], v)
                for k, v in full.items()):
        raise AssertionError("the stripped checkpoint is not the step's "
                             "parameters")
    log(json.dumps({"cli": {"seconds": secs,
                            "total_s": sum(secs.values())}}))
    return secs


# phase 17: the Blender and DTU scenes, the native COLMAP reader and the
# full-scale pipeline tool
BLENDER_VIEWS, BLENDER_SIDE = 24, 800       # trained at half resolution
BLENDER_ANGLE_X = 0.6911112070083618        # the lego scene's field of view
DTU_VIEWS, DTU_H, DTU_W = 16, 600, 800      # DTU ships 49 views, 1600 x 1200
DTU_TEST = [3, 11]                          # left out of the DTU training
TABLE_RADIUS = 1.5          # the plane is kept within this radius
COLMAP_POINTS = 100_000     # the native-vs-Python timing's model
# 12 views at 2016 x 1134, trained at factor 2 (the full 1008 x 567)
FULL_RUN_SCENE = dict(views=12, gt=4, h=1134, w=2016, factor=2)
FULL_RUN_ARGS = ["--iters-scale", "40"] + [
    a for k, v in FULL_RUN_SCENE.items() for a in (f"--{k}", str(v))]
# the CLI's training flags on the default hash-grid field: 200 steps, no
# hook renders
LOADER_FLAGS = ["--N_iters", str(STEPS), "--i_print", "50", "--i_weights",
                "0", "--i_video", "0", "--i_testset", "0", "--i_feat", "0",
                "--no_reload", "True"]


def world_view(c2w, h, w, focal):
    """RGB [h, w, 3], z-depth [h, w] and the hit mask (the ball, or the
    plane within TABLE_RADIUS of the origin) of one camera of the
    plane-and-ball world."""
    import numpy as np

    from spinnerf_tpu_torch.data import synthetic
    rgb, z, ball = synthetic.render_view(c2w, h, w, focal)
    i, j = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    d = np.stack([(i - w * 0.5) / focal, -(j - h * 0.5) / focal,
                  -np.ones_like(i)], -1) @ c2w[:3, :3].T
    p = c2w[:3, 3] + np.where(np.isfinite(z), z, 0.0)[..., None] * d
    table = np.isfinite(z) & (np.linalg.norm(p[..., :2], axis=-1)
                              < TABLE_RADIUS)
    return rgb, z, ball | table


def write_blender_scene(d):
    """BLENDER_VIEWS RGBA frames of the world at BLENDER_SIDE from
    `pose_spherical(theta, -30, 4)` (alpha: the hit mask) and
    transforms_{train,val,test}.json (every 6th view val, every 6th from
    the 4th test). Returns the z-depth range of the hit pixels."""
    import numpy as np

    from spinnerf_tpu_torch.data import blender
    from spinnerf_tpu_torch.eval.render import write_png
    side = BLENDER_SIDE
    focal = 0.5 * side / np.tan(0.5 * BLENDER_ANGLE_X)
    frames = {"train": [], "val": [], "test": []}
    zs = []
    for k in range(BLENDER_VIEWS):
        split = ("val" if k % 6 == 0 else "test" if k % 6 == 3
                 else "train")
        c2w = blender.pose_spherical(-180.0 + 360.0 * k / BLENDER_VIEWS,
                                     -30.0, 4.0)
        rgb, z, hit = world_view(c2w[:3], side, side, focal)
        zs.append(z[hit])
        (d / split).mkdir(parents=True, exist_ok=True)
        name = f"r_{len(frames[split])}"
        write_png(d / split / f"{name}.png", (np.concatenate(
            [rgb, hit[..., None].astype(np.float32)], -1) * 255)
            .astype(np.uint8))
        frames[split].append({"file_path": f"./{split}/{name}",
                              "transform_matrix": c2w.tolist()})
    for split, fr in frames.items():
        (d / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": BLENDER_ANGLE_X, "frames": fr}))
    zs = np.concatenate(zs)
    return float(zs.min()), float(zs.max())


def write_dtu_scene(d):
    """DTU_VIEWS views of the world at DTU_W x DTU_H from a ring at radius
    3, height 1.8 (white off the ball and the table) in image/, and
    cameras.npz with world_mat_<i> = K [R | t] in OpenCV's frame. Returns
    the z-depth range of the hit pixels."""
    import numpy as np

    from spinnerf_tpu_torch.data import synthetic
    from spinnerf_tpu_torch.eval.render import write_png
    (d / "image").mkdir(parents=True)
    focal = 1.2 * DTU_W
    k = np.array([[focal, 0, DTU_W / 2], [0, focal, DTU_H / 2], [0, 0, 1]])
    mats, zs = {}, []
    for v in range(DTU_VIEWS):
        th = 2 * np.pi * v / DTU_VIEWS
        c2w = synthetic.look_at_pose(
            [3.0 * np.cos(th), 3.0 * np.sin(th), 1.8], target=(0, 0, 0.3))
        rgb, z, hit = world_view(c2w, DTU_H, DTU_W, focal)
        rgb[~hit] = 1.0
        zs.append(z[hit])
        write_png(d / "image" / f"{v:06d}.png", (rgb * 255).astype(np.uint8))
        r_cv = np.stack([c2w[:, 0], -c2w[:, 1], -c2w[:, 2]], 1).T
        p = np.eye(4)
        p[:3] = k @ np.concatenate([r_cv, (-r_cv @ c2w[:, 3])[:, None]], 1)
        mats[f"world_mat_{v}"] = p
    np.savez(d / "cameras.npz", **mats)
    zs = np.concatenate(zs)
    return float(zs.min()), float(zs.max())


def cli_train_held_out(tag, exp_root, scene_dir, flags, near_far):
    """Phase 17 (a) / (b): `train` through the command line (in this
    process) on a scene directory, each step's metrics recorded around the
    step function and the Trainer kept; #1 and #2 launched twice a step
    (2 x STEPS each), the training PSNR rising, the bank's near / far the
    dataset's; then the first test view rendered and scored."""
    import numpy as np
    import torch

    from spinnerf_tpu_torch.cli.__main__ import main as cli_main
    from spinnerf_tpu_torch.core.losses import mse, mse_to_psnr
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    from spinnerf_tpu_torch.train import loop

    kept = []

    class Kept(loop.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)
    rec = StageRecorder()
    make_train_step, trainer_cls = loop.make_train_step, loop.Trainer
    loop.make_train_step, loop.Trainer = rec.wrap(make_train_step), Kept
    hw.launches.update(fwd=0, bwd=0)
    t0 = time.perf_counter()
    try:
        rc = cli_main(["train", "--expname", tag, "--basedir", str(exp_root),
                       "--datadir", str(scene_dir)] + flags + LOADER_FLAGS)
    finally:
        loop.make_train_step, loop.Trainer = make_train_step, trainer_cls
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = dict(hw.launches)
    tr = kept[0]
    ms = rec.runs[0]["metrics"]
    p_first = float(np.mean([float(ms[i]["psnr"]) for i in range(1, 11)]))
    p_last = float(np.mean([float(ms[i]["psnr"])
                            for i in range(STEPS - 9, STEPS + 1)]))
    t = int(tr.i_test[0])
    t0 = time.perf_counter()
    rgbs, _ = tr.render_poses_list(tr.scene.poses[t:t + 1])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    rgb = torch.as_tensor(rgbs[0], device=tr.device)
    held = float(mse_to_psnr(mse(rgb, torch.as_tensor(tr.scene.images[t],
                                                      device=tr.device))))
    out = {"images": list(tr.scene.images.shape), "hwf": list(tr.scene.hwf),
           "train_views": len(tr.i_train), "test_views": len(tr.i_test),
           "near_far": [tr.bank.near, tr.bank.far], "ndc": tr.bank.ndc,
           "load_s": tr.load_s, "train_s": train_s,
           "psnr_steps_1_10": p_first,
           f"psnr_steps_{STEPS - 9}_{STEPS}": p_last,
           "hash_launches": counts, "held_out_view": t,
           "held_out_psnr": held, "render_s": render_s}
    log(json.dumps({tag: out}))
    if rc != 0 or sorted(ms) != list(range(1, STEPS + 1)) or not all(
            math.isfinite(float(m["loss"])) for m in ms.values()):
        raise AssertionError(f"{tag}: exit code {rc}, steps missing or a "
                             f"loss not finite")
    if not p_last > p_first:
        raise AssertionError(f"{tag}: the training PSNR did not rise")
    if (tr.bank.near, tr.bank.far) != near_far or tr.bank.ndc:
        raise AssertionError(f"{tag}: bank near / far {tr.bank.near}, "
                             f"{tr.bank.far} (ndc {tr.bank.ndc})")
    if rgb.shape != tuple(tr.scene.images.shape[1:]) or \
            not math.isfinite(held):
        raise AssertionError(f"{tag}: the held-out render")
    if counts != {"fwd": 2 * STEPS, "bwd": 2 * STEPS}:
        raise AssertionError(f"{tag}: #1 / #2 launched {counts} times, not "
                             f"{2 * STEPS} each")
    return out


def colmap_fast_arm(exp_root):
    """Phase 17 (c): the native COLMAP reader. On the disk arm's scene its
    sparse depth equals `colmap.sparse_depth_for_views`, array for array;
    then both are timed (best of 3) on a model of COLMAP_POINTS points that
    `make_scene` writes, and equal there too."""
    import numpy as np

    from spinnerf_tpu_torch.data import colmap, colmap_fast, synthetic
    from spinnerf_tpu_torch.native import build as native_build

    t0 = time.perf_counter()
    lib = native_build.build()
    build_s = time.perf_counter() - t0

    def same(sparse, **kw):
        a = colmap_fast.sparse_depth_for_views(sparse, **kw)
        b = colmap.sparse_depth_for_views(sparse, **kw)
        return len(a) == len(b) and all(
            x.keys() == y.keys() and all(
                x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
                for k in y) for x, y in zip(a, b)), sum(
                    len(x["depth"]) for x in a)

    disk = exp_root / "disk_scene" / "sparse" / "0"
    disk_equal, disk_n = same(disk, factor=DISK_FACTOR, bd_scale=0.75)
    big = exp_root / "colmap_big"
    shutil.rmtree(big, ignore_errors=True)
    t0 = time.perf_counter()
    synthetic.make_scene(big, n_views=N_VIEWS, h=48, w=64,
                         n_points=COLMAP_POINTS)
    write_s = time.perf_counter() - t0
    sparse = big / "sparse" / "0"
    big_equal, big_n = same(sparse)
    times = {}
    for name, fn in (("python", colmap.sparse_depth_for_views),
                     ("native", colmap_fast.sparse_depth_for_views)):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(sparse)
            runs.append(time.perf_counter() - t0)
        times[name] = min(runs)
    n_points = len(colmap_fast.read_points_columns(sparse / "points3D.bin")
                   ["ids"])
    out = {"library": lib.name, "build_or_cached_s": build_s,
           "disk_scene_equal": disk_equal, "disk_scene_depths": disk_n,
           "model_points": n_points, "model_depths": big_n,
           "model_equal": big_equal, "model_write_s": write_s,
           "python_s": times["python"], "native_s": times["native"],
           "speedup": times["python"] / times["native"]}
    log(json.dumps({"colmap_fast": out}))
    if not (disk_equal and big_equal and disk_n > 0 and big_n > 0):
        raise AssertionError("colmap_fast's sparse depth is not the Python "
                             "reader's")
    return out


def full_run_arm(exp_root):
    """Phase 17 (d): `python -m spinnerf_tpu_torch.tools.full_run` in this
    process at FULL_RUN_ARGS (12 views at 2016 x 1134, trained at factor 2:
    the full 1008 x 567), once per model on copies of one generated scene,
    each Trainer's step function recorded: every trainer stage launches the
    model's kernels (#1 / #2 or #9 / #10), the fit's PSNR is finite and
    rises, the JSON has the JAX tool's keys."""
    import numpy as np
    import torch

    from spinnerf_tpu_torch.ops import fused_mlp as fm
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    from spinnerf_tpu_torch.tools import full_run
    from spinnerf_tpu_torch.train import loop

    from spinnerf_tpu_torch import weights

    # one scene, generated by the tool and copied for each model (a run
    # overwrites its label/ and guidance directories)
    gen = exp_root / "full_run_scene"
    shutil.rmtree(gen, ignore_errors=True)
    t0 = time.perf_counter()
    full_run.make_scene(gen, **FULL_RUN_SCENE,
                        analytic=weights.find("big_lama") is None)
    gen_s = time.perf_counter() - t0
    results = {}
    for model, counter in (("hashgrid", hw.launches),
                           ("mlp", fm.launches)):
        work = exp_root / f"full_run_{model}"
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(gen / "scene", work / "scene")
        rec = StageRecorder(counter)
        make_train_step = loop.make_train_step
        loop.make_train_step = rec.wrap(make_train_step)
        counter.update(fwd=0, bwd=0)
        t0 = time.perf_counter()
        try:
            rc = full_run.main(FULL_RUN_ARGS + [
                "--model", model, "--workdir", str(work)])
        finally:
            loop.make_train_step = make_train_step
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        res = json.loads((work / "FULLRUN_torch.json").read_text())
        per_stage = [{k: run["last"][k] - run["first"][k] for k in counter}
                     for run in rec.runs]
        fit = rec.runs[-1]["metrics"]
        n_fit = res["config"]["iters"]["fit"]
        psnr = [float(fit[i]["psnr"]) for i in range(1, n_fit + 1)]
        p_first, p_last = float(np.mean(psnr[:10])), float(np.mean(psnr[-10:]))
        out = {"seconds": secs, "scene_gen_s": gen_s,
               "summary": res["summary"],
               "stage_seconds": res["stage_seconds"],
               "config": res["config"],
               "peak_device_memory_gib": res.get("peak_device_memory_gib"),
               "kernel_launches_per_trainer": per_stage,
               "kernel_launches": dict(counter),
               "fit_psnr_steps_1_10": p_first,
               "fit_psnr_last_10": p_last}
        log(json.dumps({f"full_run_{model}": out}))
        if rc != 0 or set(res["stage_seconds"]) != {
                "mvseg", "prepare", "inpaint_guidance", "fit", "eval"}:
            raise AssertionError(f"full_run {model}: exit code {rc}, stages "
                                 f"{res['stage_seconds']}")
        if not all(math.isfinite(p) for p in psnr) or not p_last > p_first:
            raise AssertionError(f"full_run {model}: the fit's PSNR is not "
                                 f"finite or did not rise")
        if not all(math.isfinite(v) for v in res["summary"].values()):
            raise AssertionError(f"full_run {model}: summary {res['summary']}")
        if len(per_stage) != 3 or any(c["fwd"] <= 0 or c["bwd"] <= 0
                                      for c in per_stage):
            raise AssertionError(f"full_run {model}: a trainer did not "
                                 f"launch its kernels: {per_stage}")
        results[model] = out
        torch.cuda.empty_cache()
    return results


def loaders_arm(exp_root):
    """Phase 17: (a) a Blender scene, (b) a DTU scene, each trained through
    the command line and scored on a held-out view; (c) the native COLMAP
    reader; (d) the full-scale pipeline tool on both models. Prints its
    seconds."""
    import torch

    t_start = time.perf_counter()
    out = {}
    for tag, write, flags, near_far, zr in (
            ("blender", write_blender_scene,
             ["--dataset_type", "blender", "--half_res", "--white_bkgd"],
             (2.0, 6.0), (2.0, 6.0)),
            ("dtu", write_dtu_scene,
             ["--dataset_type", "dtu", "--test_scene",
              *map(str, DTU_TEST)], (0.1, 5.0), (0.1, 5.0))):
        scene_dir = exp_root / f"{tag}_scene"
        shutil.rmtree(scene_dir, ignore_errors=True)
        t0 = time.perf_counter()
        z_lo, z_hi = write(scene_dir)
        log(f"[{tag}] scene written in {time.perf_counter() - t0:.1f} s; "
            f"the hit pixels' z-depth {z_lo:.3f} .. {z_hi:.3f} (near / far "
            f"{near_far[0]} / {near_far[1]})" + (
                f"; {DTU_VIEWS} views at {DTU_W} x {DTU_H}, cut from DTU's "
                f"49 at 1600 x 1200" if tag == "dtu" else
                f"; {BLENDER_VIEWS} views at {BLENDER_SIDE} x "
                f"{BLENDER_SIDE}, trained at half resolution"))
        if not (zr[0] <= z_lo and z_hi <= zr[1]):
            raise AssertionError(f"{tag}: the world leaves near / far")
        out[tag] = cli_train_held_out(tag, exp_root, scene_dir, flags,
                                      near_far)
        torch.cuda.empty_cache()
    out["colmap_fast"] = colmap_fast_arm(exp_root)
    out["full_run"] = full_run_arm(exp_root)
    log(f"[phase 17] {time.perf_counter() - t_start:.1f} s")
    return out


# phase 18: LaMa training (big-lama against its discriminator at full
# width) and the LaMa commands
LAMA_TRAIN_VIEWS, LAMA_VAL_VIEWS = 12, 4
LAMA_STEPS, LAMA_RESUME_STEPS, LAMA_I_VAL = 40, 45, 20
LAMA_BATCH, LAMA_CROP = 8, 256       # the CLI's defaults (big-lama's)
LAMA_NGF, LAMA_BLOCKS = 64, 18       # big-lama's generator
LAMA_PROFILE_STEPS = 3
LAMA_F64_BATCH, LAMA_F64_CROP = 2, 128
# f32 (TF32 off) against float64 on the card. Measured in the first run
# (PR 14): d_adv 1.47e-4 (the other losses <= 9.0e-7), the lowest
# gradient cosine 0.99818 (D) / 0.99985 (G), the BN statistics 3.1e-6;
# the same step on the CPU: 1.9e-5, 0.99993 / 0.99980, 2.1e-6. The
# gradients' relative L2 5.0e-3 / 5.3e-3 (G / D) against the TF32-on
# control's 0.146 / 0.050 (PR 14, run F), whose losses lie within 7.8e-4
LAMA_LOSS_RTOL = 1e-3        # each loss of one step, relative
LAMA_GRAD_COS = 0.995        # each gradient tensor's cosine to float64's
LAMA_GRAD_L2 = 1.5e-2        # each phase's gradients, relative L2
LAMA_BN_RTOL = 1e-4          # the BN running statistics after the step
NET_F64_RTOL = 2e-5          # inception pool3 (4.5e-7), the ResNet50 (2.1e-6)
# eval_inpainting's FID against the same images' float64 pool3 features:
# 2.96e-6 (PR 14, run F; 9.1e-6 on the CPU at 120 x 160)
FID_RTOL = 1e-4
# the traced generator against the module on the card: 2.68e-5 of the
# output in the first run, where the CPU gives equal outputs
EXPORT_RTOL = 1e-4
MASK_KINDS = ("mixed", "irregular", "rectangle", "outpainting", "dumb",
              "superres", "squares", "segm")


class LamaRecorder:
    """Wraps `train.lama_loop.make_lama_train_step` while installed: every
    step's metrics (floats) and seconds (the card synchronised around the
    step), and the last state and step function it built."""

    def __init__(self):
        self.metrics, self.step_s = [], []
        self.state = self.step_fn = None

    def wrap(self, make):
        import torch

        def wrapped(gen, disc, **kw):
            init_fn, step_fn = make(gen, disc, **kw)
            self.step_fn = step_fn

            def init(seed=0):
                self.state = init_fn(seed)
                return self.state

            def step(state, images, masks):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step_fn(state, images, masks)
                self.metrics.append({k: float(v) for k, v in m.items()})
                self.step_s.append(time.perf_counter() - t0)
                return m
            return init, step
        return wrapped


def device_rows(prof):
    """(device ms, kernel launches) summed over a torch.profiler run's CUDA
    kernels (record_function ranges excluded)."""
    rows = [(ev.self_device_time_total, ev.count)
            for ev in prof.key_averages()
            if str(getattr(ev, "device_type", "")).endswith("CUDA")
            and not getattr(ev, "is_user_annotation", False)
            and "#" not in ev.key]
    return sum(r[0] for r in rows) / 1e3, sum(r[1] for r in rows)


def lama_training_arm(exp_root, train_dir, val_dir):
    """Phase 18 (a): `lama_train` in this process at big-lama's width with
    resnet_pl, each step recorded; the gates; the resume; a profile of a
    few steady steps (`utils/profiling.py`)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from spinnerf_tpu_torch.cli.__main__ import main as cli_main
    from spinnerf_tpu_torch.data.lama_masks import MixedMaskGenerator
    from spinnerf_tpu_torch.eval.render import read_png
    from spinnerf_tpu_torch.train import lama_loop
    from spinnerf_tpu_torch.train.lama_trainer import make_batch, to_nchw
    from spinnerf_tpu_torch.utils import profiling

    exp = exp_root / "lama_train"
    shutil.rmtree(exp, ignore_errors=True)
    argv = ["lama_train", "--indir", str(train_dir), "--exp_dir", str(exp),
            "--val_dir", str(val_dir), "--i_val", str(LAMA_I_VAL),
            "--batch_size", str(LAMA_BATCH), "--crop", str(LAMA_CROP),
            "--ngf", str(LAMA_NGF), "--n_blocks", str(LAMA_BLOCKS),
            "--perceptual", "resnet_pl"]
    out = {}
    runs = []
    for n_steps in (LAMA_STEPS, LAMA_RESUME_STEPS):
        rec = LamaRecorder()
        make = lama_loop.make_lama_train_step
        lama_loop.make_lama_train_step = rec.wrap(make)
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli_main(argv + ["--n_steps", str(n_steps)])
        finally:
            lama_loop.make_lama_train_step = make
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            log(f"[lama_train] {line}")
        if rc != 0:
            raise AssertionError(f"lama_train returned {rc}")
        runs.append((rec, secs, text, torch.cuda.max_memory_allocated()))
    (rec, secs, _, peak), (rec2, secs2, text2, _) = runs
    steps = rec.metrics
    if len(steps) != LAMA_STEPS or \
            len(rec2.metrics) != LAMA_RESUME_STEPS - LAMA_STEPS:
        raise AssertionError(f"lama_train ran {len(steps)} + "
                             f"{len(rec2.metrics)} steps")
    bad = [(i, k) for i, m in enumerate(steps + rec2.metrics)
           for k, v in m.items() if not math.isfinite(v)]
    rows = [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines()]
    bad += [r["step"] for r in rows if not all(
        math.isfinite(v) for k, v in r.items() if k not in ("step", "val"))]
    l1_0 = steps[0]["g_l1"]
    l1_late = float(np.mean([m["g_l1"] for m in steps[30:40]]))
    steady = rec.step_s[2:]
    step_s = float(np.median(steady))
    out.update(seconds=secs, resume_seconds=secs2, steps=len(steps),
               g_l1_step_0=l1_0, g_l1_steps_31_40=l1_late,
               first_step_s=rec.step_s[0], median_step_s=step_s,
               images_per_s=LAMA_BATCH * len(steady) / sum(steady),
               peak_device_memory_gib=peak / 2 ** 30,
               metrics_step_0=steps[0], metrics_step_40=steps[-1],
               val_rows=[r for r in rows if "val" in r])
    log(f"[lama_train] {len(steps)} steps in {secs:.1f} s: g_l1 step 0 "
        f"{l1_0:.5f}, mean of steps 31-40 {l1_late:.5f}; median step "
        f"{step_s * 1e3:.1f} ms, {out['images_per_s']:.2f} images/s, peak "
        f"{out['peak_device_memory_gib']:.2f} GiB")
    if bad:
        raise AssertionError(f"lama_train: non-finite metrics at {bad}")
    if not l1_late < l1_0:
        raise AssertionError("lama_train: g_l1 did not fall")
    if not any("val" in r for r in rows):
        raise AssertionError("lama_train: no validation row")
    grid = read_png(exp / "visualizations" / "step_000000.png")
    if grid.shape != (min(LAMA_BATCH, 8) * LAMA_CROP, 4 * LAMA_CROP, 3):
        raise AssertionError(f"visualizer grid {grid.shape}")
    ckpts = sorted(p.name for p in (exp / "checkpoints").iterdir())
    log(f"[lama_train] grid {grid.shape} decoded; checkpoints {ckpts}")
    if f"ckpt_{LAMA_STEPS - 1:08d}.pt" not in ckpts:
        raise AssertionError("lama_train wrote no checkpoint")
    if f"resumed inpainter training from step {LAMA_STEPS - 1}" \
            not in text2:
        raise AssertionError("the second lama_train did not resume")

    # a few steady steps of the resumed state under torch.profiler
    images = lama_loop.load_image_dir(train_dir)
    rng = np.random.RandomState(1)
    crops, masks = make_batch([images[j] for j in rng.choice(
        len(images), LAMA_BATCH)], MixedMaskGenerator(), rng, LAMA_CROP)
    x, m = to_nchw(crops, CARD), to_nchw(masks, CARD)
    state, step_fn = rec2.state, rec2.step_fn
    step_fn(state, x, m)
    torch.cuda.synchronize()
    with profiling.trace(exp_root / "lama_trace") as prof:
        for _ in range(LAMA_PROFILE_STEPS):
            step_fn(state, x, m)
    dev_ms, launches = device_rows(prof)
    dev_ms /= LAMA_PROFILE_STEPS
    launches /= LAMA_PROFILE_STEPS
    out.update(profile_steps=LAMA_PROFILE_STEPS,
               device_ms_per_step=dev_ms, launches_per_step=launches,
               device_busy_share=dev_ms / (step_s * 1e3))
    log(f"[lama_train] profiled {LAMA_PROFILE_STEPS} steps: {dev_ms:.1f} "
        f"device ms and {launches:.0f} kernel launches a step, busy share "
        f"{out['device_busy_share']:.3f} of the {step_s * 1e3:.1f} ms step")
    return out, exp


@contextlib.contextmanager
def tf32_everywhere():
    """TF32 on for cuDNN and matmuls through the whole LaMa step, every
    `_f32_convs` block of its modules made to switch it on as well: the
    control that phase 18 (b)'s gradient gate must refuse."""
    import torch

    from spinnerf_tpu_torch.models import lama, lpips, segmentation
    from spinnerf_tpu_torch.train import lama_trainer

    @contextlib.contextmanager
    def tf32_on():
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev
    mods = (lama, lpips, segmentation, lama_trainer)
    saved = [m._f32_convs for m in mods]
    for m in mods:
        m._f32_convs = tf32_on
    try:
        with tf32_on():
            yield
    finally:
        for m, f in zip(mods, saved):
            m._f32_convs = f


def lama_f64_step(images):
    """Phase 18 (b): one step at big-lama's width, batch 2, crop 128, from
    identical weights, in f32 (TF32 off), in float64 and with TF32 on
    (the control) on the card: every loss, each gradient before clipping
    and the BN running statistics against float64's."""
    import copy

    import numpy as np
    import torch

    from spinnerf_tpu_torch.data.lama_masks import MixedMaskGenerator
    from spinnerf_tpu_torch.models.discriminator import NLayerDiscriminator
    from spinnerf_tpu_torch.models.lama import FFCResNetGenerator
    from spinnerf_tpu_torch.models.segmentation import make_resnet_pl
    from spinnerf_tpu_torch.train import lama_trainer as lt

    rng = np.random.RandomState(2)
    crops, masks = lt.make_batch([images[j] for j in rng.choice(
        len(images), LAMA_F64_BATCH)], MixedMaskGenerator(), rng,
        LAMA_F64_CROP)
    gen = FFCResNetGenerator(ngf=LAMA_NGF, n_blocks=LAMA_BLOCKS, device=CARD)
    gen.reset_parameters(torch.Generator().manual_seed(0))
    disc = NLayerDiscriminator(device=CARD)
    disc.reset_parameters(torch.Generator().manual_seed(1))
    runs = {}
    clip = lt.clip_by_global_norm_
    for name, dtype, ctx in (("f32", torch.float32, contextlib.nullcontext),
                             ("tf32", torch.float32, tf32_everywhere),
                             ("f64", torch.float64, contextlib.nullcontext)):
        g = copy.deepcopy(gen).to(dtype)
        d = copy.deepcopy(disc).to(dtype)
        pl_fn, enc = make_resnet_pl(device=CARD)
        enc.to(dtype)
        _, step_fn = lt.make_lama_train_step(g, d, perceptual_fn=pl_fn)
        state = lt.LamaTrainState(g, d, *(
            torch.optim.Adam(mod.parameters(), lr=lr, eps=1e-8)
            for mod, lr in ((g, 1e-3), (d, 1e-4))))
        grads = []

        def capture(params, max_norm):
            grads.append([p.grad.detach().clone() for p in params])
            return clip(params, max_norm)
        lt.clip_by_global_norm_ = capture
        try:
            t0 = time.perf_counter()
            with ctx():
                m = step_fn(state, lt.to_nchw(crops, CARD).to(dtype),
                            lt.to_nchw(masks, CARD).to(dtype))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            lt.clip_by_global_norm_ = clip
        bufs = [b.detach().clone() for mod in (g, d)
                for k, b in mod.state_dict().items() if "running" in k]
        runs[name] = ({k: float(v) for k, v in m.items()}, grads, bufs,
                      secs)
        del g, d, enc, state
        torch.cuda.empty_cache()
    m64, g64, b64, s64 = runs["f64"]

    def against_f64(m32, g32, b32):
        loss_err = {k: abs(m32[k] - m64[k]) / max(abs(m64[k]), 1e-30)
                    for k in m64}
        cos, l2, zero, worst = {}, {}, {}, {}
        for phase, a_list, b_list in (("gen", g32[0], g64[0]),
                                      ("disc", g32[1], g64[1])):
            # the transpose convs' biases feed train-mode BNs, which cancel
            # them: their exact gradient is 0 (float64's is ~1e-15) and
            # f32's is noise without a direction
            top = max(float(b.abs().max()) for b in b_list)
            live = [(a, b) for a, b in zip(a_list, b_list)
                    if float(b.abs().max()) > 1e-9 * top]
            zero[phase] = len(b_list) - len(live)
            cs = sorted((float(torch.nn.functional.cosine_similarity(
                a.double().flatten(), b.flatten(), dim=0)), i,
                list(b.shape)) for i, (a, b) in enumerate(live))
            cos[phase] = cs[0][0]
            worst[phase] = cs[:3]
            num = sum(float(((a.double() - b) ** 2).sum())
                      for a, b in zip(a_list, b_list))
            den = sum(float((b ** 2).sum()) for b in b_list)
            l2[phase] = math.sqrt(num / den)
        bn_err = max(float((a.double() - b).abs().max() / b.abs().max())
                     for a, b in zip(b32, b64) if b.abs().max() > 0)
        return {"loss_rel_err": loss_err, "grad_min_cosine": cos,
                "grad_tensors_exactly_zero": zero,
                "grad_worst_cosines": worst, "grad_rel_l2_err": l2,
                "bn_stats_rel_err": bn_err}
    out = against_f64(*runs["f32"][:3])
    control = against_f64(*runs["tf32"][:3])
    out.update(tf32_control=control, f32_step_s=runs["f32"][3],
               tf32_step_s=runs["tf32"][3], f64_step_s=s64,
               batch=LAMA_F64_BATCH, crop=LAMA_F64_CROP)
    log(json.dumps({"lama_f64_step": out}))
    if not all(e <= LAMA_LOSS_RTOL for e in out["loss_rel_err"].values()):
        raise AssertionError(f"a loss is off float64's: {out}")
    if not all(c >= LAMA_GRAD_COS for c in out["grad_min_cosine"].values()):
        raise AssertionError(f"a gradient is off float64's: {out}")
    if not all(e <= LAMA_GRAD_L2 for e in out["grad_rel_l2_err"].values()):
        raise AssertionError(f"a gradient is off float64's: {out}")
    if not out["bn_stats_rel_err"] <= LAMA_BN_RTOL:
        raise AssertionError(f"BN statistics off float64's: {out}")
    # the gate tells a step with TF32 on from one without, in each phase
    if any(e <= LAMA_GRAD_L2 for e in control["grad_rel_l2_err"].values()):
        raise AssertionError(f"the TF32 control passes the gradient gate: "
                             f"{control}")
    return out


def lama_nets_f64(images):
    """Phase 18 (c): `inception_pool3` at 299 and the dilated ResNet50's
    four stage features, f32 (TF32 off) against float64 on the card."""
    import copy

    import numpy as np
    import torch

    from spinnerf_tpu_torch.models.inception import load_inception
    from spinnerf_tpu_torch.models.segmentation import (imagenet_normalize,
                                                        make_resnet_pl)
    x = torch.as_tensor(np.stack([im[:299, :299] for im in images[:4]]),
                        device=CARD).permute(0, 3, 1, 2).contiguous()
    net = load_inception(device=CARD)
    net64 = copy.deepcopy(net).double()
    with torch.no_grad():
        f32 = net(x)
        f64 = net64(x.double())
    inc_err = rel_err(f32, f64)
    del net64
    _, enc = make_resnet_pl(device=CARD)
    enc64 = copy.deepcopy(enc).double()
    xs = imagenet_normalize(x[:2, :, :256, :256])
    with torch.no_grad():
        s32 = enc(xs)
        s64 = enc64(xs.double())
    res_err = [rel_err(a, b) for a, b in zip(s32, s64)]
    out = {"inception_pool3_rel_err": inc_err,
           "inception_shape": list(f32.shape),
           "resnet50_stage_rel_err": res_err,
           "resnet50_stage_shapes": [list(a.shape) for a in s32]}
    log(json.dumps({"lama_nets_f64": out}))
    if not inc_err <= NET_F64_RTOL or not max(res_err) <= NET_F64_RTOL:
        raise AssertionError(f"a network is off float64's: {out}")
    return out


def lama_commands_arm(exp_root, src_dir, val_dir, train_exp):
    """Phase 18 (d): gen_masks for every kind, predictions by
    `inpaint2d.predict`, eval_inpainting --fid, side_by_side,
    analyze_errors, inner_features, report and export on the card; each
    command's seconds."""
    import contextlib
    import copy
    import io

    import numpy as np
    import torch

    from spinnerf_tpu_torch.cli.__main__ import main as cli_main
    from spinnerf_tpu_torch.eval.inpainting import (InceptionFeatureExtractor,
                                                    frechet_distance)
    from spinnerf_tpu_torch.eval.render import read_png, write_png
    from spinnerf_tpu_torch.models.lpips import _f32_convs
    from spinnerf_tpu_torch.pipeline import inpaint2d, lama_tools
    secs, info = {}, {}
    root = exp_root / "lama_cmds"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)

    def run(name, argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"[lama_cmds] {name}: {secs[name]:.3f} s; "
            f"{buf.getvalue().strip()[-300:]}")
        if rc != 0:
            raise AssertionError(f"`{name}` returned {rc}")
        return buf.getvalue()

    n_src = len([p for p in src_dir.iterdir() if p.suffix == ".png"])
    for kind in MASK_KINDS:
        d = root / f"masks_{kind}"
        run(f"gen_masks_{kind}", ["gen_masks", "--indir", str(src_dir),
                                  "--outdir", str(d), "--kind", kind])
        pairs = lama_tools.load_eval_pairs(d)
        empty = [mp.name for _, mp in pairs if read_png(mp).max() == 0]
        info[f"gen_masks_{kind}_pairs"] = len(pairs)
        if empty or (kind != "segm" and len(pairs) != n_src):
            raise AssertionError(f"gen_masks {kind}: {len(pairs)} pairs, "
                                 f"empty {empty}")
    # predictions by the port's inpainter on the card
    pred = root / "pred"
    pred.mkdir()
    gen = inpaint2d.load_generator(device=CARD)
    t0 = time.perf_counter()
    pairs = lama_tools.load_eval_pairs(val_dir)
    for ip, mp in pairs:
        img = lama_tools._imread_rgb(ip)
        out = inpaint2d.predict(gen, img, lama_tools._imread_mask(mp))
        write_png(pred / mp.name,
                  (np.clip(out, 0, 1) * 255).astype(np.uint8))
    torch.cuda.synchronize()
    secs["predict"] = time.perf_counter() - t0
    tsv = root / "eval" / "metrics.tsv"
    fid_calls = []
    extract = InceptionFeatureExtractor.__call__

    def recorded(self, images):
        feats = extract(self, images)
        if not fid_calls:
            fid_calls.append((self.net, [], []))
        fid_calls[-1][1].append(np.asarray(images))
        fid_calls[-1][2].append(feats)
        return feats
    InceptionFeatureExtractor.__call__ = recorded
    try:
        run("eval_inpainting", ["eval_inpainting", "--datadir",
                                str(val_dir), "--predictdir", str(pred),
                                "--outpath", str(tsv), "--fid"])
    finally:
        InceptionFeatureExtractor.__call__ = extract
    rows = {line.split("\t")[0]: line.split("\t")
            for line in tsv.read_text().splitlines()}
    fid_key = "fid" if "fid" in rows else "fid_random_inception"
    info["fid_key"] = fid_key
    info["ssim_fid100_f1"] = float(rows["ssim_fid100_f1"][2])
    # the command's FID against one from the same images' pool3 features
    # in float64 (the TSV keeps 4 decimals; without weights the FID is
    # ~1e-8)
    (net, imgs, feats), = fid_calls
    net64 = copy.deepcopy(net).double()
    with torch.no_grad():
        feats64 = [torch.cat([net64(torch.as_tensor(
            im[i:i + 4], dtype=torch.float64, device=CARD).permute(
                0, 3, 1, 2)) for i in range(0, len(im), 4)]).cpu().numpy()
            for im in imgs]
    del net64
    info["fid"] = frechet_distance(*feats)
    info["fid_f64_features"] = frechet_distance(*feats64)
    info["fid_rel_err"] = abs(info["fid"] - info["fid_f64_features"]) / \
        max(info["fid_f64_features"], 1e-300)
    if not (rows[fid_key][2] == f"{info['fid']:.4f}"
            and info["fid_f64_features"] > 0
            and info["fid_rel_err"] <= FID_RTOL):
        raise AssertionError(f"eval_inpainting's FID: {rows[fid_key]}, "
                             f"{info}")
    run("side_by_side", ["side_by_side", "--datadir", str(val_dir),
                         "--outdir", str(root / "sbs"), str(pred)])
    sheets = sorted((root / "sbs").glob("*.png"))
    shapes = {read_png(p).shape for p in sheets}
    if len(sheets) != len(pairs) or len(shapes) != 1:
        raise AssertionError(f"side_by_side: {len(sheets)} sheets {shapes}")
    run("analyze_errors", ["analyze_errors", "--datadir", str(val_dir),
                           "--predictdir", str(pred), "--outdir",
                           str(root / "errors"), "--worst_k", "2"])
    if len(list((root / "errors").glob("worst_ssim_*.png"))) != 2 or not \
            (root / "errors" / "report.html").exists():
        raise AssertionError("analyze_errors wrote no worst cases")
    run("inner_features", ["inner_features", "--indir", str(val_dir),
                           "--outdir", str(root / "feats")])
    feats = sorted((root / "feats").glob("*_features.npy"))
    z = np.load(feats[0])
    info["inner_features_shape"] = list(z.shape)
    if len(feats) != len(pairs) or not np.isfinite(z).all():
        raise AssertionError("inner_features")
    text = run("report", ["report", str(train_exp / "metrics.jsonl")])
    if "g_l1" not in text:
        raise AssertionError("report has no g_l1 row")
    run("export", ["export", "--outpath", str(root / "gen.pt"),
                   "--height", "256", "--width", "256"])
    traced = torch.jit.load(str(root / "gen.pt"), map_location=CARD)
    x = torch.rand(1, 4, 256, 256, device=CARD,
                   generator=torch.Generator(CARD).manual_seed(0))
    gen64 = copy.deepcopy(gen).double()
    with torch.no_grad(), _f32_convs():
        want = gen(x)
        ref = gen64(x.double())
        got = traced(x)
        with torch.jit.optimized_execution(False):
            plain = traced(x)
    del gen64
    info.update(export_rel_err=rel_err(got, want),
                export_bit_equal=bool(torch.equal(got, want)),
                export_unoptimized_rel_err=rel_err(plain, want),
                export_f64_err=rel_err(got, ref),
                module_f64_err=rel_err(want, ref))
    # the traced generator is within the module's own distance from
    # float64 (twice it, and EXPORT_RTOL of the module's output)
    if not (info["export_rel_err"] <= EXPORT_RTOL and info[
            "export_f64_err"] <= 2 * info["module_f64_err"] + 1e-7):
        raise AssertionError(f"the traced generator is off: {info}")
    log(json.dumps({"lama_commands": {"seconds": secs, **info}}))
    return secs, info


def lama_train_phase(exp_root):
    """Phase 18: LaMa training and the LaMa commands (module docstring)."""
    import torch

    from spinnerf_tpu_torch.cli.__main__ import main as cli_main
    from spinnerf_tpu_torch.data import synthetic
    from spinnerf_tpu_torch.train.lama_loop import load_image_dir

    t_start = time.perf_counter()
    scene = exp_root / "lama_scene"
    shutil.rmtree(scene, ignore_errors=True)
    synthetic.make_scene(scene, n_views=LAMA_TRAIN_VIEWS + LAMA_VAL_VIEWS,
                         h=FIT_H, w=FIT_W, factor=1, n_points=300)
    views = sorted((scene / "images").glob("*.png"))
    train_dir, src_dir = exp_root / "lama_images", exp_root / "lama_val_src"
    for d, vs in ((train_dir, views[:LAMA_TRAIN_VIEWS]),
                  (src_dir, views[LAMA_TRAIN_VIEWS:])):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir()
        for v in vs:
            shutil.copy(v, d / v.name)
    val_dir = exp_root / "lama_val"
    shutil.rmtree(val_dir, ignore_errors=True)
    if cli_main(["gen_masks", "--indir", str(src_dir), "--outdir",
                 str(val_dir)]) != 0:
        raise AssertionError("gen_masks for the validation set")
    train, train_exp = lama_training_arm(exp_root, train_dir, val_dir)
    torch.cuda.empty_cache()
    images = load_image_dir(train_dir)
    f64 = lama_f64_step(images)
    nets = lama_nets_f64(images)
    torch.cuda.empty_cache()
    secs, info = lama_commands_arm(exp_root, src_dir, val_dir, train_exp)
    total = time.perf_counter() - t_start
    log(json.dumps({"lama": {"train": train, "f64_step": f64,
                             "nets_f64": nets, "command_seconds": secs,
                             "commands": info, "seconds": total}}))
    log(f"[phase 18] {total:.1f} s")


DP_RANKS, DP_GROUP_STEPS, DP_CLI_STEPS = 2, 20, 50


@contextlib.contextmanager
def stdout_to(path):
    """File descriptor 1, this process's and the processes it starts,
    into `path` within the block."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def data_parallel_phase(exp_root, scene, argv=()):
    """Phase 19: data parallelism across processes (module docstring)."""
    import torch

    from spinnerf_tpu_torch.cli.__main__ import main as cli_main
    from spinnerf_tpu_torch.config import Config
    from spinnerf_tpu_torch.ops import fused_mlp as fm
    from spinnerf_tpu_torch.ops import hash_encode as he
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    from spinnerf_tpu_torch.parallel import dryrun
    from spinnerf_tpu_torch.parallel import mesh as mesh_lib
    from spinnerf_tpu_torch.train.loop import Trainer

    t_phase = time.perf_counter()
    secs, out = {}, {}

    # (a) one rank against two on this card
    t0 = time.perf_counter()
    res = dryrun.dryrun_data_parallel(DP_RANKS, device="cuda:0", log=log)
    for r, launches in enumerate(res["nerf"]["launches"]):
        if not (launches["fwd"] >= 2 and launches["bwd"] >= 2):
            raise AssertionError(f"rank {r} did not run #1 / #2 on its "
                                 f"shard: {launches}")
    log(f"[dp] (a) NeRF step: loss {res['nerf']['loss']:.6f}, 1 vs "
        f"{DP_RANKS} ranks relative {res['nerf']['loss_rel']:.3g} (gate "
        f"{dryrun.NERF_LOSS_REL}), parameters "
        f"{res['nerf']['param_max_abs']:.3g} (gate {dryrun.NERF_PARAM_ABS}); "
        f"LaMa step: G {res['lama']['gen_max_abs']:.3g} (gate "
        f"{dryrun.LAMA_GEN_ABS}), metrics {res['lama']['metrics_max_rel']:.3g}"
        f" (gate {dryrun.LAMA_METRIC_REL}), BN statistics "
        f"{res['lama']['stats_max_rel']:.3g} (gate {dryrun.LAMA_STATS_REL}), "
        f"gradients {res['lama']['grad_rel_l2']} (gate "
        f"{dryrun.LAMA_GRAD_REL}); controls failing their gates "
        f"{ {c: r['fails'] for c, r in res['controls'].items()} }; frame "
        f"{res['render']['shape']}: equal {res['render']['equal']}, largest "
        f"difference {res['render']['max_abs']:.3g} of "
        f"{res['render']['max_value']:.4g} (gate {dryrun.RENDER_REL} of it); "
        f"replicas bit-equal on all three; #1 / #2 launches per rank "
        f"{res['nerf']['launches']}")
    out["dryrun"] = res
    secs["a"] = time.perf_counter() - t0

    # (b) in deterministic mode (the kernels' fixed-order variants), two
    # runs without a group and an NCCL group of one rank, bit-equal, on the
    # hash, MLP and XOR arms; the same two runs with the mode off beside
    t0 = time.perf_counter()
    common = dict(prepare=True, basedir=str(exp_root), no_ndc=True,
                  no_reload=True, i_print=0, i_weights=0, i_video=0,
                  i_testset=0, i_feat=0)
    arms = {"hash": {}, "mlp": dict(no_tcnn=True, lrate=5e-4,
                                    lrate_decay=250),
            "xor": dict(hash_impl="mxu")}
    profile = "--profile" in argv

    def train(arm, tag):
        tr = Trainer(Config(expname=f"dp_{arm}_{tag}", **arms[arm],
                            **common), scene=scene, log=log)
        first = tr.fit(1, hooks=False)
        step1 = [p.detach().clone() for p in tr.fields.parameters()]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.fit(DP_GROUP_STEPS, hooks=False)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3 / (DP_GROUP_STEPS - 1)
        params = [p.detach().clone() for p in tr.fields.parameters()]
        if profile and tag == "solo0":
            mode = ("on" if torch.are_deterministic_algorithms_enabled()
                    else "off")
            profile_steps(tr, step_ms, tag=f"{arm} arm, deterministic {mode}")
        return ({k: float(v) for k, v in first.items()}, params, step1,
                step_ms)

    def n_differ(a, b):
        return sum(not torch.equal(x, y) for x, y in zip(a, b))

    def max_diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    counters = ((hw, "launches_det"), (he, "launches_det"),
                (fm, "launches"))
    out["group_of_one"] = {}
    with deterministic_mode():
        for mod, name in counters:
            getattr(mod, name).update(dict.fromkeys(getattr(mod, name), 0))
        for arm in arms:
            with tempfile.TemporaryDirectory(prefix="dp_group_") as rdzv:
                mesh = mesh_lib.join(0, 1,
                                     init_method=f"file://{rdzv}/rendezvous")
                try:
                    before = mesh_lib.calls["all_reduce"]
                    group = train(arm, "group")
                    reduces = mesh_lib.calls["all_reduce"] - before
                    backend = torch.distributed.get_backend()
                    # the step's gradient all-reduce leaves a group of one's
                    # tensors as they were, bit for bit
                    copies = [t.clone() for t in group[1]]
                    mesh.all_reduce_mean_(copies)
                    identity = all(torch.equal(a, b)
                                   for a, b in zip(copies, group[1]))
                finally:
                    mesh_lib.leave()
            runs = [train(arm, f"solo{i}") for i in range(2)]
            res_b = dict(backend=backend, mesh=list(mesh[:2]),
                         all_reduces=reduces, reduce_is_identity=identity,
                         tensors=len(group[1]),
                         solo_runs_differ_in=n_differ(runs[0][1], runs[1][1]),
                         group_differs_in=(n_differ(group[1], runs[0][1])
                                           + n_differ(group[2], runs[0][2])),
                         step1_differ_in=n_differ(runs[0][2], runs[1][2]),
                         step1_metrics_equal=(group[0] == runs[0][0]
                                              == runs[1][0]),
                         step_ms=[r[3] for r in (group, *runs)])
            out["group_of_one"][arm] = res_b
            log(f"[dp] (b) {arm} arm, deterministic mode: {res_b}")
            if (backend != "nccl" or reduces < 2 * DP_GROUP_STEPS
                    or not identity):
                raise AssertionError("the group of one did not all-reduce "
                                     "over NCCL, or its all-reduce changed "
                                     "a value")
            if (res_b["solo_runs_differ_in"] or res_b["group_differs_in"]
                    or res_b["step1_differ_in"]
                    or not res_b["step1_metrics_equal"]):
                raise AssertionError(f"{arm} arm: runs in deterministic mode "
                                     f"are not bit-equal")
        det_launches = {mod.__name__.rsplit(".", 1)[1]: dict(getattr(mod, n))
                        for mod, n in counters}
    log(f"[dp] (b) fixed-order launches over the deterministic runs: "
        f"{det_launches}")
    out["det_launches"] = det_launches
    for key, want in (("hash_encode_win", "bwd"), ("fused_mlp", "bwd"),
                      ("hash_encode", "bwd_pts")):
        if det_launches[key][want] < 2 * 3 * DP_GROUP_STEPS:
            raise AssertionError(f"the deterministic runs launched "
                                 f"{det_launches}")
    # the control: the same two runs with the mode off (not gated)
    out["control_mode_off"] = {}
    for arm in arms:
        runs = [train(arm, f"solo{i}") for i in range(2)]
        out["control_mode_off"][arm] = dict(
            solo_runs_differ_in=n_differ(runs[0][1], runs[1][1]),
            step1_differ_in=n_differ(runs[0][2], runs[1][2]),
            max_abs=max_diff(runs[0][1], runs[1][1]),
            step_ms=[r[3] for r in runs])
    log(f"[dp] (b) control, deterministic mode off: two runs differ in "
        f"{ {a: r['solo_runs_differ_in'] for a, r in out['control_mode_off'].items()} } "
        f"tensors: {out['control_mode_off']}")
    secs["b"] = time.perf_counter() - t0

    # (c) the command line, two ranks on this card over gloo
    t0 = time.perf_counter()
    exp = exp_root / "dp_cli"
    shutil.rmtree(exp, ignore_errors=True)
    flags = list(CLI_FLAGS)         # phase 16's, on phase 13's scene
    for flag, value in (("--factor", DISK_FACTOR), ("--N_iters", DP_CLI_STEPS),
                        ("--i_weights", DP_CLI_STEPS), ("--i_print", 10)):
        flags[flags.index(flag) + 1] = str(value)
    argv = (["train", "--expname", "dp_cli", "--basedir", str(exp_root),
             "--datadir", str(exp_root / "disk_scene"), "--mesh_shape",
             str(DP_RANKS), "--no_reload", "True"] + flags)
    captured = exp_root / "dp_cli.log"
    with stdout_to(captured):
        rc = cli_main(argv, device="cuda:0")
    text = captured.read_text()
    log(text.rstrip())
    ckpts = sorted(p.name for p in (exp / "checkpoints").iterdir())
    psnr = [float(line.split(" psnr ")[1].split()[0])
            for line in text.splitlines() if " psnr " in line]
    out["cli"] = dict(rc=rc, checkpoints=ckpts, psnr=psnr)
    log(f"[dp] (c) {out['cli']}")
    if rc != 0 or ckpts != [f"ckpt_{DP_CLI_STEPS:08d}.pt"]:
        raise AssertionError("train --mesh_shape 2 did not leave rank 0's "
                             "one checkpoint")
    if f"[{DP_CLI_STEPS}] {DP_RANKS} ranks, parameters bit-equal" not in text:
        raise AssertionError("the ranks' parameters are not reported equal")
    if len(psnr) != DP_CLI_STEPS // 10 or not psnr[-1] > psnr[0]:
        raise AssertionError(f"the PSNR did not rise: {psnr}")
    secs["c"] = time.perf_counter() - t0
    out["seconds"] = dict(secs, phase=time.perf_counter() - t_phase)
    log(json.dumps({"data_parallel": out}, default=str))
    log(f"[phase 19] {out['seconds']['phase']:.1f} s")
    return out


def fixed_order_records(records, mlp_records, idx_records, v1_records,
                        det_launches):
    """The kernels line's entries of the fixed-order variants of #2, #6
    and #4 (B1e; #10 and #8 always sum in a fixed order), each beside its
    atomic kernel's record: the same function, so the same plain version,
    bound and library call; its own launches (phase 19 (b)'s deterministic
    runs, or for #4, which no arm runs, phase 9's entry calls), error and
    time, and the atomic kernel's time on the same inputs
    (`atomic_ms`)."""
    by_name = {r["name"]: r for r in records + mlp_records + idx_records
               + v1_records}
    out = []
    for name, held, launches, extra in (
            ("hash_encode_win_bwd", "hash",
             det_launches["hash_encode_win"]["bwd"],
             {k: DET_HELD[k]["ms"] for k in DET_HELD
              if k.startswith(("disk", "fit", "dense", "2^25"))
              and "ms" in DET_HELD[k]}),
            ("hash_encode_ngp_bwd", "idx bwd_pts",
             det_launches["hash_encode"]["bwd_pts"], {}),
            ("hash_encode_idx_bwd", "idx bwd",
             DET_HELD["idx bwd"]["launches_phase9"], {})):
        base, h = by_name[name], DET_HELD[held]
        rec = {k: base[k] for k in ("route", "source", "replaces",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}
        rec.update(name=f"{name}_fixed_order", launches=launches,
                   max_abs_err=h["max_abs_err"], ms=h["ms"],
                   atomic_ms=h["atomic_ms"],
                   ms_over_atomic=h["ms"] / h["atomic_ms"])
        if extra:
            rec["ms_other_points"] = extra
        out.append(rec)
    return out


def profile_steps(trainer, step_ms, n_steps=5, tag=None):
    """torch.profiler over a few steps: device time by kernel, kernel
    launches a step, and the device's busy share of the unprofiled step
    time `step_ms`; `tag` names the arm (default: the experiment)."""
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
    def entry(us, k, c):
        return {"name": k[:90], "ms_per_step": us / 1e3 / n_steps,
                "launches_per_step": c / n_steps}

    log(json.dumps({"profile": {
        "arm": tag or trainer.cfg.expname,
        "steps": n_steps, "device_ms_per_step": device_ms,
        "step_ms_unprofiled": step_ms,
        "device_busy_share": device_ms / step_ms,
        "kernel_launches_per_step": sum(r[2] for r in rows) / n_steps,
        "top": [entry(*r) for r in rows[:15]],
        # every kernel of the windowed hash encode (#1, #2) and of the
        # index-gather encode (#3-#6), however small
        "hash_encode_win": [entry(*r) for r in rows
                            if r[1].startswith(("hf_", "hb_"))],
        "hash_encode_idx": [entry(*r) for r in rows
                            if r[1].startswith(("hi_", "void hi_"))]}}))


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from spinnerf_tpu_torch.config import Config
    from spinnerf_tpu_torch.ops import cuda_build
    from spinnerf_tpu_torch.ops import fused_mlp as fm
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    from spinnerf_tpu_torch.train.loop import Trainer

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    build_logs = cuda_build.build(["hash_encode_win", "fused_mlp_pe",
                                   "hash_encode_idx", "kbench_cal"])
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        log(f"[build] csrc/{name}.cu:\n{text.strip()}")
    # kernels that must not spill: each instantiation of the fused MLP's
    # forward, the hash forward (#1) and the calibration (#11)
    for src, kernel, want in (("fused_mlp_pe", "fm_fwd_kernel", 2),
                              ("hash_encode_win", "hf_fwd_kernel", 1),
                              ("kbench_cal", "kc_wgmma_kernel", 8)):
        res = {n: r for n, r in kernel_resources(build_logs[src]).items()
               if kernel in n}
        log(f"[build] {kernel} (registers, stack, spill stores, spill "
            f"loads): {res}")
        if len(res) != want or any(r[2] or r[3] for r in res.values()):
            raise AssertionError(f"{kernel} is missing from the build log "
                                 f"or spills")

    scene, masks, held_pose, held_rgb = synthetic_scene()
    exp_root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(exp_root, ignore_errors=True)
    common = dict(prepare=True, basedir=str(exp_root), no_ndc=True,
                  no_reload=True, N_iters=STEPS, i_print=50, i_weights=0,
                  i_video=0, i_testset=0, i_feat=0)

    # the trainer at the default prepare configuration
    cfg = Config(expname="default_prepare", **common)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, scene=scene, log=log)
    log(f"[setup] trainer on {trainer.device} in "
        f"{time.perf_counter() - t0:.1f} s: table "
        f"{tuple(trainer.model.encoder.table.shape)}, resolutions "
        f"{trainer.model.encoder.resolutions}, dense levels "
        f"{sum(b is not None for b in trainer.model.encoder._boxes)}, "
        f"groups x rays {trainer._batches_per_step()} x {cfg.N_rand}")

    # 3. hash kernels against the plain version
    x = fine_pass_points(trainer)
    records = compare_kernels(trainer, x)
    enc = trainer.model.encoder
    geom = dict(res=enc.resolutions, bounds=enc.bounds, boxes=enc._boxes,
                base_res=trainer.model.base_res,
                finest_res=trainer.model.finest_res_per_unit
                * trainer.model.bound)

    # 4.-5. the hash arm of the main path, and a held-out view
    step_ms, hash_counts = train_arm(trainer, hw.launches, "hash")
    render_held_out(trainer, held_pose, held_rgb, "hash")
    if "--profile" in argv:
        profile_steps(trainer, step_ms)

    # 6. MLP kernels against the plain version
    mlp_records = compare_mlp_kernels(trainer)
    del trainer
    torch.cuda.empty_cache()

    # 4b. the hash arm at the largest table JAX's windowed kernel takes
    big_trainer = big_table_arm(scene, common)
    records[0]["t2_25_trainer"] = big_trainer

    # 7.-8. the MLP arm: the reference's --no_tcnn operating point
    # (tools/full_run.py:138-144)
    mlp_cfg = Config(expname="mlp_prepare", no_tcnn=True, lrate=5e-4,
                     lrate_decay=250, **common)
    mlp_trainer = Trainer(mlp_cfg, scene=scene, log=log)
    log(f"[setup] MLP trainer: coarse and fine "
        f"{type(mlp_trainer.fields['coarse']).__name__} "
        f"{mlp_trainer.fields['coarse'].dims}")
    mlp_step_ms, mlp_counts = train_arm(mlp_trainer, fm.launches, "mlp")
    render_held_out(mlp_trainer, held_pose, held_rgb, "mlp")
    if "--profile" in argv:
        profile_steps(mlp_trainer, mlp_step_ms)
    # phase 11's inputs: the fine pass's points of the MLP arm's rays
    v1_points = {False: bank_points(mlp_trainer, N_POINTS // 128, 7),
                 True: bank_points(mlp_trainer, N_POINTS_SEM // 128, 8)}

    del mlp_trainer
    torch.cuda.empty_cache()

    # 9. the index-gather kernels against the plain version
    idx_records = compare_idx_kernels(x, geom)

    # 10. the XOR-prime hash arm, with the testset hook and the prepare dump
    idx_counts = xor_arm(dataclasses.replace(scene, masks=masks), held_pose,
                         held_rgb, common, argv)

    # 11. the v1 fused MLP kernels, and make_fused_field_fn
    v1_records = compare_mlp_v1_kernels(v1_points)
    del v1_points
    torch.cuda.empty_cache()

    # 12. the calibration kernel
    cal_record = compare_calibration(torch.device("cuda"))
    torch.cuda.empty_cache()

    # 13. the disk arm: the DS-NeRF prepare configuration on a scene
    # directory with COLMAP sparse depth
    disk_counts, disk_fwd, (err, ms, plain_ms) = disk_arm(exp_root, argv)
    records[0].update(disk_ms=disk_fwd[1], disk_plain_ms=disk_fwd[2],
                      disk_max_abs_err=disk_fwd[0],
                      disk_point_base_ms=disk_fwd[3])
    records[1].update(disk_ms=ms, disk_plain_ms=plain_ms,
                      disk_max_abs_err=err)
    torch.cuda.empty_cache()

    # 14. the fit arm: stage_fit with the patch-LPIPS term, stage_eval and
    # the frozen-density mode
    fit_a, fit_b, fit_held = fit_arm(exp_root, argv)
    torch.cuda.empty_cache()

    # 15. the LaMa generator and refiner, then run_pipeline with MVSeg
    lama_arm(exp_root)
    torch.cuda.empty_cache()

    # 16. the command-line entry point
    cli_arm(exp_root)
    torch.cuda.empty_cache()

    # 17. the Blender and DTU scenes, the native COLMAP reader and the
    # full-scale pipeline tool
    loaders_arm(exp_root)
    torch.cuda.empty_cache()

    # 18. LaMa training at big-lama's width and the LaMa commands
    lama_train_phase(exp_root)
    torch.cuda.empty_cache()

    # 19. data parallelism: two ranks on this card, a group of one, and
    # the command line's --mesh_shape 2
    dp = data_parallel_phase(exp_root, scene, argv)
    for r in records:
        k = r["name"].rsplit("_", 1)[1]
        r["fit_launches_per_step"] = {
            f"steps_1_{LPIPS_START}": fit_a[k],
            f"steps_{LPIPS_START + 1}_{FIT_STEPS}": fit_b[k]}
    for tag, (fwd, bwd) in fit_held.items():
        for r, (err, ms, plain_ms) in ((records[0], fwd[:3]),
                                       (records[1], bwd)):
            r.update({f"fit_{tag}_ms": ms, f"fit_{tag}_plain_ms": plain_ms,
                      f"fit_{tag}_max_abs_err": err})

    for r in records:
        r["launches"] = hash_counts[r["name"].rsplit("_", 1)[1]]
    for r in mlp_records:
        r["launches"] = mlp_counts[r["name"].rsplit("_", 1)[1]]
    for r in idx_records[:2]:    # points mode; idx mode counts in phase 9
        r["launches"] = idx_counts[r["name"].rsplit("_", 1)[1] + "_pts"]
    log(f"[launches] the disk arm's hash kernels: {disk_counts}")
    det_records = fixed_order_records(records, mlp_records, idx_records,
                                      v1_records, dp["det_launches"])
    log(json.dumps({"kernels": records + mlp_records + idx_records
                    + v1_records + [cal_record] + det_records}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
