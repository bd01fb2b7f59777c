"""Full-frame and path rendering (port of `spinnerf_tpu/eval/render.py`, the
reference's `render_path`, `DS_NeRF/run_nerf.py:168-307`).

A frame's pixels are one ray batch rendered in chunks by
`core.rendering.render_rays_chunked` under `torch.no_grad()`. The per-frame
artifact tree (rgb/depth/disp/weight/z/alpha/pose/intrinsics) reproduces the
disk contract of the reference and the JAX package. The machine with the
card has neither cv2 nor imageio, so PNGs are written by `write_png`
(stdlib zlib/struct); `write_video` keeps the JAX package's file-format
chain (imageio, then cv2, then per-frame PNGs), importing both lazily.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch.core import rendering
from spinnerf_tpu_torch.core.rendering import RenderConfig
from spinnerf_tpu_torch.data import raybank
from spinnerf_tpu_torch.eval.metrics import to8b

# Light maps hold one value per pixel; the heavy ones are per-sample
# [H, W, S] stacks (~290 MB a frame each at 1008 x 567 with 64+64 samples),
# so renderers return only the maps the caller asks for.
LIGHT_MAPS = ("rgb", "disp", "acc", "depth")
HEAVY_MAPS = ("weights", "z_vals", "alpha")


def _default_maps(cfg: RenderConfig):
    return LIGHT_MAPS + (("prob",) if cfg.semantic else ())


def maps_for_save(save_dir, save_alpha: bool = False):
    """The per-pixel maps a pose-list render must fetch to feed the
    reference's per-frame artifact tree (`run_nerf.py:231-295`): rgb/disp
    always; depth/weights/z_vals only when dumping; alpha on request. Shared
    by `render_path` and `Trainer.render_poses_list`."""
    needed = ("rgb", "disp")
    if save_dir is not None:
        needed += ("depth", "weights", "z_vals")
    if save_alpha:
        needed += ("alpha",)
    return needed


def _check_maps(maps, cfg: RenderConfig):
    """Refuse, before any rendering, a map the renderer does not produce."""
    for m in maps:
        if m not in LIGHT_MAPS + HEAVY_MAPS + ("prob",) or (
                m == "prob" and not cfg.semantic):
            raise ValueError(f"requested map '{m}' is not produced by this "
                             f"renderer (semantic head off?)")


def _frame_hwf(hwf, render_factor: int):
    h, w, focal = hwf
    if render_factor:
        return h // render_factor, w // render_factor, focal / render_factor
    return h, w, focal


def make_frame_renderer(hwf, field_fn, cfg: RenderConfig, *, near, far,
                        ndc: bool = False, chunk: int = 8192,
                        fine_field_fn=None, render_factor: int = 0,
                        maps=None, device=None):
    """A `(c2w, generator=None) -> per-pixel maps` renderer: numpy arrays
    [H, W, ...] of the fine pass (default LIGHT_MAPS, plus "prob" with
    cfg.semantic). Request HEAVY_MAPS entries only when they are read.
    Renders on `device` (the card unless the caller asks for the CPU)."""
    maps = _default_maps(cfg) if maps is None else tuple(maps)
    _check_maps(maps, cfg)
    device = resolve_device(device)
    h, w, focal = _frame_hwf(hwf, render_factor)

    def render(c2w, generator=None):
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
        with torch.no_grad():
            batch, _ = raybank.frame_ray_batch((h, w, focal), c2w[:3, :4],
                                               near, far, ndc=ndc)
            res = rendering.render_rays_chunked(
                batch, field_fn, cfg, chunk, fine_field_fn=fine_field_fn,
                generator=generator)
        out = {}
        for m in maps:
            v = getattr(res.fine, m)
            out[m] = v.reshape((h, w) + tuple(v.shape[1:])).cpu().numpy()
        return out

    return render


def render_frame(c2w, hwf, field_fn, cfg: RenderConfig, *, near, far,
                 ndc: bool = False, chunk: int = 8192, fine_field_fn=None,
                 render_factor: int = 0, maps=None, device=None,
                 generator=None):
    """Render one camera pose to per-pixel maps: rgb [H, W, 3], disp, acc,
    depth [H, W] (+ prob with cfg.semantic); weights/z_vals/alpha
    [H, W, S] through `maps`. For many poses build `make_frame_renderer`
    once."""
    return make_frame_renderer(hwf, field_fn, cfg, near=near, far=far,
                               ndc=ndc, chunk=chunk,
                               fine_field_fn=fine_field_fn,
                               render_factor=render_factor, maps=maps,
                               device=device)(c2w, generator)


def make_param_frame_renderer(hwf, fields, cfg: RenderConfig, *, near, far,
                              ndc: bool = False, chunk: int = 8192,
                              render_factor: int = 0, maps=None,
                              device=None):
    """`make_frame_renderer` over a trainer's fields ({"coarse"[, "fine"]},
    an `nn.ModuleDict`), read at each call: the JAX counterpart passes the
    parameters as jit arguments so that periodic hooks render fresh weights
    without recompiling; eager PyTorch reads the modules' current
    parameters, so there is no compile cache to carry."""
    def coarse(pts, vd):
        return fields["coarse"](pts, vd)

    def fine(pts, vd):
        return fields["fine" if "fine" in fields else "coarse"](pts, vd)

    return make_frame_renderer(hwf, coarse, cfg, near=near, far=far, ndc=ndc,
                               chunk=chunk, fine_field_fn=fine,
                               render_factor=render_factor, maps=maps,
                               device=device)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def render_path(poses, hwf, field_fn, cfg: RenderConfig, *, near, far,
                ndc: bool = False, chunk: int = 8192, fine_field_fn=None,
                render_factor: int = 0, save_dir=None, gt_images=None,
                save_alpha: bool = False, frame_fn=None, device=None,
                generator=None):
    """Render a pose list; with `save_dir`, dump the reference's per-frame
    artifact tree (rgb/, depth/, disp/, weight/, z/, pose/, images/ with
    `gt_images`, alpha/ with `save_alpha`, intrinsics.txt). `frame_fn`
    (a renderer taking `maps_for_save`'s maps) replaces the one built from
    `field_fn`. Returns (rgbs [M, H, W, 3], disps [M, H, W]) as numpy."""
    h, w, focal = _frame_hwf(hwf, render_factor)
    if save_dir is not None:
        save_dir = Path(save_dir)
        for sub in ["rgb", "depth", "disp", "weight", "z", "pose", "images"] \
                + (["alpha"] if save_alpha else []):
            (save_dir / sub).mkdir(parents=True, exist_ok=True)
        intrinsics = np.array([[focal, 0, w / 2], [0, focal, h / 2],
                               [0, 0, 1]])
        np.savetxt(save_dir / "intrinsics.txt", intrinsics)

    needed = maps_for_save(save_dir, save_alpha)
    renderer = frame_fn if frame_fn is not None else make_frame_renderer(
        (h, w, focal), field_fn, cfg, near=near, far=far, ndc=ndc,
        chunk=chunk, fine_field_fn=fine_field_fn, maps=needed, device=device)
    rgbs, disps = [], []
    for i, c2w in enumerate(poses):
        maps = renderer(c2w, generator)
        rgbs.append(maps["rgb"])
        disps.append(maps["disp"])
        if save_dir is None:
            continue
        write_png(save_dir / "rgb" / f"{i:06d}.png", to8b(maps["rgb"]))
        np.save(save_dir / "depth" / f"{i:06d}.npy", maps["depth"])
        np.save(save_dir / "disp" / f"{i:06d}.npy", maps["disp"])
        np.save(save_dir / "weight" / f"{i:06d}.npy", maps["weights"])
        np.save(save_dir / "z" / f"{i:06d}.npy", maps["z_vals"])
        if save_alpha:
            np.save(save_dir / "alpha" / f"{i:06d}.npy", maps["alpha"])
        pose44 = np.concatenate([_host(c2w)[:3, :4], [[0, 0, 0, 1]]], axis=0)
        np.savetxt(save_dir / "pose" / f"{i:06d}.txt", pose44)
        if gt_images is not None:
            write_png(save_dir / "images" / f"{i:06d}.png",
                      to8b(gt_images[i]))
    return np.stack(rgbs), np.stack(disps)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, img):
    """Write an 8-bit PNG: img uint8 [H, W] (grayscale) or [H, W, 3] (RGB),
    every row with filter 0 (none), one zlib stream."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 [H, W] or [H, W, 3], got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)
    color = 0 if img.ndim == 2 else 2
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
                           + _png_chunk(b"IEND", b""))


def write_video(path, frames, fps: int = 30):
    """Write an mp4 from [M, H, W, 3] float or grayscale/uint8 frames:
    imageio with ffmpeg where present, else OpenCV's mp4v encoder, else
    per-frame PNGs in `<path>.frames/` (the JAX package's chain)."""
    frames = [np.asarray(f) for f in frames]
    frames = [to8b(f) if f.dtype != np.uint8 else f for f in frames]
    frames = [np.repeat(f[..., None], 3, axis=-1) if f.ndim == 2 else f
              for f in frames]
    try:
        import imageio.v2 as imageio
        imageio.mimwrite(str(path), frames, fps=fps, quality=8)
        return
    except (ValueError, ImportError, OSError):
        pass
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
        if vw.isOpened():
            for f in frames:
                vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            vw.release()
            return
    out = Path(str(path) + ".frames")
    out.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        write_png(out / f"{i:04d}.png", f)


def normalize_disps_for_video(disps):
    """NaN-zeroed disparity normalized by its 95th percentile
    (`run_nerf.py:1214-1218`)."""
    d = np.nan_to_num(np.asarray(disps), nan=0.0)
    denom = np.percentile(d, 95)
    return d / (denom if denom > 0 else 1.0)
