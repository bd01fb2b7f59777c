"""Full-frame and path rendering (port of `spinnerf_tpu/eval/render.py`, the
reference's `render_path`, `DS_NeRF/run_nerf.py:168-307`).

A frame's pixels are one ray batch rendered in chunks by
`core.rendering.render_rays_chunked` under `torch.no_grad()`. The per-frame
artifact tree (rgb/depth/disp/weight/z/alpha/pose/intrinsics) reproduces the
disk contract of the reference and the JAX package. The machine with the
card has neither cv2 nor imageio, so PNGs are written by `write_png` and
read by `read_png` (stdlib zlib/struct and numpy); `write_video` keeps the
JAX package's file-format chain (imageio, then cv2, then per-frame PNGs),
importing both lazily.
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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels; and channels -> the color type written
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}


def write_png(path, img):
    """Write a PNG: img uint8 or uint16 [H, W] (grayscale) or [H, W, C] with
    C = 1 (grayscale), 2 (grayscale + alpha), 3 (RGB) or 4 (RGBA); every row
    with filter 0 (none), one zlib stream."""
    img = np.ascontiguousarray(img)
    if img.dtype not in (np.uint8, np.uint16) or not (
            img.ndim == 2 or (img.ndim == 3 and 1 <= img.shape[2] <= 4)):
        raise ValueError(f"write_png takes uint8 or uint16 [H, W] or "
                         f"[H, W, 1-4], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    data = img.astype(">u2") if img.dtype == np.uint16 else img
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           data.reshape(h, -1).view(np.uint8)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * img.itemsize,
                       _PNG_COLOR[channels], 0, 0, 0)
    Path(path).write_bytes(_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
                           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
                           + _png_chunk(b"IEND", b""))


def _png_unfilter(data: np.ndarray, filters: np.ndarray, bpp: int):
    """Undo the PNG row filters: data [H, row bytes] uint8 as stored after
    each row's filter byte, filters [H]. Rows with filter 0 (none), 1 (sub)
    and 2 (up) are undone a row at a time; average (3) and Paeth (4) depend
    on the reconstructed byte to the left, so those rows are undone along
    anti-diagonals of pixels (all pixels with the same row + column depend
    only on earlier diagonals), for every row at once."""
    h, n = data.shape
    px = data.reshape(h, n // bpp, bpp).astype(np.int16)
    if filters.max(initial=0) <= 2:
        out = np.zeros((h + 1, n // bpp, bpp), np.int16)
        for r in range(h):
            row = px[r]
            if filters[r] == 1:
                row = np.cumsum(row, axis=0)
            elif filters[r] == 2:
                row = row + out[r]
            out[r + 1] = row & 255
        return out[1:].reshape(h, n).astype(np.uint8)
    w = n // bpp
    # out[r + 1, c + 1] is pixel (r, c); row 0 and column 0 are the zeros
    # the filters read outside the image
    out = np.zeros((h + 1, w + 1, bpp), np.int16)
    kind = filters.astype(np.int64)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        c = d - r
        x = px[r, c]
        a, b, ul = out[r + 1, c], out[r, c + 1], out[r, c]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, ul))
        pred = np.choose(kind[r][:, None], [np.zeros_like(a), a, b,
                                            (a + b) >> 1, paeth])
        out[r + 1, c + 1] = (x + pred) & 255
    return out[1:, 1:].reshape(h, n).astype(np.uint8)


def read_png(path) -> np.ndarray:
    """Decode a PNG as `cv2.imread(path, cv2.IMREAD_UNCHANGED)` does, with
    the channels in RGB(A) order instead of BGR(A): [H, W] for grayscale,
    [H, W, 3] for RGB and palette images, [H, W, 4] for RGBA and grayscale +
    alpha (the gray value repeated); uint16 for 16-bit images, else uint8
    (grayscale below 8 bits scaled to 0..255). Transparency chunks (tRNS)
    are ignored, where cv2 adds an alpha channel. All five row filters;
    interlaced files raise. `path` may also be the file's bytes."""
    data = path if isinstance(path, bytes) else Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, plte, hdr = 8, [], None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, color, _, _, interlace = hdr
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if color not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{path}: unsupported PNG color type {color} / "
                         f"bit depth {depth}")
    channels = _PNG_CHANNELS[color]
    row_bytes = (w * channels * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (row_bytes + 1)].reshape(h, row_bytes + 1)
    rows = _png_unfilter(raw[:, 1:], raw[:, 0],
                         max(1, channels * depth // 8))
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w, channels)
    elif depth == 8:
        img = rows.reshape(h, w, channels)
    else:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        vals = (bits * (1 << np.arange(depth - 1, -1, -1))).sum(-1)
        img = vals[:, :w].astype(np.uint8)[..., None]
        if color == 0:
            img = img * np.uint8(255 // ((1 << depth) - 1))
    if color == 3:
        return plte[img[..., 0]]
    if color == 4:
        return np.concatenate([np.repeat(img[..., :1], 3, -1), img[..., 1:]],
                              axis=-1)
    return img[..., 0] if channels == 1 else img


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
