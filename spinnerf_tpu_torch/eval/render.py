"""Full-frame and path rendering (port of `spinnerf_tpu/eval/render.py`, the
reference's `render_path`, `DS_NeRF/run_nerf.py:168-307`).

A frame's pixels are one ray batch rendered in chunks by
`core.rendering.render_rays_chunked` under `torch.no_grad()`. The per-frame
artifact tree (rgb/depth/disp/weight/z/alpha/pose/intrinsics) reproduces the
disk contract of the reference and the JAX package. The machine with the
card has neither cv2 nor imageio, so PNGs are written by `write_png` and
read by `read_png` (stdlib zlib/struct and numpy); `write_video` keeps the
JAX package's file-format chain (imageio, then cv2, then per-frame PNGs),
importing both lazily. With `mesh=` (`parallel.Mesh`) each chunk of a
frame is split across the ranks and gathered, every rank gets every frame,
and only rank 0 writes files.
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
from spinnerf_tpu_torch.data.jpeg import exif_orientation
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
                        maps=None, device=None, mesh=None):
    """A `(c2w, generator=None) -> per-pixel maps` renderer: numpy arrays
    [H, W, ...] of the fine pass (default LIGHT_MAPS, plus "prob" with
    cfg.semantic). Request HEAVY_MAPS entries only when they are read.
    Renders on `device` (the card unless the caller asks for the CPU), with
    `mesh` pixel-sharded across its ranks (every rank must call it)."""
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
                generator=generator, mesh=mesh)
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
                              device=None, mesh=None):
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
                               device=device, mesh=mesh)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def render_path(poses, hwf, field_fn, cfg: RenderConfig, *, near, far,
                ndc: bool = False, chunk: int = 8192, fine_field_fn=None,
                render_factor: int = 0, save_dir=None, gt_images=None,
                save_alpha: bool = False, frame_fn=None, device=None,
                generator=None, mesh=None):
    """Render a pose list; with `save_dir`, dump the reference's per-frame
    artifact tree (rgb/, depth/, disp/, weight/, z/, pose/, images/ with
    `gt_images`, alpha/ with `save_alpha`, intrinsics.txt). `frame_fn`
    (a renderer taking `maps_for_save`'s maps) replaces the one built from
    `field_fn`. With `mesh` the frames render pixel-sharded (a `frame_fn`
    must be built with the same mesh) and only rank 0 writes. Returns
    (rgbs [M, H, W, 3], disps [M, H, W]) as numpy, on every rank."""
    h, w, focal = _frame_hwf(hwf, render_factor)
    writes = mesh is None or mesh.rank == 0
    if save_dir is not None and writes:
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
        chunk=chunk, fine_field_fn=fine_field_fn, maps=needed, device=device,
        mesh=mesh)
    rgbs, disps = [], []
    for i, c2w in enumerate(poses):
        maps = renderer(c2w, generator)
        rgbs.append(maps["rgb"])
        disps.append(maps["disp"])
        if save_dir is None or not writes:
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


# Adam7's passes: first column, first row, column step, row step
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}


def _png_chunks(data: bytes, name):
    """IHDR's fields, PLTE, tRNS, the IDAT payload and the first eXIf body
    of a PNG, refusing (ValueError) every stream cv2 gives None for: a cut
    chunk or a missing IEND, a chunk type that is not four letters or has
    its reserved bit set, an unknown critical chunk, a CRC mismatch in a
    critical chunk (libpng only warns for IEND's and drops an ancillary
    chunk whose CRC is wrong), IDAT chunks that are not consecutive."""
    def bad(why):
        return ValueError(f"{name}: damaged PNG ({why}; cv2 gives None)")
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, plte, trns, hdr, exif = 8, [], None, None, None, None
    idat_done = False
    while True:
        if pos + 12 > len(data):
            raise bad(f"the data ends at byte {len(data)} before IEND")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if pos + 12 + length > len(data):
            raise bad(f"chunk {tag!r} at byte {pos} is cut")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        pos += 12 + length
        if not (tag.isalpha() and tag.isascii()) or tag[2:3].islower():
            raise bad(f"invalid chunk type {tag!r}")
        crc_ok = zlib.crc32(tag + body) & 0xFFFFFFFF == crc
        critical = tag[:1].isupper()
        if tag == b"IEND":
            break
        if not crc_ok:
            if critical:
                raise bad(f"{tag.decode()} CRC error")
            continue
        if tag == b"IDAT":
            if idat_done:
                raise bad("IDAT chunks are not consecutive")
            idat.append(body)
            continue
        if idat:
            idat_done = True
        if tag == b"IHDR":
            if length != 13:
                raise bad("IHDR of the wrong size")
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body[:len(body) // 3 * 3],
                                 np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
        elif tag == b"eXIf":
            if exif is None:
                exif = body
        elif critical:
            raise bad(f"unknown critical chunk {tag.decode()}")
    if hdr is None or not idat:
        raise bad("no IHDR or no IDAT")
    w, h, depth, color, comp, filt, interlace = hdr
    if (color not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[color]
            or comp or filt or interlace > 1 or w == 0 or h == 0):
        raise bad(f"invalid IHDR (color type {color}, bit depth {depth}, "
                  f"interlace {interlace})")
    if color == 3 and plte is None:
        raise bad("a palette image without PLTE")
    return hdr, plte, trns, b"".join(idat), exif


def _png_samples(raw, w, h, depth, channels, name):
    """[H, W, channels] samples (uint8, uint16 for 16 bits; depths below 8
    unscaled) of one non-interlaced image or Adam7 pass, from the front of
    `raw`; returns them and the bytes used."""
    row_bytes = (w * channels * depth + 7) // 8
    n = h * (row_bytes + 1)
    if len(raw) < n:
        raise ValueError(f"{name}: damaged PNG (the image data ends early; "
                         f"cv2 gives None)")
    rows = np.frombuffer(raw[:n], np.uint8).reshape(h, row_bytes + 1)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError(f"{name}: damaged PNG (invalid row filter; cv2 "
                         f"gives None)")
    rows = _png_unfilter(rows[:, 1:], rows[:, 0],
                         max(1, channels * depth // 8))
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, channels), n
    if depth == 8:
        return rows.reshape(h, w, channels), n
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    vals = (bits * (1 << np.arange(depth - 1, -1, -1))).sum(-1)
    return vals[:, :w].astype(np.uint8)[..., None], n


def _png_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's png_do_rgb_to_gray with cv2's weights (0.299, 0.587: red
    9797, green 19234, blue 3737 in 15 bits): 8 bits truncated; 16 bits
    rounded, then their high byte (png_set_strip_16)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    y = r * 9797 + g * 19234 + b * 3737
    if rgb.dtype == np.uint16:
        return (((y + 16384) >> 15) >> 8).astype(np.uint8)
    return (y >> 15).astype(np.uint8)


def read_png(path, *, with_orientation: bool = False,
             mode: str = "unchanged", name=None):
    """Decode a PNG as cv2 5.0 does, with the channels in RGB(A) order
    instead of BGR(A). `mode` "unchanged" is `cv2.IMREAD_UNCHANGED`: [H, W]
    for grayscale (a tRNS chunk adds no alpha there), [H, W, 3] for RGB and
    palette images, [H, W, 4] for RGBA, grayscale + alpha (the gray value
    repeated), and RGB or palette images with a tRNS chunk (alpha 0 where
    the colour is the tRNS one, the palette's alphas); uint16 for 16-bit
    images, else uint8 (grayscale below 8 bits scaled to 0..255). "color"
    is `IMREAD_COLOR` (uint8 RGB: 16 bits to their high byte, alpha
    dropped) and "gray" `IMREAD_GRAYSCALE` (uint8: libpng's rgb_to_gray of
    colour and palette images, `_png_gray`). Both interlace methods (Adam7:
    seven passes, each with its own row filters) at every bit depth. A
    stream cv2 gives None for raises ValueError (`_png_chunks`; and image
    data that is short, or whose zlib stream is cut, damaged or fails its
    Adler-32). `path` may also be the file's bytes, `name` what the errors
    call it then.

    with_orientation: also return the EXIF orientation (1-8) of the first
    `eXIf` chunk (`data.jpeg.exif_orientation`; 1 without one), which cv2's
    colour and grayscale reads apply and its unchanged read does not."""
    data = path if isinstance(path, bytes) else Path(path).read_bytes()
    if name is None:
        name = "PNG data" if isinstance(path, bytes) else path
    hdr, plte, trns, idat, exif = _png_chunks(data, name)
    w, h, depth, color, _, _, interlace = hdr
    try:
        z = zlib.decompressobj()
        raw = z.decompress(idat)
    except zlib.error as e:
        raise ValueError(f"{name}: damaged PNG (zlib: {e}; cv2 gives "
                         f"None)") from None
    if not z.eof:
        raise ValueError(f"{name}: damaged PNG (the zlib stream is cut; "
                         f"cv2 gives None)")
    channels = _PNG_CHANNELS[color]
    if not interlace:
        img, _ = _png_samples(raw, w, h, depth, channels, name)
    else:
        img = np.zeros((h, w, channels),
                       np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            sub, n = _png_samples(raw[pos:], pw, ph, depth, channels, name)
            img[y0::dy, x0::dx] = sub
            pos += n
    alpha = None
    if color == 3:
        idx = img[..., 0]
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte
        if trns is not None:
            table = np.full(256, 255, np.uint8)
            table[:len(trns)] = np.frombuffer(trns[:256], np.uint8)
            alpha = table[idx]
        img = pal[idx]
    elif color == 0:
        img = img[..., 0]
        if depth < 8:
            img = img * np.uint8(255 // ((1 << depth) - 1))
    elif color == 4:
        img = np.concatenate([np.repeat(img[..., :1], 3, -1), img[..., 1:]],
                             axis=-1)
    elif color == 2 and trns is not None and len(trns) >= 6:
        key = np.array(struct.unpack(">HHH", trns[:6]), np.int64)
        if depth == 8:
            key = key & 0xFF
        top = 255 if depth == 8 else 65535
        alpha = np.where((img.astype(np.int64) == key).all(-1), 0,
                         top).astype(img.dtype)
    if alpha is not None:
        img = np.concatenate([img, alpha[..., None]], axis=-1)
    if mode == "color":
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        img = (np.repeat(img[..., None], 3, -1) if img.ndim == 2
               else img[..., :3])
    elif mode == "gray":
        if img.ndim == 3 and color in (2, 3, 6):
            img = _png_gray(img)
        else:
            img = img if img.ndim == 2 else img[..., 0]
            if img.dtype == np.uint16:
                img = (img >> 8).astype(np.uint8)
    elif mode != "unchanged":
        raise ValueError(f"mode must be unchanged, color or gray, got "
                         f"{mode!r}")
    if with_orientation:
        return img, 1 if exif is None else exif_orientation(exif)
    return img


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
