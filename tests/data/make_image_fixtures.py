"""Write the image-format fixtures of `tests/test_torch_image_formats.py`
and `chip_smoke.py`'s phase 21 (f) with cv2 5.0 and PIL, and record cv2's
reads of them (needs cv2, PIL and the JAX package; never run on the card):

    python tests/data/make_image_fixtures.py
    python tests/data/make_image_fixtures.py --jpeg2000   # only JPEG 2000

tests/data/images/
  <name>.<ext>     small files (23 x 37 unless named otherwise), one per
                   variant the port decodes: PNG at every colour type and
                   bit depth, tRNS, Adam7, eXIf; BMP at 1-32 bits, RLE4 /
                   RLE8, bit fields, OS/2 and V4 headers, both row orders;
                   PBM / PGM / PPM, ASCII and binary, maxval up to 65535;
                   WebP lossy (cv2's encoder, PIL's with alpha, and
                   libvpx's with the simple loop filter and 4 / 8 token
                   partitions, which libwebp does not write), lossless
                   (libwebp's, and `image_writers.vp8l` with each transform
                   and palettes of 2-200 colours), ALPH in each filter, and
                   a 504 x 672 synthetic view lossy and lossless (phase
                   21 (f) times the decoder on them); TIFF
                   strips and tiles, both byte orders, none / LZW / Deflate
                   / PackBits, predictor 2, planar, 8 / 16-bit and float
                   samples, MinIsBlack / MinIsWhite / RGB / palette,
                   Orientation; the four mis-suffixed files of ROADMAP C7
                   (`misnamed_*`); damaged PNGs (C8); animated WebPs (cv2
                   reads the first frame); PAM at each TUPLTYPE, PFM,
                   Sun raster at each depth and type, Radiance HDR
                   (RLE, flat, the headers and orientations cv2
                   refuses), GIF (LZW code sizes, a deferred clear,
                   interlace, local tables, transparency, animation,
                   offsets); ROADMAP F1's JPEGs (arithmetic coding with
                   its Huffman twin, lossless SOF3, and the 12-bit, 2-
                   component, SOF11 and SOF5 files cv2 gives None for);
                   ROADMAP F2's TIFFs (`tiff_more_files`: JPEG strips,
                   YCbCr, CMYK, 1- to 4-bit, FillOrder 2, predictor 3,
                   old-style LZW, BigTIFF, CCITT, CIELab; LZMA, Zstd,
                   WebP and old-style JPEG strips cv2 gives None for; a
                   LogLuv file the port refuses) and AVIF, which it
                   leaves to cv2
  expected.json    "files": for every file, `port` ("equal": the port must
                   give cv2's pixels; "refused": it raises ValueError;
                   "cv2": it reads through cv2, RuntimeError without) and
                   for each source ("file": cv2.imread, "buffer":
                   cv2.imdecode) and read ("unchanged", "color", "gray")
                   cv2's shape, dtype and the SHA-256 of its pixels in
                   RGB(A) order, or null where cv2 gives None (an
                   UNWRITTEN read: shape, dtype, "unwritten": true and
                   no hash, as cv2 returns memory it never wrote there);
                   "scene": a 3-view LLFF scene (a PNG named .jpg, a
                   lossless WebP, a TIFF) and the SHA-256 of JAX's
                   `load_scene(factor=1)` image stack on it;
                   "scene_more": the same for `scene_more/`, 7 views of
                   MORE_SCENE's formats under other suffixes;
                   "shard_more": the members (fixture, name in the tar)
                   of a shard of the new formats and the SHA-256 of each
                   image JAX's `iter_shard_images` streams from it;
                   "scene_tiff" / "shard_tiff": the same for 9 views of
                   TIFF_SCENE's kinds and a shard of TIFF_SHARD's files

Hand-written variants come from `image_writers.py` (neither cv2 nor PIL
writes them); every image is made from a fixed seed.
"""
from __future__ import annotations

import hashlib
import io
import json
import shutil
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
OUT = HERE / "images"
sys.path[:0] = [str(HERE), str(HERE.parents[1])]
import image_writers as iw  # noqa: E402

H, W = 23, 37


def sha256(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def rgb_order(img):
    if img.ndim == 3 and img.shape[2] >= 3:
        return img[..., [2, 1, 0] + list(range(3, img.shape[2]))]
    return img


def cv2_reads(path: Path) -> dict:
    """cv2's three reads of a file under both sources, as recorded (an
    UNWRITTEN read by its shape and dtype only)."""
    data = np.frombuffer(path.read_bytes(), np.uint8)
    out = {}
    for source in ("file", "buffer"):
        out[source] = {}
        for read, flag in (("unchanged", cv2.IMREAD_UNCHANGED),
                           ("color", cv2.IMREAD_COLOR),
                           ("gray", cv2.IMREAD_GRAYSCALE)):
            img = (cv2.imread(str(path), flag) if source == "file"
                   else cv2.imdecode(data, flag))
            out[source][read] = None if img is None else {
                "shape": list(img.shape), "dtype": str(img.dtype),
                "sha256": sha256(rgb_order(img))}
            if img is not None and (path.name, read) in UNWRITTEN:
                out[source][read].update(sha256=None, unwritten=True)
    return out


def picture(h=H, w=W, seed=0, channels=3):
    """Smooth gradients, edges and a noisy patch: every encoder's paths."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 255 // max(w - 1, 1)), (y * 255 // max(h - 1, 1)),
                    ((x + 2 * y) * 5) % 256, (x * y * 3) % 256], -1)[..., :channels]
    img[h // 4:h // 2, w // 5:w // 2] = rs.randint(0, 256,
                                                   (h // 2 - h // 4, w // 2 - w // 5,
                                                    channels))
    img[(x - w * 3 // 4) ** 2 + (y - h // 2) ** 2 < (h // 4) ** 2] = 200
    return img.astype(np.uint8)


def wide(img, rs):
    """16-bit samples whose high byte is `img`'s, the low byte seeded."""
    return ((img.astype(np.uint16) << 8)
            | rs.randint(0, 256, img.shape).astype(np.uint16))


def cv2_bytes(ext, img, params=()):
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok, ext
    return bytes(buf)


def libvpx_keyframe(rgb, *, profile=0, partitions=0, q=None):
    """A VP8 key frame of uint8 RGB [H, W, 3] (even sides) from the libvpx
    that opencv-python bundles, driven through ctypes: profile 1 signals
    the simple loop filter, `partitions` 0-3 gives 1-8 token partitions, `q`
    pins the quantizer (a high one gives a high filter level). libwebp's
    encoder (cv2's, PIL's) writes neither."""
    import ctypes
    import glob
    lib = ctypes.CDLL(glob.glob(str(Path(cv2.__file__).parents[1]
                                    / "opencv_python.libs" / "libvpx-*"))[0])
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.vpx_codec_vp8_cx.restype = vp
    lib.vpx_img_wrap.restype = vp
    lib.vpx_img_wrap.argtypes = [vp, ctypes.c_int, ctypes.c_uint,
                                 ctypes.c_uint, ctypes.c_uint, vp]
    lib.vpx_codec_get_cx_data.restype = vp
    lib.vpx_codec_get_cx_data.argtypes = [vp, vp]
    lib.vpx_codec_encode.argtypes = [vp, vp, i64, ctypes.c_ulong,
                                     ctypes.c_long, ctypes.c_ulong]
    lib.vpx_codec_enc_config_default.argtypes = [vp, vp, ctypes.c_uint]
    lib.vpx_codec_enc_init_ver.argtypes = [vp, vp, vp, ctypes.c_long,
                                           ctypes.c_int]
    lib.vpx_codec_control_.argtypes = [vp, ctypes.c_int, ctypes.c_int]
    h, w, _ = rgb.shape
    yuv = cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420)   # Y, U, V planes
    buf = np.ascontiguousarray(yuv).reshape(-1)
    cfg = ctypes.create_string_buffer(4096)
    iface = lib.vpx_codec_vp8_cx()
    assert lib.vpx_codec_enc_config_default(iface, cfg, 0) == 0
    struct.pack_into("<IIIII", cfg, 0, 0, 1, profile, w, h)  # g_usage..g_h
    if q is not None:
        struct.pack_into("<II", cfg, 116, q, q)   # rc_min / max_quantizer
    ctx = ctypes.create_string_buffer(1024)
    # the encoder ABI version differs between libvpx releases: the first
    # one init accepts
    assert any(lib.vpx_codec_enc_init_ver(ctx, iface, cfg, 0, abi) == 0
               for abi in range(1, 200))
    assert lib.vpx_codec_control_(ctx, 18, partitions) == 0  # TOKEN_PARTS
    img = lib.vpx_img_wrap(None, 0x102, w, h, 1, buf.ctypes.data)   # I420
    assert lib.vpx_codec_encode(ctx, img, 0, 1, 1, 0) == 0   # a key frame
    it, out = ctypes.c_void_p(0), b""
    while True:
        pkt = lib.vpx_codec_get_cx_data(ctx, ctypes.byref(it))
        if not pkt:
            break
        if ctypes.c_int.from_address(pkt).value == 0:   # a frame packet
            out += ctypes.string_at(ctypes.c_void_p.from_address(pkt + 8)
                                    .value,
                                    ctypes.c_size_t.from_address(pkt + 16)
                                    .value)
    lib.vpx_codec_destroy(ctx)
    return out


def pil_bytes(img, fmt, mode=None, **kw):
    bio = io.BytesIO()
    Image.fromarray(img, mode).save(bio, fmt, **kw)
    return bio.getvalue()


def pil_bilevel(bits, compression):
    """A PIL TIFF of 0 / 1 samples in mode "1" (CCITT needs it)."""
    bio = io.BytesIO()
    Image.fromarray(bits.astype(np.uint8) * 255).convert("1").save(
        bio, "TIFF", compression=compression)
    return bio.getvalue()


def exif_block(orientation):
    e = Image.Exif()
    e[0x0112] = orientation
    return e.tobytes()


def png_files(rs):
    rgb, rgba = picture(), picture(channels=4)
    gray = picture(channels=1)[..., 0]
    rgb16 = wide(rgb, rs)
    f = {}
    for depth in (1, 2, 4, 8, 16):
        g = (gray.astype(np.uint16) * 257 >> (16 - depth)) if depth < 16 \
            else gray.astype(np.uint16) * 251
        f[f"png_gray{depth}.png"] = iw.png(g, 0, depth, filt="mix",
                                           seed=depth)
        f[f"png_gray{depth}_adam7.png"] = iw.png(g, 0, depth, interlace=1,
                                                 filt="mix", seed=depth)
    for depth in (1, 2, 4, 8):
        pal = rs.randint(0, 256, (1 << depth, 3))
        idx = rs.randint(0, 1 << depth, (H, W))
        f[f"png_palette{depth}.png"] = iw.png(idx, 3, depth, palette=pal)
        f[f"png_palette{depth}_adam7.png"] = iw.png(idx, 3, depth,
                                                    palette=pal, interlace=1)
        trns = bytes(rs.randint(0, 256, max(1, (1 << depth) // 2)).astype(
            np.uint8))
        f[f"png_palette{depth}_trns.png"] = iw.png(idx, 3, depth,
                                                   palette=pal, trns=trns)
    for depth, img in ((8, rgb), (16, rgb16)):
        f[f"png_rgb{depth}.png"] = iw.png(img, 2, depth, filt="mix")
        f[f"png_rgb{depth}_adam7.png"] = iw.png(img, 2, depth, interlace=1,
                                                filt="mix")
        key = img[H // 2, W // 5]   # a colour that occurs
        f[f"png_rgb{depth}_trns.png"] = iw.png(
            img, 2, depth, trns=struct.pack(">HHH", *[int(v) for v in key]))
        a = (rgba[..., 3].astype(np.uint16) * (257 if depth == 16 else 1))
        f[f"png_rgba{depth}.png"] = iw.png(np.concatenate([img, a[..., None]],
                                                          -1), 6, depth)
        f[f"png_rgba{depth}_adam7.png"] = iw.png(
            np.concatenate([img, a[..., None]], -1), 6, depth, interlace=1,
            filt=4)
        ga = np.stack([img[..., 0], a], -1)
        f[f"png_ga{depth}.png"] = iw.png(ga, 4, depth, filt=3)
        f[f"png_ga{depth}_adam7.png"] = iw.png(ga, 4, depth, interlace=1)
    f["png_gray8_trns.png"] = iw.png(gray, 0, 8,
                                     trns=struct.pack(">H", int(gray[0, 0])))
    f["png_exif6.png"] = iw.png(rgb, 2, 8, chunks=[(b"eXIf",
                                                     exif_block(6))])
    f["png_cv2_rgb16.png"] = cv2_bytes(".png", rgb16)
    # damaged (C8): cut in half, 20 bytes zeroed, an IDAT byte flipped;
    # and an ancillary chunk with a bad CRC, which cv2 only warns about
    good = cv2_bytes(".png", rgb[..., ::-1])
    f["damaged_cut.png"] = good[:len(good) // 2]
    zeroed = bytearray(good)
    zeroed[len(good) // 2:len(good) // 2 + 20] = b"\0" * 20
    f["damaged_zeroed.png"] = bytes(zeroed)
    text = iw.png(rgb, 2, 8, chunks=[(b"tEXt", b"note\0written by hand")])
    bad_crc = bytearray(text)
    bad_crc[33 + 8 + 3] ^= 0x20     # inside tEXt's body
    f["ancillary_crc.png"] = bytes(bad_crc)
    return f


def bmp_files(rs):
    rgb = picture()
    bgr = rgb[..., ::-1]
    f = {}
    gray_pal = np.repeat(np.linspace(0, 255, 256).astype(np.uint8)[:, None],
                         3, 1)
    for bpp in (1, 4, 8):
        n = 1 << bpp
        pal = rs.randint(0, 256, (n, 3))
        idx = rs.randint(0, n, (H, W))
        idx[H // 3:, :W // 2] = idx[H // 3, 0]   # runs for the RLE files
        f[f"bmp{bpp}.bmp"] = iw.bmp(idx, bpp, palette=pal)
        f[f"bmp{bpp}_gray.bmp"] = iw.bmp(idx, bpp,
                                         palette=gray_pal[::256 // n][:n])
        if bpp > 1:
            f[f"bmp{bpp}_rle.bmp"] = iw.bmp(idx, bpp, palette=pal, rle=True)
            f[f"bmp{bpp}_core.bmp"] = iw.bmp(idx, bpp, palette=pal,
                                             core=True)
    p555 = ((bgr[..., 2].astype(np.uint16) >> 3) << 10
            | (bgr[..., 1].astype(np.uint16) >> 3) << 5
            | (bgr[..., 0].astype(np.uint16) >> 3))
    p565 = ((bgr[..., 2].astype(np.uint16) >> 3) << 11
            | (bgr[..., 1].astype(np.uint16) >> 2) << 5
            | (bgr[..., 0].astype(np.uint16) >> 3))
    f["bmp16_555.bmp"] = iw.bmp(p555, 16)
    f["bmp16_555_fields.bmp"] = iw.bmp(p555, 16,
                                       bitfields=(0x7C00, 0x3E0, 0x1F))
    f["bmp16_565_fields.bmp"] = iw.bmp(p565, 16,
                                       bitfields=(0xF800, 0x7E0, 0x1F))
    f["bmp24.bmp"] = iw.bmp(bgr, 24)
    f["bmp24_topdown.bmp"] = iw.bmp(bgr, 24, top_down=True)
    f["bmp24_core.bmp"] = iw.bmp(bgr, 24, core=True)
    bgra = np.concatenate([bgr, picture(channels=4)[..., 3:]], -1)
    f["bmp32.bmp"] = iw.bmp(bgra, 32)
    f["bmp32_fields.bmp"] = iw.bmp(bgra, 32, bitfields=(0xFF0000, 0xFF00,
                                                        0xFF))
    f["bmp32_v4.bmp"] = iw.bmp(bgra, 32, v4=True,
                               bitfields=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    f["bmp_cv2.bmp"] = cv2_bytes(".bmp", bgr)
    return f


def pxm_files(rs):
    rgb = picture()
    gray = rgb[..., 1]
    bits = (gray > 127).astype(np.uint8)
    g16 = wide(gray, rs)
    rgb16 = wide(rgb, rs)
    return {
        "pbm_ascii.pbm": iw.pxm(bits, 1, comments=True),
        "pbm_binary.pbm": iw.pxm(bits, 4),
        "pgm_ascii15.pgm": iw.pxm(gray >> 4, 2, maxval=15),
        "pgm_ascii.pgm": iw.pxm(gray, 2, comments=True),
        "pgm_binary.pgm": iw.pxm(gray, 5),
        "pgm_binary100.pgm": iw.pxm(gray * 100 // 255, 5, maxval=100),
        "pgm_binary16.pgm": iw.pxm(g16, 5, maxval=65535),
        "pgm_ascii16.pgm": iw.pxm(g16 >> 4, 2, maxval=4095),
        "ppm_ascii.ppm": iw.pxm(rgb, 3),
        "ppm_binary.ppm": iw.pxm(rgb, 6),
        "ppm_binary16.ppm": iw.pxm(rgb16, 6, maxval=65535),
        "ppm_cv2.ppm": cv2_bytes(".ppm", rgb[..., ::-1]),
    }


def webp_files(rs):
    rgb, rgba = picture(), picture(channels=4)
    bgr = rgb[..., ::-1].copy()
    f = {}
    for q in (10, 50, 90):
        f[f"webp_lossy_q{q}.webp"] = cv2_bytes(".webp", bgr,
                                               [cv2.IMWRITE_WEBP_QUALITY, q])
    odd = picture(17, 33, seed=1)
    f["webp_lossy_17x33.webp"] = cv2_bytes(".webp", odd[..., ::-1].copy())
    f["webp_lossy_big.webp"] = cv2_bytes(".webp", picture(96, 128, seed=2)[
        ..., ::-1].copy(), [cv2.IMWRITE_WEBP_QUALITY, 70])
    f["webp_lossless_cv2.webp"] = cv2_bytes(".webp", bgr,
                                            [cv2.IMWRITE_WEBP_QUALITY, 101])
    f["webp_lossy_alpha.webp"] = pil_bytes(rgba, "WEBP", "RGBA", quality=80)
    f["webp_lossy_alpha_q50.webp"] = pil_bytes(rgba, "WEBP", "RGBA",
                                               quality=60, alpha_quality=50,
                                               method=6)
    f["webp_lossless_alpha.webp"] = pil_bytes(rgba, "WEBP", "RGBA",
                                              lossless=True, exact=True)
    f["webp_lossless_m6.webp"] = pil_bytes(picture(64, 64, seed=3), "WEBP",
                                           "RGB", lossless=True, method=6,
                                           quality=100)
    f["webp_exif6.webp"] = pil_bytes(rgb, "WEBP", "RGB", lossless=True,
                                     exif=exif_block(6))
    for tr in (("subtract_green",), ("predictor",), ("cross_color",),
               ("subtract_green", "predictor", "cross_color")):
        f[f"vp8l_{'_'.join(t[:5] for t in tr)}.webp"] = iw.webp_lossless(
            rgba if "predictor" in tr else rgb, transforms=tr, pred_bits=2,
            cc_bits=2, seed=len(tr))
    for n in (2, 3, 7, 16, 200):
        pal = rs.randint(0, 256, (n, 4)).astype(np.uint8)
        f[f"vp8l_palette{n}.webp"] = iw.webp_lossless(
            pal[rs.randint(0, n, (H, W))], transforms=("color_indexing",))
    vp8 = cv2_bytes(".webp", bgr, [cv2.IMWRITE_WEBP_QUALITY, 80])[12:]
    body = vp8[8:8 + struct.unpack("<I", vp8[4:8])[0]]
    alpha = rgba[..., 3]
    for filt in range(4):
        for method in (0, 1):
            f[f"alph_f{filt}_m{method}.webp"] = iw.vp8x(
                [(b"ALPH", iw.alph(alpha, filt=filt, method=method)),
                 (b"VP8 ", body)], W, H, alpha=True)
    big = picture(48, 64, seed=5)
    for tag, kw in (("simple_q56", dict(profile=1, q=56)),
                    ("normal_q63", dict(q=63)),
                    ("parts8_q40", dict(partitions=3, q=40)),
                    ("simple_parts4_q48", dict(profile=1, partitions=2,
                                               q=48))):
        f[f"vp8_libvpx_{tag}.webp"] = iw.riff([(b"VP8 ", libvpx_keyframe(
            big, **kw))])
    view = scene_view()[..., ::-1].copy()   # the timing files of phase 21
    f["webp_lossy_504x672.webp"] = cv2_bytes(".webp", view,
                                             [cv2.IMWRITE_WEBP_QUALITY, 75])
    f["webp_lossless_504x672.webp"] = cv2_bytes(
        ".webp", view, [cv2.IMWRITE_WEBP_QUALITY, 101])
    frames = [Image.fromarray(picture(seed=s)) for s in range(3)]
    bio = io.BytesIO()
    frames[0].save(bio, "WEBP", save_all=True, append_images=frames[1:],
                   lossless=True, duration=100)
    f["webp_animated.webp"] = bio.getvalue()
    # an animation whose first frame is smaller than the canvas, at an
    # offset, lossy with an ALPH chunk (PIL writes full first frames)
    fw, fh, fx, fy = 20, 15, 6, 4
    small = picture(fh, fw, seed=9, channels=4)
    vp8 = cv2_bytes(".webp", np.ascontiguousarray(small[..., 2::-1]),
                    [cv2.IMWRITE_WEBP_QUALITY, 70])[12:]
    sub = [(b"ALPH", iw.alph(small[..., 3], filt=2)),
           (b"VP8 ", vp8[8:8 + struct.unpack("<I", vp8[4:8])[0]])]
    le24 = [struct.pack("<I", v)[:3] for v in (fx // 2, fy // 2, fw - 1,
                                               fh - 1, 100)]
    anmf = b"".join(le24) + b"\0" + b"".join(
        t + struct.pack("<I", len(b)) + b + b"\0" * (len(b) & 1)
        for t, b in sub)
    head = struct.pack("<I", 0x12) + struct.pack("<I", W - 1)[:3] \
        + struct.pack("<I", H - 1)[:3]
    f["webp_animated_offset.webp"] = iw.riff(
        [(b"VP8X", head), (b"ANIM", b"\0" * 6), (b"ANMF", anmf)])
    return f


def tiff_files(rs):
    rgb, rgba = picture(), picture(channels=4)
    gray = rgb[..., 1]
    g16 = wide(gray, rs)
    rgb16 = wide(rgb, rs)
    f = {}
    for comp, tag in ((1, "none"), (5, "lzw"), (8, "deflate"),
                      (32773, "packbits")):
        f[f"tiff_rgb_{tag}.tif"] = iw.tiff(rgb, compression=comp,
                                           rows_per_strip=5)
    f["tiff_rgb_lzw_pred2.tif"] = iw.tiff(rgb, compression=5, predictor=2)
    f["tiff_rgb_deflate_pred2.tif"] = iw.tiff(rgb, compression=8,
                                              predictor=2, rows_per_strip=8)
    f["tiff_rgb_tiles.tif"] = iw.tiff(picture(40, 70, seed=4), tile=(32, 32),
                                      compression=8, predictor=2)
    f["tiff_rgb_tiles_lzw.tif"] = iw.tiff(picture(40, 70, seed=5),
                                          tile=(48, 32), compression=5)
    f["tiff_rgb_be.tif"] = iw.tiff(rgb, order=">", compression=5,
                                   predictor=2)
    f["tiff_rgb_planar.tif"] = iw.tiff(rgb, planar=2, compression=8,
                                       rows_per_strip=7)
    f["tiff_gray_minisblack.tif"] = iw.tiff(gray, rows_per_strip=6)
    f["tiff_gray_miniswhite.tif"] = iw.tiff(gray, photometric=0,
                                            compression=32773)
    f["tiff_gray16.tif"] = iw.tiff(g16, compression=8, predictor=2)
    f["tiff_gray16_strips.tif"] = iw.tiff(g16, rows_per_strip=4,
                                          photometric=0)
    f["tiff_gray16_be.tif"] = iw.tiff(g16, order=">", compression=5)
    f["tiff_rgb16.tif"] = iw.tiff(rgb16, compression=8, predictor=2)
    f["tiff_rgb16_tiles.tif"] = iw.tiff(rgb16, tile=(32, 32), compression=5)
    f["tiff_rgb16_planar_be.tif"] = iw.tiff(rgb16, planar=2, order=">")
    for es in (1, 2):
        f[f"tiff_rgba_es{es}.tif"] = iw.tiff(rgba, extrasamples=[es],
                                             compression=5)
    f["tiff_rgba16.tif"] = iw.tiff(rgb16[..., [0, 1, 2, 0]],
                                   extrasamples=[1], compression=8)
    f["tiff_gray_alpha.tif"] = iw.tiff(rgba[..., [1, 3]], extrasamples=[2])
    cmap = rs.randint(0, 256, (256, 3)) * 257
    f["tiff_palette.tif"] = iw.tiff(rs.randint(0, 256, (H, W)).astype(
        np.uint8), photometric=3, colormap=cmap, compression=5)
    f["tiff_float.tif"] = iw.tiff(rgb.astype(np.float32) / 255,
                                  sampleformat=3, compression=8)
    f["tiff_float_gray_pred2.tif"] = iw.tiff(gray.astype(np.float32) / 7,
                                             sampleformat=3, compression=8,
                                             predictor=2)
    for o in (3, 6, 8):
        f[f"tiff_orient{o}.tif"] = iw.tiff(rgb, orientation=o, compression=5)
    f["tiff_cv2.tif"] = cv2_bytes(".tif", rgb[..., ::-1])
    f["tiff_pil_lzw.tif"] = pil_bytes(rgb, "TIFF", compression="tiff_lzw")
    # refused: photometrics and compressions outside the subset
    f["tiff_jpeg.tif"] = pil_bytes(rgb, "TIFF", compression="jpeg")
    f["tiff_ycbcr.tif"] = iw.tiff(rgb, photometric=6)
    f["tiff_cmyk.tif"] = pil_bytes(picture(channels=4), "TIFF", "CMYK")
    return f


def tiff_more_files():
    """The TIFFs of ROADMAP F2's first item (their own RandomState, so the
    fixtures made before them keep their bytes): JPEG strips and tiles
    (YCbCr 4:2:0 with a last strip that runs past the image, 4:4:4 in
    several strips, 4:2:2 tiles, RGB, gray and CMYK coded as they are,
    tables inline), YCbCr uncompressed at 2 x 1, 4 x 2 and 4 x 4 (whose
    rows cv2 reads short) and with ReferenceBlackWhite, CMYK (LZW with
    predictor 2, planar, tiled), 1-, 2- and 4-bit samples, FillOrder 2,
    the floating-point predictor in either byte order, old-style LZW,
    BigTIFF, 16-bit planar, gray and unassociated-alpha RGBA, mirrored
    tiles, CCITT RLE / Group 3 (1D and 2D) / Group 4, CIELab at 8 and 16
    bits; and those cv2 gives None for (LZMA, Zstd, WebP strips, an
    old-style JPEG) or reads and the port does not yet (LogLuv)."""
    rs = np.random.RandomState(26)
    rgb = picture(seed=26)
    gray = rgb[..., 1]
    bw = (gray > 127).astype(np.uint8)
    ycc = iw.rgb_to_ycbcr(rgb)
    f = {
        "tiff_jpeg_ycbcr22.tif": iw.tiff(rgb, compression=7, photometric=6,
                                         subsampling=(2, 2),
                                         rows_per_strip=16, jpeg_rows=16),
        "tiff_jpeg_ycbcr444_strips.tif": iw.tiff(
            rgb, compression=7, photometric=6, rows_per_strip=8,
            extra_tags=[(530, 3, [1, 1])], jpeg_quality=95),
        "tiff_jpeg_ycbcr21_tiles.tif": iw.tiff(
            picture(40, 70, seed=27), compression=7, photometric=6,
            subsampling=(2, 1), tile=(32, 16)),
        "tiff_jpeg_rgb.tif": iw.tiff(rgb, compression=7, photometric=2,
                                     jpeg_tables=False),
        "tiff_jpeg_gray.tif": iw.tiff(gray, compression=7, rows_per_strip=16),
        "tiff_jpeg_cmyk.tif": iw.tiff(picture(seed=28, channels=4),
                                      compression=7, photometric=5),
        "tiff_jpeg_pil_cmyk.tif": pil_bytes(picture(seed=28, channels=4),
                                            "TIFF", "CMYK",
                                            compression="jpeg"),
        "tiff_ycbcr21.tif": iw.tiff(ycc, photometric=6, subsampling=(2, 1)),
        "tiff_ycbcr42_lzw.tif": iw.tiff(ycc, photometric=6,
                                        subsampling=(4, 2), compression=5,
                                        rows_per_strip=6),
        "tiff_ycbcr44_short_rows.tif": iw.tiff(ycc[:, :18], photometric=6,
                                               subsampling=(4, 4)),
        "tiff_ycbcr11_refbw.tif": iw.tiff(
            ycc, photometric=6, subsampling=(1, 1), compression=8,
            extra_tags=[(529, 5, [0.2126, 0.7152, 0.0722]),
                        (532, 5, [16.0, 235.0, 128.0, 240.0, 128.0,
                                  240.0])]),
        "tiff_ycbcr_planar.tif": iw.tiff(ycc, photometric=6, planar=2,
                                         extra_tags=[(530, 3, [1, 1])]),
        "tiff_cmyk_lzw_pred2.tif": iw.tiff(picture(seed=29, channels=4),
                                           photometric=5, compression=5,
                                           predictor=2, rows_per_strip=7),
        "tiff_cmyk_planar.tif": iw.tiff(picture(seed=29, channels=4),
                                        photometric=5, planar=2),
        "tiff_cmyk_tiles.tif": iw.tiff(picture(40, 70, seed=30, channels=4),
                                       photometric=5, compression=8,
                                       tile=(32, 32)),
        "tiff_bw1.tif": iw.tiff(bw, bits=1, compression=32773),
        "tiff_bw1_miniswhite_fill2.tif": iw.tiff(bw, bits=1, photometric=0,
                                                 compression=5, fillorder=2,
                                                 rows_per_strip=5),
        "tiff_palette1.tif": iw.tiff(bw, bits=1, photometric=3,
                                     colormap=rs.randint(0, 65536, (2, 3))),
        "tiff_palette4.tif": iw.tiff(gray >> 4, bits=4, photometric=3,
                                     colormap=rs.randint(0, 65536, (16, 3)),
                                     compression=8),
        "tiff_gray2.tif": iw.tiff(gray >> 6, bits=2),
        "tiff_gray4.tif": iw.tiff(gray >> 4, bits=4),
        "tiff_fill2_lzw_pred2.tif": iw.tiff(rgb, compression=5, predictor=2,
                                            fillorder=2, rows_per_strip=9),
        "tiff_float_pred3_le.tif": iw.tiff(rgb.astype(np.float32) / 255,
                                           sampleformat=3, predictor=3,
                                           compression=8),
        "tiff_float_pred3_be.tif": iw.tiff(gray.astype(np.float32) * 3 - 7,
                                           sampleformat=3, predictor=3,
                                           compression=5, order=">",
                                           rows_per_strip=10),
        "tiff_float_pred3_tiles.tif": iw.tiff(
            picture(40, 70, seed=31).astype(np.float32), sampleformat=3,
            predictor=3, compression=8, tile=(32, 16)),
        "tiff_lzw_old.tif": iw.tiff(rgb, compression=5, old_lzw=True),
        "tiff_lzw_old_pred2_gray16.tif": iw.tiff(
            wide(gray, rs), compression=5, old_lzw=True, predictor=2,
            rows_per_strip=8),
        "tiff_bigtiff.tif": iw.tiff(rgb, bigtiff=True, compression=5,
                                    predictor=2, rows_per_strip=8),
        "tiff_bigtiff_tiles16_be.tif": iw.tiff(
            wide(picture(40, 70, seed=32), rs), bigtiff=True, order=">",
            compression=8, tile=(32, 32)),
        "tiff_gray16_planar_alpha.tif": iw.tiff(
            wide(picture(seed=33, channels=4)[..., [1, 3]], rs), planar=2,
            extrasamples=[2], compression=8),
        "tiff_gray16_tiles.tif": iw.tiff(wide(picture(40, 70, seed=34)[
            ..., 0], rs), tile=(32, 16), compression=5, photometric=0),
        "tiff_gray_alpha_tiles.tif": iw.tiff(
            picture(40, 70, seed=35, channels=4)[..., [1, 3]],
            extrasamples=[1], tile=(32, 32), compression=8),
        "tiff_rgba16_unassoc.tif": iw.tiff(wide(picture(seed=36, channels=4),
                                                rs), extrasamples=[2],
                                           compression=5, rows_per_strip=8),
        "tiff_orient2_tiles.tif": iw.tiff(picture(40, 70, seed=37),
                                          orientation=2, tile=(32, 16),
                                          compression=5),
        "tiff_orient7_tiles16.tif": iw.tiff(wide(picture(40, 70, seed=38),
                                                 rs), orientation=7,
                                            tile=(32, 32), compression=8),
        "tiff_uncompressed_tiles.tif": iw.tiff(picture(40, 70, seed=39),
                                               tile=(32, 16)),
        "tiff_ccitt_rle.tif": pil_bilevel(bw, "tiff_ccitt"),
        "tiff_g3.tif": pil_bilevel(bw, "group3"),
        "tiff_g4.tif": pil_bilevel(bw, "group4"),
        "tiff_g3_2d_fill2.tif": iw.tiff(bw, bits=1, compression=3,
                                        fax_2d=True, photometric=0,
                                        fillorder=2, rows_per_strip=8),
        "tiff_g4_tiles.tif": iw.tiff((picture(40, 70, seed=40)[..., 2] > 100
                                      ).astype(np.uint8), bits=1,
                                     compression=4, photometric=0,
                                     tile=(32, 16)),
        "tiff_cielab.tif": iw.tiff(rs.randint(0, 256, (H, W, 3)).astype(
            np.uint8), photometric=8, compression=5),
        "tiff_cielab16_whitepoint.tif": iw.tiff(
            rs.randint(0, 65536, (H, W, 3)).astype(np.uint16), photometric=8,
            extra_tags=[(318, 5, [0.3127, 0.329])]),
        "tiff_cielab_pil.tif": pil_bytes(rgb, "TIFF", "LAB"),
        "tiff_lzma.tif": pil_bytes(rgb, "TIFF", compression="lzma"),
        "tiff_zstd.tif": pil_bytes(rgb, "TIFF", compression="zstd"),
        "tiff_webp.tif": iw.tiff_webp(picture(seed=41, channels=4)),
        "tiff_ojpeg.tif": iw.tiff_ojpeg(iw.jpeg(iw.jpeg_coefficients(
            picture(16, 16, seed=42), sampling=[(2, 2), (1, 1), (1, 1)])),
            16, 16),
        "tiff_logluv.tif": iw.tiff_logluv(
            (rs.randint(0x3000, 0x5000, (H, W)).astype(np.uint32) << 16)
            | (rs.randint(60, 120, (H, W)).astype(np.uint32) << 8)
            | rs.randint(100, 160, (H, W)).astype(np.uint32)),
    }
    return f


def pam_files(rs):
    """PAM at each TUPLTYPE (GRAYSCALE_ALPHA and RGB_ALPHA one pixel wide,
    where cv2 writes each read whole), 16-bit, MAXVAL below 255, without a
    TUPLTYPE, and DEPTH against TUPLTYPE (cv2 gives None)."""
    rgb, rgba = picture(), picture(channels=4)
    gray = rgb[..., 1]
    return {
        "pam_bw.pam": iw.pam((gray > 127).astype(np.uint8), maxval=1,
                             tupltype="BLACKANDWHITE"),
        "pam_bw_notype.pam": iw.pam(gray & 1, maxval=1),
        "pam_gray.pam": iw.pam(gray, tupltype="GRAYSCALE", comments=True),
        "pam_gray16.pam": iw.pam(wide(gray, rs), maxval=65535,
                                 tupltype="GRAYSCALE"),
        "pam_ga_w1.pam": iw.pam(rgba[:, :1, [1, 3]],
                                tupltype="GRAYSCALE_ALPHA"),
        "pam_ga16_w1.pam": iw.pam(wide(rgba[:, :1, [1, 3]], rs),
                                  maxval=65535, tupltype="GRAYSCALE_ALPHA"),
        "pam_rgb.pam": iw.pam(rgb, tupltype="RGB"),
        "pam_rgb16.pam": iw.pam(wide(rgb, rs), maxval=65535, tupltype="RGB"),
        "pam_rgb_notype.pam": iw.pam(rgb, order=("DEPTH", "MAXVAL", "HEIGHT",
                                                 "WIDTH")),
        "pam_rgb_maxval100.pam": iw.pam(rgb // 3, maxval=100,
                                        tupltype="RGB"),
        "pam_rgba_w1.pam": iw.pam(rgba[:, :1], tupltype="RGB_ALPHA"),
        "pam_depth_mismatch.pam": iw.pam(rgb, tupltype="GRAYSCALE"),
    }


def pfm_files(rs):
    """PF / Pf, both byte orders, scales other than 1, values past [0, 2]
    and NaN / inf (the colour read's unscaled saturate)."""
    rgb = picture().astype(np.float32)
    wild = rgb * np.float32(2.3) - np.float32(100)
    wild[0, :4, 0] = [np.nan, np.inf, -np.inf, 300.5]
    return {
        "pfm_rgb_le.pfm": iw.pfm(rgb / 255, scale=-1.0),
        "pfm_rgb_be.pfm": iw.pfm(rgb / 100, scale=1.0),
        "pfm_rgb_scaled.pfm": iw.pfm(wild, scale=-0.37),
        "pfm_gray_le.pfm": iw.pfm(rgb[..., 1] / 50, scale=-1.0),
        "pfm_gray_be_scaled.pfm": iw.pfm(rgb[..., 2], scale=2.5),
    }


def sunras_files(rs):
    """Sun rasters at depths 1, 8, 24 and 32, RT_OLD and RT_STANDARD, with
    an RGB colour map (colour, gray, short) or none, odd widths; and the
    RT_BYTE_ENCODED and RT_FORMAT_RGB rasters cv2 5.0 refuses."""
    rgb = picture()
    bgr = rgb[..., ::-1]
    idx = rs.randint(0, 256, (H, W))
    idx[H // 3:, :W // 2] = idx[H // 3, 0]
    pal = rs.randint(0, 256, (256, 3))
    bits = (rgb[..., 1] > 127).astype(np.uint8)
    xbgr = np.concatenate([rs.randint(0, 256, (H, W, 1)), bgr], -1)
    return {
        "ras1.ras": iw.sunras(bits, 1),
        "ras1_pal.ras": iw.sunras(bits, 1, palette=pal[:2]),
        "ras8_pal.ras": iw.sunras(idx, 8, palette=pal),
        "ras8_pal_short.ras": iw.sunras(idx % 7, 8, palette=pal[:7]),
        "ras8_graypal.ras": iw.sunras(idx, 8, palette=np.repeat(
            np.arange(256)[:, None], 3, 1)),
        "ras8_nomap.ras": iw.sunras(idx, 8),
        "ras8_old.ras": iw.sunras(idx, 8, palette=pal, rtype=0),
        "ras24.ras": iw.sunras(bgr, 24),
        "ras24_odd.ras": iw.sunras(picture(9, 13, seed=3)[..., ::-1], 24),
        "ras32.ras": iw.sunras(xbgr, 32),
        "ras8_rle.ras": iw.sunras(idx, 8, palette=pal, rtype=2),
        "ras24_rle.ras": iw.sunras(bgr, 24, rtype=2),
        "ras24_format_rgb.ras": iw.sunras(rgb, 24, rtype=3),
    }


def hdr_files(rs):
    """Radiance HDR: new-style RLE and flat scanlines, #?RADIANCE and
    #?RGBE, header lines before FORMAT, a width below 8 (flat throughout),
    old-style RLE pixels (read as they are); and what cv2 refuses: xyze,
    +Y / +X orientations, a cut file."""
    rgb = picture().astype(np.float32) / 255
    hdr = rgb ** 2 * np.float32(7)
    old = iw.rgbe(hdr)
    old[:, 5:9] = [1, 1, 1, 3]   # old-style run marks
    return {
        "hdr_rle.hdr": iw.hdr(hdr),
        "hdr_flat.hdr": iw.hdr(hdr, rle=False, magic=b"#?RGBE"),
        "hdr_lines.hdr": iw.hdr(rgb, lines=(b"# made by hand",
                                            b"EXPOSURE=2.0", b"GAMMA=1.0")),
        "hdr_narrow.hdr": iw.hdr(hdr[:, :6]),
        "hdr_oldrle.hdr": iw.hdr(None, raw=old, rle=False),
        "hdr_xyze.hdr": iw.hdr(hdr, fmt=b"32-bit_rle_xyze"),
        "hdr_plus_y.hdr": iw.hdr(hdr, size=b"+Y 23 +X 37"),
        "hdr_cut.hdr": iw.hdr(hdr)[:-40],
    }


def gif_files(rs):
    """GIF at LZW code sizes 2-8, with clear codes, a full table kept with
    a deferred clear, interlace, global and local tables, a transparent
    index, an animation, a frame smaller than the screen at an offset,
    PIL's GIF; and cut data (cv2 gives None)."""
    rgb = picture()
    f = {}
    for mcs in (2, 3, 5, 8):
        pal = rs.randint(0, 256, (1 << mcs, 3))
        idx = rs.randint(0, 1 << mcs, (H, W))
        idx[H // 2:] = idx[H // 2, 0]
        f[f"gif_mcs{mcs}.gif"] = iw.gif([dict(indices=idx, min_code_size=mcs,
                                              clear_every=50)], W, H,
                                        palette=pal)
    pal = rs.randint(0, 256, (256, 3))
    big = rs.randint(0, 256, (72, 80))
    f["gif_deferred_clear.gif"] = iw.gif([dict(indices=big, deferred=True)],
                                         80, 72, palette=pal)
    idx = rs.randint(0, 16, (H, W))
    idx[:H // 2, :W // 2] = 3
    f["gif_interlace.gif"] = iw.gif([dict(indices=idx, interlace=True)], W, H,
                                    palette=pal[:16])
    f["gif_local.gif"] = iw.gif([dict(indices=idx, palette=pal[16:32])], W,
                                H, palette=pal[:16])
    f["gif_transparent.gif"] = iw.gif([dict(indices=idx, transparent=3)], W,
                                      H, palette=pal[:16])
    f["gif_animated.gif"] = iw.gif(
        [dict(indices=idx, delay=10), dict(indices=idx[::-1], disposal=2,
                                           transparent=0)], W, H,
        palette=pal[:16], loop=0)
    f["gif_offset.gif"] = iw.gif([dict(indices=idx[:9, :14], x=11, y=7)], W,
                                 H, palette=pal[:16], background=5)
    f["gif_offset_transparent.gif"] = iw.gif(
        [dict(indices=idx[:9, :14], x=11, y=7, transparent=1)], W, H,
        palette=pal[:16], background=9)
    f["gif_pil.gif"] = pil_bytes(rgb, "GIF")
    f["gif_cut.gif"] = f["gif_interlace.gif"][:-9]
    return f


def jpeg_f1_files(rs):
    """ROADMAP F1: arithmetic-coded JPEGs (SOF9 / SOF10, DAC conditioning,
    restarts, gray) with their Huffman twins; lossless SOF3 at each
    predictor, precisions 2-8, point transform, restarts, RGB, CMYK and
    subsampled; and what cv2 gives None for: 12-bit SOF1 / SOF2, 2
    components, lossless above 8 bits or in YCbCr, SOF11, SOF5."""
    rgb = picture()
    c = iw.jpeg_coefficients(rgb, quality=80, sampling=[(2, 2), (1, 1),
                                                        (1, 1)])
    g = iw.jpeg_coefficients(rgb[..., 1], quality=60)
    f = {"jpeg_arith_seq.jpg": iw.jpeg(c, coding="arith"),
         "jpeg_arith_huffman_twin.jpg": iw.jpeg(c),
         "jpeg_arith_prog.jpg": iw.jpeg(c, coding="arith", progressive=True),
         "jpeg_arith_rst_dac.jpg": iw.jpeg(
             c, coding="arith", restart=3,
             dac={("dc", 0): (1, 4), ("ac", 0): 9}),
         "jpeg_arith_prog_rst.jpg": iw.jpeg(c, coding="arith",
                                            progressive=True, restart=5),
         "jpeg_arith_gray.jpg": iw.jpeg(g, coding="arith"),
         "jpeg_arith_gray_prog.jpg": iw.jpeg(g, coding="arith",
                                             progressive=True)}
    gray = rgb[..., 1].astype(np.int64)
    for p in range(1, 8):
        f[f"jpeg_lossless_p{p}.jpg"] = iw.jpeg_lossless(gray, predictor=p)
    f["jpeg_lossless_4bit_pt1.jpg"] = iw.jpeg_lossless(gray >> 4, precision=4,
                                                       predictor=4, pt=1)
    f["jpeg_lossless_2bit.jpg"] = iw.jpeg_lossless(gray >> 6, precision=2,
                                                   predictor=7)
    f["jpeg_lossless_rgb_rst.jpg"] = iw.jpeg_lossless(rgb, predictor=6,
                                                      restart=2 * W)
    f["jpeg_lossless_rgb_sub.jpg"] = iw.jpeg_lossless(
        rgb, predictor=5, sampling=[(2, 2), (1, 1), (1, 1)])
    f["jpeg_lossless_cmyk.jpg"] = iw.jpeg_lossless(
        picture(channels=4), predictor=2, markers=iw._marker(
            0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00"))
    f["jpeg_lossless_12bit.jpg"] = iw.jpeg_lossless(gray * 16, precision=12)
    f["jpeg_lossless_ycbcr.jpg"] = iw.jpeg_lossless(rgb, markers=iw._jfif())
    f["jpeg_lossless_sof11.jpg"] = iw.jpeg_lossless(gray, sof=0xCB)
    c12 = iw.jpeg_coefficients(rgb.astype(np.int64) * 16, precision=12)
    f["jpeg_12bit.jpg"] = iw.jpeg(c12)
    f["jpeg_12bit_prog.jpg"] = iw.jpeg(c12, progressive=True)
    f["jpeg_2comp.jpg"] = iw.jpeg(iw.jpeg_coefficients(rgb[..., :2],
                                                       rgb=True))
    f["jpeg_sof5.jpg"] = iw.jpeg(c, sof=0xC5)
    return f


def other_files():
    """Formats the port leaves to cv2 (AVIF, ROADMAP F2) or decodes."""
    rgb = picture()
    bgr = rgb[..., ::-1].copy()
    return {"left_gif.gif": cv2_bytes(".gif", bgr),
            "left_hdr.hdr": cv2_bytes(".hdr", bgr.astype(np.float32) / 255),
            "left_sunras.ras": cv2_bytes(".ras", bgr),
            "left_pfm.pfm": cv2_bytes(".pfm", bgr.astype(np.float32) / 255),
            "left_pam.pam": cv2_bytes(".pam", bgr),
            "left_avif.avif": cv2_bytes(".avif", bgr)}


def misnamed_files():
    """ROADMAP C7: content and suffix disagree."""
    rgb = picture(20, 30, seed=7)
    bgr = rgb[..., ::-1].copy()
    return {"misnamed_png.jpg": cv2_bytes(".png", bgr),
            "misnamed_jpeg.png": cv2_bytes(".jpg", bgr),
            "misnamed_webp.png": cv2_bytes(".webp", bgr,
                                           [cv2.IMWRITE_WEBP_QUALITY, 101]),
            "misnamed_bmp.jpg": cv2_bytes(".bmp", bgr)}


def jpeg2000_files():
    """JPEG 2000 (their own RandomState): PIL's and cv2's files (OpenJPEG
    2.5.4 / 2.5.3) lossless and lossy, J2K and JP2, gray, RGB, RGBA and
    gray + alpha at 8 and 16 bits, 1 and 7 resolutions, code-block and
    precinct sizes, tiles, tile and image offsets (cv2 gives None), each
    progression order, several layers, MCT off, PLT; and
    `image_writers.j2k`'s, which neither writes: each code-block style
    (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM), SOP / EPH, POC, packet
    headers in PPM and PPT, RGN, sub-sampled components, 2 and 5
    components, signed samples, 4-, 12- and 20-bit samples, a palette
    (pclr / cmap) of 8- and 16-bit entries, cdef reordering and alpha, an
    sYCC and a CMYK colr, Psot 0 and TNsot 0 tile-parts."""
    rs = np.random.RandomState(27)
    rgb = picture(seed=27)
    rgba = picture(seed=28, channels=4)
    gray = rgb[..., 1].copy()
    g16 = wide(gray, rs)
    big = picture(64, 64, seed=29)
    f = {}

    def pil(name, img, mode=None, **kw):
        f[name] = pil_bytes(img, "JPEG2000", mode, **kw)

    pil("jp2_rgb.jp2", rgb)
    pil("j2k_rgb.j2k", rgb, no_jp2=True)
    pil("jp2_rgb_97.jp2", rgb, irreversible=True, quality_layers=[12])
    pil("jp2_rgb_97_layers.jp2", rgb, irreversible=True,
        quality_layers=[40, 12, 4], progression="RLCP")
    pil("jp2_rgb_53_layers.jp2", rgb, quality_layers=[30, 8])
    pil("jp2_gray.jp2", gray)
    pil("j2k_gray_97.j2k", gray, irreversible=True, no_jp2=True)
    pil("jp2_rgba.jp2", rgba)
    pil("j2k_rgba_97.j2k", rgba, irreversible=True, no_jp2=True,
        quality_layers=[10])
    pil("jp2_gray16.jp2", g16, "I;16")
    pil("j2k_gray16_97.j2k", g16, "I;16", irreversible=True, no_jp2=True)
    pil("jp2_la.jp2", np.dstack([gray, rgba[..., 3]]), "LA")
    pil("j2k_la.j2k", np.dstack([gray, rgba[..., 3]]), "LA", no_jp2=True)
    pil("jp2_res1.jp2", rgb, num_resolutions=1)
    pil("jp2_res7_64x64.jp2", big, num_resolutions=7, irreversible=True)
    pil("jp2_cblk4x64.jp2", big, codeblock_size=(4, 64))
    pil("jp2_precincts.jp2", big, precinct_size=(32, 32),
        codeblock_size=(8, 8), quality_layers=[20, 5], num_resolutions=3)
    pil("jp2_tiles.jp2", rgb, tile_size=(16, 16))
    pil("jp2_tiles_97.jp2", rgb, tile_size=(13, 11), irreversible=True)
    pil("jp2_offset.jp2", rgb, offset=(5, 3), tile_size=(64, 64))
    pil("jp2_tile_offset.jp2", rgb, offset=(4, 6), tile_offset=(2, 3),
        tile_size=(16, 16))
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        pil(f"jp2_{prog.lower()}.jp2", big, progression=prog,
            precinct_size=(32, 32), codeblock_size=(8, 8),
            quality_layers=[30, 10, 3], tile_size=(48, 40))
    pil("jp2_mct0.jp2", rgb, mct=0)
    pil("jp2_plt.jp2", rgb, plt=True)
    pil("jp2_signed.jp2", g16, "I;16", signed=True)
    # cv2 codes 6 resolutions: 32 x 32 samples at least
    bgr40 = picture(40, 48, seed=30)[..., ::-1].copy()
    f["cv2_rgb.jp2"] = cv2_bytes(".jp2", bgr40)
    f["cv2_rgb_x100.jp2"] = cv2_bytes(
        ".jp2", bgr40, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 100])
    f["cv2_gray.jp2"] = cv2_bytes(".jp2", bgr40[..., 1].copy())
    f["cv2_rgb16.jp2"] = cv2_bytes(".jp2", wide(bgr40, rs))

    planes = [rgb[..., i] for i in range(3)]
    for name, sty in (("bypass", 1), ("reset_termall", 6),
                      ("vsc_pterm_segsym", 56), ("all_styles", 63)):
        f[f"j2k_{name}.j2k"] = iw.j2k(planes, cblksty=sty, layers=2,
                                      cblk=(3, 3), levels=3)
    f["j2k_sop_eph.j2k"] = iw.j2k(planes, sop=True, eph=True, layers=3,
                                  progression=1)
    f["j2k_poc.j2k"] = iw.j2k(planes, layers=2, pocs=[
        (0, 0, 1, 2, 3, 0), (0, 0, 2, 3, 3, 4)])
    f["j2k_ppm.j2k"] = iw.j2k(planes, ppm=2, tile=(16, 16), layers=2)
    f["j2k_ppt.j2k"] = iw.j2k(planes, ppt=2, tile=(20, 12), tile_parts=2,
                              sop=True)
    f["j2k_rgn.j2k"] = iw.j2k(planes, roi=(1, 9, (4, 3, 20, 15)))
    f["j2k_psot0_tnsot0.j2k"] = iw.j2k(planes, tile=(16, 16), tile_parts=2,
                                       psot_zero=True, tnsot=False)
    f["j2k_mct_tiles.j2k"] = iw.j2k(planes, mct=True, tile=(24, 8),
                                    precincts=[(2, 2), (3, 2), (2, 3)])
    f["j2k_subsampled.j2k"] = iw.j2k(
        [gray, gray[::2, ::2], gray[::2, ::2]],
        subsampling=[(1, 1), (2, 2), (2, 2)])
    f["j2k_2comp.j2k"] = iw.j2k([gray, rgba[..., 3]])
    f["j2k_5comp.j2k"] = iw.j2k(planes + [gray, gray])
    f["j2k_signed.j2k"] = iw.j2k([gray.astype(np.int64) - 128], signed=True)
    f["j2k_4bit.j2k"] = iw.j2k([gray >> 4], precision=4)
    f["j2k_12bit.j2k"] = iw.j2k([p.astype(np.int64) << 4 | 9
                                 for p in planes], precision=12)
    f["j2k_20bit.j2k"] = iw.j2k([gray.astype(np.int64) << 12 | 77],
                                precision=20)
    idx = (gray // 16).astype(np.int64)
    pal = rs.randint(0, 256, (16, 3))
    f["jp2_palette.jp2"] = iw.j2k([idx], jp2=True, colr=16,
                                  pclr=(pal, [8, 8, 8]),
                                  cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    f["jp2_palette16.jp2"] = iw.j2k(
        [idx], jp2=True, colr=16, pclr=(rs.randint(0, 65536, (16, 3)),
                                        [16, 16, 16]),
        cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    f["jp2_cdef_bgr.jp2"] = iw.j2k(planes[::-1], jp2=True, colr=16,
                                   cdef=[(0, 0, 3), (1, 0, 2), (2, 0, 1)])
    f["jp2_cdef_alpha.jp2"] = iw.j2k(
        [rgba[..., 3]] + [rgba[..., i] for i in range(3)], jp2=True,
        colr=16, cdef=[(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)])
    ycc = iw.rgb_to_ycbcr(rgb)
    f["jp2_sycc.jp2"] = iw.j2k([ycc[..., i] for i in range(3)], jp2=True,
                               colr=18)
    f["jp2_cmyk.jp2"] = iw.j2k(planes + [gray], jp2=True, colr=12)
    f["jp2_icc.jp2"] = iw.j2k(planes, jp2=True, icc=bytes(132))
    return f


def scene_view():
    """View 1 of `synthetic.make_scene`'s 504 x 672 world (seed 0), RGB."""
    import tempfile
    from spinnerf_tpu_torch.data import synthetic
    with tempfile.TemporaryDirectory() as tmp:
        synthetic.make_scene(Path(tmp), n_views=2, h=504, w=672, factor=1,
                             seed=0)
        path = sorted((Path(tmp) / "images").glob("*.png"))[1]
        return cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]


# scene_j2k/: the 12 views of tests/data/jpeg/scene as JPEG 2000, each
# coded another way (PIL's and cv2's encoders), named after JAX's
# IMG_EXTS; and the shard of JPEG 2000 fixtures
J2K_SCENE = (
    ("jp2", ".jpg", dict(irreversible=True, quality_layers=[40])),
    ("jp2", ".png", dict(quality_layers=[40, 120])),
    ("jp2", ".jpg", dict(irreversible=True, quality_layers=[40],
                         tile_size=(128, 160))),
    ("jp2", ".png", dict(irreversible=True, quality_layers=[40],
                         progression="RPCL", precinct_size=(64, 64))),
    ("jp2", ".jpg", dict(quality_layers=[40], progression="PCRL",
                         precinct_size=(128, 128))),
    ("jp2", ".png", dict(irreversible=True, quality_layers=[40],
                         progression="CPRL")),
    ("jp2", ".jpg", dict(irreversible=True, quality_layers=[160, 80, 40],
                         progression="RLCP")),
    ("cv2_16", ".png", dict()),
    ("j2k", ".jpg", dict(irreversible=True, quality_layers=[40])),
    ("jp2", ".png", dict(irreversible=True, quality_layers=[40], mct=0)),
    ("jp2", ".jpg", dict(irreversible=True, quality_layers=[40],
                         codeblock_size=(16, 16), num_resolutions=4)),
    ("cv2", ".png", dict()),
)
J2K_SHARD = ("jp2_rgb_97.jp2", "j2k_rgb.j2k", "jp2_rgba.jp2",
             "jp2_gray16.jp2", "jp2_offset.jp2", "j2k_all_styles.j2k",
             "jp2_palette.jp2", "jp2_sycc.jp2", "cv2_rgb_x100.jp2",
             "j2k_2comp.j2k", "jp2_rpcl.jp2", "j2k_ppt.j2k")


def j2k_scene_view(kind, rgb, kw):
    if kind == "cv2":
        return cv2_bytes(".jp2", rgb[..., ::-1].copy(),
                         [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 30])
    if kind == "cv2_16":
        return cv2_bytes(".jp2", rgb[..., ::-1].astype(np.uint16) * 257,
                         [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 15])
    return pil_bytes(rgb, "JPEG2000", no_jp2=kind == "j2k", **kw)


def j2k_scene_fixture(expected):
    """`scene_j2k/` and the SHA-256 of JAX's load_scene(factor=2) image
    stack on it (read from a copy: minify writes images_2/ beside the
    views); "shard_j2k": the SHA-256 of each image JAX's
    `iter_shard_images` streams from a tar of J2K_SHARD's fixtures
    (shuffle buffer 4, RandomState(7))."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import tarfile
    import tempfile
    from spinnerf_tpu.data import llff as jllff
    from spinnerf_tpu.data import shards as jshards
    src = HERE / "jpeg" / "scene"
    d = OUT / "scene_j2k"
    shutil.rmtree(d, ignore_errors=True)
    (d / "images").mkdir(parents=True)
    shutil.copy(src / "poses_bounds.npy", d / "poses_bounds.npy")
    views = sorted((src / "images").glob("*.jpg"))
    assert len(views) == len(J2K_SCENE)
    for (kind, suffix, kw), v in zip(J2K_SCENE, views):
        rgb = cv2.imread(str(v), cv2.IMREAD_COLOR)[..., ::-1].copy()
        (d / "images" / f"{v.stem}{suffix}").write_bytes(
            j2k_scene_view(kind, rgb, kw))
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(d, Path(tmp) / "s")
        scene = jllff.load_scene(Path(tmp) / "s", factor=2, prepare=True)
    images = np.asarray(scene.images)
    expected["scene_j2k"] = {"images_shape": list(images.shape),
                             "images_sha256": sha256(images)}
    members = [(n, Path(n).stem + (".png", ".jpg")[k % 2])
               for k, n in enumerate(J2K_SHARD)]
    with tempfile.TemporaryDirectory() as tmp:
        tar = Path(tmp) / "j2k.tar"
        with tarfile.open(tar, "w") as tf:
            for name, member in members:
                tf.add(OUT / name, arcname=member)
        got = [sha256(x) for x in jshards.iter_shard_images(
            [tar], rng=np.random.RandomState(7), shuffle_buffer=4,
            loop=False)]
    expected["shard_j2k"] = {"members": members, "sha256": got}


def jpeg2000_only():
    """Rewrite only the JPEG 2000 fixtures and their entries in
    expected.json (every other fixture keeps its bytes)."""
    expected = json.loads((OUT / "expected.json").read_text())
    for name in [n for n in expected["files"]
                 if n.endswith((".jp2", ".j2k"))]:
        del expected["files"][name]
        (OUT / name).unlink(missing_ok=True)
    for name, data in sorted(jpeg2000_files().items()):
        (OUT / name).write_bytes(data)
        expected["files"][name] = {"port": "equal", **cv2_reads(OUT / name)}
    expected["files"] = dict(sorted(expected["files"].items()))
    j2k_scene_fixture(expected)
    (OUT / "expected.json").write_text(json.dumps(expected, indent=1) + "\n")


# cv2 reads them, the port does not yet (ROADMAP F2)
REFUSED = ("tiff_logluv.tif",)
# reads where cv2 returns memory it never wrote (a planar 16-bit TIFF's
# unchanged read fills a buffer of every sample from the first plane's
# strips): recorded by shape and dtype, "unwritten", no hash; the port
# refuses them
UNWRITTEN = {("tiff_rgb16_planar_be.tif", "unchanged")}
LEFT_TO_CV2 = ("left_avif.avif",)
# the 7-view scene of the formats decoded natively since ROADMAP F1 / F2
# (view k written as MORE_SCENE[k]: kind, suffix) and the shard members
MORE_SCENE = (("pam", ".png"), ("hdr", ".jpg"), ("gif", ".png"),
              ("sunras", ".jpg"), ("pfm", ".png"), ("jpeg_arith", ".png"),
              ("jpeg_lossless", ".jpg"))
MORE_SHARD = ("pam_rgb.pam", "hdr_rle.hdr", "gif_interlace.gif",
              "ras24.ras", "pfm_rgb_le.pfm", "jpeg_arith_prog.jpg",
              "jpeg_lossless_rgb_rst.jpg", "gif_transparent.gif",
              "ras8_rle.ras", "pam_gray16.pam", "left_hdr.hdr")


# the 9-view scene of ROADMAP F2's TIFFs (view k written as TIFF_SCENE[k]:
# kind, suffix) and the shard of them
TIFF_SCENE = (("jpeg_ycbcr", ".jpg"), ("ycbcr", ".png"), ("cmyk", ".jpg"),
              ("bw1", ".png"), ("float_pred3", ".jpg"), ("bigtiff16", ".png"),
              ("cielab", ".jpg"), ("g4", ".png"), ("old_lzw", ".jpg"))
TIFF_SHARD = ("tiff_jpeg_ycbcr22.tif", "tiff_cmyk_lzw_pred2.tif",
              "tiff_ycbcr42_lzw.tif", "tiff_bw1.tif", "tiff_g3_2d_fill2.tif",
              "tiff_cielab.tif", "tiff_bigtiff.tif", "tiff_lzw_old.tif",
              "tiff_float_pred3_le.tif", "tiff_lzma.tif",
              "tiff_jpeg_pil_cmyk.tif", "tiff_uncompressed_tiles.tif",
              "tiff_palette4.tif", "tiff_g4_tiles.tif")


def tiff_scene_view(kind, rgb):
    """A view's TIFF in one of the TIFF_SCENE kinds (numpy writers)."""
    gray = rgb[..., 1]
    if kind == "jpeg_ycbcr":
        return iw.tiff(rgb, compression=7, photometric=6,
                       subsampling=(2, 2), rows_per_strip=16)
    if kind == "ycbcr":
        return iw.tiff(iw.rgb_to_ycbcr(rgb), photometric=6,
                       subsampling=(2, 2), compression=5)
    if kind == "cmyk":
        return iw.tiff(iw.rgb_to_cmyk(rgb), photometric=5, compression=8)
    if kind == "bw1":
        return iw.tiff((gray > 100).astype(np.uint8), bits=1, photometric=0,
                       fillorder=2, compression=32773)
    if kind == "float_pred3":
        return iw.tiff(rgb.astype(np.float32), sampleformat=3, predictor=3,
                       compression=8)
    if kind == "bigtiff16":
        return iw.tiff(rgb.astype(np.uint16) * 257, bigtiff=True,
                       compression=5, predictor=2, order=">")
    if kind == "cielab":
        return iw.tiff(rgb, photometric=8, compression=5)
    if kind == "g4":
        return iw.tiff((gray > 100).astype(np.uint8), bits=1, compression=4,
                       photometric=0)
    return iw.tiff(rgb, compression=5, old_lzw=True, rows_per_strip=7)


def tiff_scene_fixture(expected):
    """`scene_tiff/`: 9 views of TIFF_SCENE's kinds under .jpg / .png, and
    the SHA-256 of JAX's load_scene image stack on it; "shard_tiff": the
    SHA-256 of each image JAX's `iter_shard_images` streams from a tar of
    TIFF_SHARD's fixtures (shuffle buffer 4, RandomState(6))."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import tarfile
    import tempfile
    from spinnerf_tpu.data import llff as jllff
    from spinnerf_tpu.data import shards as jshards
    from spinnerf_tpu_torch.data import synthetic
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        synthetic.make_scene(tmp / "s", n_views=len(TIFF_SCENE), h=24, w=32,
                             factor=1, n_points=200, seed=2)
        d = OUT / "scene_tiff"
        shutil.rmtree(d, ignore_errors=True)
        (d / "images").mkdir(parents=True)
        shutil.copy(tmp / "s" / "poses_bounds.npy", d / "poses_bounds.npy")
        views = sorted((tmp / "s" / "images").glob("*.png"))
        for (kind, suffix), v in zip(TIFF_SCENE, views):
            rgb = cv2.imread(str(v), cv2.IMREAD_COLOR)[..., ::-1].copy()
            (d / "images" / f"{v.stem}{suffix}").write_bytes(
                tiff_scene_view(kind, rgb))
        scene = jllff.load_scene(d, factor=1, prepare=True)
    images = np.asarray(scene.images)
    expected["scene_tiff"] = {"images_shape": list(images.shape),
                              "images_sha256": sha256(images)}
    members = [(n, Path(n).stem + (".png", ".jpg")[k % 2])
               for k, n in enumerate(TIFF_SHARD)]
    with tempfile.TemporaryDirectory() as tmp:
        tar = Path(tmp) / "tiff.tar"
        with tarfile.open(tar, "w") as tf:
            for name, member in members:
                tf.add(OUT / name, arcname=member)
        got = [sha256(x) for x in jshards.iter_shard_images(
            [tar], rng=np.random.RandomState(6), shuffle_buffer=4,
            loop=False)]
    expected["shard_tiff"] = {"members": members, "sha256": got}


def shard_members():
    """(fixture, member name) of the shard: each under a suffix that the
    shard readers take (.png / .jpg), whatever its format."""
    return [(n, Path(n).stem + (".png", ".jpg")[k % 2])
            for k, n in enumerate(MORE_SHARD)]


def more_scene_view(kind, rgb):
    """A view's file in one of the MORE_SCENE formats (numpy writers)."""
    if kind == "pam":
        return iw.pam(rgb[..., ::-1])
    if kind == "hdr":
        return iw.hdr(rgb.astype(np.float32) / 255)
    if kind == "gif":
        q = ((rgb[..., 0] >> 5) << 5) | ((rgb[..., 1] >> 5) << 2) | (
            rgb[..., 2] >> 6)
        v = np.arange(256)
        pal = np.stack([(v >> 5) << 5, ((v >> 2) & 7) << 5, (v & 3) << 6], -1)
        return iw.gif([dict(indices=q)], rgb.shape[1], rgb.shape[0],
                      palette=pal)
    if kind == "sunras":
        return iw.sunras(rgb[..., ::-1], 24)
    if kind == "pfm":
        return iw.pfm(rgb.astype(np.float32), scale=-1.0)
    if kind == "jpeg_arith":
        return iw.jpeg(iw.jpeg_coefficients(rgb, quality=85), coding="arith",
                       progressive=True)
    return iw.jpeg_lossless(rgb, predictor=4)


def scene_fixture(expected):
    """A 3-view LLFF scene of mis-suffixed and other-format views, and the
    SHA-256 of JAX's load_scene image stack on it."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from spinnerf_tpu.data import llff as jllff
    from spinnerf_tpu_torch.data import synthetic
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        synthetic.make_scene(tmp / "s", n_views=3, h=24, w=32, factor=1,
                             n_points=200)
        d = OUT / "scene"
        shutil.rmtree(d, ignore_errors=True)
        (d / "images").mkdir(parents=True)
        shutil.copy(tmp / "s" / "poses_bounds.npy", d / "poses_bounds.npy")
        views = sorted((tmp / "s" / "images").glob("*.png"))
        for k, v in enumerate(views):
            rgb = cv2.imread(str(v), cv2.IMREAD_COLOR)[..., ::-1]
            if k == 0:
                (d / "images" / f"{v.stem}.jpg").write_bytes(v.read_bytes())
            elif k == 1:
                (d / "images" / f"{v.stem}.png").write_bytes(
                    iw.webp_lossless(rgb))
            else:
                (d / "images" / f"{v.stem}.png").write_bytes(
                    iw.tiff(rgb, compression=5, predictor=2))
        scene = jllff.load_scene(d, factor=1, prepare=True)
    images = np.asarray(scene.images)
    expected["scene"] = {"images_shape": list(images.shape),
                         "images_sha256": sha256(images)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        synthetic.make_scene(tmp / "s", n_views=len(MORE_SCENE), h=24, w=32,
                             factor=1, n_points=200, seed=1)
        d = OUT / "scene_more"
        shutil.rmtree(d, ignore_errors=True)
        (d / "images").mkdir(parents=True)
        shutil.copy(tmp / "s" / "poses_bounds.npy", d / "poses_bounds.npy")
        views = sorted((tmp / "s" / "images").glob("*.png"))
        for (kind, suffix), v in zip(MORE_SCENE, views):
            rgb = cv2.imread(str(v), cv2.IMREAD_COLOR)[..., ::-1].copy()
            (d / "images" / f"{v.stem}{suffix}").write_bytes(
                more_scene_view(kind, rgb))
        scene = jllff.load_scene(d, factor=1, prepare=True)
    images = np.asarray(scene.images)
    expected["scene_more"] = {"images_shape": list(images.shape),
                              "images_sha256": sha256(images)}


def shard_fixture(expected):
    """The SHA-256 of each image JAX's `iter_shard_images` streams from a
    tar of MORE_SHARD's fixtures (shuffle buffer 4, RandomState(5))."""
    import tarfile
    import tempfile
    from spinnerf_tpu.data import shards as jshards
    with tempfile.TemporaryDirectory() as tmp:
        tar = Path(tmp) / "more.tar"
        with tarfile.open(tar, "w") as tf:
            for name, member in shard_members():
                tf.add(OUT / name, arcname=member)
        got = [sha256(x) for x in jshards.iter_shard_images(
            [tar], rng=np.random.RandomState(5), shuffle_buffer=4,
            loop=False)]
    expected["shard_more"] = {"members": shard_members(), "sha256": got}


def main():
    rs = np.random.RandomState(0)
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    files = {}
    for group in (png_files(rs), bmp_files(rs), pxm_files(rs),
                  webp_files(rs), tiff_files(rs), other_files(),
                  misnamed_files(), pam_files(rs), pfm_files(rs),
                  sunras_files(rs), hdr_files(rs), gif_files(rs),
                  jpeg_f1_files(rs), tiff_more_files(), jpeg2000_files()):
        files.update(group)
    expected = {"files": {}}
    for name, data in sorted(files.items()):
        (OUT / name).write_bytes(data)
        port = ("refused" if name in REFUSED else
                "cv2" if name in LEFT_TO_CV2 else "equal")
        expected["files"][name] = {"port": port, **cv2_reads(OUT / name)}
    scene_fixture(expected)
    shard_fixture(expected)
    tiff_scene_fixture(expected)
    j2k_scene_fixture(expected)
    (OUT / "expected.json").write_text(json.dumps(expected, indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"{len(files)} files, {size} bytes in {OUT}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--jpeg2000"]:
        jpeg2000_only()
    else:
        main()
