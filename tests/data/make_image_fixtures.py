"""Write the image-format fixtures of `tests/test_torch_image_formats.py`
and `chip_smoke.py`'s phase 21 (f) with cv2 5.0 and PIL, and record cv2's
reads of them (needs cv2, PIL and the JAX package; never run on the card):

    python tests/data/make_image_fixtures.py

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
                   reads the first frame); files the port refuses (JPEG /
                   YCbCr / CMYK and 16-bit planar TIFFs) and the
                   formats it leaves to cv2 (GIF, HDR, Sun raster, PFM,
                   PAM, AVIF)
  expected.json    "files": for every file, `port` ("equal": the port must
                   give cv2's pixels; "refused": it raises ValueError;
                   "cv2": it reads through cv2, RuntimeError without) and
                   for each source ("file": cv2.imread, "buffer":
                   cv2.imdecode) and read ("unchanged", "color", "gray")
                   cv2's shape, dtype and the SHA-256 of its pixels in
                   RGB(A) order, or null where cv2 gives None;
                   "scene": a 3-view LLFF scene (a PNG named .jpg, a
                   lossless WebP, a TIFF) and the SHA-256 of JAX's
                   `load_scene(factor=1)` image stack on it

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
    """cv2's three reads of a file under both sources, as recorded."""
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


def other_files():
    """Formats the port leaves to cv2 (ROADMAP F2)."""
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


def scene_view():
    """View 1 of `synthetic.make_scene`'s 504 x 672 world (seed 0), RGB."""
    import tempfile
    from spinnerf_tpu_torch.data import synthetic
    with tempfile.TemporaryDirectory() as tmp:
        synthetic.make_scene(Path(tmp), n_views=2, h=504, w=672, factor=1,
                             seed=0)
        path = sorted((Path(tmp) / "images").glob("*.png"))[1]
        return cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]


REFUSED = ("tiff_jpeg.tif", "tiff_ycbcr.tif", "tiff_cmyk.tif",
           "tiff_rgb16_planar_be.tif")


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


def main():
    rs = np.random.RandomState(0)
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    files = {}
    for group in (png_files(rs), bmp_files(rs), pxm_files(rs),
                  webp_files(rs), tiff_files(rs), other_files(),
                  misnamed_files()):
        files.update(group)
    expected = {"files": {}}
    for name, data in sorted(files.items()):
        (OUT / name).write_bytes(data)
        port = ("refused" if name in REFUSED else
                "cv2" if name.startswith("left_") else "equal")
        expected["files"][name] = {"port": port, **cv2_reads(OUT / name)}
    scene_fixture(expected)
    (OUT / "expected.json").write_text(json.dumps(expected, indent=1) + "\n")
    size = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"{len(files)} files, {size} bytes in {OUT}")


if __name__ == "__main__":
    main()
