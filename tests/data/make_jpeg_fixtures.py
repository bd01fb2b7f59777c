"""Write the JPEG fixtures of `tests/test_torch_jpeg.py`,
`tests/test_torch_jpeg_damaged.py` and `chip_smoke.py`'s phase 21 with cv2
(needs cv2, PIL and the JAX package; never run on the card):

    python tests/data/make_jpeg_fixtures.py

tests/data/jpeg/
  <name>.jpg                 small files, one per feature the decoder takes
                             (samplings, gray, progressive, restarts,
                             optimized tables, odd sizes, EXIF orientation,
                             CMYK through PIL, CMYK / YCCK / Adobe-less
                             4-component files through `four_component_jpeg`)
                             and damaged ones (cut, edited, scans dropped,
                             restart markers renumbered or removed)
  scene/images/view<NNN>.jpg 12 views at 504 x 672 (q95, 4:2:0,
                             progressive, which keeps the fixtures under
                             1 MB) of `data.synthetic.make_scene`'s world,
                             seed 0
  scene/poses_bounds.npy     that scene's poses and bounds
  mixed/view003.jpg,         views 3 and 7 of that world as YCCK (4:2:0,
  mixed/view007.jpg          `four_component_jpeg`) and CMYK (PIL)
  expected.json              "files": for every .jpg, each source ("file":
                             cv2.imread, "buffer": cv2.imdecode) and each
                             read ("unchanged", "color", "gray"): cv2's shape
                             and the SHA-256 of its pixels in RGB channel
                             order (colour and gray reads with the EXIF
                             orientation applied), or null where cv2 gives
                             None; "mixed_scene": the scene with views 3
                             and 7 replaced by mixed/, view 10 cut at a byte
                             offset and view 5 edited, and the SHA-256 of
                             JAX's `load_scene(factor=2)` image stack on it;
                             "shard": a tar of damaged and 4-component
                             members and the SHA-256 of each image JAX's
                             `iter_shard_images` yields from it, in order

Every image is made from a fixed seed, so a rerun writes the same pixels;
the bytes depend on the cv2 and PIL builds' encoders.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import struct
import sys
import tarfile
import tempfile
from pathlib import Path

import cv2
import numpy as np

OUT = Path(__file__).resolve().parent / "jpeg"
SCENE_VIEWS, SCENE_H, SCENE_W, SCENE_SEED = 12, 504, 672, 0
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
READS = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "gray": cv2.IMREAD_GRAYSCALE}
MIXED_YCCK, MIXED_CMYK, MIXED_CUT, MIXED_EDIT = 3, 7, 10, 5
SHARD_MEMBERS = ("sampling_420.jpg", "cmyk_pil.jpg", "ycck_420.jpg",
                 "truncated_baseline.jpg", "corrupt_baseline.jpg",
                 "missing_scans.jpg", "cmyk_plain_444.jpg",
                 "truncated_progressive.jpg", "corrupt_progressive.jpg",
                 "no_eoi.jpg", "progressive_420.jpg")
SHARD_SEED, SHARD_BUFFER = 21, 3


def smooth_noisy(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """uint8 [H, W(, C)]: smooth waves with Gaussian noise (sigma 12)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(xx / (6 + k) + k) * np.cos(yy / (8 + k))
                     for k in range(channels)], -1)
    img = np.clip(base + rng.normal(0, 12, base.shape), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def encode(img: np.ndarray, *, quality=90, sampling=None, progressive=False,
           optimize=False, restart=0) -> bytes:
    """cv2's JPEG of img (BGR order for colour, as cv2 takes it)."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    return buf.tobytes()


# Annex K.1's quantisation tables in natural order (luminance, chrominance)
STD_Q = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
             + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38))
ZIGZAG = np.array([    # zigzag position -> natural position
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Annex K.3's Huffman tables: (code counts of lengths 1-16, symbols)
STD_DC = (([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12))),
          ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], bytes(range(12))))
STD_AC = (
    ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a8384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2"
        "c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4"
        "f5f6f7f8f9fa")),
    ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")))


def _qtable(base):
    """A quantisation table scaled to quality 90 as libjpeg's
    jpeg_quality_scaling scales it."""
    scale = 200 - 2 * 90
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _codes(bits, vals):
    """symbol -> (code, length) of a canonical Huffman table."""
    out, code, k = {}, 0, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _dct_matrix():
    """The orthonormal 8-point DCT-II."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


def four_component_jpeg(cmyk, *, transform, sampling="444"):
    """A baseline JPEG of a uint8 [H, W, 4] image. transform 0 stores the
    channels as CMYK under an Adobe APP14 marker (transform 0), 2 as YCCK
    (libjpeg's cmyk_ycck_convert: the YCbCr of 255 - C, 255 - M, 255 - Y,
    K as is; Adobe transform 2), None as CMYK with no Adobe marker.
    sampling "420" halves components 1 and 2 both ways. Quality 90."""
    h, w, _ = cmyk.shape
    planes = [cmyk[..., i].astype(np.float64) for i in range(4)]
    if transform == 2:
        r, g, b = (255.0 - p for p in planes[:3])
        planes[0] = 0.299 * r + 0.587 * g + 0.114 * b
        planes[1] = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128
        planes[2] = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128
    hv = ([(2, 2), (1, 1), (1, 1), (2, 2)] if sampling == "420"
          else [(1, 1)] * 4)
    hmax = max(a for a, _ in hv)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * hmax))
    tables = (0, 1, 1, 0)
    qts = [_qtable(STD_Q[t]) for t in (0, 1)]
    cm = _dct_matrix()
    comp_blocks = []
    for p, (ch, cv), t in zip(planes, hv, tables):
        f = hmax // ch
        if f > 1:   # mean of 2 x 2 (edges repeated)
            p = np.pad(p, ((0, (-h) % f), (0, (-w) % f)), mode="edge")
            p = p.reshape(p.shape[0] // f, f, p.shape[1] // f, f).mean((1, 3))
        p = np.clip(np.round(p), 0, 255)
        ph, pw = mcuy * cv * 8, mcux * ch * 8
        p = np.pad(p, ((0, ph - p.shape[0]), (0, pw - p.shape[1])),
                   mode="edge") - 128
        blocks = p.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ux,abxy,vy->abuv", cm, blocks, cm)
        q = np.round(coef / qts[t].reshape(8, 8)).astype(np.int64)
        comp_blocks.append(q.reshape(q.shape[0], q.shape[1], 64)[..., ZIGZAG])
    dc_codes = [_codes(*STD_DC[t]) for t in (0, 1)]
    ac_codes = [_codes(*STD_AC[t]) for t in (0, 1)]
    out = bytearray()
    acc, nacc = 0, 0

    def put(code, n):
        nonlocal acc, nacc
        acc = (acc << n) | code
        nacc += n
        while nacc >= 8:
            nacc -= 8
            byte = (acc >> nacc) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
        acc &= (1 << nacc) - 1

    def put_value(v):
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    pred = [0, 0, 0, 0]
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (ch, cv) in enumerate(hv):
                t = tables[ci]
                for y in range(cv):
                    for x in range(ch):
                        blk = comp_blocks[ci][my * cv + y, mx * ch + x]
                        diff = int(blk[0]) - pred[ci]
                        pred[ci] = int(blk[0])
                        s, bits = put_value(diff)
                        put(*dc_codes[t][s])
                        if s:
                            put(bits, s)
                        run = 0
                        for k in range(1, 64):
                            v = int(blk[k])
                            if v == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac_codes[t][0xF0])
                                run -= 16
                            s, bits = put_value(v)
                            put(*ac_codes[t][(run << 4) | s])
                            put(bits, s)
                            run = 0
                        if run:
                            put(*ac_codes[t][0])
    if nacc:
        put((1 << (8 - nacc)) - 1, 8 - nacc)

    def seg(marker, body):
        return (bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big")
                + body)
    data = b"\xff\xd8"
    if transform is not None:
        data += seg(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform]))
    data += seg(0xDB, b"".join(bytes([t]) + bytes(qts[t][ZIGZAG].tolist())
                               for t in (0, 1)))
    data += seg(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                + bytes([4]) + b"".join(bytes([i + 1, (a << 4) | b, t])
                                        for i, ((a, b), t) in
                                        enumerate(zip(hv, tables))))
    for cls, tabs in ((0, STD_DC), (1, STD_AC)):
        for t, (bits, vals) in enumerate(tabs):
            data += seg(0xC4, bytes([(cls << 4) | t]) + bytes(bits)
                        + bytes(vals))
    data += seg(0xDA, bytes([4]) + b"".join(bytes([i + 1, (t << 4) | t])
                                            for i, t in enumerate(tables))
                + bytes([0, 63, 0]))
    return data + bytes(out) + b"\xff\xd9"


def cmyk_for(rgb: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 4] that `four_component_jpeg` stores so that cv2's
    colour read gives back about rgb: C, M, Y = R, G, B and K = 255 (OpenCV
    takes CMYK as stored: R = K - (255 - C) * K / 256)."""
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)],
                          -1)


def pil_cmyk(rgb: np.ndarray) -> bytes:
    """PIL's CMYK JPEG (q90, 4:4:4, Adobe transform 0) of about rgb: PIL
    stores CMYK inverted, so it is given 255 - RGB and K = 0."""
    from PIL import Image
    cmyk = np.concatenate([255 - rgb, np.zeros(rgb.shape[:2] + (1,),
                                               np.uint8)], -1)
    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=90)
    return buf.getvalue()


def with_orientation(data: bytes, orientation: int,
                     little_endian: bool = True) -> bytes:
    """data with an APP1 Exif segment (IFD0 holding only tag 0x0112) right
    after SOI."""
    o = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(o + "HI", 42, 8)
            + struct.pack(o + "H", 1)
            + struct.pack(o + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(o + "I", 0))
    body = b"Exif\x00\x00" + tiff
    return (data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
            + data[2:])


def small_files() -> dict[str, bytes]:
    img = smooth_noisy(29, 45, 3, 1)
    files = {f"sampling_{s}.jpg": encode(img, sampling=s) for s in SAMPLING}
    files["gray.jpg"] = encode(smooth_noisy(29, 45, 1, 2))
    files["progressive_420.jpg"] = encode(img, sampling="420",
                                          progressive=True)
    files["restart_7.jpg"] = encode(img, sampling="420", restart=7)
    files["optimized.jpg"] = encode(img, sampling="422", optimize=True)
    files["size_1x1.jpg"] = encode(smooth_noisy(1, 1, 3, 3))
    files["size_17x33.jpg"] = encode(smooth_noisy(17, 33, 3, 4),
                                     sampling="420", quality=75)
    files["exif_6.jpg"] = with_orientation(encode(img), 6)
    files["exif_8.jpg"] = with_orientation(encode(img, sampling="444"), 8,
                                           little_endian=False)
    return files


def sos_offsets(data: bytes) -> list[int]:
    """Offsets of the file's SOS markers (cv2 stuffs every FF in scan
    data, so FF DA occurs only as a marker)."""
    out, i = [], data.find(b"\xff\xda")
    while i >= 0:
        out.append(i)
        i = data.find(b"\xff\xda", i + 2)
    return out


def rst_offsets(data: bytes) -> list[int]:
    return [i for i in range(len(data) - 1)
            if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]


def scan_start(data: bytes) -> int:
    """The first byte of the first scan's entropy-coded data."""
    sos = data.find(b"\xff\xda")
    return sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]


def cut_in_longest_scan(data: bytes) -> bytes:
    """A progressive file cut in the middle of its longest scan."""
    sos = sos_offsets(data)
    k = max(range(len(sos) - 1), key=lambda i: sos[i + 1] - sos[i])
    return data[:(sos[k] + sos[k + 1]) // 2]


def xor(data: bytes, edits) -> bytes:
    out = bytearray(data)
    for off, mask in edits:
        out[off] ^= mask
    return bytes(out)


def four_component_files() -> dict[str, bytes]:
    """CMYK through PIL; CMYK (Adobe transform 0), YCCK (transform 2) and
    CMYK without an Adobe marker through `four_component_jpeg`."""
    rgb = smooth_noisy(29, 45, 3, 12)
    ink = np.concatenate([rgb, smooth_noisy(29, 45, 1, 13)[..., None]], -1)
    return {
        "cmyk_pil.jpg": pil_cmyk(rgb),
        "cmyk_adobe_420.jpg": four_component_jpeg(cmyk_for(rgb), transform=0,
                                                  sampling="420"),
        "ycck_444.jpg": four_component_jpeg(cmyk_for(rgb), transform=2),
        "ycck_420.jpg": four_component_jpeg(cmyk_for(rgb), transform=2,
                                            sampling="420"),
        "cmyk_plain_444.jpg": four_component_jpeg(ink, transform=None),
        "cmyk_plain_420.jpg": four_component_jpeg(ink, transform=None,
                                                  sampling="420")}


def damaged_files() -> dict[str, bytes]:
    """Cut, edited and incompletely scanned files, and restart markers
    renumbered or removed (each edit at a fixed place in the scan data)."""
    img = smooth_noisy(48, 64, 3, 11)
    base = encode(img, sampling="420")
    rst = encode(img, sampling="420", restart=1)
    prog = encode(img, sampling="420", progressive=True)

    def at(data, frac):   # a byte `frac` of the way through the scan data
        s0 = scan_start(data)
        return s0 + int((len(data) - 2 - s0) * frac)
    r1, r3 = rst_offsets(rst)[1], rst_offsets(rst)[3]
    return {
        "truncated_baseline.jpg": base[:at(base, 0.6)],
        "truncated_restart.jpg": rst[:at(rst, 0.7)],
        "truncated_progressive.jpg": cut_in_longest_scan(prog),
        "no_eoi.jpg": base[:-2],
        "missing_scans.jpg": prog[:sos_offsets(prog)[-3]] + b"\xff\xd9",
        "corrupt_baseline.jpg": xor(base, [(at(base, 0.3), 0x35),
                                           (at(base, 0.7), 0x81)]),
        "corrupt_progressive.jpg": xor(prog, [(at(prog, 0.04), 0x10),
                                              (at(prog, 0.8), 0x44)]),
        "rst_renumbered.jpg": rst[:r1 + 1] + bytes([rst[r1 + 1] + 2 & 0xD7])
        + rst[r1 + 2:],
        "rst_removed.jpg": rst[:r3] + rst[r3 + 2:]}


def write_scene(out: Path, mixed: Path) -> tuple[float, float]:
    """The JPEG twin of make_scene(n_views=12, 504 x 672, factor=1, seed 0):
    its views re-encoded at q95 4:2:0 (progressive) and its poses; views
    MIXED_YCCK and MIXED_CMYK also as YCCK (q90, 4:2:0) and CMYK (PIL, q90)
    under `mixed`. Returns the lowest PSNR (dB) of a decoded view against
    its PNG, in RGB and in luma (the gray read against libjpeg's Y of the
    PNG)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from spinnerf_tpu_torch.data import synthetic
    from spinnerf_tpu_torch.eval.render import read_png
    worst, worst_y = np.inf, np.inf
    mixed.mkdir(parents=True)
    with tempfile.TemporaryDirectory() as tmp:
        synthetic.make_scene(tmp, n_views=SCENE_VIEWS, h=SCENE_H, w=SCENE_W,
                             factor=1, seed=SCENE_SEED)
        (out / "images").mkdir(parents=True)
        for k, png in enumerate(sorted((Path(tmp) / "images").glob("*.png"))):
            rgb = read_png(png)
            data = encode(rgb[..., ::-1], quality=95, sampling="420",
                          progressive=True)
            (out / "images" / (png.stem + ".jpg")).write_bytes(data)
            worst = min(worst, psnr(cv2_read(data, cv2.IMREAD_COLOR), rgb))
            worst_y = min(worst_y, psnr(cv2_read(data, cv2.IMREAD_GRAYSCALE),
                                        libjpeg_luma(rgb)))
            if k == MIXED_YCCK:
                (mixed / (png.stem + ".jpg")).write_bytes(four_component_jpeg(
                    cmyk_for(rgb), transform=2, sampling="420"))
            if k == MIXED_CMYK:
                (mixed / (png.stem + ".jpg")).write_bytes(pil_cmyk(rgb))
        shutil.copy(Path(tmp) / "poses_bounds.npy", out / "poses_bounds.npy")
    return worst, worst_y


def mixed_recipe() -> dict:
    """How phase 21 (d) builds its scene from the committed one: views
    MIXED_YCCK and MIXED_CMYK replaced by mixed/, view MIXED_CUT cut at a
    byte offset, view MIXED_EDIT with bytes XORed (fixed places in their
    scan data)."""
    views = sorted((OUT / "scene" / "images").glob("*.jpg"))
    cut = views[MIXED_CUT].read_bytes()
    edit = views[MIXED_EDIT].read_bytes()
    s0 = scan_start(edit)
    return {"replace": {str(MIXED_YCCK): f"mixed/{views[MIXED_YCCK].name}",
                        str(MIXED_CMYK): f"mixed/{views[MIXED_CMYK].name}"},
            "cut": [MIXED_CUT, len(cut) * 3 // 5],
            "xor": [MIXED_EDIT, [[s0 + (len(edit) - s0) * k // 7, mask]
                                 for k, mask in ((2, 0x21), (5, 0x0C))]]}


def build_mixed_scene(recipe: dict, dst: Path) -> None:
    shutil.copytree(OUT / "scene", dst)
    views = sorted((dst / "images").glob("*.jpg"))
    for k, name in recipe["replace"].items():
        shutil.copy(OUT / name, views[int(k)])
    k, off = recipe["cut"]
    views[k].write_bytes(views[k].read_bytes()[:off])
    k, edits = recipe["xor"]
    views[k].write_bytes(xor(views[k].read_bytes(), edits))


def write_shard(path: Path) -> None:
    """A tar of SHARD_MEMBERS' bytes, in that order."""
    with tarfile.open(path, "w") as tf:
        for name in SHARD_MEMBERS:
            data = (OUT / name).read_bytes()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def jax_records() -> tuple[dict, dict]:
    """The JAX package's results on the mixed scene and the shard:
    `load_scene(factor=2, prepare=True)`'s image stack and the images
    `iter_shard_images` yields (seed SHARD_SEED, buffer SHARD_BUFFER)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from spinnerf_tpu.data import llff as jllff
    from spinnerf_tpu.data import shards as jshards
    recipe = mixed_recipe()
    with tempfile.TemporaryDirectory() as tmp:
        build_mixed_scene(recipe, Path(tmp) / "scene")
        for p in sorted((Path(tmp) / "scene" / "images").glob("*.jpg")):
            if cv2.imread(str(p), cv2.IMREAD_UNCHANGED) is None:
                raise RuntimeError(f"cv2.imread refuses the mixed scene's "
                                   f"{p.name}")
        images = jllff.load_scene(Path(tmp) / "scene", factor=2,
                                  prepare=True).images
        write_shard(Path(tmp) / "shard.tar")
        got = list(jshards.iter_shard_images(
            [Path(tmp) / "shard.tar"], rng=np.random.RandomState(SHARD_SEED),
            shuffle_buffer=SHARD_BUFFER, loop=False))
    mixed = dict(recipe, images_shape=list(images.shape),
                 images_sha256=sha256(images))
    shard = {"members": list(SHARD_MEMBERS), "seed": SHARD_SEED,
             "shuffle_buffer": SHARD_BUFFER,
             "sha256": [sha256(img) for img in got]}
    return mixed, shard


def sha256(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def cv2_reads(path: Path) -> dict:
    """cv2's result of each read of the file from disk (`cv2.imread`) and
    from its bytes (`cv2.imdecode`): shape and SHA-256 in RGB order, or
    None."""
    data = path.read_bytes()
    out = {}
    for source in ("file", "buffer"):
        out[source] = {}
        for read, flag in READS.items():
            img = (cv2.imread(str(path), flag) if source == "file" else
                   cv2.imdecode(np.frombuffer(data, np.uint8), flag))
            if img is not None and img.ndim == 3:
                img = img[..., ::-1]
            out[source][read] = None if img is None else {
                "shape": list(img.shape), "sha256": sha256(img)}
    return out


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse))


def libjpeg_luma(rgb: np.ndarray) -> np.ndarray:
    """libjpeg's RGB -> Y (jccolor.c: FIX(0.299), FIX(0.587), FIX(0.114),
    16 fractional bits, rounded)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return (19595 * r + 38470 * g + 7471 * b + 32768) >> 16


def cv2_read(data: bytes, flag: int) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
    return img[..., ::-1] if img.ndim == 3 else img


def main():
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    files = {**small_files(), **four_component_files(), **damaged_files()}
    for name, data in files.items():
        (OUT / name).write_bytes(data)
    worst, worst_y = write_scene(OUT / "scene", OUT / "mixed")
    mixed, shard = jax_records()
    expected = {"files": {p.relative_to(OUT).as_posix(): cv2_reads(p)
                          for p in sorted(OUT.rglob("*.jpg"))},
                "mixed_scene": mixed, "shard": shard}
    (OUT / "expected.json").write_text(json.dumps(expected) + "\n")
    total = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"wrote {len(expected['files'])} JPEG files, {total} bytes in all, "
          f"under {OUT}; the scene's views decode >= {worst:.2f} dB PSNR "
          f"from their PNGs in RGB, >= {worst_y:.2f} dB in luma; the shard "
          f"yields {len(shard['sha256'])} of {len(SHARD_MEMBERS)} members")


if __name__ == "__main__":
    main()
