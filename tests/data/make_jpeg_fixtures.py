"""Write the JPEG fixtures of `tests/test_torch_jpeg.py` and of
`chip_smoke.py`'s phase 21 with cv2 (needs cv2; never run on the card):

    python tests/data/make_jpeg_fixtures.py

tests/data/jpeg/
  <name>.jpg                 small files, one per feature the decoder takes
                             (samplings, gray, progressive, restarts,
                             optimized tables, odd sizes, EXIF orientation)
  scene/images/view<NNN>.jpg 12 views at 504 x 672 (q95, 4:2:0,
                             progressive, which keeps the fixtures under
                             1 MB) of `data.synthetic.make_scene`'s world,
                             seed 0
  scene/poses_bounds.npy     that scene's poses and bounds
  expected.json              for every .jpg and every read ("unchanged",
                             "color", "gray"): cv2's shape and the SHA-256
                             of its pixels in RGB channel order (colour and
                             gray reads with the EXIF orientation applied)

Every image is made from a fixed seed, so a rerun writes the same pixels;
the bytes depend on the cv2 build's encoder.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import struct
import sys
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


def write_scene(out: Path) -> tuple[float, float]:
    """The JPEG twin of make_scene(n_views=12, 504 x 672, factor=1, seed 0):
    its views re-encoded at q95 4:2:0 (progressive) and its poses. Returns
    the lowest PSNR (dB) of a decoded view against its PNG, in RGB and in
    luma (the gray read against libjpeg's Y of the PNG)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from spinnerf_tpu_torch.data import synthetic
    from spinnerf_tpu_torch.eval.render import read_png
    worst, worst_y = np.inf, np.inf
    with tempfile.TemporaryDirectory() as tmp:
        synthetic.make_scene(tmp, n_views=SCENE_VIEWS, h=SCENE_H, w=SCENE_W,
                             factor=1, seed=SCENE_SEED)
        (out / "images").mkdir(parents=True)
        for png in sorted((Path(tmp) / "images").glob("*.png")):
            rgb = read_png(png)
            data = encode(rgb[..., ::-1], quality=95, sampling="420",
                          progressive=True)
            (out / "images" / (png.stem + ".jpg")).write_bytes(data)
            worst = min(worst, psnr(cv2_read(data, cv2.IMREAD_COLOR), rgb))
            worst_y = min(worst_y, psnr(cv2_read(data, cv2.IMREAD_GRAYSCALE),
                                        libjpeg_luma(rgb)))
        shutil.copy(Path(tmp) / "poses_bounds.npy", out / "poses_bounds.npy")
    return worst, worst_y


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
    for name, data in small_files().items():
        (OUT / name).write_bytes(data)
    worst, worst_y = write_scene(OUT / "scene")
    expected = {}
    for path in sorted(OUT.rglob("*.jpg")):
        data = path.read_bytes()
        expected[path.relative_to(OUT).as_posix()] = {
            read: {"shape": list(img.shape),
                   "sha256": hashlib.sha256(
                       np.ascontiguousarray(img).tobytes()).hexdigest()}
            for read, img in ((r, cv2_read(data, f))
                              for r, f in READS.items())}
    (OUT / "expected.json").write_text(json.dumps(expected) + "\n")
    total = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"wrote {len(expected)} JPEG files, {total} bytes in all, under "
          f"{OUT}; the scene's views decode >= {worst:.2f} dB PSNR from "
          f"their PNGs in RGB, >= {worst_y:.2f} dB in luma")


if __name__ == "__main__":
    main()
