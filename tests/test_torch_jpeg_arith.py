"""The JPEG frames of ROADMAP F1 in the port's decoder
(`spinnerf_tpu_torch/native/jpeg_native.cpp` through `data/jpeg.py` and
`data/imageio.py`) against cv2 5.0's libjpeg-turbo 3.1.

Files come from `tests/data/image_writers.py`, which codes one set of
quantised DCT coefficients with Huffman tables and with the QM coder
(T.81 Annex D as libjpeg's jcarith.c runs it), and lossless SOF3 frames.

- The QM coder is checked apart from the port: cv2 decodes each
  arithmetic-coded file to the same pixels as its Huffman twin.
- Seeded sweeps: arithmetic coding (SOF9 sequential, SOF10 progressive,
  DAC conditioning, restart intervals, table numbers up to 15, gray and
  subsampled colour) and lossless frames (predictors 1-7, precisions 2-8,
  point transforms, restarts, RGB, CMYK, replicated subsampling) equal
  cv2's unchanged, colour and gray reads under both sources (`cv2.imread`,
  `cv2.imdecode`), or both refuse.
- What cv2 gives None for is refused with a ValueError naming the marker:
  12-bit DCT frames (SOF1 / SOF2), 2 components, lossless frames above 8
  bits, in YCbCr or read in a colour space they do not hold, SOF11, the
  hierarchical SOF5-SOF7 and SOF13-SOF15.
- One-byte damage (a seeded XOR in the scan data, as C6) and truncation of
  sequential, progressive and restart arithmetic files, and of lossless
  files: the port gives cv2's pixels (libjpeg's JWRN_ARITH_BAD_CODE, zeros
  past a marker, fake EOIs of a file read) or both refuse.
"""
import re
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from spinnerf_tpu_torch.data import imageio

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests" / "data"))
import image_writers as iw  # noqa: E402

FLAGS = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "gray": cv2.IMREAD_GRAYSCALE}


def picture(h, w, seed, channels=3):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    ((x + 2 * y) * 5) % 256, (x * y * 3) % 256],
                   -1)[..., :channels]
    img[h // 4:h // 2, w // 5:w // 2] = rs.randint(
        0, 256, (h // 2 - h // 4, w // 2 - w // 5, channels))
    return img.astype(np.uint8)


def _cv2(data, source, read, tmp_path):
    if source == "file":
        path = tmp_path / "x.jpg"
        path.write_bytes(data)
        img = cv2.imread(str(path), FLAGS[read])
    else:
        img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS[read])
    return None if img is None else imageio._bgr_to_rgb(img)


def _same(data, tmp_path, tag, sources=("file", "buffer")):
    """Each read under each source: the port's pixels are cv2's, or both
    refuse; returns the number of reads cv2 gave None for."""
    nones = 0
    for source in sources:
        for read in FLAGS:
            want = _cv2(data, source, read, tmp_path)
            try:
                got = imageio.read(data, mode=read, source=source, name=tag)
            except ValueError as e:
                assert want is None, (tag, source, read, str(e))
                assert tag in str(e)
                nones += 1
                continue
            assert want is not None, (tag, source, read)
            assert got.dtype == want.dtype and got.shape == want.shape, (
                tag, source, read)
            assert np.array_equal(got, want), (tag, source, read)
    return nones


@pytest.mark.parametrize("progressive", [False, True])
def test_qm_coder_equals_huffman_twin_in_cv2(progressive):
    """cv2 reads an arithmetic-coded file to the pixels of the Huffman file
    made from the same coefficients (the writer's QM coder is right), and
    so does the port."""
    img = picture(45, 61, seed=1)
    c = iw.jpeg_coefficients(img, quality=70, sampling=[(2, 2), (1, 1),
                                                        (1, 1)])
    huff = iw.jpeg(c, progressive=progressive)
    arith = iw.jpeg(c, coding="arith", progressive=progressive, restart=4)
    want = cv2.imdecode(np.frombuffer(huff, np.uint8), cv2.IMREAD_COLOR)
    assert np.array_equal(cv2.imdecode(np.frombuffer(arith, np.uint8),
                                       cv2.IMREAD_COLOR), want)
    assert np.array_equal(imageio.read(arith, mode="color", name="a"),
                          want[..., ::-1])


def _random_arith(rs, k):
    h, w = (int(v) for v in rs.randint(1, 70, 2))
    gray = rs.rand() < 0.3
    img = picture(h, w, seed=k, channels=1 if gray else 3)
    samp = None
    if not gray and rs.rand() < 0.7:
        samp = [tuple(int(v) for v in rs.choice([1, 2], 2)), (1, 1), (1, 1)]
    c = iw.jpeg_coefficients(img[..., 0] if gray else img,
                             quality=int(rs.randint(5, 100)), sampling=samp)
    kw = dict(coding="arith", progressive=bool(rs.rand() < 0.5))
    if rs.rand() < 0.4:
        kw["restart"] = int(rs.randint(1, 7))
    if rs.rand() < 0.4:
        kw["dac"] = {("dc", 0): (int(rs.randint(0, 3)), int(rs.randint(3, 9))),
                     ("ac", 0): int(rs.randint(1, 63))}
    if not gray and rs.rand() < 0.3:
        kw["tables"] = {0: (0, 0), 1: (int(rs.randint(16)),
                                       int(rs.randint(16))), 2: (15, 15)}
        kw.pop("dac", None)
    return iw.jpeg(c, **kw)


def test_random_arithmetic_files_equal_cv2(tmp_path):
    rs = np.random.RandomState(25)
    for k in range(36):
        assert _same(_random_arith(rs, k), tmp_path, f"arith{k}") == 0


def _random_lossless(rs, k):
    h, w = (int(v) for v in rs.randint(1, 50, 2))
    p = int(rs.randint(2, 9))
    ch = int(rs.choice([1, 3, 4]))
    x = rs.randint(0, 1 << p, (h, w, ch))
    x[:h // 2] = x[0, 0]
    samp = None
    if ch > 1 and rs.rand() < 0.4:
        samp = [tuple(int(v) for v in rs.choice([1, 2], 2))] + [(1, 1)] * (
            ch - 1)
    mcux = -(-w // max(s[0] for s in samp)) if samp else w
    markers = b""
    if ch == 4 and rs.rand() < 0.5:
        markers = iw._marker(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    return iw.jpeg_lossless(
        x[..., 0] if ch == 1 else x, precision=p,
        predictor=int(rs.randint(1, 8)),
        pt=int(rs.randint(0, p)) if rs.rand() < 0.3 else 0,
        restart=mcux * int(rs.randint(1, 4)) if rs.rand() < 0.4 else 0,
        sampling=samp, markers=markers)


def test_random_lossless_files_equal_cv2(tmp_path):
    rs = np.random.RandomState(3)
    nones = sum(_same(_random_lossless(rs, k), tmp_path, f"lossless{k}")
                for k in range(36))
    assert nones > 0   # the gray read of RGB and the colour read of gray


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_predictors_are_exact(predictor, tmp_path):
    """Every predictor at 8 bits and at 5 bits with a point transform gives
    back the samples (shifted back by the transform), as cv2 does."""
    x = picture(31, 43, seed=predictor, channels=1)[..., 0].astype(np.int64)
    for p, pt in ((8, 0), (5, 2)):
        v = x >> (8 - p)
        data = iw.jpeg_lossless(v, precision=p, predictor=predictor, pt=pt,
                                restart=43 * 2)
        got = imageio.read(data, name="ll")
        assert np.array_equal(got, (v >> pt) << pt)
        # libjpeg-turbo converts no colour in lossless mode: the colour
        # read of a gray frame gives None under both sources
        assert _same(data, tmp_path, "ll") == 2


def _refused():
    rgb = picture(23, 37, seed=4)
    gray = rgb[..., 1].astype(np.int64)
    c = iw.jpeg_coefficients(rgb)
    c12 = iw.jpeg_coefficients(rgb.astype(np.int64) * 16, precision=12)
    return {
        "SOF1 12-bit": (iw.jpeg(c12), "12-bit precision (SOF1)"),
        "SOF2 12-bit": (iw.jpeg(c12, progressive=True),
                        "12-bit precision (SOF2)"),
        "SOF9 12-bit": (iw.jpeg(c12, coding="arith"),
                        "12-bit precision (SOF9)"),
        "2 components": (iw.jpeg(iw.jpeg_coefficients(rgb[..., :2],
                                                      rgb=True)),
                         "2 components (SOF0)"),
        "lossless 12-bit": (iw.jpeg_lossless(gray * 16, precision=12),
                            "12-bit precision (SOF3)"),
        "lossless 16-bit": (iw.jpeg_lossless(gray * 257, precision=16),
                            "16-bit precision (SOF3)"),
        "lossless 2 components": (iw.jpeg_lossless(rgb[..., :2]),
                                  "2 components (SOF3)"),
        "lossless YCbCr": (iw.jpeg_lossless(rgb, markers=iw._jfif()),
                           "lossless YCbCr"),
        "SOF11": (iw.jpeg_lossless(gray, sof=0xCB), "SOF11"),
        "SOF5": (iw.jpeg(c, sof=0xC5), "SOF5"),
        "SOF6": (iw.jpeg(c, sof=0xC6), "SOF6"),
        "SOF7": (iw.jpeg(c, sof=0xC7), "SOF7"),
        "SOF13": (iw.jpeg(c, sof=0xCD), "SOF13"),
        "SOF14": (iw.jpeg(c, sof=0xCE), "SOF14"),
        "SOF15": (iw.jpeg(c, sof=0xCF), "SOF15"),
    }


@pytest.mark.parametrize("what", sorted(_refused()))
def test_refused_where_cv2_gives_none(what, tmp_path):
    data, marker = _refused()[what]
    for source in ("file", "buffer"):
        for read in FLAGS:
            assert _cv2(data, source, read, tmp_path) is None, (source, read)
            with pytest.raises(ValueError,
                               match=r"x\.jpg: .*" + re.escape(marker)):
                imageio.read(data, mode=read, source=source, name="x.jpg")


@pytest.mark.parametrize("kind", ["seq", "prog", "seq_rst", "prog_rst"])
def test_arithmetic_one_byte_damage_equals_cv2(kind, tmp_path):
    """A seeded XOR of one byte of the scan data in each of 40 copies, and
    a cut at every 29th byte: both sources and reads equal cv2."""
    img = picture(48, 64, seed=5)
    c = iw.jpeg_coefficients(img, quality=90, sampling=[(2, 2), (1, 1),
                                                        (1, 1)])
    good = iw.jpeg(c, coding="arith", progressive="prog" in kind,
                   restart=3 if "rst" in kind else 0)
    sos = good.index(b"\xff\xda")
    rs = np.random.RandomState(len(kind) + 7 * ("rst" in kind))
    for k in range(40):
        data = bytearray(good)
        data[int(rs.randint(sos + 12, len(good) - 2))] ^= 1 << int(
            rs.randint(8))
        _same(bytes(data), tmp_path, f"{kind}{k}")
    for cut in range(sos, len(good), 29):
        _same(good[:cut], tmp_path, f"{kind} cut {cut}")


def test_lossless_damage_and_truncation_equal_cv2(tmp_path):
    x = picture(30, 40, seed=2)
    rs = np.random.RandomState(11)
    for rst in (0, 80):
        good = iw.jpeg_lossless(x, predictor=4, restart=rst)
        sos = good.index(b"\xff\xda")
        for cut in range(sos, len(good), 97):
            _same(good[:cut], tmp_path, f"cut {rst} {cut}")
        for k in range(20):
            data = bytearray(good)
            data[int(rs.randint(sos + 12, len(good) - 2))] ^= 1 << int(
                rs.randint(8))
            _same(bytes(data), tmp_path, f"xor {rst} {k}")
