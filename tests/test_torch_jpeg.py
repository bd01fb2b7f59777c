"""The port's JPEG decoder and EXIF orientation (`spinnerf_tpu_torch/
native/jpeg_native.cpp` through `data/jpeg.py`; `data/llff.py`'s reads,
`data/shards.py`) against cv2 5's libjpeg-turbo and the JAX package.

- The native decode equals `cv2.imdecode` bit for bit (unchanged, colour and
  grayscale reads) on seeded smooth-plus-noise images that cv2 encodes here:
  quality 10 / 50 / 75 / 95 / 100, samplings 4:4:4, 4:2:2, 4:2:0, 4:1:1,
  4:4:0 and gray, baseline and progressive, standard and optimized Huffman
  tables, restart intervals 0 / 1 / 7, sizes 1 x 1 to 63 x 65; also on
  files edited to take the decoder's other paths (Adobe RGB, no JFIF
  marker, the standard Huffman tables, DQT between scans).
- EXIF orientations 1-8 on JPEG and PNG: `llff.imread` stays unrotated as
  cv2's unchanged read does, `imread_rgb8` / `imread_gray8` equal cv2's
  colour and grayscale reads.
- Refused streams (hierarchical and lossless arithmetic frames, a lossless
  or progressive arithmetic frame whose scan holds sequential parameters,
  12-bit precision, 2 components, frames without a scan) raise naming the
  file and the marker; a baseline file relabelled SOF9 or given a DAC
  segment reads to cv2's pixels (arithmetic coding is decoded:
  `tests/test_torch_jpeg_arith.py`); damaged and 4-component streams are
  `tests/test_torch_jpeg_damaged.py`'s.
- The committed fixtures still decode to `tests/data/jpeg/expected.json`,
  read from disk as cv2.imread reads them and from memory as cv2.imdecode
  does.
- With cv2 made unimportable, `llff.imread`, `load_scene` at factor 2 and
  `shards._decode` give exactly what JAX's modules give with cv2.
"""
import hashlib
import itertools
import json
import shutil
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from spinnerf_tpu.data import llff as jllff
from spinnerf_tpu.data import shards as jshards
from spinnerf_tpu_torch.data import jpeg
from spinnerf_tpu_torch.data import llff as tllff
from spinnerf_tpu_torch.data import shards as tshards
from spinnerf_tpu_torch.eval.render import write_png

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
READS = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "gray": cv2.IMREAD_GRAYSCALE}
SIZES = [(1, 1), (7, 13), (16, 16), (17, 33), (63, 65)]


def smooth_noisy(h, w, channels, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(xx / (5 + k) + k) * np.cos(yy / (7 + k))
                     for k in range(channels)], -1)
    img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def encode(img, *, quality=90, sampling=None, progressive=False,
           optimize=False, restart=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def cv2_read(data, read):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), READS[read])
    return None if img is None else (img[..., ::-1] if img.ndim == 3
                                     else img)


def assert_decodes_as_cv2(data, tag):
    for read in READS:
        want = cv2_read(data, read)
        got = jpeg.decode(data, name=tag, mode=read)
        assert got.shape == want.shape, (tag, read)
        np.testing.assert_array_equal(got, want, err_msg=f"{tag} {read}")


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "411", "440",
                                      "gray"])
def test_decode_equals_cv2(sampling, progressive):
    """Every quality, size, table choice and restart interval of one
    sampling and mode, bit for bit in all three reads."""
    channels = 1 if sampling == "gray" else 3
    for n, (q, (h, w), optimize, restart) in enumerate(itertools.product(
            (10, 50, 75, 95, 100), SIZES, (False, True), (0, 1, 7))):
        img = smooth_noisy(h, w, channels, n)
        data = encode(img, quality=q, progressive=progressive,
                      optimize=optimize, restart=restart,
                      sampling=None if sampling == "gray" else sampling)
        assert_decodes_as_cv2(data, f"q{q} {h}x{w} opt {optimize} rst "
                                    f"{restart}")


def _segments(data):
    """(offset, marker, end) of each segment before the first SOS."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((pos, data[pos + 1], end))
        pos = end
    return out, pos


def test_decode_edited_files_equals_cv2():
    """Files edited to reach the decoder's other branches: an Adobe APP14
    marker with transform 0 (RGB stored as is) and 1, no JFIF marker, the
    component ids 'R', 'G', 'B' (RGB), every DHT removed (the standard
    tables), and a DQT redefined before a progressive file's second scan
    (each component keeps the table of its first scan)."""
    img = smooth_noisy(33, 45, 3, 1)
    base = encode(img, sampling="444")
    segs, _ = _segments(base)
    app0 = next((s, e) for s, m, e in segs if m == 0xE0)
    no_jfif = base[:app0[0]] + base[app0[1]:]
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"
    rgb_ids = bytearray(no_jfif)
    sof = rgb_ids.find(b"\xff\xc0")
    sos = rgb_ids.find(b"\xff\xda")
    for k, cid in enumerate(b"RGB"):
        rgb_ids[sof + 10 + 3 * k] = cid
        rgb_ids[sos + 5 + 2 * k] = cid
    no_dht = base
    for s, m, e in reversed(segs):
        if m == 0xC4:
            no_dht = no_dht[:s] + no_dht[e:]
    prog = encode(img, sampling="420", progressive=True, quality=70)
    second = prog.find(b"\xff\xda", prog.find(b"\xff\xda") + 2)
    dqt = (b"\xff\xdb\x00\x43\x00" + bytes([7] * 64)
           + b"\xff\xdb\x00\x43\x01" + bytes([3] * 64))
    for tag, data in (
            ("adobe 0", base[:app0[0]] + adobe + b"\x00" + base[app0[1]:]),
            ("adobe 1", base[:app0[0]] + adobe + b"\x01" + base[app0[1]:]),
            ("no JFIF", no_jfif), ("RGB ids", bytes(rgb_ids)),
            ("no DHT", no_dht),
            ("DQT between scans", prog[:second] + dqt + prog[second:])):
        assert_decodes_as_cv2(data, tag)


def tiff_orientation(orientation, little_endian=True):
    o = "<" if little_endian else ">"
    return ((b"II" if little_endian else b"MM") + struct.pack(o + "HI", 42, 8)
            + struct.pack(o + "H", 1)
            + struct.pack(o + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(o + "I", 0))


def jpeg_with_orientation(data, orientation, little_endian=True):
    xmp = b"http://ns.adobe.com/xap/1.0/\x00<x/>"
    body = b"Exif\x00\x00" + tiff_orientation(orientation, little_endian)
    return (data[:2] + b"\xff\xe1" + struct.pack(">H", len(xmp) + 2) + xmp
            + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
            + data[2:])


def png_with_orientation(data, orientation):
    tag, body = b"eXIf", tiff_orientation(orientation, False)
    chunk = (struct.pack(">I", len(body)) + tag + body
             + struct.pack(">I", zlib.crc32(tag + body)))
    at = data.find(b"IDAT") - 4
    return data[:at] + chunk + data[at:]


def _expect_reads(path):
    for read, fn in (("unchanged", tllff.imread), ("color", tllff.imread_rgb8),
                     ("gray", tllff.imread_gray8)):
        want = cv2_read(path.read_bytes(), read)
        got = fn(path)
        assert got.shape == want.shape, (path.name, read)
        np.testing.assert_array_equal(got, want, err_msg=f"{path} {read}")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_jpeg(tmp_path, orientation):
    """C4 on JPEG: the unchanged read stays unrotated, the colour and gray
    reads turn the image as cv2's do (an XMP APP1 before the Exif one, and
    both byte orders)."""
    for k, (sampling, le) in enumerate((("420", True), ("444", False))):
        data = encode(smooth_noisy(13, 21, 3, orientation), sampling=sampling)
        path = tmp_path / f"o{k}.JPG"
        path.write_bytes(jpeg_with_orientation(data, orientation, le))
        assert jpeg.exif_orientation(path.read_bytes()) == orientation
        _expect_reads(path)
        if orientation >= 5:
            assert tllff.imread_rgb8(path).shape == (21, 13, 3)
            assert tllff.imread(path).shape == (13, 21, 3)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_png(tmp_path, orientation):
    """C4 on PNG (an `eXIf` chunk): a colour PNG and a gray one. The colour
    image's channels are equal, so that its gray read is exact (cv2's PNG
    reader rounds some colour pixels 1 away from cvtColor's luma, as
    `llff.imread_gray8` says)."""
    gray = smooth_noisy(9, 5, 1, orientation)
    for name, img in (("rgb.png", np.repeat(gray[..., None], 3, -1)),
                      ("gray.png", gray)):
        write_png(tmp_path / name, img)
        data = png_with_orientation((tmp_path / name).read_bytes(),
                                    orientation)
        (tmp_path / name).write_bytes(data)
        _expect_reads(tmp_path / name)


def _refusals():
    base = encode(smooth_noisy(16, 24, 3, 5), sampling="420")
    sof = base.find(b"\xff\xc0")
    out = {}
    for marker, what in ((0xC3, "SOF3"), (0xC5, "SOF5"), (0xC6, "SOF6"),
                         (0xC7, "SOF7"), (0xC9, "SOF9"), (0xCA, "SOF10"),
                         (0xCB, "SOF11"), (0xCD, "SOF13"), (0xCE, "SOF14"),
                         (0xCF, "SOF15")):
        out[what] = base[:sof + 1] + bytes([marker]) + base[sof + 2:]
    dac = b"\xff\xcc\x00\x04\x01\x11"
    out["DAC"] = base[:sof] + dac + base[sof:]
    out["DHP"] = base[:sof] + b"\xff\xde\x00\x02" + base[sof:]
    out["12-bit"] = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    for n in (2, 4):     # a frame header with n components
        comps = b"".join(bytes([i + 1, 0x11, 0]) for i in range(n))
        hdr = (b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * n, 8, 16, 24, n)
               + comps)
        out[f"{n} components"] = b"\xff\xd8" + hdr + b"\xff\xd9"
    return out


REFUSALS = _refusals()
# arithmetic decoding reads these as cv2 does (SOF9: Huffman data through
# the QM decoder; DAC: conditioning that a Huffman scan ignores)
DECODED = ("SOF9", "DAC")


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_refused_streams_raise_naming_the_file(tmp_path, what):
    """Each refused format raises ValueError naming the file, and the marker
    where there is one; every read of `llff` raises the same. The streams
    the decoder has read since arithmetic coding came (DECODED) read to
    cv2's pixels in every read, from disk and from memory."""
    path = tmp_path / "refused.jpeg"
    path.write_bytes(REFUSALS[what])
    if what in DECODED:
        for read, flag in (("unchanged", cv2.IMREAD_UNCHANGED),
                           ("color", cv2.IMREAD_COLOR),
                           ("gray", cv2.IMREAD_GRAYSCALE)):
            for source in ("file", "buffer"):
                want = (cv2.imread(str(path), flag) if source == "file" else
                        cv2.imdecode(np.frombuffer(REFUSALS[what],
                                                   np.uint8), flag))
                got = jpeg.decode(REFUSALS[what], name=path, mode=read,
                                  source=source)
                np.testing.assert_array_equal(
                    got, want[..., ::-1] if want.ndim == 3 else want)
        return
    marker = what.split()[0] if what.startswith(("SOF", "DAC", "DHP")) \
        else ""
    for fn in (tllff.imread, tllff.imread_rgb8, tllff.imread_gray8):
        with pytest.raises(ValueError, match=f"refused.jpeg.*{marker}"):
            fn(path)


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def test_fixtures_match_expected():
    """Every committed fixture: cv2's decode still gives the recorded shape
    and hash (or None) in each read from disk (`cv2.imread`) and from memory
    (`cv2.imdecode`), and so does the port's: `llff.imread`, `imread_rgb8`
    and `imread_gray8` (which read as cv2.imread does and apply the EXIF
    orientation as cv2's colour and gray reads do) and `jpeg.decode` of the
    bytes."""
    expected = json.loads((FIXTURES / "expected.json").read_text())["files"]
    files = sorted(p.relative_to(FIXTURES).as_posix()
                   for p in FIXTURES.rglob("*.jpg"))
    assert files == sorted(expected) and len(files) == 42
    for name, sources in expected.items():
        path = FIXTURES / name
        data = path.read_bytes()
        orientation = jpeg.exif_orientation(data)
        for read, fn in (("unchanged", tllff.imread),
                         ("color", tllff.imread_rgb8),
                         ("gray", tllff.imread_gray8)):
            for source, want in ((s, sources[s][read])
                                 for s in ("file", "buffer")):
                ref = (cv2.imread(str(path), READS[read]) if source == "file"
                       else cv2.imdecode(np.frombuffer(data, np.uint8),
                                         READS[read]))
                if ref is not None and ref.ndim == 3:
                    ref = ref[..., ::-1]
                assert (None if ref is None else
                        {"shape": list(ref.shape), "sha256": _sha(ref)}) \
                    == want, (name, source, read)
                try:
                    got = (fn(path) if source == "file" else jpeg.orient(
                        jpeg.decode(data, name=name, mode=read),
                        1 if read == "unchanged" else orientation))
                except ValueError:
                    got = None
                assert (None if got is None else
                        {"shape": list(got.shape), "sha256": _sha(got)}) \
                    == want, (name, source, read)
        assert orientation == {"exif_6.jpg": 6,
                               "exif_8.jpg": 8}.get(name, 1)


@pytest.fixture
def no_cv2(monkeypatch):
    def block():
        monkeypatch.setitem(sys.modules, "cv2", None)
    return block


def test_without_cv2_equals_jax(tmp_path, no_cv2):
    """With cv2 unimportable: `llff.imread` of the committed scene's views
    equals cv2's unchanged read; `load_scene` of the scene at factor 2
    (`minify` of the JPEG originals) equals JAX's with cv2; `_decode` of
    JPEG shard members (EXIF-tagged, progressive, gray, not a JPEG) equals
    JAX's `shards._decode`."""
    views = sorted((FIXTURES / "scene" / "images").glob("*.jpg"))
    want_views = [cv2.imread(str(p), cv2.IMREAD_UNCHANGED)[..., ::-1]
                  for p in views]
    for sub in ("jax", "torch"):
        shutil.copytree(FIXTURES / "scene", tmp_path / sub)
    want = jllff.load_scene(tmp_path / "jax", factor=2, prepare=True)
    members = {p.name: p.read_bytes() for p in (
        FIXTURES / "exif_6.jpg", FIXTURES / "progressive_420.jpg",
        FIXTURES / "gray.jpg", FIXTURES / "size_1x1.jpg")}
    members["not_a.jpg"] = b"\x89PNG not an image"
    want_members = {n: jshards._decode(n, d) for n, d in members.items()}

    no_cv2()
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401
    for p, ref in zip(views, want_views):
        np.testing.assert_array_equal(tllff.imread(p), ref)
    got = tllff.load_scene(tmp_path / "torch", factor=2, prepare=True)
    assert got.images.shape == (12, 252, 336, 3)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.bounds, want.bounds, rtol=0, atol=1e-6)
    assert got.hwf == want.hwf and got.i_holdout == want.i_holdout
    for name in sorted((tmp_path / "jax" / "images_2").glob("*.png")):
        np.testing.assert_array_equal(
            tllff.imread(tmp_path / "torch" / "images_2" / name.name),
            tllff.imread(name))
    for name, data in members.items():
        got_m = tshards._decode(name, data)
        if want_members[name] is None:
            assert got_m is None, name
        else:
            np.testing.assert_array_equal(got_m, want_members[name],
                                          err_msg=name)
