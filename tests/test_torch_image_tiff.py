"""TIFF read without cv2 (`spinnerf_tpu_torch/data/tiff.py`, its codecs in
`native/image_native.cpp` and `native/jpeg_native.cpp`) against cv2 5.0's
libtiff 4.7.1 and the JAX package.

- 30 seeded files of each feature (strip or tile sizes, byte order,
  compression, predictor, subsampling and bit depth drawn from a
  RandomState): JPEG-compressed strips and tiles (YCbCr at 4:4:4, 4:2:2
  and 4:2:0, RGB, gray and CMYK coded as they are, with and without
  JPEGTables, last strips that run past the image), uncompressed YCbCr at
  each subsampling libtiff enumerates (ReferenceBlackWhite and
  YCbCrCoefficients too), CMYK, 1-, 2- and 4-bit samples, FillOrder 2,
  the floating-point predictor, old-style LZW, BigTIFF, 16-bit planar,
  mirrored tiles, 16-bit gray tiles, 16-bit unassociated alpha,
  uncompressed tiles, CCITT RLE / Group 3 / Group 4 and CIELab. Each
  file's unchanged, colour and gray reads under `cv2.imread` and
  `cv2.imdecode` equal cv2's here, or raise where cv2 gives None; the
  port refuses only the unchanged read of planar 16-bit samples (cv2
  returns memory it never wrote there).
- The same features cut short, with bits flipped in a strip or with a
  strip's byte count cut: equal to cv2's pixels or its None (a damaged
  CCITT strip, whose row-by-row recovery the port does not follow, is
  refused, naming that), and a corrupted JPEG strip decodes as libjpeg's
  recovery does.
- A 9-view LLFF scene of the new kinds under .jpg / .png loads to JAX's
  `load_scene` image stack bit for bit, and a shard of the new fixtures
  streams through `iter_shard_images` to JAX's images, with only the
  members JAX drops dropped; both equal the hashes recorded where the
  fixtures were made.
- Fixtures with bytes of their header or directory edited raise nothing
  but ValueError (cv2's None) where they do not read.
- In a process where cv2 cannot be imported, every TIFF fixture reads to
  the recorded hashes in each read and source.
"""
import hashlib
import json
import shutil
import struct
import subprocess
import sys
import tarfile
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from spinnerf_tpu.data import llff as jllff
from spinnerf_tpu.data import shards as jshards
from spinnerf_tpu_torch.data import imageio
from spinnerf_tpu_torch.data import llff as tllff
from spinnerf_tpu_torch.data import shards as tshards
from spinnerf_tpu_torch.data import tiff

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "images"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())
FLAGS = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "gray": cv2.IMREAD_GRAYSCALE}
# the port's refusals a file may meet where cv2 reads it
ALLOWED = ("unwritten", "damaged CCITT", "uncompressed tile")

sys.path.insert(0, str(ROOT / "tests" / "data"))
import image_writers as iw  # noqa: E402

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _cv2(data, source, read, tmp_path):
    if source == "file":
        path = tmp_path / "x.tif"
        path.write_bytes(data)
        img = cv2.imread(str(path), FLAGS[read])
    else:
        img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS[read])
    return None if img is None else imageio._bgr_to_rgb(img)


def _same(data, tmp_path, tag):
    """The port's six reads equal cv2's (or both give none); returns the
    reads the port refused that cv2 gave, each for an ALLOWED reason."""
    refused = 0
    for source in ("file", "buffer"):
        for read in FLAGS:
            want = _cv2(data, source, read, tmp_path)
            try:
                got = imageio.read(data, mode=read, source=source, name=tag)
            except ValueError as e:
                assert tag in str(e)
                if want is not None:
                    assert any(a in str(e) for a in ALLOWED), (
                        tag, source, read, str(e))
                    refused += 1
                continue
            assert want is not None, (tag, source, read)
            assert (got.dtype, got.shape) == (want.dtype, want.shape), (
                tag, source, read)
            assert np.array_equal(got, want, equal_nan=True), (
                tag, source, read)
    return refused


def _strips(rs, h):
    return dict(rows_per_strip=int(rs.randint(1, h + 1)))


def _tiles(rs):
    return dict(tile=(16 * int(rs.randint(1, 3)), 16 * int(rs.randint(1, 3))))


def _jpeg(rs, h, w, kw):
    ph = int(rs.choice([6, 6, 2, 1, 5]))
    a = rs.randint(0, 256, (h, w, {6: 3, 2: 3, 1: 1, 5: 4}[ph])).astype(
        np.uint8)
    a[:h // 2] = a[0, 0]
    ss = (tuple(int(v) for v in rs.choice(["11", "21", "22"]))
          if ph == 6 else (1, 1))
    kw.update(compression=7, photometric=ph,
              jpeg_quality=int(rs.randint(30, 100)),
              jpeg_tables=bool(rs.rand() < 0.8))
    if ss != (1, 1):
        kw["subsampling"] = ss
    elif ph == 6 and rs.rand() < 0.5:
        kw["extra_tags"] = [(530, 3, [1, 1])]
    if rs.rand() < 0.4:
        kw.update(_tiles(rs))
    else:
        rps = 8 * ss[1] * int(rs.randint(1, 4))
        kw["rows_per_strip"] = rps
        if rs.rand() < 0.5:
            kw["jpeg_rows"] = rps
    return iw.tiff(a, **kw)


def _ycbcr(rs, h, w, kw):
    ss = tuple(int(v) for v in rs.choice(["11", "12", "21", "22", "41",
                                           "42", "44"]))
    tags = []
    if rs.rand() < 0.3:
        tags.append((532, 5, [float(rs.randint(0, 40)), 255.0, 128.0, 255.0,
                              128.0, 255.0]))
    if rs.rand() < 0.3:
        tags.append((529, 5, [0.2126, 0.7152, 0.0722]))
    kw.update(photometric=6, subsampling=ss,
              compression=int(rs.choice([1, 5, 8, 32773])),
              subsampling_tag=not (ss == (2, 2) and rs.rand() < 0.5),
              extra_tags=tags,
              rows_per_strip=ss[1] * int(rs.randint(1, max(2, h // ss[1] + 1))))
    return iw.tiff(rs.randint(0, 256, (h, w, 3)).astype(np.uint8), **kw)


def _cmyk(rs, h, w, kw):
    comp = int(rs.choice([1, 5, 8, 32773]))
    kw.update(photometric=5, compression=comp, planar=int(rs.choice([1, 2])),
              predictor=int(rs.choice([1, 2])) if comp in (5, 8) else 1)
    kw.update(_tiles(rs) if rs.rand() < 0.3 and comp != 1 else
              _strips(rs, h))
    return iw.tiff(rs.randint(0, 256, (h, w, 4)).astype(np.uint8), **kw)


def _bits(rs, h, w, kw):
    bits, ph = [(1, 0), (1, 1), (1, 3), (4, 3), (2, 1), (4, 1)][
        int(rs.randint(6))]
    kw.update(bits=bits, photometric=ph, fillorder=int(rs.choice([1, 2])),
              compression=int(rs.choice([1, 5, 8, 32773])), **_strips(rs, h))
    if ph == 3:
        kw["colormap"] = rs.randint(0, 256, (1 << bits, 3)) * int(
            rs.choice([1, 257]))
    return iw.tiff(rs.randint(0, 1 << bits, (h, w)).astype(np.uint8), **kw)


def _samples(rs, h, w, spp, dtypes=(np.uint8, np.uint16)):
    dt = dtypes[int(rs.randint(len(dtypes)))]
    return rs.randint(0, np.iinfo(dt).max + 1, (h, w, spp)).astype(dt)


def _fillorder(rs, h, w, kw):
    spp = int(rs.choice([1, 3, 4]))
    kw.update(fillorder=2, compression=int(rs.choice([1, 5, 8, 32773])),
              predictor=int(rs.choice([1, 2])), **_strips(rs, h))
    if spp == 4:
        kw["extrasamples"] = [int(rs.choice([1, 2]))]
    return iw.tiff(_samples(rs, h, w, spp), **kw)


def _pred3(rs, h, w, kw):
    a = (rs.randn(h, w, int(rs.choice([1, 3]))) * 10.0 ** rs.randint(-3, 4)
         ).astype(np.float32)
    kw.update(sampleformat=3, predictor=3, compression=int(rs.choice([5, 8])))
    kw.update(_tiles(rs) if rs.rand() < 0.3 else _strips(rs, h))
    return iw.tiff(a, **kw)


def _old_lzw(rs, h, w, kw):
    a = rs.randint(0, 50, (h, w, int(rs.choice([1, 3]))))
    kw.update(compression=5, old_lzw=True, predictor=int(rs.choice([1, 2])),
              **_strips(rs, h))
    return iw.tiff(a.astype([np.uint8, np.uint16][int(rs.randint(2))]), **kw)


def _bigtiff(rs, h, w, kw):
    spp = int(rs.choice([1, 3, 4]))
    comp = int(rs.choice([1, 5, 8, 32773]))
    kw.update(bigtiff=True, compression=comp,
              predictor=int(rs.choice([1, 2])) if comp in (5, 8) else 1)
    if spp == 4:
        kw["extrasamples"] = [int(rs.choice([1, 2]))]
    kw.update(_tiles(rs) if rs.rand() < 0.3 and comp != 1 else
              _strips(rs, h))
    return iw.tiff(_samples(rs, h, w, spp), **kw)


def _planar16(rs, h, w, kw):
    spp = int(rs.choice([2, 3, 4]))
    kw.update(planar=2, compression=int(rs.choice([1, 5, 8, 32773])),
              **_strips(rs, h))
    if spp in (2, 4):
        kw["extrasamples"] = [int(rs.choice([0, 1, 2]))]
    return iw.tiff(_samples(rs, h, w, spp, (np.uint16,)), **kw)


def _mirrored_tiles(rs, h, w, kw):
    spp = int(rs.choice([1, 3, 4]))
    kw.update(orientation=int(rs.choice([2, 3, 6, 7])),
              compression=int(rs.choice([5, 8])),
              tile=(16, 16 * int(rs.randint(1, 3))))
    if spp == 4:
        kw["extrasamples"] = [int(rs.choice([1, 2]))]
    return iw.tiff(_samples(rs, h, w, spp), **kw)


def _gray16_tiles(rs, h, w, kw):
    kw.update(photometric=int(rs.choice([0, 1])),
              compression=int(rs.choice([5, 8])), tile=(16, 32))
    return iw.tiff(_samples(rs, h, w, 1, (np.uint16,)), **kw)


def _rgba16_unassoc(rs, h, w, kw):
    comp = int(rs.choice([1, 5, 8, 32773]))
    kw.update(extrasamples=[2], compression=comp)
    kw.update(_tiles(rs) if rs.rand() < 0.3 and comp != 1 else
              _strips(rs, h))
    return iw.tiff(_samples(rs, h, w, 4, (np.uint16,)), **kw)


def _uncompressed_tiles(rs, h, w, kw):
    spp = int(rs.choice([1, 2, 3, 4]))
    kw.update(tile=(16 * int(rs.randint(1, 4)), 16 * int(rs.randint(1, 4))),
              fillorder=int(rs.choice([1, 1, 2])),
              orientation=int(rs.randint(1, 9)))
    if spp in (2, 4):
        kw["extrasamples"] = [int(rs.choice([0, 1, 2]))]
    return iw.tiff(_samples(rs, h, w, spp), **kw)


def _ccitt(rs, h, w, kw):
    bw = (rs.rand(h, w) < rs.rand()).astype(np.uint8)
    if rs.rand() < 0.5:
        bw[:, :w // 2] = bw[0, 0]
    comp = int(rs.choice([2, 3, 3, 4]))
    kw.update(bits=1, compression=comp, photometric=int(rs.choice([0, 1])),
              fillorder=int(rs.choice([1, 2])),
              fax_2d=bool(comp == 3 and rs.rand() < 0.6))
    kw.update(_tiles(rs) if rs.rand() < 0.25 else _strips(rs, h))
    return iw.tiff(bw, **kw)


def _cielab(rs, h, w, kw):
    kw.update(photometric=8, compression=int(rs.choice([1, 5, 8])))
    if rs.rand() < 0.3:
        kw["extra_tags"] = [(318, 5, [float(rs.uniform(0.2, 0.4)),
                                      float(rs.uniform(0.2, 0.4))])]
    kw.update(_tiles(rs) if rs.rand() < 0.3 and kw["compression"] != 1
              else _strips(rs, h))
    if rs.rand() < 0.2:
        kw["planar"] = 2   # libtiff's RGBA reader refuses it: cv2 None
    return iw.tiff(_samples(rs, h, w, 3), **kw)


WRITERS = {"jpeg": _jpeg, "ycbcr": _ycbcr, "cmyk": _cmyk, "bits": _bits,
           "fillorder": _fillorder, "pred3": _pred3, "old_lzw": _old_lzw,
           "bigtiff": _bigtiff, "planar16": _planar16,
           "mirrored_tiles": _mirrored_tiles, "gray16_tiles": _gray16_tiles,
           "rgba16_unassoc": _rgba16_unassoc,
           "uncompressed_tiles": _uncompressed_tiles, "ccitt": _ccitt,
           "cielab": _cielab}


def _random_tiff(feature, rs):
    h, w = (int(v) for v in rs.randint(1, 40, 2))
    # the IFD first in some files, so that a cut takes strips, not the IFD
    return WRITERS[feature](rs, h, w, dict(order=str(rs.choice(["<", ">"])),
                                           ifd_first=bool(rs.rand() < 0.3)))


@pytest.mark.parametrize("feature", sorted(WRITERS))
def test_random_tiffs_equal_cv2(feature, tmp_path):
    """30 seeded files: three reads, two sources, each equal to cv2's."""
    rs = np.random.RandomState(zlib.crc32(feature.encode()) % 1000)
    refused = sum(_same(_random_tiff(feature, rs), tmp_path, f"{feature}{k}")
                  for k in range(30))
    # only the unchanged reads of planar 16-bit RGB(A) are refused
    assert (refused > 0) == (feature == "planar16")


def _count_entry(data, tag):
    """Where the values of `tag` (StripByteCounts / TileByteCounts) lie in
    a classic or BigTIFF file: byte order, offset and struct format."""
    order = "<" if data[:2] == b"II" else ">"
    big = struct.unpack(order + "H", data[2:4])[0] == 43
    word = "Q" if big else "I"
    inline = struct.calcsize(word)
    (ifd,) = struct.unpack(order + word, data[4 + 4 * big:8 + 8 * big])
    head = 8 if big else 2
    (n,) = struct.unpack(order + ("Q" if big else "H"), data[ifd:ifd + head])
    for e in range(ifd + head, ifd + head + (4 + 2 * inline) * n,
                   4 + 2 * inline):
        t, typ = struct.unpack(order + "HH", data[e:e + 4])
        (count,) = struct.unpack(order + word, data[e + 4:e + 4 + inline])
        if t == tag:
            fmt = {3: "H", 4: "I", 16: "Q"}[typ]
            at = e + 4 + inline
            if count * struct.calcsize(fmt) > inline:
                (at,) = struct.unpack(order + word, data[at:at + inline])
            return order, at, fmt
    raise AssertionError(f"no tag {tag}")


def _damaged(data, rs):
    """`data` cut short, with 1-3 bits flipped in one strip or tile, or
    with one strip's byte count cut."""
    t = tiff._Tiff(data, "x")
    kind = str(rs.choice(["cut", "flip", "count"]))
    if kind == "cut":
        return data[:int(rs.randint(8, len(data)))], kind
    k = int(rs.randint(len(t.offsets)))
    edit = bytearray(data)
    if kind == "flip":
        for _ in range(int(rs.randint(1, 4))):
            p = t.offsets[k] + int(rs.randint(max(t.counts[k], 1)))
            edit[p] ^= 1 << int(rs.randint(8))
        return bytes(edit), kind
    order, at, fmt = _count_entry(data, 325 if t.tiled else 279)
    at += struct.calcsize(fmt) * k
    old = struct.unpack(order + fmt, data[at:at + struct.calcsize(fmt)])[0]
    struct.pack_into(order + fmt, edit, at, int(rs.randint(0, max(old, 1))))
    return bytes(edit), kind


@pytest.mark.parametrize("feature", sorted(WRITERS))
def test_damaged_tiffs_equal_cv2(feature, tmp_path):
    """25 seeded files of each feature, damaged: the port gives cv2's
    pixels where libtiff recovers them and raises where cv2 gives None."""
    rs = np.random.RandomState(zlib.crc32(feature.encode()) % 1000 + 7)
    for k in range(25):
        data, kind = _damaged(_random_tiff(feature, rs), rs)
        _same(data, tmp_path, f"{feature}{k} {kind}")


def test_corrupted_jpeg_strips_recover_as_libjpeg(tmp_path):
    """A JPEG strip's entropy-coded data with bytes flipped: libjpeg's
    warnings and its recovery, as libtiff leaves them (30 files)."""
    rs = np.random.RandomState(11)
    for k in range(30):
        data = _jpeg(rs, int(rs.randint(16, 40)), int(rs.randint(16, 40)),
                     {})
        t = tiff._Tiff(data, "x")
        j = int(rs.randint(len(t.offsets)))
        edit = bytearray(data)
        for _ in range(int(rs.randint(1, 6))):
            p = t.offsets[j] + int(rs.randint(t.counts[j]))
            edit[p] ^= 1 << int(rs.randint(8))
        _same(bytes(edit), tmp_path, f"jpeg{k}")


def test_edited_headers_raise_only_valueerror():
    """200 TIFF fixtures with 1-2 bytes of their header or directory
    changed (sizes, types, counts, offsets out of all proportion): each
    read gives pixels or raises ValueError / FileNotFoundError as cv2's
    None; none raises anything else or allocates past cv2's image and
    tile limits."""
    names = sorted(n for n in EXPECTED["files"] if n.startswith("tiff_"))
    rs = np.random.RandomState(12)
    for k in range(200):
        data = bytearray((FIXTURES / names[k % len(names)]).read_bytes())
        for _ in range(int(rs.randint(1, 3))):
            # the writers put the directory last, PIL's and cv2's first
            p = (len(data) - 1 - int(rs.randint(min(len(data), 300)))
                 if rs.rand() < 0.6 else int(rs.randint(min(len(data), 200))))
            data[p] = int(rs.randint(256))
        for source in ("file", "buffer"):
            for read in FLAGS:
                try:
                    imageio.read(bytes(data), mode=read, source=source,
                                 name=f"h{k}")
                except (ValueError, FileNotFoundError):
                    pass


def test_no_codec_and_not_yet_name_their_reason():
    """LZMA / Zstd / WebP strips: cv2's libtiff has no codec and gives
    None, which the port says; LogLuv, which cv2 reads, the port refuses
    naming the tag and ROADMAP F2."""
    for name in ("tiff_lzma.tif", "tiff_zstd.tif", "tiff_webp.tif"):
        with pytest.raises(ValueError, match=f"{name}: cv2 gives None .*"
                                             f"no such codec"):
            imageio.read((FIXTURES / name).read_bytes(), name=name)
    with pytest.raises(ValueError, match=r"Compression tag \(259\) value "
                                         r"34676 .*ROADMAP F2"):
        imageio.read((FIXTURES / "tiff_logluv.tif").read_bytes(), name="l")
    assert EXPECTED["files"]["tiff_logluv.tif"]["port"] == "refused"
    assert EXPECTED["files"]["tiff_logluv.tif"]["buffer"]["color"]


def test_scene_tiff_loads_as_jax(tmp_path):
    """The committed 9-view scene of the new TIFF kinds (each named .jpg or
    .png) loads to JAX's stack bit for bit and to the recorded hash; each
    view's reads equal JAX's imread_float and cv2's colour and gray
    reads."""
    for sub in ("jax", "torch"):
        shutil.copytree(FIXTURES / "scene_tiff", tmp_path / sub)
    want = jllff.load_scene(tmp_path / "jax", factor=1, prepare=True)
    got = tllff.load_scene(tmp_path / "torch", factor=1, prepare=True)
    np.testing.assert_array_equal(got.images, want.images)
    assert ([list(got.images.shape), _sha(got.images)]
            == [EXPECTED["scene_tiff"]["images_shape"],
                EXPECTED["scene_tiff"]["images_sha256"]])
    views = sorted((tmp_path / "torch" / "images").iterdir())
    assert {imageio.sniff(p.read_bytes()) for p in views} == {"tiff"}
    for p in views:
        np.testing.assert_array_equal(tllff.imread_float(p),
                                      jllff.imread_float(p), err_msg=p.name)
        for read, fn in (("color", tllff.imread_rgb8),
                         ("gray", tllff.imread_gray8)):
            want = _cv2(p.read_bytes(), "file", read, tmp_path)
            if want is None:   # the colour read of a float view
                with pytest.raises(ValueError):
                    fn(p)
                continue
            np.testing.assert_array_equal(fn(p), want, err_msg=(p.name, read))


def test_shard_tiff_streams_as_jax(tmp_path):
    """A tar of new TIFF fixtures, each named .png or .jpg, streams to
    JAX's images in JAX's order and to the hashes recorded from JAX's
    stream; the port drops a member exactly where JAX does."""
    rec = EXPECTED["shard_tiff"]
    tar = tmp_path / "tiff.tar"
    with tarfile.open(tar, "w") as tf:
        for name, member in rec["members"]:
            tf.add(FIXTURES / name, arcname=member)
    kw = dict(shuffle_buffer=4, loop=False)
    want = [_sha(x) for x in jshards.iter_shard_images(
        [tar], rng=np.random.RandomState(6), **kw)]
    got = [_sha(x) for x in tshards.iter_shard_images(
        [tar], rng=np.random.RandomState(6), **kw)]
    assert got == want == rec["sha256"]
    dropped = 0
    for name, member in rec["members"]:
        data = (FIXTURES / name).read_bytes()
        j, t = jshards._decode(member, data), tshards._decode(member, data)
        assert (j is None) == (t is None), name
        dropped += j is None
        if j is not None:
            np.testing.assert_array_equal(t, j, err_msg=name)
    # the float view, LZMA and the uncompressed tiles cv2.imdecode refuses
    assert dropped == 3 and len(got) == len(rec["members"]) - 3


def test_tiff_fixtures_without_cv2():
    """In a process where `import cv2` fails, every TIFF fixture reads to
    the recorded hashes in each read and source, or raises ValueError
    where cv2 gave None, the port refuses the file or the read is
    unwritten."""
    names = sorted(n for n in EXPECTED["files"] if n.startswith("tiff_"))
    code = f"""
import hashlib, json, sys
sys.modules["cv2"] = None
import numpy as np
from spinnerf_tpu_torch.data import imageio
fx = {str(FIXTURES)!r}
files = json.load(open(fx + "/expected.json"))["files"]
n = 0
for name in {names!r}:
    e = files[name]
    data = open(fx + "/" + name, "rb").read()
    for source in ("file", "buffer"):
        for read in ("unchanged", "color", "gray"):
            want = e[source][read]
            try:
                img = imageio.read(data, mode=read, source=source, name=name)
            except ValueError as err:
                assert (e["port"] == "refused" or want is None
                        or want.get("unwritten")), (name, source, read, err)
                continue
            got = {{"shape": list(img.shape), "dtype": str(img.dtype),
                   "sha256": hashlib.sha256(
                       np.ascontiguousarray(img).tobytes()).hexdigest()}}
            assert e["port"] == "equal" and got == want, (name, source, read)
            n += 1
assert "cv2" not in [k for k, v in sys.modules.items() if v is not None]
print(n)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout) > 400
