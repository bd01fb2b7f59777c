"""JPEG 2000 read without cv2 (`spinnerf_tpu_torch/data/jpeg2000.py`, its
decoder in `native/j2k_native.cpp`) against cv2 5.0's OpenJPEG 2.5.3 and
the JAX package.

- Seeded files of each feature, written by PIL (OpenJPEG 2.5.4's encoder:
  lossless and lossy, 1-7 resolutions, code-block and precinct sizes,
  tiles, layers, each progression order, MCT on and off, PLT, J2K and JP2,
  gray / RGB / RGBA / gray + alpha at 8 and 16 bits) and by
  `image_writers.j2k` (what neither PIL nor cv2 writes: the six code-block
  styles, SOP / EPH, POC, PPM / PPT, RGN, tiles and tile-parts with Psot
  0 and TNsot 0, image and tile offsets, sub-sampled components, 2 and 5
  components, signed samples, 4- to 20-bit samples, MCT, JP2 colour
  spaces, palettes and channel definitions). Each file's unchanged,
  colour and gray reads under `cv2.imread` and `cv2.imdecode` equal cv2's
  here, or raise ValueError where cv2 gives None.
- The same files cut short (anywhere, or at a marker, with or without an
  EOC after), with bits flipped or bytes changed in the headers or the
  packet data: equal to cv2's pixels or its None; and the end of a stream
  after each tile-part, which OpenJPEG reads as the end only in one
  layout.
- Fixtures with header bytes edited raise nothing but ValueError.
- HTJ2K code-blocks are refused, naming HTJ2K and ROADMAP F2.
- The 12-view `scene_j2k` loads to JAX's `load_scene(factor=2)` stack bit
  for bit and to the recorded hash; a shard of JPEG 2000 fixtures streams
  through `iter_shard_images` to JAX's images.
- In a process where cv2 cannot be imported, every JPEG 2000 fixture reads
  to the recorded hashes in each read and source.
"""
import hashlib
import io
import json
import shutil
import struct
import subprocess
import sys
import tarfile
import warnings
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from spinnerf_tpu.data import llff as jllff
from spinnerf_tpu.data import shards as jshards
from spinnerf_tpu_torch.data import imageio
from spinnerf_tpu_torch.data import llff as tllff
from spinnerf_tpu_torch.data import shards as tshards

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "images"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())
J2K_FILES = sorted(n for n in EXPECTED["files"]
                   if imageio.sniff((FIXTURES / n).read_bytes()) == "jpeg2000")
FLAGS = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "gray": cv2.IMREAD_GRAYSCALE}

sys.path.insert(0, str(ROOT / "tests" / "data"))
import image_writers as iw  # noqa: E402

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _cv2(data, source, read, tmp_path):
    try:
        if source == "file":
            path = tmp_path / "x.jp2"
            path.write_bytes(data)
            img = cv2.imread(str(path), FLAGS[read])
        else:
            img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS[read])
    except cv2.error:   # validateInputImageSize raises past its limits
        return None
    return None if img is None else imageio._bgr_to_rgb(img)


def _same(data, tmp_path, tag):
    """The port's six reads equal cv2's, or both give none (the port
    raises); returns the number of reads that gave pixels."""
    n = 0
    for source in ("file", "buffer"):
        for read in FLAGS:
            want = _cv2(data, source, read, tmp_path)
            try:
                got = imageio.read(data, mode=read, source=source, name=tag)
            except (ValueError, FileNotFoundError) as e:   # cut too short
                assert tag in str(e)                       # to sniff
                assert want is None, (tag, source, read, str(e))
                continue
            assert want is not None, (tag, source, read)
            assert (got.dtype, got.shape) == (want.dtype, want.shape), (
                tag, source, read)
            assert np.array_equal(got, want), (tag, source, read)
            n += 1
    return n


# ----------------------------------------------------------- seeded files

def _pil(rs):
    """A PIL file of random size, samples and encoder parameters."""
    h, w = (int(v) for v in rs.randint(1, 49, 2))
    kind = str(rs.choice(["L", "RGB", "RGBA", "LA", "I;16"]))
    nch = {"L": 1, "RGB": 3, "RGBA": 4, "LA": 2, "I;16": 1}[kind]
    if kind == "I;16":
        a = rs.randint(0, 65536, (h, w)).astype(np.uint16)
    else:
        a = rs.randint(0, 256, (h, w, nch)).astype(np.uint8)
        if rs.rand() < 0.5:
            a = (np.mgrid[0:h, 0:w].sum(0)[..., None] * np.arange(1, nch + 1)
                 * 5 % 256).astype(np.uint8)
        a = a[..., 0] if nch == 1 else a
    kw = {}
    maxres = max(1, min(7, int(np.log2(max(1, min(h, w)))) + 1))
    nres = int(rs.randint(1, maxres + 1))
    kw["num_resolutions"] = nres
    if rs.rand() < 0.4:
        cw, ch = int(2 ** rs.randint(2, 7)), int(2 ** rs.randint(2, 7))
        kw["codeblock_size"] = (cw, max(4, min(ch, 4096 // cw)))
    if rs.rand() < 0.3:
        kw["tile_size"] = (int(rs.randint(max(8, 2 ** (nres - 1)), 60)),
                           int(rs.randint(max(8, 2 ** (nres - 1)), 60)))
    if rs.rand() < 0.5:
        # libopenjp2's 9/7 encoder asserts on a 1-sample signal
        tw, th = kw.get("tile_size", (w, h))
        dims = [h, w, tw, th] + [v % t for v, t in ((w, tw), (h, th))
                                 if v % t]
        if min(dims) >> (nres - 1) >= 2:
            kw["irreversible"] = True
    if rs.rand() < 0.5:
        kw["quality_layers"] = sorted(
            (float(rs.uniform(2, 60)) for _ in range(rs.randint(1, 4))),
            reverse=True)
    kw["progression"] = str(rs.choice(["LRCP", "RLCP", "RPCL", "PCRL",
                                       "CPRL"]))
    if nch >= 3 and rs.rand() < 0.3:
        kw["mct"] = int(rs.randint(0, 2))
    kw["no_jp2"] = bool(rs.rand() < 0.3)
    kw["plt"] = bool(rs.rand() < 0.2)
    bio = io.BytesIO()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Image.fromarray(a, kind if kind in ("LA", "I;16") else None).save(
            bio, "JPEG2000", **kw)
    return bio.getvalue()


def _samples(rs, h, w, prec, signed, kw, nc):
    hi = 1 << prec
    out = []
    for c in range(nc):
        dx, dy = (kw.get("subsampling") or [(1, 1)] * nc)[c]
        ch, cw = -(-h // dy), -(-w // dx)
        a = (rs.randint(-hi // 2, hi // 2, (ch, cw)) if signed
             else rs.randint(0, hi, (ch, cw)))
        if rs.rand() < 0.5:
            a = (np.mgrid[0:ch, 0:cw].sum(0) * (c + 3) * max(1, hi // 64)
                 % hi - (hi // 2 if signed else 0))
        out.append(a)
    return out


def _writer(feature):
    """A seeded `image_writers.j2k` file of one feature."""
    def make(rs):
        h, w = (int(v) for v in rs.randint(1, 25, 2))
        nc, prec, signed = int(rs.choice([1, 1, 3, 3, 4])), 8, False
        kw = dict(levels=int(rs.randint(0, 4)),
                  cblk=(int(rs.randint(2, 6)), int(rs.randint(2, 6))),
                  progression=int(rs.randint(0, 5)),
                  layers=int(rs.randint(1, 4)))
        nr = kw["levels"] + 1
        if feature == "cblksty":
            kw["cblksty"] = int(rs.randint(0, 64))
        elif feature == "sop_eph":
            kw.update(sop=bool(rs.rand() < .7), eph=bool(rs.rand() < .7))
        elif feature == "poc":
            pocs = []
            for _ in range(int(rs.randint(1, 4))):
                r0, c0 = int(rs.randint(0, nr)), int(rs.randint(0, nc))
                pocs.append((r0, c0, int(rs.randint(1, kw["layers"] + 1)),
                             int(rs.randint(r0 + 1, nr + 2)),
                             int(rs.randint(c0 + 1, nc + 2)),
                             int(rs.randint(0, 5))))
            kw["pocs"] = pocs + [(0, 0, kw["layers"], nr, nc,
                                  int(rs.randint(0, 5)))]
        elif feature == "ppm_ppt":
            kw["ppm" if rs.rand() < .5 else "ppt"] = int(rs.randint(1, 3))
            if rs.rand() < .5:
                kw["tile"] = (int(rs.randint(4, 20)), int(rs.randint(4, 20)))
            kw.update(tile_parts=int(rs.randint(1, 4)),
                      sop=bool(rs.rand() < .3), eph=bool(rs.rand() < .3))
        elif feature == "rgn":
            x0, y0 = int(rs.randint(0, w)), int(rs.randint(0, h))
            kw["roi"] = (int(rs.randint(0, nc)), int(rs.randint(1, 12)),
                         (x0, y0, int(rs.randint(x0 + 1, w + 1)),
                          int(rs.randint(y0 + 1, h + 1))))
        elif feature == "precincts":
            kw["precincts"] = [(int(rs.randint(1 if r else 0, 6)),
                                int(rs.randint(1 if r else 0, 6)))
                               for r in range(nr)]
        elif feature == "tiles":
            kw.update(tile=(int(rs.randint(3, 20)), int(rs.randint(3, 20))),
                      tile_parts=int(rs.randint(1, 4)),
                      psot_zero=bool(rs.rand() < .3),
                      tnsot=bool(rs.rand() < .7))
            if rs.rand() < .3:   # cv2 gives None: the image is offset
                kw["offset"] = (int(rs.randint(0, 9)), int(rs.randint(0, 9)))
                kw["tile_offset"] = (int(rs.randint(0, kw["offset"][0] + 1)),
                                     int(rs.randint(0, kw["offset"][1] + 1)))
        elif feature == "subsampled":
            nc = int(rs.choice([2, 3]))
            kw["subsampling"] = [(1, 1), (2, int(rs.randint(1, 3)))] + [
                (int(rs.randint(1, 3)), int(rs.randint(1, 3)))
                for _ in range(nc - 2)]
        elif feature == "precision":
            nc = int(rs.choice([1, 2, 3, 4, 5]))
            prec = int(rs.choice([4, 7, 8, 9, 10, 12, 14, 16, 17, 20]))
            signed = bool(rs.rand() < .25)
        elif feature == "mct":
            nc = int(rs.choice([1, 3, 4]))
            kw["mct"] = nc >= 3 or rs.rand() < .3
        elif feature == "jp2":
            kw.update(jp2=True, colr=int(rs.choice([16, 17, 18, 12, 24, 14,
                                                    99])))
            if rs.rand() < .15:
                kw.update(icc=bytes(8), colr=None)
            if nc > 1 and rs.rand() < .4:
                perm = rs.permutation(nc)
                typ = [0] * nc
                if nc in (2, 4) and rs.rand() < .6:
                    typ[-1] = int(rs.choice([1, 2]))
                kw["cdef"] = [(int(perm[i]), typ[i],
                               0 if typ[i] else int(rs.randint(1, nc + 1)))
                              for i in range(nc)]
        elif feature == "palette":
            n, k = int(rs.randint(2, 40)), int(rs.choice([1, 3, 3, 4]))
            depths = [int(rs.choice([8, 8, 5, 12, 16])) for _ in range(k)]
            kw.update(jp2=True, colr=int(rs.choice([16, 17])),
                      pclr=(np.stack([rs.randint(0, 1 << d, n)
                                      for d in depths], -1), depths),
                      cmap=[(0, 1, i) for i in range(k)])
            if k >= 3 and rs.rand() < .3:
                kw["cdef"] = [(i, 0, i + 1) for i in range(k)][::-1]
            return iw.j2k([rs.randint(0, n + 2 * (rs.rand() < .2), (h, w))],
                          **kw)
        return iw.j2k(_samples(rs, h, w, prec, signed, kw, nc),
                      precision=prec, signed=signed, **kw)
    return make


WRITERS = {f: _writer(f) for f in (
    "cblksty", "sop_eph", "poc", "ppm_ppt", "rgn", "precincts", "tiles",
    "subsampled", "precision", "mct", "jp2", "palette")}
WRITERS["pil"] = _pil
COUNT = {"pil": 24}


@pytest.mark.parametrize("feature", sorted(WRITERS))
def test_random_files_equal_cv2(feature, tmp_path):
    """Seeded files of each feature: three reads, two sources, each equal
    to cv2's; most of them read (cv2 gives None for the features that are
    its refusals: sub-sampling, offsets, signed or < 8-bit samples)."""
    rs = np.random.RandomState(zlib.crc32(feature.encode()) % 1000)
    reads = sum(_same(WRITERS[feature](rs), tmp_path, f"{feature}{k}")
                for k in range(COUNT.get(feature, 16)))
    assert (reads == 0) == (feature == "subsampled")


def _damaged(data, rs):
    """`data` cut anywhere or at a marker (with or without an EOC after),
    or with 1-3 bits flipped or bytes replaced in its headers or data."""
    kind = str(rs.choice(["cut", "cut_marker", "flip_head", "flip_data",
                          "byte_head"]))
    if kind == "cut":
        return data[:int(rs.randint(1, len(data)))]
    if kind == "cut_marker":
        at = [i for i in range(len(data) - 1) if data[i] == 0xFF
              and data[i + 1] in (0x90, 0x93, 0xD9, 0x91, 0x92)]
        cut = data[:int(rs.choice(at))] if at else data[:len(data) // 2]
        return cut + (b"\xff\xd9" if rs.rand() < 0.5 else b"")
    soc, sod = data.find(b"\xff\x4f\xff\x51"), data.find(b"\xff\x93")
    lo, hi = ((max(soc, 0), max(sod, soc + 4)) if kind != "flip_data"
              else (sod + 2, len(data) - 2))
    if hi <= lo:
        return data[:len(data) // 2]
    edit = bytearray(data)
    for _ in range(int(rs.randint(1, 4))):
        p = int(rs.randint(lo, hi))
        if kind == "byte_head":
            edit[p] = int(rs.randint(256))
        else:
            edit[p] ^= 1 << int(rs.randint(8))
    return bytes(edit)


@pytest.mark.parametrize("feature", sorted(WRITERS))
def test_damaged_files_equal_cv2(feature, tmp_path):
    """Seeded files of each feature, damaged: the port gives cv2's pixels
    where OpenJPEG decodes what is left and raises where cv2 gives
    None."""
    rs = np.random.RandomState(zlib.crc32(feature.encode()) % 1000 + 7)
    for k in range(COUNT.get(feature, 16) + 8):
        _same(_damaged(WRITERS[feature](rs), rs), tmp_path, f"{feature}{k}")


def test_stream_ends_after_each_tile_part(tmp_path):
    """Tiled streams of 1-3 tile-parts a tile, TNsot given or 0, ended
    after each tile-part (no EOC), at its SOT or with 1-2 stray bytes:
    OpenJPEG reads the end as EOC only after a tile-part of the last tile
    with TNsot 0, and then decodes the tiles from the first one of a
    single tile-part on (the rest stay 0); the port does the same."""
    rs = np.random.RandomState(31)
    decoded = 0
    for k in range(24):
        g = rs.randint(0, 256, (int(rs.randint(5, 20)),
                                int(rs.randint(5, 20))))
        tile = (int(rs.randint(3, 12)), int(rs.randint(3, 12)))
        ntiles = -(-g.shape[1] // tile[0]) * -(-g.shape[0] // tile[1])
        data = iw.j2k([g], tile=tile, tnsot=bool(rs.rand() < .4),
                      tile_parts=[int(v) for v in rs.randint(1, 4, ntiles)])
        for i in range(len(data) - 1):
            if data[i:i + 2] != b"\xff\x90":
                continue
            end = i + struct.unpack(">I", data[i + 6:i + 10])[0]
            for cut in (data[:end], data[:end] + b"\x00", data[:i],
                        data[:end] + b"\x00\x00"):
                decoded += _same(cut, tmp_path, f"tp{k}") > 0
    assert decoded > 50


def test_edited_headers_raise_only_valueerror():
    """200 JPEG 2000 fixtures with 1-3 bytes of their boxes or main header
    changed: each read gives pixels or raises ValueError."""
    rs = np.random.RandomState(12)
    for k in range(200):
        data = bytearray((FIXTURES / J2K_FILES[k % len(J2K_FILES)])
                         .read_bytes())
        end = data.find(b"\xff\x90")
        for _ in range(int(rs.randint(1, 4))):
            data[int(rs.randint(0, max(end, 8)))] = int(rs.randint(256))
        for read in FLAGS:
            try:
                imageio.read(bytes(data), mode=read, name=f"h{k}")
            except (ValueError, FileNotFoundError):
                pass


def test_htj2k_is_refused_by_name():
    """A code-block style with the HT bit (Part 15): OpenJPEG decodes
    HTJ2K, the port refuses it, naming HTJ2K and ROADMAP F2."""
    data = bytearray((FIXTURES / "j2k_rgb.j2k").read_bytes())
    cod = data.find(b"\xff\x52")
    data[cod + 12] |= 0x40   # SPcod's code-block style
    for read in FLAGS:
        with pytest.raises(ValueError, match=r"HTJ2K .*ROADMAP F2"):
            imageio.read(bytes(data), mode=read, name="ht.j2k")


def test_fixture_reads_cover_the_features():
    """The recorded fixtures read in each way cv2 reads JPEG 2000: 8- and
    16-bit unchanged reads of 1, 3 and 4 channels, and each kind of None."""
    kinds = set()
    for name in J2K_FILES:
        e = EXPECTED["files"][name]
        assert e["port"] == "equal"
        for read in FLAGS:
            r = e["buffer"][read]
            kinds.add((read, None if r is None else (
                r["dtype"], 1 if len(r["shape"]) == 2 else r["shape"][2])))
    assert {("unchanged", ("uint8", 1)), ("unchanged", ("uint16", 1)),
            ("unchanged", ("uint8", 3)), ("unchanged", ("uint16", 3)),
            ("unchanged", ("uint8", 4)), ("unchanged", None),
            ("color", ("uint8", 3)), ("color", None), ("gray", ("uint8", 1)),
            ("gray", None)} <= kinds


def test_scene_j2k_loads_as_jax(tmp_path):
    """The committed 12-view scene of JPEG 2000 views (each named .jpg or
    .png, coded in 12 ways) loads at factor 2 to JAX's stack bit for bit
    and to the recorded hash; each view's colour read equals cv2's."""
    for sub in ("jax", "torch"):
        shutil.copytree(FIXTURES / "scene_j2k", tmp_path / sub)
    want = jllff.load_scene(tmp_path / "jax", factor=2, prepare=True)
    got = tllff.load_scene(tmp_path / "torch", factor=2, prepare=True)
    np.testing.assert_array_equal(got.images, want.images)
    assert ([list(got.images.shape), _sha(got.images)]
            == [EXPECTED["scene_j2k"]["images_shape"],
                EXPECTED["scene_j2k"]["images_sha256"]])
    views = sorted((FIXTURES / "scene_j2k" / "images").iterdir())
    assert {imageio.sniff(p.read_bytes()) for p in views} == {"jpeg2000"}
    for p in views:
        np.testing.assert_array_equal(tllff.imread_rgb8(p), _cv2(
            p.read_bytes(), "file", "color", tmp_path), err_msg=p.name)


def test_shard_j2k_streams_as_jax(tmp_path):
    """A tar of JPEG 2000 fixtures, each named .png or .jpg, streams to
    JAX's images in JAX's order and to the hashes recorded from JAX's
    stream; the port drops a member exactly where JAX does."""
    rec = EXPECTED["shard_j2k"]
    tar = tmp_path / "j2k.tar"
    with tarfile.open(tar, "w") as tf:
        for name, member in rec["members"]:
            tf.add(FIXTURES / name, arcname=member)
    kw = dict(shuffle_buffer=4, loop=False)
    want = [_sha(x) for x in jshards.iter_shard_images(
        [tar], rng=np.random.RandomState(7), **kw)]
    got = [_sha(x) for x in tshards.iter_shard_images(
        [tar], rng=np.random.RandomState(7), **kw)]
    assert got == want == rec["sha256"]
    dropped = 0
    for name, member in rec["members"]:
        data = (FIXTURES / name).read_bytes()
        j, t = jshards._decode(member, data), tshards._decode(member, data)
        assert (j is None) == (t is None), name
        dropped += j is None
        if j is not None:
            np.testing.assert_array_equal(t, j, err_msg=name)
    # the offset image and the 2-component one cv2.imdecode refuses
    assert dropped == 2 and len(got) == len(rec["members"]) - 2


def test_jpeg2000_fixtures_without_cv2():
    """In a process where `import cv2` fails, every JPEG 2000 fixture reads
    to the recorded hashes in each read and source, or raises ValueError
    where cv2 gave None; no read reaches cv2."""
    code = f"""
import hashlib, json, sys
sys.modules["cv2"] = None
import numpy as np
from spinnerf_tpu_torch.data import imageio
fx = {str(FIXTURES)!r}
files = json.load(open(fx + "/expected.json"))["files"]
n = 0
for name in {J2K_FILES!r}:
    e = files[name]
    data = open(fx + "/" + name, "rb").read()
    for source in ("file", "buffer"):
        for read in ("unchanged", "color", "gray"):
            want = e[source][read]
            try:
                img = imageio.read(data, mode=read, source=source, name=name)
            except ValueError as err:
                assert want is None, (name, source, read, err)
                continue
            got = {{"shape": list(img.shape), "dtype": str(img.dtype),
                   "sha256": hashlib.sha256(
                       np.ascontiguousarray(img).tobytes()).hexdigest()}}
            assert got == want, (name, source, read)
            n += 1
assert "cv2" not in [k for k, v in sys.modules.items() if v is not None]
print(n)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout) > 200
