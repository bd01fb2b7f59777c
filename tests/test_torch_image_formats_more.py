"""PAM, PFM, Sun raster, Radiance HDR and GIF read without cv2
(`native/image_native.cpp` through `data/imageio.py`), against cv2 5.0 and
the JAX package.

- Seeded files of each format from `tests/data/image_writers.py`: the
  port gives cv2's unchanged, colour and gray reads under both sources
  (`cv2.imread`, `cv2.imdecode`), shape, dtype and pixels, and raises
  where cv2 gives None. PAM's conversions that cv2 runs over a part of
  each row only (the colour read of 2 / 4 channels, the gray read of 4
  channels on most widths) leave pixels cv2 never wrote: the port refuses
  them, naming that.
- Cut and one-byte-edited files of each format: the port raises where cv2
  gives None (or raises) and gives cv2's pixels where it reads them (GIF:
  cv2's LZW loop, whose end code resets as a clear, which stops where the
  frame is full and refuses data past the bytes the next code takes).
- A 7-view LLFF scene of PAM, HDR, GIF, Sun raster, PFM, arithmetic and
  lossless JPEG views, each named with another format's suffix, loads to
  JAX's `load_scene` image stack bit for bit; `llff`'s reads of its views
  equal JAX's `imread_float` and cv2's colour and gray reads.
- A tar of one member of each new format streams through
  `shards.iter_shard_images` to JAX's images in JAX's order.
- Both equal the hashes recorded where the fixtures were made, and in a
  process where cv2 cannot be imported every fixture of these formats
  reads to the recorded hashes: no read of them reaches cv2.
"""
import hashlib
import io
import json
import shutil
import subprocess
import sys
import tarfile
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

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "images"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())
FLAGS = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "gray": cv2.IMREAD_GRAYSCALE}
KINDS = ("pam", "pfm", "sunras", "hdr", "gif")

sys.path.insert(0, str(ROOT / "tests" / "data"))
import image_writers as iw  # noqa: E402


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _cv2(data, source, read, tmp_path):
    try:
        if source == "file":
            path = tmp_path / "x.img"
            path.write_bytes(data)
            img = cv2.imread(str(path), FLAGS[read])
        else:
            img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS[read])
    except cv2.error:   # cv2 raises on some damaged headers
        return None
    return None if img is None else imageio._bgr_to_rgb(img)


def _same(data, tmp_path, tag, sources=("file", "buffer"), allowed=()):
    """The port's reads equal cv2's (or both refuse); a read whose refusal
    names one of `allowed` is not held to cv2. Returns the reads cv2 gave
    None for."""
    nones = 0
    for source in sources:
        for read in FLAGS:
            try:
                got = imageio.read(data, mode=read, source=source, name=tag)
            except (ValueError, FileNotFoundError) as e:
                if any(a in str(e) for a in allowed):
                    continue
                want = _cv2(data, source, read, tmp_path)
                assert want is None, (tag, source, read, str(e))
                assert tag in str(e)
                nones += 1
                continue
            want = _cv2(data, source, read, tmp_path)
            assert want is not None, (tag, source, read)
            assert (got.dtype, got.shape) == (want.dtype, want.shape), (
                tag, source, read)
            assert np.array_equal(got, want, equal_nan=True), (
                tag, source, read)
    return nones


def _pam(rs):
    h, w = (int(v) for v in rs.randint(1, 30, 2))
    t = rs.choice(["BLACKANDWHITE", "GRAYSCALE", "RGB", None])
    c = {"BLACKANDWHITE": 1, "GRAYSCALE": 1, "RGB": 3,
         None: int(rs.choice([1, 3]))}[t]
    maxval = 1 if t == "BLACKANDWHITE" else int(rs.choice([1, 15, 255, 1000,
                                                           65535]))
    return iw.pam(rs.randint(0, maxval + 1, (h, w, c)), maxval=maxval,
                  tupltype=t, comments=bool(rs.rand() < 0.3))


def _pfm(rs):
    h, w = (int(v) for v in rs.randint(1, 30, 2))
    img = ((rs.randn(h, w, 3) * 100) if rs.rand() < 0.5
           else rs.rand(h, w) * 3).astype(np.float32)
    return iw.pfm(img, scale=float(rs.choice([-1.0, 1.0, -0.37, 2.0,
                                              1e-3])))


def _sunras(rs):
    h, w = (int(v) for v in rs.randint(1, 30, 2))
    bpp = int(rs.choice([1, 8, 24, 32]))
    pal = None
    if bpp <= 8:
        px = rs.randint(0, 1 << bpp, (h, w))
        r = rs.rand()
        if r < 0.4:
            pal = rs.randint(0, 256, (int(rs.randint(1, (1 << bpp) + 1)), 3))
        elif r < 0.6:
            pal = np.repeat(rs.randint(0, 256, (1 << bpp, 1)), 3, 1)
    else:
        px = rs.randint(0, 256, (h, w, bpp // 8))
    return iw.sunras(px, bpp, rtype=int(rs.choice([0, 1, 1, 2, 3])),
                     palette=pal)


def _hdr(rs):
    h, w = (int(v) for v in rs.randint(1, 40, 2))
    img = (rs.rand(h, w, 3) ** 3 * rs.choice([1, 10, 1000])).astype(
        np.float32)
    img[:h // 2] = img[0, 0]
    return iw.hdr(img, rle=bool(rs.rand() < 0.7),
                  magic=[b"#?RADIANCE", b"#?RGBE"][int(rs.randint(2))])


def _gif(rs):
    h, w = (int(v) for v in rs.randint(1, 40, 2))
    n = int(rs.choice([2, 4, 16, 256]))
    pal = rs.randint(0, 256, (n, 3))
    idx = rs.randint(0, n, (h, w))
    idx[:h // 2] = idx[0, 0]
    fr = dict(indices=idx, interlace=bool(rs.rand() < 0.3))
    if rs.rand() < 0.3:
        fr["transparent"] = int(rs.randint(0, n))
    if rs.rand() < 0.3:
        fr["palette"] = rs.randint(0, 256, (n, 3))
    if rs.rand() < 0.2:
        fr["clear_every"] = int(rs.randint(3, 50))
    frames = [fr]
    if rs.rand() < 0.3:
        frames.append(dict(indices=idx[::-1], transparent=1))
    sw, sh = w + int(rs.randint(0, 3)), h + int(rs.randint(0, 3))
    fr["x"], fr["y"] = sw - w, sh - h
    return iw.gif(frames, sw, sh, palette=pal,
                  background=int(rs.randint(0, n)))


WRITERS = {"pam": _pam, "pfm": _pfm, "sunras": _sunras, "hdr": _hdr,
           "gif": _gif}


@pytest.mark.parametrize("kind", KINDS)
def test_random_files_equal_cv2(kind, tmp_path):
    """30 seeded files: three reads, two sources, each equal to cv2's."""
    rs = np.random.RandomState(KINDS.index(kind) + 100)
    nones = sum(_same(WRITERS[kind](rs), tmp_path, f"{kind}{k}")
                for k in range(30))
    # cv2 refuses RLE / RGB-format Sun rasters and PFM reads whose channel
    # count differs under cv2.imread
    assert kind not in ("sunras", "pfm") or nones > 0


def test_pam_partly_written_reads_are_refused():
    """GRAYSCALE_ALPHA / RGB_ALPHA: the colour read fills one pixel in 2 /
    4 of each row and the gray read one pixel in 3 steps of 4 samples, so
    cv2 returns memory it never wrote; the port refuses those reads and
    gives the rest (the unchanged read, the gray read of 2 channels)."""
    rs = np.random.RandomState(4)
    for c, t in ((2, "GRAYSCALE_ALPHA"), (4, "RGB_ALPHA")):
        x = rs.randint(0, 256, (5, 7, c))
        data = iw.pam(x, tupltype=t)
        got = imageio.read(data, mode="unchanged", name="p.pam")
        want = x.astype(np.uint8)
        if c == 4:
            want = want[..., [2, 1, 0, 3]]   # the file's samples as BGRA
        assert np.array_equal(got, want)
        with pytest.raises(ValueError, match="p.pam: .*unwritten"):
            imageio.read(data, mode="color", name="p.pam")
        if c == 2:   # three bytes a step over one sample in two
            assert np.array_equal(imageio.read(data, mode="gray",
                                               name="p.pam"),
                                  x[:, [0, 0, 0, 1, 1, 1, 2], 0])
        else:
            with pytest.raises(ValueError, match="unwritten"):
                imageio.read(data, mode="gray", name="p.pam")


@pytest.mark.parametrize("kind", KINDS)
def test_damaged_files_equal_cv2(kind, tmp_path):
    """25 seeded files, each cut at 4 places and with 4 single-bit edits,
    read from memory: the port refuses where cv2 gives None and gives
    cv2's pixels elsewhere."""
    rs = np.random.RandomState(KINDS.index(kind) + 200)
    allowed = ("unwritten",)
    for k in range(25):
        good = WRITERS[kind](rs)
        for cut in sorted(set(int(v) for v in rs.randint(0, len(good), 4))):
            _same(good[:cut], tmp_path, f"{kind}{k} cut {cut}",
                  sources=("buffer",), allowed=allowed)
        for _ in range(4):
            data = bytearray(good)
            pos = int(rs.randint(0, len(good)))
            data[pos] ^= 1 << int(rs.randint(8))
            if kind == "pam" and any(m in bytes(data[:80]) for m in (
                    b"DEPTH 2", b"DEPTH 4", b"ALPHA")):
                continue   # cv2's gray read of them writes past its buffer
            _same(bytes(data), tmp_path, f"{kind}{k} xor {pos}",
                  sources=("buffer",), allowed=allowed)


def test_scene_of_new_formats_loads_as_jax(tmp_path):
    """The committed 7-view scene (PAM, HDR, GIF, Sun raster, PFM,
    arithmetic and lossless JPEG, each under another suffix) loads to
    JAX's stack bit for bit, and to the recorded hash; each view's reads
    equal JAX's imread_float and cv2's colour and gray reads."""
    for sub in ("jax", "torch"):
        shutil.copytree(FIXTURES / "scene_more", tmp_path / sub)
    want = jllff.load_scene(tmp_path / "jax", factor=1, prepare=True)
    got = tllff.load_scene(tmp_path / "torch", factor=1, prepare=True)
    np.testing.assert_array_equal(got.images, want.images)
    assert ([list(got.images.shape), _sha(got.images)]
            == [EXPECTED["scene_more"]["images_shape"],
                EXPECTED["scene_more"]["images_sha256"]])
    views = sorted((tmp_path / "torch" / "images").iterdir())
    kinds = {imageio.sniff(p.read_bytes()) for p in views}
    assert kinds == {"pam", "hdr", "gif", "sunras", "pfm", "jpeg"}
    for p in views:
        np.testing.assert_array_equal(tllff.imread_float(p),
                                      jllff.imread_float(p), err_msg=p.name)
        for read, fn in (("color", tllff.imread_rgb8),
                         ("gray", tllff.imread_gray8)):
            want = _cv2(p.read_bytes(), "file", read, tmp_path)
            if want is None:   # cv2.imread's gray read of a colour PFM
                with pytest.raises(ValueError):
                    fn(p)
                continue
            np.testing.assert_array_equal(fn(p), want, err_msg=(p.name, read))


def test_shard_of_new_formats_streams_as_jax(tmp_path):
    """A tar of one member of each new format, each named .png or .jpg
    (and an RLE Sun raster, which cv2 and the port drop), streams to JAX's
    images in JAX's order, and to the hashes recorded from JAX's
    stream."""
    rec = EXPECTED["shard_more"]
    tar = tmp_path / "more.tar"
    with tarfile.open(tar, "w") as tf:
        for name, member in rec["members"]:
            tf.add(FIXTURES / name, arcname=member)
    kw = dict(shuffle_buffer=4, loop=False)
    want = [_sha(x) for x in jshards.iter_shard_images(
        [tar], rng=np.random.RandomState(5), **kw)]
    got = [_sha(x) for x in tshards.iter_shard_images(
        [tar], rng=np.random.RandomState(5), **kw)]
    assert got == want == rec["sha256"]
    assert len(got) == len(rec["members"]) - 1   # the RLE raster drops
    members = [(m, (FIXTURES / n).read_bytes()) for n, m in rec["members"]]
    for name, data in members:
        j, t = jshards._decode(name, data), tshards._decode(name, data)
        assert (j is None) == (t is None), name
        if j is not None:
            np.testing.assert_array_equal(t, j, err_msg=name)


def test_new_fixtures_without_cv2():
    """In a process where `import cv2` fails, every fixture of the new
    formats (and of F1's JPEG frames) reads to the recorded hashes in each
    read and source, or raises ValueError where cv2 gave None; none is
    left to cv2."""
    names = sorted(n for n, e in EXPECTED["files"].items()
                   if n.split("_")[0] in ("pam", "pfm", "ras8", "ras1",
                                          "ras24", "ras32", "hdr", "gif",
                                          "left")
                   or n.startswith(("jpeg_arith", "jpeg_lossless")))
    assert all(EXPECTED["files"][n]["port"] == "equal" for n in names
               if n != "left_avif.avif")
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
                assert want is None, (name, source, read, err)
                continue
            except RuntimeError as err:
                assert name == "left_avif.avif", (name, err)
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
    assert int(out.stdout) > 300
