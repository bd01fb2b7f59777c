"""Image files read by their content, as cv2 5.0 reads them, without cv2
(`spinnerf_tpu_torch/data/imageio.py`, `eval/render.py::read_png`,
`native/image_native.cpp`), against cv2 and the JAX package.

- Every committed fixture (`tests/data/images/`, written by
  `tests/data/make_image_fixtures.py`) in cv2's unchanged, colour and gray
  reads, as `cv2.imread` and `cv2.imdecode` read it: the port gives cv2's
  shape, dtype and pixels where the fixture's `port` is "equal" (against
  cv2 here, and against the recorded `expected.json` always), raises
  ValueError where it is "refused", and reads through cv2 where it is
  "cv2" (the formats ROADMAP F2 leaves out). A read recorded "unwritten"
  (cv2 returns memory it never wrote there: the unchanged read of a
  planar 16-bit TIFF) holds cv2 to its shape and dtype, and the port
  refuses it, naming that.
- ROADMAP C7: a PNG named .jpg, a JPEG and a WebP named .png and a BMP
  named .jpg read to cv2's pixels through `llff.imread`, `imread_rgb8`,
  `imread_gray8` (against JAX's `imread_float` and cv2's reads) and
  `shards._decode` (against JAX's).
- C8: a PNG member cut in half or with 20 bytes zeroed gives None in
  `shards._decode`, as JAX's does, and `iter_shard_images` streams past
  them in JAX's order.
- C9: the gray read of 8-bit, 16-bit and palette colour PNGs equals cv2 on
  every pixel of a random 256 x 256 image (libpng's rgb_to_gray, not
  cvtColor's luma); tRNS and Adam7 files equal cv2's three reads.
- A 3-view LLFF scene of a PNG named .jpg, a lossless WebP and a TIFF loads
  to JAX's `load_scene` images bit for bit.
- Seeded random files of each format the port decodes (PNG of every
  colour type, depth, interlace and tRNS, cut and with a flipped bit; BMP;
  PxM; TIFF; WebP from cv2's, PIL's and the hand-written encoders): the
  port gives cv2's three reads where cv2 reads them, refuses only the
  variants ROADMAP F2 lists, and raises where cv2 gives None.
- `pipeline.stages.stage_rgb` stages a view for LaMa by its content: the
  staged PNG's colour read equals cv2's colour read of the file JAX
  copies, for mis-suffixed, WebP, TIFF and EXIF-turned views.
- In a process where cv2 cannot be imported, every fixture reads to the
  recorded hashes, and the formats left to cv2 raise naming cv2.
"""
import hashlib
import io
import json
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
FILES = EXPECTED["files"]
FLAGS = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "gray": cv2.IMREAD_GRAYSCALE}
MISNAMED = ("misnamed_png.jpg", "misnamed_jpeg.png", "misnamed_webp.png",
            "misnamed_bmp.jpg")

sys.path.insert(0, str(ROOT / "tests" / "data"))
import image_writers as iw  # noqa: E402


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _record(img):
    return {"shape": list(img.shape), "dtype": str(img.dtype),
            "sha256": _sha(img)}


def _rgb(img):
    return imageio._bgr_to_rgb(img)


def _cv2(path, data, source, read):
    img = (cv2.imread(str(path), FLAGS[read]) if source == "file"
           else cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS[read]))
    return None if img is None else _rgb(img)


def test_fixture_set_is_whole():
    files = sorted(p.name for p in FIXTURES.iterdir()
                   if p.is_file() and p.name != "expected.json")
    assert files == sorted(FILES)
    assert sum((FIXTURES / f).stat().st_size for f in files) < 1 << 20
    kinds = {imageio.sniff((FIXTURES / f).read_bytes()) for f in files}
    assert kinds == {"bmp", "jpeg", "webp", "pxm", "tiff", "png",   # ported
                     "jpeg2000",
                     "gif", "hdr", "avif", "sunras", "pfm", "pam"}  # F2


@pytest.mark.parametrize("name", sorted(FILES))
def test_fixture_reads_equal_cv2(name):
    """Each source and read: cv2 still gives the recorded result, and the
    port gives it too (or refuses, or goes through cv2)."""
    path, entry = FIXTURES / name, FILES[name]
    data = path.read_bytes()
    for source in ("file", "buffer"):
        for read in ("unchanged", "color", "gray"):
            want = entry[source][read]
            # a read where cv2 returns memory it never wrote: recorded by
            # its shape and dtype, and refused by the port
            unwritten = bool(want and want.get("unwritten"))
            ref = _cv2(path, data, source, read)
            if entry["port"] == "equal" and unwritten:
                assert ref is not None and [list(ref.shape), str(
                    ref.dtype)] == [want["shape"], want["dtype"]], \
                    (name, source, read)
            elif entry["port"] == "equal":   # (cv2 reads some refused files
                # and some of PFM's reads from memory it never wrote)
                assert (None if ref is None else _record(ref)) == want, \
                    (name, source, read)
            try:
                got = imageio.read(data, mode=read, source=source, name=name)
            except ValueError as e:
                assert entry["port"] == "refused" or want is None or (
                    unwritten and "unwritten" in str(e)), \
                    (name, source, read, e)
                assert name in str(e)
                continue
            assert entry["port"] != "refused" and not unwritten, (
                name, source, read)
            if entry["port"] == "equal":
                assert _record(got) == want, (name, source, read)


@pytest.mark.parametrize("name", MISNAMED)
def test_misnamed_files_read_by_content(name, tmp_path):
    """C7: `llff`'s three reads and `shards._decode` pick the decoder by
    content; each equals cv2 and JAX."""
    path = tmp_path / name
    path.write_bytes((FIXTURES / name).read_bytes())
    np.testing.assert_array_equal(tllff.imread_float(path),
                                  jllff.imread_float(path))
    for read, fn in (("unchanged", tllff.imread), ("color", tllff.imread_rgb8),
                     ("gray", tllff.imread_gray8)):
        np.testing.assert_array_equal(fn(path),
                                      _cv2(path, None, "file", read))
    data = path.read_bytes()
    want = jshards._decode(name, data)
    assert want is not None
    np.testing.assert_array_equal(tshards._decode(name, data), want)


def _shard(tmp_path, members):
    tar = tmp_path / "s.tar"
    with tarfile.open(tar, "w") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return tar


def test_damaged_png_members_drop_and_the_stream_goes_on(tmp_path):
    """C8: cut and zeroed PNG members give None, as JAX's `_decode` does;
    the shard streams past them (and past a WebP and a mis-suffixed PNG,
    which JAX decodes) and yields JAX's images in JAX's order."""
    names = ("damaged_cut.png", "png_rgb8.png", "damaged_zeroed.png",
             "misnamed_webp.png", "ancillary_crc.png", "misnamed_png.jpg",
             "webp_lossy_q50.webp")
    members = [(n if not n.endswith(".webp") else n[:-5] + ".png",
                (FIXTURES / n).read_bytes()) for n in names]
    for name, data in members:
        want = jshards._decode(name, data)
        got = tshards._decode(name, data)
        if want is None:
            assert got is None, name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert jshards._decode(*members[0]) is None
    assert jshards._decode(*members[2]) is None
    tar = _shard(tmp_path, members)
    kw = dict(shuffle_buffer=3, loop=False)
    want = [_sha(x) for x in jshards.iter_shard_images(
        [tar], rng=np.random.RandomState(5), **kw)]
    got = [_sha(x) for x in tshards.iter_shard_images(
        [tar], rng=np.random.RandomState(5), **kw)]
    assert len(want) == 5 and got == want


@pytest.mark.parametrize("case", ["rgb8", "rgb16", "palette", "rgba16"])
def test_png_gray_read_is_libpngs(case, tmp_path):
    """C9: the gray read of a colour PNG equals cv2's on every pixel of a
    random 256 x 256 image: libpng's (9797 R + 19234 G + 3737 B) >> 15,
    truncated at 8 bits, rounded then cut to the high byte at 16."""
    rs = np.random.RandomState(11)
    if case == "palette":
        data = iw.png(rs.randint(0, 256, (256, 256)), 3, 8,
                      palette=rs.randint(0, 256, (256, 3)))
    else:
        depth = 16 if case.endswith("16") else 8
        ch = 4 if case.startswith("rgba") else 3
        data = iw.png(rs.randint(0, 1 << depth, (256, 256, ch)),
                      6 if ch == 4 else 2, depth)
    path = tmp_path / "c.png"
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(tllff.imread_gray8(path), want)
    if case == "rgb8":   # cvtColor's luma is not cv2's gray read of a PNG
        rgb = tllff.imread_rgb8(path).astype(np.int64)
        luma = (rgb @ np.array([4899, 9617, 1868]) + 8192) >> 14
        assert (luma != want).sum() > 10_000


@pytest.mark.parametrize("color,depth", [(2, 8), (2, 16), (3, 4), (0, 2),
                                         (4, 16), (6, 8)])
def test_png_adam7_and_trns_equal_cv2(color, depth, tmp_path):
    """C9: Adam7 at each colour type (seeded row filters), and the same
    image with a tRNS chunk where the colour type takes one, equal cv2's
    unchanged, colour and gray reads."""
    rs = np.random.RandomState(color * 17 + depth)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    samples = rs.randint(0, 1 << depth, (19, 29, ch))
    kw = {}
    if color == 3:
        kw["palette"] = rs.randint(0, 256, (1 << depth, 3))
        kw["trns"] = bytes(rs.randint(0, 256, 5).astype(np.uint8))
    elif color in (0, 2):
        kw["trns"] = b"".join(int(v).to_bytes(2, "big")
                              for v in samples[3, 4])
    for interlace in (0, 1):
        data = iw.png(samples, color, depth, interlace=interlace, filt="mix",
                      seed=depth, **kw)
        for read in FLAGS:
            want = _cv2(None, data, "buffer", read)
            got = imageio.read(data, mode=read, name="t.png")
            assert _record(got) == _record(want), (interlace, read)


def test_scene_of_other_formats_loads_as_jax(tmp_path):
    """A 3-view LLFF scene (a PNG named .jpg, a lossless WebP and an LZW
    TIFF named .png) loads to JAX's image stack bit for bit; both equal the
    hash recorded where the fixtures were made."""
    import shutil
    for sub in ("jax", "torch"):
        shutil.copytree(FIXTURES / "scene", tmp_path / sub)
    want = jllff.load_scene(tmp_path / "jax", factor=1, prepare=True)
    got = tllff.load_scene(tmp_path / "torch", factor=1, prepare=True)
    np.testing.assert_array_equal(got.images, want.images)
    assert ([list(got.images.shape), _sha(got.images)]
            == [EXPECTED["scene"]["images_shape"],
                EXPECTED["scene"]["images_sha256"]])


def _random_png(rs, k):
    depths = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
              6: (8, 16)}
    color = int(rs.choice(list(depths)))
    depth = int(rs.choice(depths[color]))
    h, w = (int(v) for v in rs.randint(1, 30, 2))
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    samples = rs.randint(0, 1 << depth, (h, w, ch))
    kw = {}
    if color == 3:
        kw["palette"] = rs.randint(0, 256, (1 << depth, 3))
        if rs.rand() < 0.5:
            kw["trns"] = bytes(rs.randint(0, 256, 3).astype(np.uint8))
    elif color in (0, 2) and rs.rand() < 0.5:
        kw["trns"] = b"".join(int(v).to_bytes(2, "big")
                              for v in samples[0, 0])
    data = iw.png(samples, color, depth, interlace=int(rs.randint(2)),
                  filt="mix", seed=k, **kw)
    if k % 3 == 1:
        data = data[:int(rs.randint(len(data)))]
    elif k % 3 == 2:
        edit = bytearray(data)
        edit[int(rs.randint(8, len(data)))] ^= 1 << int(rs.randint(8))
        data = bytes(edit)
    return data


def _random_file(fmt, rs, k):
    h, w = (int(v) for v in rs.randint(1, 40, 2))
    if fmt == "png":
        return _random_png(rs, k)
    if fmt == "bmp":
        bpp = int(rs.choice([1, 4, 8, 16, 24, 32]))
        kw = {}
        if bpp <= 8:
            kw["palette"] = rs.randint(0, 256, (1 << bpp, 3))
            px = rs.randint(0, 1 << bpp, (h, w))
            px[:, :w // 2] = px[0, 0]
            kw["rle"] = bpp > 1 and rs.rand() < 0.5
        else:
            px = rs.randint(0, 256 if bpp > 16 else 65536,
                            (h, w, bpp // 8) if bpp > 16 else (h, w))
            if bpp == 32 and rs.rand() < 0.5:
                kw.update(v4=True, bitfields=(0xFF0000, 0xFF00, 0xFF,
                                              0xFF000000))
        kw["top_down"] = not kw.get("rle") and rs.rand() < 0.3
        return iw.bmp(px, bpp, **kw)
    if fmt == "pxm":
        kind = int(rs.randint(1, 7))
        maxval = 1 if kind in (1, 4) else int(rs.choice([7, 255, 1000]))
        return iw.pxm(rs.randint(0, maxval + 1, (h, w, 3) if kind in (3, 6)
                                 else (h, w)), kind, maxval=maxval)
    if fmt == "tiff":
        dtype = rs.choice([np.uint8, np.uint16])
        spp = int(rs.choice([1, 3, 4]))
        a = rs.randint(0, np.iinfo(dtype).max + 1, (h, w, spp)).astype(dtype)
        kw = dict(order=str(rs.choice(["<", ">"])),
                  compression=int(rs.choice([1, 5, 8, 32773])),
                  predictor=int(rs.choice([1, 2])),
                  orientation=int(rs.randint(1, 9)))
        if kw["compression"] != 1 and rs.rand() < 0.4:
            kw["tile"] = (32, 16)
        else:
            kw["rows_per_strip"] = int(rs.randint(1, h + 1))
        if spp == 4:
            kw["extrasamples"] = [int(rs.choice([1, 2]))]
        return iw.tiff(a, **kw)
    img = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
    img[:h // 2] = img[0, 0]
    if k % 3 == 0:
        return cv2.imencode(".webp", img[..., :3], [
            cv2.IMWRITE_WEBP_QUALITY, int(rs.randint(0, 102))])[1].tobytes()
    if k % 3 == 1:
        bio = io.BytesIO()
        from PIL import Image
        Image.fromarray(img).save(bio, "WEBP", quality=int(rs.randint(101)),
                                  lossless=bool(rs.randint(2)),
                                  method=int(rs.randint(7)))
        return bio.getvalue()
    return iw.webp_lossless(img, transforms=("subtract_green", "predictor",
                                             "cross_color"),
                            pred_bits=2, cc_bits=2, seed=k)


@pytest.mark.parametrize("fmt", ["png", "bmp", "pxm", "tiff", "webp"])
def test_random_files_equal_cv2(fmt):
    """30 seeded files a format: every read the port makes equals cv2's,
    the port raises where cv2 gives None, and it refuses a file cv2 reads
    only for a variant ROADMAP F2 lists (TIFF here)."""
    rs = np.random.RandomState(["png", "bmp", "pxm", "tiff",
                                "webp"].index(fmt))
    refused = 0
    for k in range(30):
        data = _random_file(fmt, rs, k)
        for read in FLAGS:
            want = _cv2(None, data, "buffer", read)
            try:
                got = imageio.read(data, mode=read, name=f"{fmt}{k}")
            except (ValueError, FileNotFoundError) as e:
                if want is not None:
                    assert fmt == "tiff" and "TIFF" in str(e), (k, read, e)
                    refused += 1
                continue
            assert want is not None, (k, read)
            assert _record(got) == _record(want), (k, read)
    assert refused <= 30


@pytest.mark.parametrize("name", MISNAMED + (
    "png_exif6.png", "webp_exif6.webp", "tiff_rgb_lzw_pred2.tif",
    "png_rgb16.png"))
def test_stage_rgb_gives_lamas_pixels(name, tmp_path):
    """The staged PNG reads (as LaMa's colour read) to cv2's colour read of
    the original, which JAX copies as it is; only PNG content is copied."""
    from spinnerf_tpu_torch.pipeline import stages
    src = tmp_path / name
    src.write_bytes((FIXTURES / name).read_bytes())
    dst = tmp_path / "staged" / "img000.png"
    dst.parent.mkdir()
    stages.stage_rgb(src, dst)
    np.testing.assert_array_equal(tllff.imread_rgb8(dst),
                                  _cv2(src, None, "file", "color"))
    assert (dst.read_bytes() == src.read_bytes()) == (
        imageio.sniff(src.read_bytes()) == "png")


def test_every_fixture_without_cv2():
    """In a process where `import cv2` fails: every "equal" fixture reads
    to the recorded hashes in each read and source, "refused" ones raise
    ValueError naming the file, and the formats left to cv2 raise
    RuntimeError naming cv2 and ROADMAP F2."""
    code = f"""
import hashlib, json, sys
sys.modules["cv2"] = None
import numpy as np
from spinnerf_tpu_torch.data import imageio
fx = {str(FIXTURES)!r}
files = json.load(open(fx + "/expected.json"))["files"]
n = 0
for name, e in files.items():
    data = open(fx + "/" + name, "rb").read()
    for source in ("file", "buffer"):
        for read in ("unchanged", "color", "gray"):
            want = e[source][read]
            try:
                img = imageio.read(data, mode=read, source=source, name=name)
            except ValueError as err:
                assert e["port"] == "refused" or want is None or (
                    want.get("unwritten") and "unwritten" in str(err)), (
                    name, err)
                continue
            except RuntimeError as err:
                assert e["port"] == "cv2" and "cv2" in str(err), name
                assert "ROADMAP F2" in str(err), name
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
    assert int(out.stdout) > 500
