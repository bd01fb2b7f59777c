"""The port's JPEG decoder on damaged, incomplete and 4-component streams
(`spinnerf_tpu_torch/native/jpeg_native.cpp` through `data/jpeg.py`,
`data/llff.py` and `data/shards.py`) against cv2 5's libjpeg-turbo and the
JAX package.

Every case holds the port to cv2 bit for bit, or both refuse: a file read
(`source="file"`, `llff`'s reads) against `cv2.imread`, a buffer read
(`source="buffer"`, `shards`) against `cv2.imdecode`, each in the
unchanged, colour and gray reads.

- C6: XOR one byte of a 64 x 80 q90 JPEG's scan data at a seeded place
  (seeds 0-59, baseline and progressive): the decoder used to return other
  pixels than cv2 on 12 of these 120 files (the IDCT of huge coefficients).
- 360 further seeded edits (single-byte XORs, deleted bytes, restart markers
  renumbered or removed) of baseline 4:2:0, 4:4:4 and gray, restart
  intervals, optimized tables and progressive files.
- Truncation at every 7th byte of a baseline, a restart and a progressive
  file; progressive files with their last 1 to n scans dropped and an EOI
  kept (block smoothing).
- CMYK, YCCK and Adobe-less 4-component files at 4:4:4 and 4:2:0 (and
  PIL's CMYK).
- The streams `tests/test_torch_jpeg.py` once pinned as refused (a cut
  file, a file without EOI, a progressive file with missing scans).
- With cv2 unimportable: `llff.imread_float` and `load_scene(factor=2)` of
  a scene with a truncated, a CMYK, a YCCK and a corrupt view, and
  `iter_shard_images` of a tar of such members, equal JAX's; the committed
  mixed scene and shard equal what `expected.json` records of JAX.
"""
import hashlib
import importlib.util
import io
import json
import shutil
import sys
import tarfile
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
from spinnerf_tpu_torch.data import synthetic

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "make_jpeg_fixtures",
    Path(__file__).resolve().parent / "data" / "make_jpeg_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

READS = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "gray": cv2.IMREAD_GRAYSCALE}


def cv2_read(data, read, source, tmp_path):
    """cv2's result for the bytes read from disk ("file") or from memory
    ("buffer"), in RGB order; None where cv2 gives None."""
    if source == "file":
        path = tmp_path / "case.jpg"
        path.write_bytes(data)
        img = cv2.imread(str(path), READS[read])
    else:
        img = (cv2.imdecode(np.frombuffer(data, np.uint8), READS[read])
               if data else None)
    return None if img is None else (img[..., ::-1] if img.ndim == 3
                                     else img)


def port_read(data, read, source):
    try:
        return jpeg.decode(data, name="case.jpg", mode=read, source=source)
    except ValueError:
        return None


def assert_as_cv2(data, tag, tmp_path, reads=READS, sources=("file",
                                                            "buffer")):
    """Each source and read: the port's pixels equal cv2's, or both
    refuse. Returns how many reads decoded."""
    decoded = 0
    for source in sources:
        for read in reads:
            want = cv2_read(data, read, source, tmp_path)
            got = port_read(data, read, source)
            if want is None:
                assert got is None, f"{tag} {source} {read}: cv2 gives None"
                continue
            assert got is not None, f"{tag} {source} {read}: port refuses"
            assert got.shape == want.shape, (tag, source, read)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{tag} {source} {read}")
            decoded += 1
    return decoded


@pytest.mark.parametrize("progressive", [False, True])
def test_c6_single_byte_sweep(tmp_path, progressive):
    """C6: 60 files, each with one byte of the scan data (the bytes after
    the first SOS) XORed with a seeded mask at a seeded offset; the colour
    read of each from disk and from memory equals cv2's."""
    base = fx.encode(fx.smooth_noisy(64, 80, 3, 0), progressive=progressive)
    start, decoded = fx.scan_start(base), 0
    for seed in range(60):
        rng = np.random.default_rng(seed)
        off = int(rng.integers(start, len(base) - 2))
        data = fx.xor(base, [(off, int(rng.integers(1, 256)))])
        decoded += assert_as_cv2(data, f"seed {seed}", tmp_path,
                                 reads=("color",))
    assert decoded >= 90     # most damaged files decode


DAMAGE = {    # name -> (encode arguments, channels)
    "baseline_420": (dict(sampling="420"), 3),
    "baseline_444": (dict(sampling="444"), 3),
    "gray": (dict(), 1),
    "restart_1": (dict(sampling="420", restart=1), 3),
    "restart_3_optimized": (dict(sampling="444", restart=3, optimize=True),
                            3),
    "optimized_420": (dict(sampling="420", optimize=True), 3),
    "progressive_420": (dict(sampling="420", progressive=True), 3),
    "progressive_restart": (dict(sampling="422", progressive=True,
                                 restart=2), 3),
    "progressive_gray": (dict(progressive=True), 1)}


def damaged(base, seed):
    """One seeded edit of the scan data: a byte XORed, 1-3 bytes deleted,
    or a restart marker renumbered or removed (an XOR where the file has
    none)."""
    rng = np.random.default_rng(1000 + seed)
    start = fx.scan_start(base)
    off = int(rng.integers(start, len(base) - 2))
    kind = seed % 4
    rsts = fx.rst_offsets(base)
    if kind == 0 or (kind >= 2 and not rsts):
        return fx.xor(base, [(off, int(rng.integers(1, 256)))])
    if kind == 1:
        return base[:off] + base[off + int(rng.integers(1, 4)):]
    r = rsts[int(rng.integers(len(rsts)))]
    if kind == 2:
        return base[:r + 1] + bytes([0xD0 + int(rng.integers(8))]) + \
            base[r + 2:]
    return base[:r] + base[r + 2:]


@pytest.mark.parametrize("name", sorted(DAMAGE))
def test_damaged_streams_equal_cv2(tmp_path, name):
    """40 seeded edits of one kind of file (360 in all), each through both
    sources and all three reads."""
    kwargs, channels = DAMAGE[name]
    base = fx.encode(fx.smooth_noisy(40, 56, channels, len(name)), **kwargs)
    decoded = sum(assert_as_cv2(damaged(base, seed), f"{name} {seed}",
                                tmp_path) for seed in range(40))
    assert decoded >= 120


TRUNCATE = {
    "baseline": dict(sampling="420"),
    "restart": dict(sampling="420", restart=2),
    "progressive": dict(sampling="420", progressive=True)}


@pytest.mark.parametrize("name", sorted(TRUNCATE))
def test_truncation_equals_cv2(tmp_path, name):
    """The file cut at every 7th byte: a file read decodes where libjpeg's
    fake EOI lets it (grey blocks, block-smoothed progressive scans), a
    buffer read gives None where cv2.imdecode does."""
    base = fx.encode(fx.smooth_noisy(32, 48, 3, 7), **TRUNCATE[name])
    decoded = {"file": 0, "buffer": 0}
    for cut in range(0, len(base), 7):
        for source in decoded:
            decoded[source] += assert_as_cv2(base[:cut], f"cut {cut}",
                                             tmp_path, sources=(source,))
    assert decoded["file"] > decoded["buffer"]


@pytest.mark.parametrize("sampling", ["420", "444", "gray"])
def test_missing_scans_are_block_smoothed_as_cv2(tmp_path, sampling):
    """Progressive files with their last 1 to n-1 scans dropped and an EOI
    kept: libjpeg block-smooths what the scans leave incomplete (DC
    interpolation where no AC scan came)."""
    channels = 1 if sampling == "gray" else 3
    base = fx.encode(fx.smooth_noisy(56, 72, channels, 9), progressive=True,
                     sampling=None if sampling == "gray" else sampling)
    sos = fx.sos_offsets(base)
    for k in range(1, len(sos)):
        data = base[:sos[k]] + b"\xff\xd9"
        assert assert_as_cv2(data, f"{k} scans", tmp_path) == 6
        smoothed = jpeg.decode(data, name="x", mode="gray")
        if k < len(sos) - 1:     # the scans left drop information
            assert not np.array_equal(smoothed,
                                      jpeg.decode(base, name="x", mode="gray"))


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("kind", ["cmyk_adobe", "ycck", "cmyk_plain"])
def test_four_components_equal_cv2(tmp_path, kind, sampling):
    """CMYK (Adobe transform 0), YCCK (transform 2) and CMYK without an
    Adobe marker: libjpeg's YCCK -> CMYK, then OpenCV's CMYK -> BGR / gray;
    the unchanged read is the colour one. Also cut and edited copies."""
    rgb = fx.smooth_noisy(37, 53, 3, 14)
    ink = (fx.cmyk_for(rgb) if kind != "cmyk_plain" else np.concatenate(
        [rgb, fx.smooth_noisy(37, 53, 1, 15)[..., None]], -1))
    data = fx.four_component_jpeg(
        ink, transform={"cmyk_adobe": 0, "ycck": 2, "cmyk_plain": None}[kind],
        sampling=sampling)
    assert assert_as_cv2(data, kind, tmp_path) == 6
    assert jpeg.decode(data, name="x").shape == (37, 53, 3)
    if kind != "cmyk_plain":     # about the image it was made from
        assert np.abs(jpeg.decode(data, name="x", mode="color").astype(int)
                      - rgb).mean() < 12
    start = fx.scan_start(data)
    for frac in (0.3, 0.8):
        off = start + int((len(data) - start) * frac)
        assert_as_cv2(data[:off], f"{kind} cut", tmp_path)
        assert_as_cv2(fx.xor(data, [(off, 0x5A)]), f"{kind} xor", tmp_path)


def test_pil_cmyk_equals_cv2(tmp_path):
    """PIL's CMYK JPEG (Adobe transform 0, stored inverted)."""
    data = fx.pil_cmyk(fx.smooth_noisy(31, 43, 3, 16))
    assert assert_as_cv2(data, "PIL CMYK", tmp_path) == 6


def _formerly_refused():
    base = fx.encode(fx.smooth_noisy(16, 24, 3, 5), sampling="420")
    prog = fx.encode(fx.smooth_noisy(16, 24, 3, 6), progressive=True)
    return {"truncated": base[:len(base) // 2],
            "missing scans": prog[:prog.rfind(b"\xff\xda")] + b"\xff\xd9",
            "no EOI": base[:-2]}


FORMERLY_REFUSED = _formerly_refused()


@pytest.mark.parametrize("what", sorted(FORMERLY_REFUSED))
def test_formerly_refused_streams_equal_cv2(tmp_path, what):
    """The cut file, the progressive file with missing scans and the file
    without EOI that the decoder used to refuse: `llff`'s reads equal
    cv2.imread's (or raise naming the file where it gives None), a buffer
    read equals cv2.imdecode's."""
    data = FORMERLY_REFUSED[what]
    path = tmp_path / "formerly.jpeg"
    path.write_bytes(data)
    for read, fn in (("unchanged", tllff.imread), ("color", tllff.imread_rgb8),
                     ("gray", tllff.imread_gray8)):
        want = cv2_read(data, read, "file", tmp_path)
        if want is None:
            with pytest.raises(ValueError, match="formerly.jpeg"):
                fn(path)
        else:
            np.testing.assert_array_equal(fn(path), want, err_msg=read)
    assert_as_cv2(data, what, tmp_path, sources=("buffer",))


@pytest.fixture
def no_cv2(monkeypatch):
    def block():
        monkeypatch.setitem(sys.modules, "cv2", None)
        with pytest.raises(ImportError):
            import cv2 as _  # noqa: F401
    return block


def test_mixed_scene_without_cv2_equals_jax(tmp_path, no_cv2):
    """A six-view scene whose JPEG views are valid, cut, CMYK, YCCK,
    corrupt and progressive: with cv2 unimportable, the port's
    `imread_float` of each view and `load_scene(factor=2)` equal JAX's."""
    src = synthetic.make_scene(tmp_path / "png", n_views=6, h=48, w=64,
                               factor=1, seed=3)
    scene = tmp_path / "jax"
    (scene / "images").mkdir(parents=True)
    shutil.copy(Path(src) / "poses_bounds.npy", scene / "poses_bounds.npy")
    pngs = sorted((Path(src) / "images").glob("*.png"))
    for k, png in enumerate(pngs):
        rgb = cv2.imread(str(png), cv2.IMREAD_COLOR)[..., ::-1]
        bgr = np.ascontiguousarray(rgb[..., ::-1])
        if k == 0:
            data = fx.encode(bgr)
        elif k == 1:
            data = fx.cut_in_longest_scan(fx.encode(bgr, progressive=True))
        elif k == 2:
            data = fx.pil_cmyk(rgb)
        elif k == 3:
            data = fx.four_component_jpeg(fx.cmyk_for(rgb), transform=2,
                                          sampling="420")
        elif k == 4:
            data = fx.encode(bgr)
            data = fx.xor(data, [(fx.scan_start(data) + 40, 0x3C)])
        else:
            data = fx.encode(bgr, progressive=True)
        (scene / "images" / (png.stem + ".jpg")).write_bytes(data)
    shutil.copytree(scene, tmp_path / "torch")
    views = sorted((scene / "images").glob("*.jpg"))
    want_views = [jllff.imread_float(p) for p in views]
    want = jllff.load_scene(scene, factor=2, prepare=True)

    no_cv2()
    for p, ref in zip(views, want_views):
        np.testing.assert_array_equal(tllff.imread_float(p), ref,
                                      err_msg=p.name)
    got = tllff.load_scene(tmp_path / "torch", factor=2, prepare=True)
    assert got.images.shape == (6, 24, 32, 3)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=1e-6)


def _shard(path, members):
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def test_shard_without_cv2_equals_jax(tmp_path, no_cv2):
    """One tar of valid, CMYK, YCCK, cut, corrupt and missing-scan members:
    the port's `iter_shard_images` (cv2 unimportable) yields as many images
    as JAX's, in the same order, with equal values (rng seed 5, buffer 3,
    no loop); a member cv2.imdecode gives None for is dropped by both."""
    img = fx.smooth_noisy(24, 32, 3, 17)
    base = fx.encode(img, sampling="420")
    prog = fx.encode(img, progressive=True)
    members = [("valid.jpg", base),
               ("cmyk.jpg", fx.pil_cmyk(img)),
               ("ycck.jpg", fx.four_component_jpeg(fx.cmyk_for(img),
                                                   transform=2)),
               ("cut.jpg", base[:len(base) * 3 // 4]),
               ("corrupt.jpg",
                fx.xor(base, [(fx.scan_start(base) + 30, 0x77)])),
               ("missing_scans.jpg", prog[:fx.sos_offsets(prog)[-2]]
                + b"\xff\xd9"),
               ("progressive.jpg", prog), ("no_eoi.jpg", base[:-2])]
    _shard(tmp_path / "s.tar", members)

    def stream():
        return list(it([tmp_path / "s.tar"], rng=np.random.RandomState(5),
                       shuffle_buffer=3, loop=False))
    it = jshards.iter_shard_images
    want = stream()
    want_none = [n for n, d in members if jshards._decode(n, d) is None]
    no_cv2()
    it = tshards.iter_shard_images
    got = stream()
    assert len(got) == len(want) == len(members) - len(want_none)
    assert {"cut.jpg", "no_eoi.jpg"} <= set(want_none)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def test_committed_mixed_scene_and_shard_match_records(tmp_path, no_cv2):
    """What chip_smoke.py's phase 21 (d) and (e) hold the card to, on the
    CPU with cv2 unimportable: `load_scene(factor=2)` of the committed
    scene with its YCCK, CMYK, cut and edited views gives the image stack
    JAX gave (`expected.json`'s "mixed_scene"), and `iter_shard_images` of
    the tar of the "shard" members gives JAX's images in JAX's order."""
    expected = json.loads((fx.OUT / "expected.json").read_text())
    no_cv2()
    mixed = expected["mixed_scene"]
    fx.build_mixed_scene(mixed, tmp_path / "scene")
    images = tllff.load_scene(tmp_path / "scene", factor=2,
                              prepare=True).images
    assert list(images.shape) == mixed["images_shape"]
    assert _sha(images) == mixed["images_sha256"]
    shard = expected["shard"]
    _shard(tmp_path / "s.tar", [(n, (fx.OUT / n).read_bytes())
                                for n in shard["members"]])
    got = list(tshards.iter_shard_images(
        [tmp_path / "s.tar"], rng=np.random.RandomState(shard["seed"]),
        shuffle_buffer=shard["shuffle_buffer"], loop=False))
    assert [_sha(g) for g in got] == shard["sha256"]
