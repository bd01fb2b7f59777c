"""The port's native COLMAP parser (`spinnerf_tpu_torch/native/
colmap_native.cpp`, built by g++ into build/ at first use) and its columnar
reader (`data/colmap_fast.py`) against the port's Python reader
(`data/colmap.py`) and the JAX package's `colmap_fast`, on the model of
`synthetic.make_scene(n_points=2000)`: cameras, images, points and
`sparse_depth_for_views` equal, bit for bit. JAX's side is skipped only
where its own extension fails to build (as `tests/test_native.py` does)."""
import struct

import numpy as np
import pytest
import torch

from spinnerf_tpu_torch.data import colmap, colmap_fast, synthetic
from spinnerf_tpu_torch.native import build as native_build

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sparse_dir(tmp_path_factory):
    d = synthetic.make_scene(tmp_path_factory.mktemp("s"), n_views=6, h=60,
                             w=80, n_points=2000)
    return d / "sparse" / "0"


@pytest.fixture(scope="module")
def jax_fast():
    from spinnerf_tpu.data import colmap_fast as jfast
    try:
        jfast.build_native()
    except Exception as e:
        pytest.skip(f"the JAX package's native extension did not build: {e}")
    assert jfast.native_available()
    return jfast


def _assert_models_equal(got, want):
    gc, gi, gp = got
    wc, wi, wp = want
    assert list(gc) == list(wc)
    for k in wc:
        a, b = gc[k], wc[k]
        assert (a.id, a.model, a.width, a.height) == (b.id, b.model,
                                                      b.width, b.height)
        np.testing.assert_array_equal(a.params, b.params)
    assert list(gi) == list(wi)
    for k in wi:
        a, b = gi[k], wi[k]
        assert (a.id, a.camera_id, a.name) == (b.id, b.camera_id, b.name)
        for f in ("qvec", "tvec", "xys", "point3d_ids"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert list(gp) == list(wp)
    for k in wp:
        a, b = gp[k], wp[k]
        assert a.id == b.id and a.error == b.error
        for f in ("xyz", "rgb", "image_ids", "point2d_idxs"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)


def _assert_depths_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_native_build_is_cached_by_source_hash():
    path = native_build.build()
    assert path.exists() and path.parent == native_build.BUILD_DIR
    assert path.name.startswith("libcolmap_native-")
    assert native_build.build() == path == native_build.library_path(
        "colmap_native")


def test_native_reader_matches_python_reader(sparse_dir):
    model = colmap_fast.read_model(sparse_dir)
    _assert_models_equal(model, colmap.read_model(sparse_dir))
    assert len(model[2]) > 1000 and len(model[1]) == 6


@pytest.mark.parametrize("kw", [dict(), dict(factor=2.0, bd_scale=1.5),
                                dict(bounds="scene")],
                         ids=["plain", "scaled", "bounds"])
def test_sparse_depth_matches_python_reader(sparse_dir, kw):
    if kw.get("bounds") == "scene":
        pb = np.load(sparse_dir.parents[1] / "poses_bounds.npy")
        kw = dict(bounds=pb[:, -2:], bd_scale=0.8)
    got = colmap_fast.sparse_depth_for_views(sparse_dir, **kw)
    _assert_depths_equal(got, colmap.sparse_depth_for_views(sparse_dir, **kw))
    assert sum(len(v["depth"]) for v in got) > 1000


def test_native_reader_matches_jax(sparse_dir, jax_fast):
    _assert_models_equal(colmap_fast.read_model(sparse_dir),
                         jax_fast.read_model(sparse_dir))
    got = colmap_fast.sparse_depth_for_views(sparse_dir, factor=2.0,
                                             bd_scale=1.5)
    want = jax_fast.sparse_depth_for_views(sparse_dir, factor=2.0,
                                           bd_scale=1.5)
    _assert_depths_equal(got, want)
    cols = colmap_fast.read_points_columns(sparse_dir / "points3D.bin")
    jcols = jax_fast.read_points_columns(sparse_dir / "points3D.bin")
    for k in jcols:
        np.testing.assert_array_equal(cols[k], jcols[k], err_msg=k)


def test_text_model_goes_through_the_python_reader(sparse_dir, tmp_path):
    cams, imgs, pts = colmap.read_model(sparse_dir)
    (tmp_path / "cameras.txt").write_text("".join(
        f"{c.id} {c.model} {c.width} {c.height} "
        + " ".join(repr(float(v)) for v in c.params) + "\n"
        for c in cams.values()))
    (tmp_path / "images.txt").write_text("".join(
        f"{i.id} " + " ".join(repr(float(v)) for v in (*i.qvec, *i.tvec))
        + f" {i.camera_id} {i.name}\n"
        + " ".join(f"{x!r} {y!r} {p}" for (x, y), p in zip(
            i.xys.tolist(), i.point3d_ids.tolist())) + "\n"
        for i in imgs.values()))
    (tmp_path / "points3D.txt").write_text("".join(
        f"{p.id} " + " ".join(repr(float(v)) for v in p.xyz)
        + " " + " ".join(str(int(v)) for v in p.rgb) + f" {p.error!r} "
        + " ".join(f"{a} {b}" for a, b in zip(p.image_ids, p.point2d_idxs))
        + "\n" for p in pts.values()))
    _assert_depths_equal(colmap_fast.sparse_depth_for_views(tmp_path),
                         colmap.sparse_depth_for_views(sparse_dir))


def test_corrupt_models_raise():
    huge = struct.pack("<Q", 1 << 60)
    for fn in (colmap_fast.parse_cameras, colmap_fast.parse_images,
               colmap_fast.parse_points):
        for data in (huge, b"\x03", b"\x10" + b"\x00" * 7 + b"short"):
            with pytest.raises(ValueError, match="truncated|corrupt"):
                fn(data)
    # an image record whose 2D-point count exceeds the bytes
    rec = (struct.pack("<Q", 1) + struct.pack("<i", 1) + b"\x00" * 56
           + struct.pack("<i", 1) + b"a.png\x00" + struct.pack("<Q", 1 << 50))
    with pytest.raises(ValueError, match="truncated"):
        colmap_fast.parse_images(rec)
    cam = (struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 99, 4, 4)
           + b"\x00" * 64)
    with pytest.raises(ValueError, match="unknown camera model"):
        colmap_fast.parse_cameras(cam)


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int f( {\n")
    monkeypatch.setattr(native_build, "SRC", tmp_path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for native/broken"):
        native_build.build("broken")
    assert not list((tmp_path / "build").glob("*.so"))
