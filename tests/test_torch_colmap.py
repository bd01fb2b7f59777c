"""The port's COLMAP I/O and sparse depth (`spinnerf_tpu_torch/data/colmap.py`)
against the JAX package: models written by one side read by the other into
identical arrays, and the sparse depth of a JAX-written synthetic scene
(binary, and the same model as text) equal to JAX's."""
import numpy as np
import pytest
import torch

from spinnerf_tpu.data import colmap as jcolmap
from spinnerf_tpu.data import llff as jllff
from spinnerf_tpu.data import synthetic as jsynthetic
from spinnerf_tpu_torch.data import colmap as tcolmap

torch.set_num_threads(1)


def _model(mod, seed=0):
    """A small model in `mod`'s dataclasses: two camera models, an image
    without 2D points, untriangulated keypoints and a point with an empty
    track."""
    rng = np.random.RandomState(seed)
    cams = {1: mod.Camera(1, "SIMPLE_PINHOLE", 40, 30,
                          np.array([50.0, 20.0, 15.0])),
            3: mod.Camera(3, "OPENCV", 64, 48, rng.rand(8))}
    images = {}
    for i, n in ((1, 5), (2, 0), (5, 7)):
        q = rng.randn(4)
        ids = rng.randint(1, 6, n).astype(np.int64)
        ids[::3] = -1
        images[i] = mod.Image(i, q / np.linalg.norm(q), rng.randn(3),
                              1 if i < 5 else 3, f"img_{i}.png",
                              rng.rand(n, 2) * 30, ids)
    points = {pid: mod.Point3D(pid, rng.randn(3),
                               rng.randint(0, 256, 3).astype(np.uint8),
                               float(rng.rand()),
                               rng.randint(1, 6, k).astype(np.int32),
                               rng.randint(0, 7, k).astype(np.int32))
              for pid, k in ((1, 3), (2, 0), (4, 2), (5, 1))}
    return cams, images, points


def _write(mod, model, d):
    d.mkdir(parents=True, exist_ok=True)
    mod.write_cameras_binary(model[0], d / "cameras.bin")
    mod.write_images_binary(model[1], d / "images.bin")
    mod.write_points3d_binary(model[2], d / "points3D.bin")


def _assert_models_equal(a, b):
    for da, db in zip(a, b):
        assert list(da) == list(db)
        for k in da:
            va, vb = vars(da[k]), vars(db[k])
            assert list(va) == list(vb)
            for f in va:
                x, y = va[f], vb[f]
                if isinstance(x, np.ndarray):
                    assert x.dtype == y.dtype and x.shape == y.shape, (k, f)
                    np.testing.assert_array_equal(x, y, err_msg=f"{k}.{f}")
                else:
                    assert x == y, (k, f)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_binary_models_cross_read(tmp_path, writer):
    """One side writes, both read: identical records and arrays."""
    src = jcolmap if writer == "jax" else tcolmap
    _write(src, _model(src), tmp_path)
    _assert_models_equal(tcolmap.read_model(tmp_path),
                         jcolmap.read_model(tmp_path))


def test_text_models_read_alike(tmp_path):
    (tmp_path / "cameras.txt").write_text(
        "# Camera list\n1 PINHOLE 40 30 50 51 20 15\n2 SIMPLE_RADIAL 8 6 "
        "9 4 3 0.01\n")
    # image 2 has no 2D points: an empty second line
    (tmp_path / "images.txt").write_text(
        "# Image list\n1 0.9 0.1 0.2 0.3 1 2 3 1 a.png\n1.5 2.5 4 3.5 4.5 -1\n"
        "2 1 0 0 0 0 0 0 2 b.png\n\n")
    (tmp_path / "points3D.txt").write_text(
        "# 3D points\n4 0.1 0.2 0.3 10 20 30 0.7 1 0 2 5\n7 1 2 3 0 0 0 "
        "1.5\n")
    _assert_models_equal(tcolmap.read_model(tmp_path),
                         jcolmap.read_model(tmp_path))


def test_qvec_and_dense_arrays_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    for _ in range(5):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        r = tcolmap.qvec_to_rotmat(q)
        np.testing.assert_array_equal(r, jcolmap.qvec_to_rotmat(q))
        np.testing.assert_array_equal(tcolmap.rotmat_to_qvec(r),
                                      jcolmap.rotmat_to_qvec(r))
    for shape in ((6, 5), (6, 5, 3)):
        a = rng.rand(*shape).astype(np.float32)
        tcolmap.write_dense_array(a, tmp_path / "t.bin")
        jcolmap.write_dense_array(a, tmp_path / "j.bin")
        assert (tmp_path / "t.bin").read_bytes() == \
            (tmp_path / "j.bin").read_bytes()
        np.testing.assert_array_equal(
            tcolmap.read_dense_array(tmp_path / "j.bin"), a)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return jsynthetic.make_scene(tmp_path_factory.mktemp("scene"), n_views=6,
                                 h=40, w=52, factor=2, n_points=400)


def _assert_depths_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"depth", "coord", "weight"}
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _write_text(model, d):
    """`model` in COLMAP's text format (floats as repr, which reads back
    exactly)."""
    cams, images, points = model
    d.mkdir(parents=True, exist_ok=True)
    (d / "cameras.txt").write_text("".join(
        f"{c.id} {c.model} {c.width} {c.height} "
        + " ".join(map(repr, c.params.tolist())) + "\n"
        for c in cams.values()))
    (d / "images.txt").write_text("".join(
        f"{im.id} " + " ".join(map(repr, [*im.qvec.tolist(),
                                          *im.tvec.tolist()]))
        + f" {im.camera_id} {im.name}\n"
        + " ".join(f"{x!r} {y!r} {pid}" for (x, y), pid
                   in zip(im.xys.tolist(), im.point3d_ids.tolist())) + "\n"
        for im in images.values()))
    (d / "points3D.txt").write_text("".join(
        f"{p.id} " + " ".join(map(repr, p.xyz.tolist()))
        + " " + " ".join(map(str, p.rgb.tolist())) + f" {p.error!r} "
        + " ".join(f"{i} {j}" for i, j in zip(p.image_ids.tolist(),
                                               p.point2d_idxs.tolist()))
        + "\n" for p in points.values()))


@pytest.mark.parametrize("fmt", ["bin", "txt"])
@pytest.mark.parametrize("with_bounds", [False, True])
def test_sparse_depth_matches_jax(scene_dir, tmp_path, fmt, with_bounds):
    sc = jllff.load_scene(scene_dir, factor=2)
    kw = dict(factor=2, bd_scale=sc.scale,
              bounds=sc.bounds / sc.scale if with_bounds else None)
    sparse = scene_dir / "sparse" / "0"
    if fmt == "txt":
        _write_text(jcolmap.read_model(sparse), tmp_path / "txt")
        sparse = tmp_path / "txt"
        assert not (sparse / "points3D.bin").exists()
    got = tcolmap.sparse_depth_for_views(sparse, **kw)
    want = jcolmap.sparse_depth_for_views(sparse, **kw)
    _assert_depths_equal(got, want)
    assert sum(len(v["depth"]) for v in got) > 100


def test_poses_bounds_match_jax(scene_dir):
    sparse = scene_dir / "sparse" / "0"
    rows_t, names_t = tcolmap.poses_bounds_from_model(sparse)
    rows_j, names_j = jcolmap.poses_bounds_from_model(sparse)
    np.testing.assert_array_equal(rows_t, rows_j)
    assert names_t == names_j
