"""The port's fused point-cloud IO (`spinnerf_tpu_torch/data/
colmap_fused.py`): a write / read round trip, the files byte-equal to the
JAX package's writer's and the clouds read by both packages equal, for
random clouds (empty visibility lists included), a PLY without normals,
colours or `.vis`, and a corrupt `.vis`."""
import numpy as np
import pytest
import torch

from spinnerf_tpu.data import colmap_fused as jfused
from spinnerf_tpu_torch.data import colmap_fused as tfused

torch.set_num_threads(1)


def _cloud(mod, n, seed):
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, 6, n)
    return mod.FusedPointCloud(
        positions=rng.randn(n, 3).astype(np.float32),
        normals=rng.randn(n, 3).astype(np.float32),
        colors=rng.randint(0, 256, (n, 3)).astype(np.uint8),
        vis_offsets=np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
        vis_flat=rng.randint(0, 40, counts.sum()).astype(np.uint32))


def _assert_clouds_equal(a, b):
    for f in ("positions", "normals", "colors", "vis_offsets", "vis_flat"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("n,seed", [(1, 0), (257, 1), (3000, 2)])
def test_round_trip_matches_jax(tmp_path, n, seed):
    pc = _cloud(tfused, n, seed)
    tfused.write_fused(pc, tmp_path / "t.ply")
    jfused.write_fused(_cloud(jfused, n, seed), tmp_path / "j.ply")
    for suffix in (".ply", ".ply.vis"):
        assert ((tmp_path / f"t{suffix}").read_bytes()
                == (tmp_path / f"j{suffix}").read_bytes()), suffix
    got = tfused.read_fused(tmp_path / "t.ply")
    _assert_clouds_equal(got, pc)
    _assert_clouds_equal(got, jfused.read_fused(tmp_path / "t.ply"))
    assert len(got) == n
    for i in (0, n - 1):
        np.testing.assert_array_equal(got.visible_image_idxs(i),
                                      pc.vis_flat[pc.vis_offsets[i]:
                                                  pc.vis_offsets[i + 1]])


def test_plain_ply_and_bad_vis(tmp_path):
    """A PLY of xyz alone (no .vis): zero normals, colours and visibility;
    a .vis whose count disagrees raises in both packages."""
    xyz = np.random.RandomState(3).randn(5, 3).astype(np.float32)
    header = (b"ply\nformat binary_little_endian 1.0\ncomment x\n"
              b"element vertex 5\nproperty float x\nproperty float y\n"
              b"property float z\nend_header\n")
    (tmp_path / "p.ply").write_bytes(header + xyz.tobytes())
    got = tfused.read_fused(tmp_path / "p.ply")
    _assert_clouds_equal(got, jfused.read_fused(tmp_path / "p.ply"))
    np.testing.assert_array_equal(got.positions, xyz)
    assert not got.normals.any() and not got.colors.any()
    assert len(got.vis_flat) == 0
    (tmp_path / "p.ply.vis").write_bytes(np.uint64(4).tobytes())
    for mod in (tfused, jfused):
        with pytest.raises(ValueError, match="4 points"):
            mod.read_fused(tmp_path / "p.ply")
    (tmp_path / "a.ply").write_bytes(b"ply\nformat ascii 1.0\nend_header\n")
    with pytest.raises(ValueError, match="unsupported PLY format"):
        tfused.read_fused(tmp_path / "a.ply")
