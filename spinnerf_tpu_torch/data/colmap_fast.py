"""COLMAP binary models through the native parser (port of
`spinnerf_tpu/data/colmap_fast.py`).

`native/colmap_native.cpp` parses each file into columns that numpy owns;
the readers return `data.colmap`'s types, and `sparse_depth_for_views`
hands the point columns straight to `colmap.sparse_depth_from_columns`,
never building one Python object per 3D point. The
parser is built with g++ at first use (`native/build.py`); a failed build
raises. A model in COLMAP's text format (no `.bin` files) is read by
`data.colmap`, the plain Python reader these functions are held against.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from spinnerf_tpu_torch.data import colmap as _py
from spinnerf_tpu_torch.native import build as _native

_MODEL_NAMES = {mid: name for mid, (name, _) in _py.CAMERA_MODELS.items()}
# the parser's negative returns (`colmap_native.cpp`)
_ERRORS = {-1: "truncated {}", -2: "corrupt {} (bad count)",
           -3: "unknown camera model id in {}"}
_VP = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    """The parser's library (built at first use), its functions typed: the
    bytes, their length, then `n` pointers to sizes or columns."""
    lib = _native.load("colmap_native")
    for name, n in (("cm_cameras_count", 1), ("cm_cameras_fill", 6),
                    ("cm_images_count", 2), ("cm_images_fill", 9),
                    ("cm_points_count", 1), ("cm_points_fill", 6)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64] + [_VP] * n
    return lib


def _check(ret: int, what: str) -> int:
    """The parser's record count, or ValueError naming its error."""
    if ret < 0:
        raise ValueError(_ERRORS.get(ret, "unreadable {}").format(what))
    return ret


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_VP)


def _count(fn, data: bytes, what: str, n_sizes: int):
    sizes = [ctypes.c_int64(0) for _ in range(n_sizes)]
    n = _check(fn(data, len(data), *[ctypes.byref(s) for s in sizes]), what)
    return n, [s.value for s in sizes]


def parse_cameras(data: bytes) -> dict:
    """cameras.bin bytes -> columns: id, model, width, height [N], params
    [P] f64 with offsets [N + 1]."""
    lib = _lib()
    n, (n_params,) = _count(lib.cm_cameras_count, data, "cameras.bin", 1)
    cols = {"id": np.empty(n, np.int32), "model": np.empty(n, np.int32),
            "width": np.empty(n, np.uint64),
            "height": np.empty(n, np.uint64),
            "param_offsets": np.empty(n + 1, np.int64),
            "params": np.empty(n_params, np.float64)}
    _check(lib.cm_cameras_fill(data, len(data), *map(_ptr, cols.values())),
           "cameras.bin")
    return cols


def parse_images(data: bytes) -> dict:
    """images.bin bytes -> columns: id, camera_id [N], qvec [N, 4], tvec
    [N, 3], names (bytes with offsets [N + 1]), xys [P, 2] and point3d_ids
    [P] with point_offsets [N + 1]."""
    lib = _lib()
    n, (n_pts, n_name) = _count(lib.cm_images_count, data, "images.bin", 2)
    cols = {"id": np.empty(n, np.int32), "qvec": np.empty((n, 4)),
            "tvec": np.empty((n, 3)), "camera_id": np.empty(n, np.int32),
            "name_offsets": np.empty(n + 1, np.int64),
            "names": np.empty(n_name, np.uint8),
            "point_offsets": np.empty(n + 1, np.int64),
            "xys": np.empty((n_pts, 2)),
            "point3d_ids": np.empty(n_pts, np.int64)}
    _check(lib.cm_images_fill(data, len(data), *map(_ptr, cols.values())),
           "images.bin")
    return cols


def parse_points(data: bytes) -> dict:
    """points3D.bin bytes -> columns: ids [N], xyz [N, 3], rgb [N, 3] u8,
    error [N], track [T, 2] i32 (image id, 2D point index) with
    track_offsets [N + 1]."""
    lib = _lib()
    n, (n_track,) = _count(lib.cm_points_count, data, "points3D.bin", 1)
    cols = {"ids": np.empty(n, np.int64), "xyz": np.empty((n, 3)),
            "rgb": np.empty((n, 3), np.uint8), "error": np.empty(n),
            "track_offsets": np.empty(n + 1, np.int64),
            "track": np.empty((n_track, 2), np.int32)}
    _check(lib.cm_points_fill(data, len(data), *map(_ptr, cols.values())),
           "points3D.bin")
    return cols


def read_cameras_binary(path) -> dict:
    c = parse_cameras(Path(path).read_bytes())
    off = c["param_offsets"]
    return {int(cid): _py.Camera(int(cid), _MODEL_NAMES[int(m)], int(w),
                                 int(h), c["params"][off[i]:off[i + 1]].copy())
            for i, (cid, m, w, h) in enumerate(zip(c["id"], c["model"],
                                                   c["width"], c["height"]))}


def read_images_binary(path) -> dict:
    c = parse_images(Path(path).read_bytes())
    names, no, po = c["names"].tobytes(), c["name_offsets"], c["point_offsets"]
    out = {}
    for i, iid in enumerate(c["id"]):
        out[int(iid)] = _py.Image(
            int(iid), c["qvec"][i].copy(), c["tvec"][i].copy(),
            int(c["camera_id"][i]), names[no[i]:no[i + 1]].decode("utf-8"),
            c["xys"][po[i]:po[i + 1]].copy(),
            c["point3d_ids"][po[i]:po[i + 1]].copy())
    return out


def read_points3d_binary(path) -> dict:
    c = parse_points(Path(path).read_bytes())
    off, track = c["track_offsets"], c["track"]
    out = {}
    for i, pid in enumerate(c["ids"]):
        t = track[off[i]:off[i + 1]]
        out[int(pid)] = _py.Point3D(int(pid), c["xyz"][i].copy(),
                                    c["rgb"][i].copy(), float(c["error"][i]),
                                    t[:, 0].copy(), t[:, 1].copy())
    return out


def read_model(sparse_dir):
    """`colmap.read_model` through the native parser (a text model through
    `colmap`)."""
    sparse_dir = Path(sparse_dir)
    if not (sparse_dir / "cameras.bin").exists():
        return _py.read_model(sparse_dir)
    return (read_cameras_binary(sparse_dir / "cameras.bin"),
            read_images_binary(sparse_dir / "images.bin"),
            read_points3d_binary(sparse_dir / "points3D.bin"))


def read_points_columns(path) -> dict:
    """points3D.bin -> columns: ids [N], xyz [N, 3], error [N]."""
    c = parse_points(Path(path).read_bytes())
    return {"ids": c["ids"], "xyz": c["xyz"], "error": c["error"]}


def sparse_depth_for_views(sparse_dir, *, factor: float = 1.0,
                           bd_scale: float = 1.0, bounds=None):
    """`colmap.sparse_depth_for_views` from the native parser's columns,
    with no Python object per 3D point: per view (sorted by image name)
    each triangulated keypoint's camera z-depth times `bd_scale`, its pixel
    coordinate over `factor` and the weight 2 exp(-(err / mean err)^2),
    inside the view's `bounds` (or in front of the camera)."""
    sparse_dir = Path(sparse_dir)
    if not (sparse_dir / "points3D.bin").exists():
        return _py.sparse_depth_for_views(sparse_dir, factor=factor,
                                          bd_scale=bd_scale, bounds=bounds)
    cols = read_points_columns(sparse_dir / "points3D.bin")
    return _py.sparse_depth_from_columns(
        read_images_binary(sparse_dir / "images.bin"), cols["ids"],
        cols["xyz"], cols["error"], factor=factor, bd_scale=bd_scale,
        bounds=bounds)
