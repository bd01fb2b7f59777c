"""COLMAP sparse-model I/O in numpy and struct (port of
`spinnerf_tpu/data/colmap.py`, same semantics).

cameras / images / points3D in COLMAP's binary and text formats, the
quaternion <-> rotation helpers, dense depth/normal map arrays, and the two
derived products training needs: per-view sparse depth with
reprojection-error weights (`sparse_depth_for_views`) and the LLFF
`poses_bounds.npy` rows of a model (`poses_bounds_from_model`).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

# camera model id -> (name, number of parameters), COLMAP's enumeration
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}

_XY_ID = [("xy", "<f8", 2), ("id3d", "<i8")]
_TRACK = [("img", "<i4"), ("idx", "<i4")]


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray      # [num_params] float64


@dataclass
class Image:
    id: int
    qvec: np.ndarray        # [4] (w, x, y, z)
    tvec: np.ndarray        # [3]
    camera_id: int
    name: str
    xys: np.ndarray         # [N, 2] keypoint pixel coordinates
    point3d_ids: np.ndarray  # [N] int64, -1 = not triangulated

    def rotmat(self) -> np.ndarray:
        return qvec_to_rotmat(self.qvec)

    def world_to_cam(self) -> np.ndarray:
        """[4, 4] world -> camera."""
        m = np.eye(4)
        m[:3, :3] = self.rotmat()
        m[:3, 3] = self.tvec
        return m

    def cam_to_world(self) -> np.ndarray:
        """[4, 4] camera -> world (the inverse of the stored pose)."""
        r = self.rotmat()
        m = np.eye(4)
        m[:3, :3] = r.T
        m[:3, 3] = -r.T @ self.tvec
        return m


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray         # [3]
    rgb: np.ndarray         # [3] uint8
    error: float
    image_ids: np.ndarray   # [track_len]
    point2d_idxs: np.ndarray  # [track_len]


def qvec_to_rotmat(q) -> np.ndarray:
    """Rotation matrix of a (w, x, y, z) quaternion."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_qvec(r) -> np.ndarray:
    """(w, x, y, z) quaternion of a rotation matrix (Shepperd's method)."""
    k = np.array([
        [r[0, 0] - r[1, 1] - r[2, 2], 0, 0, 0],
        [r[0, 1] + r[1, 0], r[1, 1] - r[0, 0] - r[2, 2], 0, 0],
        [r[0, 2] + r[2, 0], r[1, 2] + r[2, 1], r[2, 2] - r[0, 0] - r[1, 1], 0],
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1],
         r[0, 0] + r[1, 1] + r[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


# --- binary readers ---------------------------------------------------------

def read_cameras_binary(path) -> dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, width, height = struct.unpack("<iiQQ",
                                                            f.read(24))
            name, n_params = CAMERA_MODELS[model_id]
            params = np.frombuffer(f.read(8 * n_params), dtype="<f8")
            cameras[cam_id] = Camera(cam_id, name, width, height,
                                     params.copy())
    return cameras


def read_images_binary(path) -> dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (img_id,) = struct.unpack("<i", f.read(4))
            qvec = np.frombuffer(f.read(32), dtype="<f8").copy()
            tvec = np.frombuffer(f.read(24), dtype="<f8").copy()
            (cam_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (n_pts,) = struct.unpack("<Q", f.read(8))
            rec = np.frombuffer(f.read(24 * n_pts), dtype=_XY_ID)
            images[img_id] = Image(img_id, qvec, tvec, cam_id,
                                   name.decode("utf-8"), rec["xy"].copy(),
                                   rec["id3d"].copy())
    return images


def read_points3d_binary(path) -> dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (pt_id,) = struct.unpack("<q", f.read(8))
            xyz = np.frombuffer(f.read(24), dtype="<f8").copy()
            rgb = np.frombuffer(f.read(3), dtype=np.uint8).copy()
            (error,) = struct.unpack("<d", f.read(8))
            (track_len,) = struct.unpack("<Q", f.read(8))
            track = np.frombuffer(f.read(8 * track_len), dtype=_TRACK)
            points[pt_id] = Point3D(pt_id, xyz, rgb, error,
                                    track["img"].copy(), track["idx"].copy())
    return points


# --- binary writers ---------------------------------------------------------

def write_cameras_binary(cameras: dict[int, Camera], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            f.write(struct.pack("<iiQQ", cam.id, CAMERA_MODEL_IDS[cam.model],
                                cam.width, cam.height))
            f.write(np.asarray(cam.params, dtype="<f8").tobytes())


def write_images_binary(images: dict[int, Image], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(np.asarray(im.qvec, dtype="<f8").tobytes())
            f.write(np.asarray(im.tvec, dtype="<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            rec = np.empty(len(im.xys), dtype=_XY_ID)
            rec["xy"] = im.xys
            rec["id3d"] = im.point3d_ids
            f.write(rec.tobytes())


def write_points3d_binary(points: dict[int, Point3D], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pt in points.values():
            f.write(struct.pack("<q", pt.id))
            f.write(np.asarray(pt.xyz, dtype="<f8").tobytes())
            f.write(np.asarray(pt.rgb, dtype=np.uint8).tobytes())
            f.write(struct.pack("<d", pt.error))
            f.write(struct.pack("<Q", len(pt.image_ids)))
            rec = np.empty(len(pt.image_ids), dtype=_TRACK)
            rec["img"] = pt.image_ids
            rec["idx"] = pt.point2d_idxs
            f.write(rec.tobytes())


# --- text readers -----------------------------------------------------------

def read_cameras_text(path) -> dict[int, Camera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cameras[cam_id] = Camera(cam_id, parts[1], int(parts[2]),
                                     int(parts[3]),
                                     np.array([float(p) for p in parts[4:]]))
    return cameras


def read_images_text(path) -> dict[int, Image]:
    images = {}
    with open(path) as f:
        # an image without 2D points has an empty second line: blank lines
        # are kept so that the header / points pairing stays in step
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    for header, data in zip(lines[0::2], lines[1::2]):
        p = header.split()
        img_id = int(p[0])
        d = data.split()
        xys = (np.array(d, dtype=np.float64).reshape(-1, 3)[:, :2] if d
               else np.zeros((0, 2)))
        ids = (np.array(d[2::3], dtype=np.int64) if d
               else np.zeros(0, np.int64))
        images[img_id] = Image(img_id, np.array([float(x) for x in p[1:5]]),
                               np.array([float(x) for x in p[5:8]]),
                               int(p[8]), p[9], xys, ids)
    return images


def read_points3d_text(path) -> dict[int, Point3D]:
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            pt_id = int(p[0])
            track = np.array(p[8:], dtype=np.int64).reshape(-1, 2)
            points[pt_id] = Point3D(pt_id, np.array(p[1:4], dtype=np.float64),
                                    np.array(p[4:7], dtype=np.uint8),
                                    float(p[7]), track[:, 0].astype(np.int32),
                                    track[:, 1].astype(np.int32))
    return points


def read_model(sparse_dir):
    """(cameras, images, points) of a sparse model directory: the binary
    files where present, else the text files."""
    sparse_dir = Path(sparse_dir)
    if (sparse_dir / "cameras.bin").exists():
        return (read_cameras_binary(sparse_dir / "cameras.bin"),
                read_images_binary(sparse_dir / "images.bin"),
                read_points3d_binary(sparse_dir / "points3D.bin"))
    return (read_cameras_text(sparse_dir / "cameras.txt"),
            read_images_text(sparse_dir / "images.txt"),
            read_points3d_text(sparse_dir / "points3D.txt"))


# --- dense depth / normal maps ----------------------------------------------

def read_dense_array(path) -> np.ndarray:
    """A COLMAP dense map: an ASCII 'w&h&c&' header, then float32 data in
    column-major channel order."""
    with open(path, "rb") as f:
        header, amps = b"", 0
        while amps < 3:
            c = f.read(1)
            if not c:
                raise ValueError(f"{path}: truncated or invalid dense-array "
                                 f"header")
            header += c
            amps += c == b"&"
        w, h, c = (int(x) for x in header.decode().split("&")[:3])
        data = np.frombuffer(f.read(), dtype="<f4")
    return data.reshape(c, h, w).transpose(1, 2, 0).squeeze()


def write_dense_array(arr: np.ndarray, path):
    arr = np.atleast_3d(np.asarray(arr, dtype="<f4"))
    h, w, c = arr.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode())
        f.write(arr.transpose(2, 0, 1).tobytes())


# --- derived products -------------------------------------------------------

def camera_focal_hw(cam: Camera):
    """(focal, height, width), taking the first parameter as the focal."""
    return float(cam.params[0]), cam.height, cam.width


def poses_bounds_from_model(sparse_dir, perc=(0.1, 99.9)):
    """The LLFF `poses_bounds.npy` rows [N, 17] of a sparse model, views
    sorted by image name: the 3x5 [down, right, backward | t | hwf] matrix
    and the (close, far) percentiles of the z-depths of the points each
    view sees. Returns (rows, names)."""
    cameras, images, points = read_model(sparse_dir)
    img_ids = sorted(images, key=lambda i: images[i].name)
    focal_hw = {cid: camera_focal_hw(c) for cid, c in cameras.items()}
    pts = {pid: p.xyz for pid, p in points.items()}
    rows = []
    for iid in img_ids:
        im = images[iid]
        c2w = im.cam_to_world()
        f, h, w = focal_hw[im.camera_id]
        # COLMAP's camera columns are (right, down, forward): down = +y,
        # backward = -z
        m = np.concatenate(
            [c2w[:3, 1:2], c2w[:3, 0:1], -c2w[:3, 2:3], c2w[:3, 3:4],
             np.array([[h], [w], [f]])], axis=1)
        w2c = im.world_to_cam()
        vis = [pts[pid] for pid in im.point3d_ids if pid != -1 and pid in pts]
        if vis:
            z = np.stack(vis) @ w2c[2, :3].T + w2c[2, 3]
            close, far = np.percentile(z, perc[0]), np.percentile(z, perc[1])
        else:
            close, far = 0.1, 100.0
        rows.append(np.concatenate([m.ravel(), [close, far]]))
    return np.stack(rows), [images[i].name for i in img_ids]


def sparse_depth_for_views(sparse_dir, *, factor: float = 1.0,
                           bd_scale: float = 1.0, bounds=None):
    """Per-view sparse depth from the triangulated points, views sorted by
    image name: for every keypoint with a 3D point, its camera z-depth
    (times `bd_scale`), its pixel coordinate (divided by `factor`) and the
    weight 2 exp(-(err / mean err)^2). Points outside the view's [close,
    far] `bounds` (or, without bounds, behind the camera) are dropped.
    Returns a list of {"depth" [K], "coord" [K, 2], "weight" [K]}."""
    _, images, points = read_model(sparse_dir)
    return sparse_depth_from_columns(
        images, np.fromiter(points, np.int64, len(points)),
        np.array([p.xyz for p in points.values()], np.float64).reshape(-1, 3),
        np.array([p.error for p in points.values()], np.float64),
        factor=factor, bd_scale=bd_scale, bounds=bounds)


def sparse_depth_from_columns(images, ids, xyz, err, *, factor: float = 1.0,
                              bd_scale: float = 1.0, bounds=None):
    """`sparse_depth_for_views` from the images and the points as columns
    (ids [N], xyz [N, 3], error [N]), with an id -> row lookup table, so
    that each view's points are gathered with array indexing rather than
    one dict lookup per keypoint."""
    err_mean = float(err.mean()) if len(err) else 1.0
    # COLMAP's point ids are small integers
    max_id = int(ids.max()) if len(ids) else 0
    lut = np.full(max_id + 2, -1, np.int64)
    lut[ids] = np.arange(len(ids))
    out = []
    for view_idx, iid in enumerate(sorted(images,
                                          key=lambda i: images[i].name)):
        im = images[iid]
        pid = im.point3d_ids
        kp = np.flatnonzero((pid >= 0) & (pid <= max_id))
        row = lut[pid[kp]]
        kp, row = kp[row >= 0], row[row >= 0]
        if len(kp) == 0:
            out.append({"depth": np.zeros(0), "coord": np.zeros((0, 2)),
                        "weight": np.zeros(0)})
            continue
        w2c = im.world_to_cam()
        z = (xyz[row] @ w2c[2, :3].T + w2c[2, 3]) * bd_scale
        if bounds is not None:
            lo, hi = np.asarray(bounds[view_idx], np.float64) * bd_scale
            inb = (z >= lo) & (z <= hi)
        else:
            inb = z > 0
        weight = 2.0 * np.exp(-((err[row] / err_mean) ** 2))
        out.append({"depth": z[inb], "coord": im.xys[kp][inb] / factor,
                    "weight": weight[inb]})
    return out
