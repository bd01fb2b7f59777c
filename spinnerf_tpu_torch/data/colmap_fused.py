"""COLMAP dense-fusion point clouds: `fused.ply` + `fused.ply.vis` (port of
`spinnerf_tpu/data/colmap_fused.py`, numpy only).

The reference reads them with PyntCloud and per-point struct loops
(`DS_NeRF/colmapUtils/read_write_fused_vis.py`); this follows COLMAP's
on-disk contract (`src/mvs/fusion.cc`) with array operations:

- `fused.ply`: binary_little_endian PLY with per-vertex
  x,y,z (f32), nx,ny,nz (f32), red,green,blue (u8).
- `fused.ply.vis`: u64 point count, then per point a u32 count followed by
  that many u32 image indices (the views the point was fused from).

Returned as struct-of-arrays (positions [N,3] f32, normals [N,3] f32,
colors [N,3] u8, visibility as a ragged (offsets, flat indices) pair) —
which the ray and depth-supervision builders take as they are.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class FusedPointCloud:
    positions: np.ndarray        # [N, 3] f32
    normals: np.ndarray          # [N, 3] f32
    colors: np.ndarray           # [N, 3] u8
    vis_offsets: np.ndarray      # [N + 1] i64; point i sees vis_flat[o_i:o_{i+1}]
    vis_flat: np.ndarray         # [sum counts] u32 image indices

    def __len__(self):
        return len(self.positions)

    def visible_image_idxs(self, i: int) -> np.ndarray:
        return self.vis_flat[self.vis_offsets[i]:self.vis_offsets[i + 1]]


_PLY_PROPS = [("x", "f4"), ("y", "f4"), ("z", "f4"),
              ("nx", "f4"), ("ny", "f4"), ("nz", "f4"),
              ("red", "u1"), ("green", "u1"), ("blue", "u1")]


def _parse_ply_header(f):
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt, n, props = None, None, []
    _TYPES = {b"float": "f4", b"float32": "f4", b"double": "f8",
              b"uchar": "u1", b"uint8": "u1", b"int": "i4", b"uint": "u4",
              b"short": "i2", b"ushort": "u2", b"char": "i1"}
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        parts = line.split()
        if not parts or parts[0] == b"comment":
            continue
        if parts[0] == b"format":
            fmt = parts[1]
        elif parts[0] == b"element":
            if parts[1] != b"vertex":
                raise ValueError(f"unsupported PLY element {parts[1]!r}")
            n = int(parts[2])
        elif parts[0] == b"property":
            props.append((parts[2].decode(), _TYPES[parts[1]]))
        elif parts[0] == b"end_header":
            break
    if fmt != b"binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt!r}")
    return n, props


def read_fused(ply_path, vis_path=None) -> FusedPointCloud:
    """Read fused.ply (+ fused.ply.vis when present) vectorized."""
    ply_path = Path(ply_path)
    with open(ply_path, "rb") as f:
        n, props, = _parse_ply_header(f)
        rec = np.dtype(props)
        data = np.frombuffer(f.read(n * rec.itemsize), dtype=rec, count=n)

    def cols(names, dt):
        return np.stack([data[c].astype(dt) for c in names], axis=1)

    positions = cols(("x", "y", "z"), np.float32)
    has = {name for name, _ in props}
    normals = (cols(("nx", "ny", "nz"), np.float32)
               if {"nx", "ny", "nz"} <= has else np.zeros_like(positions))
    colors = (cols(("red", "green", "blue"), np.uint8)
              if {"red", "green", "blue"} <= has
              else np.zeros((n, 3), np.uint8))

    vis_path = Path(vis_path) if vis_path else ply_path.with_suffix(
        ply_path.suffix + ".vis")
    if vis_path.exists():
        raw = np.fromfile(vis_path, dtype=np.uint8)
        n_vis = int(np.frombuffer(raw[:8], "<u8")[0])
        if n_vis != n:
            raise ValueError(f".vis has {n_vis} points, ply has {n}")
        # ragged u32 stream: count_i, idx_0..idx_{count_i-1}, ...
        words = np.frombuffer(raw[8:], "<u4")
        offsets = np.empty(n + 1, np.int64)
        counts = np.empty(n, np.int64)
        pos = 0
        # counts are data-dependent; walk the stream (still ~30M pts/s)
        for i in range(n):
            c = int(words[pos])
            counts[i] = c
            pos += 1 + c
        offsets[0] = 0
        np.cumsum(counts, out=offsets[1:])
        # gather the index words: for point i they sit after its count word
        starts = np.concatenate(([0], np.cumsum(counts[:-1] + 1))) + 1
        take = (starts[:, None] +
                np.arange(int(counts.max()) if n else 0)[None, :])
        mask = np.arange(int(counts.max()) if n else 0)[None, :] < counts[:, None]
        vis_flat = words[take[mask]] if n else np.empty(0, np.uint32)
    else:
        offsets = np.zeros(n + 1, np.int64)
        vis_flat = np.empty(0, np.uint32)

    return FusedPointCloud(positions, normals, colors, offsets,
                           vis_flat.astype(np.uint32))


def write_fused(pc: FusedPointCloud, ply_path, vis_path=None):
    """Write fused.ply + fused.ply.vis in COLMAP's binary contract."""
    ply_path = Path(ply_path)
    n = len(pc)
    rec = np.dtype(_PLY_PROPS)
    data = np.empty(n, rec)
    for i, c in enumerate(("x", "y", "z")):
        data[c] = pc.positions[:, i]
    for i, c in enumerate(("nx", "ny", "nz")):
        data[c] = pc.normals[:, i]
    for i, c in enumerate(("red", "green", "blue")):
        data[c] = pc.colors[:, i]
    type_names = {"f4": b"float", "u1": b"uchar"}
    header = (b"ply\nformat binary_little_endian 1.0\n"
              b"element vertex %d\n" % n +
              b"".join(b"property %s %s\n" % (type_names[dt], c.encode())
                       for c, dt in _PLY_PROPS) +
              b"end_header\n")
    with open(ply_path, "wb") as f:
        f.write(header)
        f.write(data.tobytes())

    vis_path = Path(vis_path) if vis_path else ply_path.with_suffix(
        ply_path.suffix + ".vis")
    counts = np.diff(pc.vis_offsets).astype(np.uint32)
    # interleave counts with their index runs as one u32 stream
    total = n + len(pc.vis_flat)
    stream = np.empty(total, "<u4")
    write_pos = pc.vis_offsets[:-1] + np.arange(n)      # count positions
    stream[write_pos] = counts
    mask = np.ones(total, bool)
    mask[write_pos] = False
    stream[mask] = pc.vis_flat
    with open(vis_path, "wb") as f:
        f.write(np.uint64(n).tobytes())
        f.write(stream.tobytes())
