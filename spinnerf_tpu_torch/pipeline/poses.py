"""SfM preprocessing: COLMAP driving + pose export (reference stage 1; port
of `spinnerf_tpu/pipeline/poses.py`).

Parity: `colmap_wrapper.py:23-76` (feature_extractor with a single shared
camera -> exhaustive/sequential matcher -> mapper with tri-angle 4, single
model, logged to colmap_output.txt) and `imgs2poses.py:260-285` (`gen_poses`:
run COLMAP if no sparse model exists, then export poses_bounds.npy).

The COLMAP binary is optional at runtime, as in the JAX package:
`run_colmap` raises when it is missing, while `gen_poses` works on any scene
that already has a `sparse/0` model (the common dataset case). Host only.
"""
from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np

from spinnerf_tpu_torch.data import colmap as colmap_io
from spinnerf_tpu_torch.data.llff import minify


def colmap_available() -> bool:
    return shutil.which("colmap") is not None


def run_colmap(scene_dir, match_type: str = "exhaustive_matcher"):
    """Run the COLMAP SfM chain on `<scene_dir>/images`, writing
    `<scene_dir>/sparse/0` and a `colmap_output.txt` log."""
    if not colmap_available():
        raise RuntimeError(
            "COLMAP binary not found on PATH; provide a precomputed sparse/0 "
            "model or install COLMAP")
    scene_dir = Path(scene_dir)
    db = scene_dir / "database.db"
    sparse = scene_dir / "sparse"
    sparse.mkdir(exist_ok=True)
    with open(scene_dir / "colmap_output.txt", "w") as log:
        def run(args):
            log.write("$ colmap " + " ".join(args) + "\n")
            log.flush()
            subprocess.run(["colmap"] + args, check=True, stdout=log,
                           stderr=subprocess.STDOUT)

        run(["feature_extractor", "--database_path", str(db),
             "--image_path", str(scene_dir / "images"),
             "--ImageReader.single_camera", "1"])
        run([match_type, "--database_path", str(db)])
        run(["mapper", "--database_path", str(db),
             "--image_path", str(scene_dir / "images"),
             "--output_path", str(sparse),
             "--Mapper.init_min_tri_angle", "4",
             "--Mapper.multiple_models", "0",
             "--Mapper.extract_colors", "0"])


def gen_poses(scene_dir, match_type: str = "exhaustive_matcher",
              factors=None) -> bool:
    """End-to-end pose generation: ensure a sparse model exists (running
    COLMAP if needed), export poses_bounds.npy, optionally pre-minify."""
    scene_dir = Path(scene_dir)
    sparse = scene_dir / "sparse" / "0"
    have_model = (sparse / "cameras.bin").exists() or \
        (sparse / "cameras.txt").exists()
    if not have_model:
        run_colmap(scene_dir, match_type)
    arr, _ = colmap_io.poses_bounds_from_model(sparse)
    np.save(scene_dir / "poses_bounds.npy", arr)
    for f in factors or ():
        minify(scene_dir, f)
    return True
