"""Tar-shard image streaming, the webdataset-equivalent training feed (port
of `spinnerf_tpu/data/shards.py`).

The reference's LaMa trainer can stream tar shards of images
(`lama/saicinpainting/training/data/datasets.py:25-100`,
`InpaintingTrainWebDataset`). Here: plain `tarfile` shards, a
shuffled-shard + shuffle-buffer iterator, and a writer that shards an image
tree. Members are decoded without cv2, as JAX's `cv2.imdecode(...,
IMREAD_COLOR)` decodes them: by their content, not their name
(`data/imageio.py`, `source="buffer"`), each turned by its orientation; a
member cv2 gives None for (cut, damaged, not an image) is dropped and the
stream goes on.
"""
from __future__ import annotations

import tarfile
from pathlib import Path

import numpy as np

from spinnerf_tpu_torch.data import imageio

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")


def write_tar_shards(indir, out_dir, *, shard_size: int = 1000,
                     pattern: str = "shard-%05d.tar"):
    """Pack every image under `indir` (not `*_mask*`) into tar shards of
    `shard_size` files. Returns the shard paths written."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = sorted(p for p in Path(indir).rglob("*")
                   if p.suffix.lower() in IMAGE_SUFFIXES
                   and "_mask" not in p.stem)
    if not paths:
        raise FileNotFoundError(f"no images under {indir}")
    shards = []
    tf = None
    try:
        for i, p in enumerate(paths):
            if i % shard_size == 0:
                if tf is not None:
                    tf.close()
                shard_path = out / (pattern % (i // shard_size))
                tf = tarfile.open(shard_path, "w")
                shards.append(shard_path)
            tf.add(p, arcname=p.name)
    finally:
        if tf is not None:
            tf.close()
    return shards


def _decode(name: str, data: bytes):
    """[H, W, 3] float32 RGB in [0, 1] of one member's bytes, or None
    exactly where `cv2.imdecode(..., IMREAD_COLOR)` gives None."""
    try:
        img = imageio.read(data, mode="color", source="buffer", name=name)
    except (FileNotFoundError, ValueError):
        return None
    return img.astype(np.float32) / 255.0


def iter_shard_images(shard_paths, *, rng=None, shuffle_shards: bool = True,
                      shuffle_buffer: int = 0, loop: bool = False):
    """Stream decoded [H, W, 3] float32 RGB images from tar shards.

    Args:
      shard_paths: iterable of .tar paths (or a directory of shards).
      rng: np.random.RandomState for shard order / buffer shuffling.
      shuffle_buffer: > 0 keeps a reservoir of that many decoded images and
        yields a random one as each new image streams in.
      loop: restart from a fresh shard order when exhausted.
    """
    rng = rng or np.random.RandomState(0)
    if isinstance(shard_paths, (str, Path)) and Path(shard_paths).is_dir():
        shard_paths = sorted(Path(shard_paths).glob("*.tar"))
    shard_paths = [Path(p) for p in shard_paths]
    if not shard_paths:
        raise FileNotFoundError("no tar shards given")

    def stream_once():
        order = list(shard_paths)
        if shuffle_shards:
            rng.shuffle(order)
        for shard in order:
            with tarfile.open(shard, "r") as tf:
                for member in tf:
                    if not member.isfile():
                        continue
                    if not member.name.lower().endswith(IMAGE_SUFFIXES):
                        continue
                    data = tf.extractfile(member).read()
                    img = _decode(member.name, data)
                    if img is not None:
                        yield img

    buf = []
    while True:
        for img in stream_once():
            if shuffle_buffer <= 0:
                yield img
                continue
            buf.append(img)
            if len(buf) > shuffle_buffer:
                j = rng.randint(len(buf))
                buf[j], buf[-1] = buf[-1], buf[j]
                yield buf.pop()
        if not loop:
            break
    while buf:
        j = rng.randint(len(buf))
        buf[j], buf[-1] = buf[-1], buf[j]
        yield buf.pop()
