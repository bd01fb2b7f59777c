"""Decode speed of the port's JPEG decoder (`native/jpeg_native.cpp`)
against another version of its source, both in one process.

    python -m spinnerf_tpu_torch.tools.jpeg_speed --baseline OLD.cpp
        [--reps 5] [--out jpeg_speed.json]

Both sources are compiled with g++ and the flags of `native/build.py` into
a temporary directory. The committed 12-view scene (`tests/data/jpeg/
scene`, 504 x 672, q95 4:2:0 progressive) is decoded from memory, colour
and gray reads, by each decoder in turn: `reps` rounds of baseline, new,
new, baseline. Each decoder's median ms per megapixel and the ratio new /
baseline are printed as one JSON line (and written to `--out`), beside the
machine's `nvidia-smi` name and power limit where it has a card. A
baseline whose `jd_header` / `jd_decode` take no `flags` argument is bound
without it. Reads no cv2.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

from spinnerf_tpu_torch.native import build as native

SCENE = (Path(__file__).resolve().parents[2] / "tests" / "data" / "jpeg"
         / "scene" / "images")


class Decoder:
    """One compiled decoder source, bound with ctypes."""

    def __init__(self, src: Path, out: Path):
        cmd = [native.cxx_path(), *native.CXX_FLAGS, str(src), "-o", str(out)]
        subprocess.run(cmd, check=True)
        lib = ctypes.CDLL(str(out))
        self.flags = "int32_t flags" in src.read_text()
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        f = [i32] if self.flags else []
        lib.jd_header.argtypes = [ctypes.c_char_p, i64, *f, vp, vp, i64]
        lib.jd_decode.argtypes = [ctypes.c_char_p, i64, *f, i32, vp, i64, vp,
                                  i64]
        self.lib = lib

    def decode(self, data: bytes, channels: int) -> np.ndarray:
        err = ctypes.create_string_buffer(512)
        hwc = np.zeros(3, np.int32)
        f = (0,) if self.flags else ()   # a buffer read
        if self.lib.jd_header(data, len(data), *f, hwc.ctypes.data,
                              ctypes.addressof(err), 512):
            raise ValueError(err.value.decode())
        h, w = int(hwc[0]), int(hwc[1])
        out = np.empty((h, w, channels), np.uint8)
        if self.lib.jd_decode(data, len(data), *f, channels, out.ctypes.data,
                              out.size, ctypes.addressof(err), 512):
            raise ValueError(err.value.decode())
        return out


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no card"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    blobs = [p.read_bytes() for p in sorted(SCENE.glob("*.jpg"))]
    with tempfile.TemporaryDirectory() as tmp:
        decoders = {"baseline": Decoder(args.baseline, Path(tmp) / "old.so"),
                    "new": Decoder(native.SRC / "jpeg_native.cpp",
                                   Path(tmp) / "new.so")}
        for ch in (3, 1):   # the same pixels from both
            for b in blobs:
                if not np.array_equal(decoders["baseline"].decode(b, ch),
                                      decoders["new"].decode(b, ch)):
                    raise AssertionError("the decoders disagree")
        mp = sum(decoders["new"].decode(b, 1).size for b in blobs) / 1e6
        times = {(k, ch): [] for k in decoders for ch in (3, 1)}
        for _ in range(args.reps):
            for k in ("baseline", "new", "new", "baseline"):
                for ch in (3, 1):
                    t0 = time.perf_counter()
                    for b in blobs:
                        decoders[k].decode(b, ch)
                    times[k, ch].append((time.perf_counter() - t0) * 1e3 / mp)
    res = {"card": card(), "views": len(blobs), "megapixels": mp,
           "rounds": 2 * args.reps}
    for ch, read in ((3, "color"), (1, "gray")):
        med = {k: statistics.median(times[k, ch]) for k in decoders}
        res[read] = {"baseline_ms_per_mp": med["baseline"],
                     "new_ms_per_mp": med["new"],
                     "new_over_baseline": med["new"] / med["baseline"]}
    line = json.dumps(res)
    print(line)
    if args.out:
        args.out.write_text(line + "\n")
    return res


if __name__ == "__main__":
    main()
