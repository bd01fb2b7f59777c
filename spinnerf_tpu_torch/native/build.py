"""Build the port's native sources with g++ and load them with ctypes.

`native/<name>.cpp` compiles, at first use, into `build/lib<name>-<source
hash>.so` beside the package (the directory the CUDA kernels build into,
git-ignored), so a changed source never loads a stale library. Each build
writes a file of its own and renames it into place, so processes that
build at once never load a partial library. A failed build raises with the
compiler's output.

    python -m spinnerf_tpu_torch.native.build     # build every native/*.cpp
                                                  # now, print the paths
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

from spinnerf_tpu_torch.ops.cuda_build import BUILD_DIR

SRC = Path(__file__).resolve().parent
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_loaded: dict[str, ctypes.CDLL] = {}


def cxx_path() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++")):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("g++ not found (set CXX or put g++ on PATH)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((SRC / f"{name}.cpp").read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str = "colmap_native") -> Path:
    """Compile `native/<name>.cpp` unless its library exists; returns the
    library's path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx_path(), *CXX_FLAGS, str(SRC / f"{name}.cpp"), "-o", str(tmp)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for native/{name}.cpp "
                           f"({' '.join(cmd)}):\n{proc.stdout}")
    os.replace(tmp, out)     # atomic: a reader never sees a partial file
    return out


def load(name: str = "colmap_native") -> ctypes.CDLL:
    """The loaded library of `native/<name>.cpp`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib


if __name__ == "__main__":
    for src in sorted(SRC.glob("*.cpp")):
        print(build(src.stem))
    sys.exit(0)
