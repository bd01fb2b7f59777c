"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles, at first use,
into `build/lib<name>-<source hash>.so` beside the package (the directory is
git-ignored), so a changed source never loads a stale library. Nothing is
built or loaded when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

_BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC")
# Per source. -fmad=false: both hash sources rebuild the corner geometry
# in the kernel, and it must round as the f32 host index function does, bit
# for bit (see the notes in csrc/hash_encode_win.cu and
# csrc/hash_encode_idx.cu); the MLP kernels need no such rule.
NVCC_FLAGS = {
    "hash_encode_win": _BASE_FLAGS + ("-fmad=false", "-Xptxas", "-v"),
    "fused_mlp_pe": _BASE_FLAGS + ("-Xptxas", "-v"),
    "fused_mlp_gen": _BASE_FLAGS + ("-Xptxas", "-v"),
    "hash_encode_idx": _BASE_FLAGS + ("-fmad=false", "-Xptxas", "-v"),
    "kbench_cal": _BASE_FLAGS + ("-Xptxas", "-v"),
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS[name]).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def report_path(name: str) -> Path:
    """Where the compiler's output for `library_path(name)` is kept."""
    return library_path(name).with_suffix(".log")


def build(names) -> dict[str, str]:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together. Returns each named source's
    compiler output (ptxas register and spill report), of this build or the
    one that built the library before ("" where none was kept); raises on
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS[name], "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        report_path(name).write_text(log)
        os.replace(tmp, out)     # atomic: a reader never sees a partial file
    return {name: report_path(name).read_text()
            if report_path(name).exists() else "" for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
