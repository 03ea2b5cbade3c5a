"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface, so ``nvcc`` compiles them into a
shared library in seconds (PyTorch's own extension builder would include
its headers and take minutes), and ``ctypes`` loads it.  The library goes
to ``build/kernels/`` beside the package, named by a hash of the sources
and flags, so an edited source is never served by a stale build.  Each C
entry point returns the launch's ``cudaGetLastError()`` code; the kernel
wrappers raise when it is not 0.

Nothing here runs at import: the first kernel launch builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["library", "build", "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of csrc/dedisperse.cu and their argument types
_SIGNATURES = {
    "bbt_k1_packed": [_P] * 9 + [_I] * 6 + [_F] * 5 + [_I, _P],
    "bbt_k1_float": [_P] * 9 + [_I] * 5 + [_I, _P],
    "bbt_k2": [_P] * 4 + [_I] * 3 + [_I, _P],
    "bbt_k3_fold": [_P] * 5 + [_I] * 6 + [_I, _P],
}

_lib = None


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH,
    or the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + \
            [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit "
                       "to build the Hopper kernels")


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def build():
    """Compile ``csrc/*.cu`` if no library of these sources exists yet.

    Returns ``(path, log)``: the library and the compiler's output
    (``-Xptxas -v`` registers and shared memory per kernel; empty when a
    cached build was found).
    """
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        digest.update(p.name.encode() + p.read_bytes())
    so = BUILD_DIR / f"libbbt_kernels_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    units = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, *units],
                              capture_output=True, text=True, check=False)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, proc.stdout + proc.stderr


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
