"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface, so ``nvcc`` compiles each of them
into a shared library in seconds (``torch.utils.cpp_extension`` would
include PyTorch's headers and take minutes), and ``ctypes`` loads them.  The
sources are compiled in parallel, one ``nvcc`` each, into ``build/kernels/``
beside the package; each library is named by a hash of its source, the
shared headers and the flags, so an edited source is never served by a
stale build.  Each C entry point returns the launch's ``cudaGetLastError()``
code; :func:`launch` raises when it is not 0 and otherwise adds one to the
kernel's count in :data:`launch_counts`.

Nothing here runs at import: the first kernel launch builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import types
from pathlib import Path

import torch

__all__ = ["library", "build", "nvcc_path", "launch", "launch_counts",
           "reset_launch_counts", "kernel_tile", "kernel_form"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
_PLL = ctypes.POINTER(_LL)          # a host array of device addresses
_PI = ctypes.POINTER(_I)
# C entry points of csrc/*.cu and their argument types (each launch ends
# with the device index and the stream)
_SIGNATURES = {
    "bbt_k1_packed": [_P] * 9 + [_I] * 6 + [_F] * 5 + [_I, _P],
    "bbt_k1_float": [_P] * 9 + [_I] * 5 + [_I, _P],
    "bbt_k1_window": [_P] * 4 + [_I] * 3 + [_I, _P],
    "bbt_k2": [_P] * 4 + [_I] * 3 + [_I, _P],
    "bbt_k3_fold": [_P] * 5 + [_I] * 6 + [_I, _P],
    "bbt_k2_fwd": [_P] * 4 + [_F] + [_I] * 3 + [_I, _P],
    "bbt_k2_inv": [_P] * 4 + [_F] + [_I] * 3 + [_I, _P],
    "bbt_k3_trim": [_P] * 4 + [_I] * 5 + [_I, _P],
    "bbt_k1_stream": [_P] * 5 + [_F] + [_P] * 2 + [_I] * 4 + [_I, _P],
    "bbt_lane_mix": [_P] * 5 + [_I] * 3 + [_I, _P],
    "bbt_lane_mix_tile": [_PI],
    "bbt_pfb_fwd": [_P] * 7 + [_F] + [_P] * 2 + [_I] * 3 + [_I, _P],
    "bbt_pfb_fwd_tile": [_PI],
    "bbt_k1_planes": [_P] * 3 + [_I] * 3 + [_I, _P],
    "bbt_k1_stream_planes": [_P] * 6 + [_I] * 5 + [_I, _P],
    "bbt_k2_theta": [_P] * 3 + [_I] * 3 + [_I, _P],
    "bbt_k3_fold_stokes": [_P] * 5 + [_I] * 6 + [_I, _P],
    "bbt_k3_power": [_P] * 3 + [_I] * 3 + [_I, _P],
    "bbt_bank_power": [_P] * 4 + [_I] * 3 + [_I, _P],
    "bbt_bank_power_tile": [_PI],
    "bbt_accel_corr": [_P] * 3 + [_I] * 6 + [_I, _P],
    "bbt_resident": [_P] * 12 + [_I] * 7 + [_I, _P],
    "bbt_resident_form": [_I] * 4,
    "bbt_k2_form": [_I] * 3,
    "bbt_k1_form": [_I] * 3,
    "bbt_halo_edges": [_PLL] * 3 + [_I] * 5 + [_LL, _I] + [_I, _P],
    "bbt_enable_peer": [_I, _I],
}
# the bf16-intermediate passes take the arguments of their float32 twins
_SIGNATURES.update({f"{name}_bf16": _SIGNATURES[name] for name in (
    "bbt_k1_packed", "bbt_k1_float", "bbt_k2", "bbt_k3_fold",
    "bbt_k3_fold_stokes")})
_SIGNATURES["bbt_k2_bf16_chirp"] = _SIGNATURES["bbt_k2"]

#: kernel launches since the last :func:`reset_launch_counts`, by launch
#: name (the flagship's K1p/K1f/K2/K3, the four-step passes, the
#: streaming stage A, the lane mix, the forward PFB without and with its
#: DFT, the flagship's variants: full-Stokes K3, K3 as |.|^2, K2 on a
#: phase-plane chirp, K1 from planes-first windows and edges; the accel
#: search's bank product and bank correlation, the single-pass resident
#: dedisperse -> fold, and the flagship passes on bf16 intermediates:
#: K1p, K1f, K2 with a float32 or a bf16 chirp, K3 power and Stokes;
#: and the halo edges of a time-sharded mesh)
launch_counts = {"k1_packed": 0, "k1_float": 0, "k2": 0, "k3_fold": 0,
                 "k1_window": 0, "k2_fwd": 0, "k2_inv": 0, "k3_trim": 0,
                 "k1_stream": 0, "lane_mix": 0, "pfb_fwd": 0,
                 "pfb_fwd_dft": 0, "k3_fold_stokes": 0, "k3_power": 0,
                 "k2_theta": 0, "k1_planes": 0, "k1_stream_planes": 0,
                 "bank_power": 0, "accel_corr": 0, "resident": 0,
                 "k1_packed_bf16": 0, "k1_float_bf16": 0, "k2_bf16": 0,
                 "k2_bf16_chirp": 0, "k3_fold_bf16": 0,
                 "k3_fold_stokes_bf16": 0, "halo_remote": 0}

_lib = None


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


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


def _library_path(unit, headers):
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [unit, *headers]:
        digest.update(p.name.encode() + p.read_bytes())
    return BUILD_DIR / f"lib{unit.stem}_{digest.hexdigest()[:16]}.so"


def build():
    """Compile every ``csrc/*.cu`` that has no library of its current
    sources yet, all at once.

    Returns ``(paths, log)``: the libraries and the compilers' output
    (``-Xptxas -v`` registers and shared memory per kernel; empty for a
    cached build).
    """
    units = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    paths = [_library_path(u, headers) for u in units]
    todo = [(u, so) for u, so in zip(units, paths) if not so.exists()]
    if not todo:
        return paths, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    try:
        for unit, so in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(unit)],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((unit, so, tmp, proc))
        log, failed = [], []
        for unit, so, tmp, proc in jobs:
            out = proc.communicate()[0]
            log.append(f"{unit.name}:\n{out}")
            if proc.returncode:
                failed.append(f"{unit.name} ({proc.returncode}):\n{out}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths, "".join(log)


def library():
    """A namespace of the C entry points of every kernel library (built on
    first use), with their argument types set."""
    global _lib
    if _lib is None:
        paths, _ = build()
        libs = [ctypes.CDLL(str(p)) for p in paths]
        fns = {}
        for name, argtypes in _SIGNATURES.items():
            found = [getattr(lib, name) for lib in libs if hasattr(lib, name)]
            if len(found) != 1:
                raise RuntimeError(f"{name}: found in {len(found)} kernel "
                                   f"libraries, expected 1")
            fn = found[0]
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        _lib = types.SimpleNamespace(**fns)
    return _lib


def kernel_form(fn, *args, other="shared"):
    """Which form of a kernel a launch of this shape runs, from its C
    query ``fn`` (``bbt_k2_form``, ``bbt_resident_form``, ``bbt_k1_form``):
    'register' (the column in registers, compiled for its size), else
    ``other``: 'shared' (the shared-memory body kept for columns the
    register block cannot hold) or, for K1, 'general' (the register
    kernel on a run-time pass plan)."""
    form = getattr(library(), fn)(*args)
    if form not in (0, 1):
        raise ValueError(f"{fn}{args}: no kernel takes this shape")
    return "register" if form else other


def kernel_tile(fn):
    """(columns, depth): the tile a 3xTF32 kernel's staged operand is laid
    out for, from its C entry point ``fn`` (``ops/tf32.py``)."""
    tile = (_I * 2)()
    getattr(library(), fn)(tile)
    return tuple(tile)


def launch(name, fn, device, *args):
    """Call entry point ``fn`` with ``args``, the device index and the
    current stream; raise on a launch error, else count one ``name``."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(library(), fn)(*args, index, stream)
    if err:
        raise RuntimeError(f"{fn} launch failed with CUDA error {err}")
    launch_counts[name] += 1
