"""Native (C) host helpers: fast payload bit-unpacking.

Counterpart of ``baseband_tasks_tpu/native`` (the same C source and the
same numpy fallbacks, bit for bit).  The shared library is compiled on
first use with the system compiler (``$CC``, default ``cc -O3``) into the
git-ignored ``build/native/`` beside the package, named by a hash of the
source, so an edited source is never served by a stale build; without a
compiler the numpy fallbacks run.  This is the file readers' host decode
(``io/``), not a device path: the device decoders are
``ops/unpack.py``'s.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "unpack_2bit", "unpack_4bit", "unpack_8bit",
           "pack_2bit"]

_SRC = Path(__file__).resolve().parent / "unpack.c"
BUILD_DIR = _SRC.parent.parent.parent / "build" / "native"
_CFLAGS = ["-O3", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_tried = False


def _library_path():
    digest = hashlib.sha256(" ".join(_CFLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"libunpack_{digest.hexdigest()[:16]}.so"


def _build(path):
    """Compile the source into ``path`` (through a temporary file, so a
    concurrent process never loads a half-written library)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CC", "cc"), *_CFLAGS, str(_SRC),
                        "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = _library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError):
            return None      # no compiler: the numpy fallbacks run
        fp = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.unpack_2bit.argtypes = [u8p, ctypes.c_size_t, fp, fp]
        lib.unpack_4bit.argtypes = [u8p, ctypes.c_size_t, ctypes.c_float,
                                    fp]
        lib.unpack_8bit.argtypes = [u8p, ctypes.c_size_t, ctypes.c_float,
                                    fp]
        lib.pack_2bit.argtypes = [fp, ctypes.c_size_t, fp, u8p]
        for fn in (lib.unpack_2bit, lib.unpack_4bit, lib.unpack_8bit,
                   lib.pack_2bit):
            fn.restype = None
        _lib = lib
        return _lib


def available():
    """True when the native library is (or can be) loaded."""
    return _load() is not None


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _as_u8(raw):
    raw = np.ascontiguousarray(raw, dtype=np.uint8).ravel()
    return raw, raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def unpack_2bit(raw, levels):
    """Expand bytes to 4 floats each via a 4-level table (LSB-first)."""
    lib = _load()
    levels = np.ascontiguousarray(levels, dtype=np.float32)
    if lib is None:
        raw = np.asarray(raw, dtype=np.uint8).ravel()
        vals = np.empty(raw.size * 4, np.uint8)
        vals[0::4] = raw & 0x3
        vals[1::4] = (raw >> 2) & 0x3
        vals[2::4] = (raw >> 4) & 0x3
        vals[3::4] = raw >> 6
        return levels[vals]
    raw, rp = _as_u8(raw)
    out = np.empty(raw.size * 4, np.float32)
    lib.unpack_2bit(rp, raw.size, _fp(levels), _fp(out))
    return out


def unpack_4bit(raw, offset=7.5):
    """Expand bytes to 2 floats each, ``nibble - offset``, low first."""
    lib = _load()
    if lib is None:
        raw = np.asarray(raw, dtype=np.uint8).ravel()
        vals = np.empty(raw.size * 2, np.uint8)
        vals[0::2] = raw & 0xF
        vals[1::2] = raw >> 4
        return vals.astype(np.float32) - np.float32(offset)
    raw, rp = _as_u8(raw)
    out = np.empty(raw.size * 2, np.float32)
    lib.unpack_4bit(rp, raw.size, ctypes.c_float(offset), _fp(out))
    return out


def unpack_8bit(raw, offset=127.5):
    """Bytes to floats, ``byte - offset``."""
    lib = _load()
    if lib is None:
        return (np.asarray(raw, dtype=np.float32).ravel()
                - np.float32(offset))
    raw, rp = _as_u8(raw)
    out = np.empty(raw.size, np.float32)
    lib.unpack_8bit(rp, raw.size, ctypes.c_float(offset), _fp(out))
    return out


def pack_2bit(values, thresholds):
    """Quantize floats to packed 2-bit codes with 3 thresholds."""
    values = np.ascontiguousarray(values, dtype=np.float32).ravel()
    thresholds = np.ascontiguousarray(thresholds, dtype=np.float32)
    lib = _load()
    if lib is None:
        idx = np.digitize(values, thresholds).astype(np.uint8)
        pad = (-idx.size) % 4
        if pad:
            idx = np.concatenate([idx, np.zeros(pad, np.uint8)])
        return (idx[0::4] | (idx[1::4] << 2) | (idx[2::4] << 4)
                | (idx[3::4] << 6))
    n = values.size
    out = np.empty((n + 3) // 4, np.uint8)
    lib.pack_2bit(_fp(values), n, _fp(thresholds),
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out
