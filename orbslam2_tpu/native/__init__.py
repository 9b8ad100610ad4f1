"""ctypes loader for the native host-runtime kernels (mapops.cpp).

Compiles the shared library on first use with g++ into `_build/` (listed in
.gitignore), under a name keyed by a hash of the source and the host's
machine type, so a library built on one host is never loaded on another
kind. It is built for the generic target of that machine type (no
`-march=native`): the tree may be copied to a host with another CPU.
All entry points degrade gracefully: callers fall back to numpy when the
toolchain is unavailable, and the fallback is reported once on stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
_SRC = _DIR / "mapops.cpp"
_BUILD = _DIR / "_build"
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library for this source and this machine type lives."""
    key = hashlib.sha256(_SRC.read_bytes()
                         + platform.machine().encode()).hexdigest()[:16]
    return _BUILD / f"libmapops-{key}.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename: concurrent test workers may race
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(_SRC),
                    "-o", str(tmp)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        i64 = ctypes.c_int64
        lib.covis_weights.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64, i64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.medoid_descriptors.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i64, ctypes.c_void_p]
        lib.covis_matrix.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64,
            ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
    except Exception as e:
        _lib = None
        print(f"orbslam2 native map ops unavailable ({type(e).__name__}: "
              f"{e}); using the numpy fallback", file=sys.stderr)
    return _lib


def available() -> bool:
    return _load() is not None


def covis_weights(kf_pt: np.ndarray, kf_valid: np.ndarray, k: int,
                  n_points: int, scratch: np.ndarray | None = None
                  ) -> np.ndarray | None:
    """Native covisibility voting; returns None if the library is missing."""
    lib = _load()
    if lib is None:
        return None
    K, N = kf_pt.shape
    kf_pt = np.ascontiguousarray(kf_pt, np.int32)
    valid = np.ascontiguousarray(kf_valid, np.uint8)
    if scratch is None:
        scratch = np.zeros(n_points, np.uint8)
    out = np.zeros(K, np.int64)
    lib.covis_weights(kf_pt.ctypes.data, valid.ctypes.data, K, N, n_points,
                      int(k), scratch.ctypes.data, out.ctypes.data)
    return out


def covis_matrix(kf_pt: np.ndarray, kf_valid: np.ndarray, n_points: int
                 ) -> np.ndarray | None:
    """Full [K, K] shared-point counts (upper triangular + mirrored);
    returns None if the library is missing."""
    lib = _load()
    if lib is None:
        return None
    K, N = kf_pt.shape
    kf_pt = np.ascontiguousarray(kf_pt, np.int32)
    valid = np.ascontiguousarray(kf_valid, np.uint8)
    scratch = np.full(n_points, -1, np.int32)
    out = np.zeros((K, K), np.int32)
    lib.covis_matrix(kf_pt.ctypes.data, valid.ctypes.data, K, N, n_points,
                     scratch.ctypes.data, out.ctypes.data)
    return out + out.T


def medoid_descriptors(descs: np.ndarray, offsets: np.ndarray
                       ) -> np.ndarray | None:
    """descs [M, 8] u32 grouped by offsets [G+1]; returns medoid index per
    group, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    descs = np.ascontiguousarray(descs, np.uint32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    G = len(offsets) - 1
    out = np.zeros(G, np.int64)
    lib.medoid_descriptors(descs.ctypes.data, offsets.ctypes.data, G,
                           out.ctypes.data)
    return out
