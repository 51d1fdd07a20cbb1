"""ctypes loader for the native library, building it on first use into
``build/tisph_tpu_torch/native/`` beside the package (the source directory
stays clean)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_OUT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "tisph_tpu_torch", "native")
_LIB = os.path.join(_OUT, "libsph_native.so")
_lock = threading.Lock()
_cached: ctypes.CDLL | None = None
_load_failed = False


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _cached, _load_failed
    with _lock:
        if _cached is not None:
            return _cached
        if _load_failed:
            return None
        if not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB)
            < os.path.getmtime(os.path.join(_HERE, "sph_native.cpp"))
        ):
            try:
                subprocess.run(
                    ["make", "-s", f"OUT={_OUT}", _LIB],
                    cwd=_HERE, check=True, capture_output=True, timeout=120,
                )
            except Exception:
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            _load_failed = True
            return None
        lib.tisph_cluster_points.restype = ctypes.c_int64
        lib.tisph_cluster_points.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_double, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tisph_neighbor_counts_2d.restype = None
        lib.tisph_neighbor_counts_2d.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_double, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tisph_bpa_trace_2d.restype = ctypes.c_int64
        lib.tisph_bpa_trace_2d.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_int64),
        ]
        _cached = lib
        return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def cluster_points(lib: ctypes.CDLL, pts: np.ndarray, radius: float) -> list[list[int]]:
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    n, dim = pts.shape
    labels = np.empty(n, dtype=np.int64)
    ncomp = lib.tisph_cluster_points(_dptr(pts), n, dim, radius, _iptr(labels))
    groups: list[list[int]] = [[] for _ in range(ncomp)]
    for i, l in enumerate(labels):
        groups[l].append(i)
    return groups


def neighbor_counts_2d(lib: ctypes.CDLL, pts: np.ndarray, radius: float) -> np.ndarray:
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    counts = np.empty(pts.shape[0], dtype=np.int64)
    lib.tisph_neighbor_counts_2d(_dptr(pts), pts.shape[0], radius, _iptr(counts))
    return counts


def bpa_trace_2d(
    lib: ctypes.CDLL, pts: np.ndarray, members: np.ndarray, radius: float,
    max_dist: float = 0.0,
) -> np.ndarray:
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    members = np.ascontiguousarray(members, dtype=np.int64)
    out = np.empty(pts.shape[0], dtype=np.int64)
    cnt = lib.tisph_bpa_trace_2d(
        _dptr(pts), pts.shape[0], _iptr(members), members.shape[0], radius,
        max_dist, _iptr(out)
    )
    return out[:cnt].copy()
