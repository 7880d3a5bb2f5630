"""ctypes bindings for the native problem-compiler kernels.

Builds `libmcs_native.so` from neighbors.cpp on first use (g++ -O3); every
entry point degrades gracefully to the pure-NumPy fallbacks in models/ when
the toolchain or the build is unavailable (returns None -> caller falls
back). Device compute never goes through this layer — it is host-side problem
compilation only (the analog of the reference's Cython tools module).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libmcs_native.so")
_SRC = os.path.join(_HERE, "neighbors.cpp")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            try:
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-o", _SO, _SRC],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except Exception:
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _build_failed = True
            return None
        lib.mcs_build_neighbor_table.restype = ctypes.c_int64
        lib.mcs_build_neighbor_table.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.mcs_greedy_color.restype = ctypes.c_int64
        lib.mcs_greedy_color.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.mcs_triplet_energy.restype = ctypes.c_double
        lib.mcs_triplet_energy.argtypes = [
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def neighbor_table_native(nspins, rows, cols, vals, maxnb):
    """O(nnz) neighbor-table compile; None if native lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    out = np.zeros((nspins, maxnb, 2), dtype=np.float64)
    rc = lib.mcs_build_neighbor_table(
        nspins, rows.shape[0],
        _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
        _ptr(vals, ctypes.c_double), maxnb, _ptr(out, ctypes.c_double),
    )
    if rc != 0:
        raise ValueError(
            f"spin {-rc - 1} has more than maxnb={maxnb} neighbors; raise maxnb"
        )
    return out


def greedy_color_native(nbr_idx, nbr_val=None):
    """Greedy coloring; None if native lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    nbr_idx = np.ascontiguousarray(nbr_idx, dtype=np.int32)
    nspins, maxnb = nbr_idx.shape
    colors = np.empty(nspins, dtype=np.int32)
    if nbr_val is not None:
        nbr_val = np.ascontiguousarray(nbr_val, dtype=np.float64)
        vptr = _ptr(nbr_val, ctypes.c_double)
    else:
        vptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_double))
    n = lib.mcs_greedy_color(
        nspins, maxnb, _ptr(nbr_idx, ctypes.c_int32), vptr,
        _ptr(colors, ctypes.c_int32),
    )
    return colors, int(n)


def triplet_energy_native(rows, cols, vals, spins):
    """Sparse energy oracle; None if native lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    spins = np.ascontiguousarray(spins, dtype=np.float64)
    return float(
        lib.mcs_triplet_energy(
            rows.shape[0], _ptr(rows, ctypes.c_int64),
            _ptr(cols, ctypes.c_int64), _ptr(vals, ctypes.c_double),
            _ptr(spins, ctypes.c_double),
        )
    )
