"""ctypes binding + on-demand build of the C++ serial FSM solver
(native/fsm.cc). Used as the golden oracle for the parallel solvers' fixed
point and as a host-side traveltime-table builder for locate-only runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from mceik_tpu.grid import Grid

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "fsm.cc")
_LIB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_fsm.so")

_lock = threading.Lock()
_lib = None


def _build() -> str:
    # A per-process temporary name: parallel test workers may build at
    # the same time, and each must rename a complete library into place.
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)
    return _LIB


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_LIB)
        lib.fsm_solve.restype = ctypes.c_int
        lib.fsm_solve.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return lib


def have_native() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def fsm_solve(slowness, src_xyz, grid: Grid, seed_radius: float = 3.0,
              tol: float = 1e-6, max_passes: int = 100):
    """Serial Gauss-Seidel FSM solve on the host. Returns (T, n_passes)."""
    lib = _load()
    s = np.ascontiguousarray(np.asarray(slowness, dtype=np.float32))
    if s.shape != grid.shape:
        raise ValueError(f"slowness {s.shape} != grid {grid.shape}")
    shape = np.asarray(grid.shape, dtype=np.int64)
    spacing = np.asarray(grid.spacing, dtype=np.float64)
    src = (np.asarray(src_xyz, dtype=np.float64)
           - np.asarray(grid.origin, dtype=np.float64))
    out = np.empty(grid.shape, dtype=np.float32)
    n_passes = lib.fsm_solve(
        grid.ndim,
        shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        spacing.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        float(seed_radius), float(tol), int(max_passes),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if n_passes < 0:
        raise RuntimeError("fsm_solve failed")
    return out, n_passes
