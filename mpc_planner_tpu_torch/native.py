"""ctypes binding of the native (C++) host geometry: spline fit, closest
point, the space-time PRM search, the Douglas-Rachford projection and the
free-space polytope.

Counterpart of mpc_planner_tpu/native/__init__.py. It builds the port's
own copy of the source, csrc/geometry.cpp (plain C++; byte-equal to
mpc_planner_tpu/native/src/geometry.cpp, which a test checks), with the
same g++ flags, into the port's git-ignored `_build/geometry/` at first
use, so both packages return bit-equal results on one machine. This is host
code, not a device kernel: where g++ is missing the callers keep their
numpy fallbacks (spline_fit.py, guidance/prm.py), as the reference does;
`available()` says which one runs.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "csrc", "geometry.cpp")
BUILD_DIR = os.path.join(_HERE, "_build", "geometry")
LIB = os.path.join(BUILD_DIR, "_geometry.so")
# The reference's flags (mpc_planner_tpu/native/__init__.py:30-33).
FLAGS = ["-O2", "-march=native", "-shared", "-fPIC", "-std=c++17"]

logger = logging.getLogger(__name__)

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_lock = threading.Lock()


def _build() -> Optional[str]:
    """Compile into a temporary file and rename it over LIB, so processes
    that build at once never load a half-written library. Returns the
    compiler's error text, or None."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, SRC, "-o", tmp], capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        return str(e)
    if proc.returncode != 0:
        os.unlink(tmp)
        return proc.stderr[-2000:]
    os.replace(tmp, LIB)
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it if needed; None if it cannot be
    built (then the numpy fallbacks run)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if not os.path.exists(SRC):
            _build_error = f"{SRC} not found"
        elif not os.path.exists(LIB) or os.path.getmtime(LIB) < os.path.getmtime(SRC):
            _build_error = _build()
        if _build_error is not None:
            logger.warning("native geometry: build failed, using numpy fallbacks:\n%s",
                           _build_error)
            return None
        lib = ctypes.CDLL(LIB)
        c_d = ctypes.POINTER(ctypes.c_double)
        c_i = ctypes.POINTER(ctypes.c_int64)
        lib.fit_natural_cubic.restype = ctypes.c_int
        lib.fit_natural_cubic.argtypes = [c_d, c_d, ctypes.c_int64, c_d]
        lib.closest_point.restype = ctypes.c_double
        lib.closest_point.argtypes = [c_d, c_d, c_d, ctypes.c_int64, ctypes.c_double,
                                      ctypes.c_double, ctypes.c_double, ctypes.c_double,
                                      ctypes.c_int64]
        lib.dr_project.restype = None
        lib.dr_project.argtypes = [c_d, ctypes.c_int64, c_d, c_d, ctypes.c_int64, ctypes.c_int]
        lib.free_polytope.restype = None
        lib.free_polytope.argtypes = [ctypes.c_double, ctypes.c_double, c_d, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_double, c_d]
        lib.prm_search.restype = ctypes.c_int
        lib.prm_search.argtypes = [c_d, c_i, ctypes.c_int64, ctypes.c_int64, c_d, c_d, c_d,
                                   ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_int64, ctypes.c_int64, c_i, c_d,
                                   c_i, c_i]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def fit_natural_cubic(t: np.ndarray, y: np.ndarray) -> Optional[np.ndarray]:
    """Natural cubic spline coefficients [n-1, 4] (a, b, c, d), or None."""
    lib = get_lib()
    if lib is None:
        return None
    t = np.ascontiguousarray(t, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    n = len(t)
    out = np.empty((n - 1, 4), dtype=np.float64)
    rc = lib.fit_natural_cubic(_ptr(t), _ptr(y), n, _ptr(out))
    if rc != 0:
        raise ValueError(f"fit_natural_cubic failed with code {rc}")
    return out


def closest_point(coeffs_x, coeffs_y, knots, px, py, lo, hi, samples=200) -> Optional[float]:
    """Arclength in [lo, hi] of the path point closest to (px, py), or None."""
    lib = get_lib()
    if lib is None:
        return None
    cx = np.ascontiguousarray(coeffs_x, dtype=np.float64)
    cy = np.ascontiguousarray(coeffs_y, dtype=np.float64)
    kn = np.ascontiguousarray(knots, dtype=np.float64)
    return float(lib.closest_point(_ptr(cx), _ptr(cy), _ptr(kn), len(kn) - 1, px, py, lo, hi,
                                   samples))


def dr_project(points, obstacles, radii, iters: int = 3) -> Optional[np.ndarray]:
    """Douglas-Rachford-style projection of points [K, 2] (copied) out of the
    discs around obstacles [K, M, 2] with radii [M]; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64).copy()
    obs = np.ascontiguousarray(obstacles, dtype=np.float64)
    rad = np.ascontiguousarray(radii, dtype=np.float64)
    lib.dr_project(_ptr(pts), pts.shape[0], _ptr(obs), _ptr(rad), rad.shape[0], iters)
    return pts


def free_polytope(seed, points, max_constraints: int, radius: float) -> Optional[np.ndarray]:
    """Halfspaces [max_constraints, 3] of a convex free region around `seed`
    among occupied `points` [P, 2]; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64)
    out = np.empty((max_constraints, 3), dtype=np.float64)
    lib.free_polytope(float(seed[0]), float(seed[1]), _ptr(pts), pts.shape[0], max_constraints,
                      radius, _ptr(out))
    return out


def prm_search(pos, tk, n_goals: int, pred, clear, dt: float, v_max: float,
               labels_per_node: int, max_out: int, goal_cost=None):
    """Space-time Visibility-PRM core (guidance/prm.py's search).

    pos [n, 2], tk [n] stage indices (node 0 = start, the last n_goals
    nodes = goals), pred [M, N+1, 2] obstacle tracks, clear [M] clearance
    radii, goal_cost [n_goals] optional additive per-goal penalty. Returns
    a list of (cost, node chain) sorted by penalized cost and homology-key
    distinct, or None when the library is unavailable or refuses the input
    (more than 64 obstacles)."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    tk = np.ascontiguousarray(tk, dtype=np.int64)
    pred = np.ascontiguousarray(pred, dtype=np.float64)
    clear = np.ascontiguousarray(clear, dtype=np.float64)
    gc = np.ascontiguousarray(np.zeros(n_goals) if goal_cost is None else goal_cost,
                              dtype=np.float64)
    n = pos.shape[0]
    out_count = np.zeros(1, dtype=np.int64)
    out_cost = np.empty(max_out, dtype=np.float64)
    out_len = np.empty(max_out, dtype=np.int64)
    out_nodes = np.empty((max_out, n), dtype=np.int64)
    rc = lib.prm_search(_ptr(pos), _iptr(tk), n, n_goals, _ptr(gc), _ptr(pred), _ptr(clear),
                        pred.shape[0], pred.shape[1], dt, v_max, labels_per_node, max_out,
                        _iptr(out_count), _ptr(out_cost), _iptr(out_len), _iptr(out_nodes))
    if rc != 0:
        return None
    k = int(out_count[0])
    return [(float(out_cost[i]), out_nodes[i, : out_len[i]].tolist()) for i in range(k)]
