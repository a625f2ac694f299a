"""Host-side cubic-spline fitting + closest-point search.

Frozen copy of the port's spline_fit.py, numpy route only (the port calls
its native C++ geometry where it builds; this copy keeps the numpy fallback).
Equivalent of the ros_tools `Spline2D` / `tk::spline`
dependency (SURVEY.md §2.4; consumed by the reference's contouring module
at contouring.cpp:37,104-122 and by width/velocity splines at
contouring_constraints.cpp:13-221, path_reference_velocity.cpp:13-133).

Fitting runs on host (numpy) when a new reference path arrives — a
ms-scale event — and produces the per-segment cubic coefficients that are
uploaded to the device as solver parameters (`spline_x{i}_{a..d}`,
`spline{i}_start`), matching the reference's parameter contract.
"""

from __future__ import annotations


import numpy as np


def fit_natural_cubic(t: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Natural cubic spline through (t_i, y_i).

    Returns coeffs [n-1, 4] = (a, b, c, d) per interval with
    y(s) = a*(s-t_i)^3 + b*(s-t_i)^2 + c*(s-t_i) + d  for s in [t_i, t_{i+1}].
    (Same convention as the reference's SplineSegment, spline.py:17-21.)

    """
    t = np.asarray(t, dtype=float)
    y = np.asarray(y, dtype=float)
    n = len(t)
    if n < 2:
        raise ValueError("need at least 2 points")
    h = np.diff(t)
    if np.any(h <= 0):
        raise ValueError("t must be strictly increasing")
    if n == 2:
        # Linear segment
        c = (y[1] - y[0]) / h[0]
        return np.array([[0.0, 0.0, c, y[0]]])

    # Solve for second derivatives M (natural: M_0 = M_{n-1} = 0)
    # Tridiagonal system: h[i-1] M[i-1] + 2(h[i-1]+h[i]) M[i] + h[i] M[i+1] = 6*(...)
    rhs = 6.0 * ((y[2:] - y[1:-1]) / h[1:] - (y[1:-1] - y[:-2]) / h[:-1])
    diag = 2.0 * (h[:-1] + h[1:])
    lower = h[:-1].copy()
    upper = h[1:].copy()
    m_inner = _solve_tridiagonal(lower[1:], diag, upper[:-1], rhs)
    M = np.zeros(n)
    M[1:-1] = m_inner

    a = (M[1:] - M[:-1]) / (6.0 * h)
    b = M[:-1] / 2.0
    c = (y[1:] - y[:-1]) / h - h * (2.0 * M[:-1] + M[1:]) / 6.0
    d = y[:-1].copy()
    return np.stack([a, b, c, d], axis=1)


def _solve_tridiagonal(lower, diag, upper, rhs):
    """Thomas algorithm. lower: [n-1], diag: [n], upper: [n-1], rhs: [n]."""
    n = len(diag)
    diag = diag.astype(float).copy()
    rhs = rhs.astype(float).copy()
    for i in range(1, n):
        w = lower[i - 1] / diag[i - 1]
        diag[i] -= w * upper[i - 1]
        rhs[i] -= w * rhs[i - 1]
    x = np.zeros(n)
    x[-1] = rhs[-1] / diag[-1]
    for i in range(n - 2, -1, -1):
        x[i] = (rhs[i] - upper[i] * x[i + 1]) / diag[i]
    return x


class CubicSpline:
    """Scalar cubic spline y(t) with segment-coefficient access."""

    def __init__(self, t: np.ndarray, y: np.ndarray):
        self.t = np.asarray(t, dtype=float)
        self.coeffs = fit_natural_cubic(self.t, np.asarray(y, dtype=float))

    @property
    def n_segments(self) -> int:
        return len(self.coeffs)

    def _segment(self, s) -> np.ndarray:
        return np.clip(np.searchsorted(self.t, s, side="right") - 1, 0, self.n_segments - 1)

    def __call__(self, s):
        s = np.asarray(s, dtype=float)
        i = self._segment(s)
        ds = s - self.t[i]
        a, b, c, d = self.coeffs[i].T if s.ndim else self.coeffs[i]
        return ((a * ds + b) * ds + c) * ds + d

    def deriv(self, s):
        s = np.asarray(s, dtype=float)
        i = self._segment(s)
        ds = s - self.t[i]
        a, b, c, _ = self.coeffs[i].T if s.ndim else self.coeffs[i]
        return (3.0 * a * ds + 2.0 * b) * ds + c

    def deriv2(self, s):
        s = np.asarray(s, dtype=float)
        i = self._segment(s)
        ds = s - self.t[i]
        a, b, _, _ = self.coeffs[i].T if s.ndim else self.coeffs[i]
        return 6.0 * a * ds + 2.0 * b


class PathSpline2D:
    """2D arclength-parameterized path spline (ros_tools Spline2D equivalent).

    Fits x(s), y(s) natural cubics over accumulated chord length, then
    refines s to approximate true arclength with one resampling pass.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, resample: bool = True):
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        if len(x) < 2:
            raise ValueError("need at least 2 waypoints")
        # Drop consecutive duplicates
        keep = np.ones(len(x), dtype=bool)
        keep[1:] = (np.abs(np.diff(x)) + np.abs(np.diff(y))) > 1e-9
        x, y = x[keep], y[keep]

        s = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x), np.diff(y)))])
        self.sx = CubicSpline(s, x)
        self.sy = CubicSpline(s, y)

        if resample and len(x) > 2:
            # One refinement pass: measure arclength of the fitted spline and
            # refit so that s is close to true arclength (the contouring
            # dynamics integrate ds/dt = v, so s must track real arclength).
            ss = np.linspace(0.0, s[-1], max(50, 10 * len(x)))
            px, py = self.sx(ss), self.sy(ss)
            arc = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(px), np.diff(py)))])
            s_new = np.interp(s, ss, arc)
            # Guard against collapse of intervals
            if np.all(np.diff(s_new) > 1e-9):
                self.sx = CubicSpline(s_new, x)
                self.sy = CubicSpline(s_new, y)
                s = s_new

        self.s = s

    @property
    def length(self) -> float:
        return float(self.s[-1])

    @property
    def n_segments(self) -> int:
        return self.sx.n_segments

    def at(self, s):
        return np.stack([self.sx(s), self.sy(s)], axis=-1)

    def deriv(self, s):
        return np.stack([self.sx.deriv(s), self.sy.deriv(s)], axis=-1)

    def find_segment(self, s: float) -> int:
        return int(self.sx._segment(float(s)))

    def closest_point(self, pos: np.ndarray, s_hint: float = None, window: float = None) -> float:
        """Arclength of the point on the path closest to `pos`.

        Coarse sampling (optionally windowed around `s_hint`) followed by
        Newton refinement — the reference does a segmentwise search in
        contouring.cpp (closest-point search on ros_tools Spline2D).
        """
        pos = np.asarray(pos, dtype=float)
        lo, hi = 0.0, self.length
        if s_hint is not None and window is not None:
            lo = max(0.0, s_hint - window)
            hi = min(self.length, s_hint + window)
            if hi <= lo:
                lo, hi = 0.0, self.length
        ss = np.linspace(lo, hi, 200)
        pts = self.at(ss)
        d2 = np.sum((pts - pos) ** 2, axis=-1)
        s_best = float(ss[np.argmin(d2)])

        # Newton refinement on g(s) = d/ds |p(s)-pos|^2
        for _ in range(10):
            p = self.at(s_best) - pos
            dp = self.deriv(s_best)
            ddp = np.array([self.sx.deriv2(s_best), self.sy.deriv2(s_best)])
            g = 2.0 * float(p @ dp)
            h = 2.0 * float(dp @ dp + p @ ddp)
            if abs(h) < 1e-12:
                break
            step = g / h
            s_best = float(np.clip(s_best - step, 0.0, self.length))
            if abs(step) < 1e-10:
                break
        return s_best

    def segment_param_arrays(self, start_segment: int, num_segments: int):
        """Coefficient arrays for `num_segments` consecutive segments starting
        at `start_segment` (clamped at the end like the reference upload in
        contouring.cpp:50-124).

        Slots BEYOND the final real segment upload a constant segment
        pinned at the path end (a=b=c=0, d=end, s_start=length): the
        traced reference then SATURATES at the end point instead of
        cubic-extrapolating the last segment. Extrapolation let the
        in-solver reference bend arbitrarily once the ego s-state passed
        the path end — measured in the 12-ped corridor: a robot that
        brushed past the 1 m completion ball chased the extrapolated
        curve 13 m off-corridor. With saturation, contour/lag pull it
        back to the end point.

        Returns dict with keys ax, bx, cx, dx, ay, by, cy, dy, s_start —
        each [num_segments].
        """
        last = self.n_segments - 1
        idx = [min(start_segment + i, last) for i in range(num_segments)]
        cx = self.sx.coeffs[idx].copy()
        cy = self.sy.coeffs[idx].copy()
        s_start = np.asarray(self.sx.t[idx], dtype=float).copy()
        end = self.at(self.length)
        for i in range(num_segments):
            if start_segment + i > last:
                cx[i] = (0.0, 0.0, 0.0, end[0])
                cy[i] = (0.0, 0.0, 0.0, end[1])
                s_start[i] = self.length
        return {
            "ax": cx[:, 0], "bx": cx[:, 1], "cx": cx[:, 2], "dx": cx[:, 3],
            "ay": cy[:, 0], "by": cy[:, 1], "cy": cy[:, 2], "dy": cy[:, 3],
            "s_start": s_start,
        }
