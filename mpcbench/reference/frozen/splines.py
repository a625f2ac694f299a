"""Sigmoid-blended cubic splines evaluated inside the OCP's stage functions.

Counterpart of mpc_planner_tpu/splines.py (ref solver_generator/spline.py:
4-87). Cubic segments y_i(s) = a(s-s0)^3 + b(s-s0)^2 + c(s-s0) + d are
blended with sigmoids lambda_i(s) = 1/(1+exp((s - s_start_i + 0.02)/0.1))
so the cost is smooth in s across segment boundaries (spline.py:37):

  value = sum_i w_i * y_i(s),  w_i = lambda_i * prod_{j<i} (1 - lambda_j)

with lambda for the *last* segment fixed to 1 (the fallback branch of the
reference's telescoping recursion). Written with tensor ops only, so
torch.func differentiates it and make_fx traces it for the generated K3
stage code (ops/stage_codegen.py).
"""

from __future__ import annotations

import torch


def _blend_weights(s, s_starts):
    """Blend weights w_i(s) for segments with start offsets s_starts[1:].

    s_starts: [num_segments] (the first entry is unused: no lambda for
    segment 0, spline.py:35-37). Returns [..., num_segments].
    """
    num_segments = s_starts.shape[0]
    if num_segments == 1:
        return torch.ones(s.shape + (1,), dtype=s.dtype, device=s.device)
    # lambda_i for i = 0..n-2 gates segment i against everything after it,
    # with segment (i+1)'s start. torch.sigmoid is the overflow-safe form
    # of the reference's 1/(1+exp(t)): the naive one gives inf/inf = NaN
    # under autodiff for |t| > ~88 in f32.
    lam = torch.sigmoid(-(s[..., None] - s_starts[1:] + 0.02) / 0.1)  # [..., n-1]
    # Telescoping product, unrolled over the (static, small) segment count
    # as in the reference (its cumprod form does not lower in its fused
    # kernel; here the unrolled form keeps the traced graph elementwise).
    ws = []
    prod = torch.ones_like(s)
    for i in range(num_segments - 1):
        ws.append(lam[..., i] * prod)
        prod = prod * (1.0 - lam[..., i])
    ws.append(prod)  # last segment: lambda = 1 (fallback branch)
    return torch.stack(ws, dim=-1)


class Spline:
    """1D blended cubic spline addressed by parameter-name bundles
    (ref spline.py Spline)."""

    def __init__(self, params, name: str, num_segments: int, s):
        # Per-segment coefficients gathered from the bound parameter vector.
        self.a = torch.stack([params.get(f"{name}{i}_a") for i in range(num_segments)])
        self.b = torch.stack([params.get(f"{name}{i}_b") for i in range(num_segments)])
        self.c = torch.stack([params.get(f"{name}{i}_c") for i in range(num_segments)])
        self.d = torch.stack([params.get(f"{name}{i}_d") for i in range(num_segments)])
        self.s_start = torch.stack([params.get(f"spline{i}_start") for i in range(num_segments)])
        self.num_segments = num_segments
        self._w = _blend_weights(torch.as_tensor(s), self.s_start)

    def _ds(self, s):
        return torch.as_tensor(s)[..., None] - self.s_start

    def at(self, s):
        ds = self._ds(s)
        vals = self.a * ds**3 + self.b * ds**2 + self.c * ds + self.d
        return torch.sum(self._w * vals, dim=-1)

    def deriv(self, s):
        ds = self._ds(s)
        vals = 3.0 * self.a * ds**2 + 2.0 * self.b * ds + self.c
        return torch.sum(self._w * vals, dim=-1)

    def deriv2(self, s):
        ds = self._ds(s)
        vals = 6.0 * self.a * ds + 2.0 * self.b
        return torch.sum(self._w * vals, dim=-1)


class Spline2D:
    """2D path spline (ref spline.py Spline2D)."""

    def __init__(self, params, num_segments: int, s):
        self.spline_x = Spline(params, "spline_x", num_segments, s)
        self.spline_y = Spline(params, "spline_y", num_segments, s)

    def at(self, s):
        return self.spline_x.at(s), self.spline_y.at(s)

    def deriv(self, s):
        return self.spline_x.deriv(s), self.spline_y.deriv(s)

    def deriv_normalized(self, s):
        dx = self.spline_x.deriv(s)
        dy = self.spline_y.deriv(s)
        norm = torch.sqrt(dx * dx + dy * dy) + 1e-12
        return dx / norm, dy / norm

    def deriv2(self, s):
        return self.spline_x.deriv2(s), self.spline_y.deriv2(s)

    def get_curvature(self, s):
        ddx = self.spline_x.deriv2(s)
        ddy = self.spline_y.deriv2(s)
        # Double-where: sqrt's gradient at exactly 0 is NaN, and a straight
        # reference path hits 0 exactly (the reference's fix 800aa14: it
        # froze every curvature-aware solve on a straight centerline).
        sq = ddx * ddx + ddy * ddy
        safe = torch.where(sq > 1e-20, sq, 1e-20)
        return torch.where(sq > 1e-20, torch.sqrt(safe), 0.0)
