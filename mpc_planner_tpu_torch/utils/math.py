"""Math helpers (counterpart of mpc_planner_tpu/utils/math.py; ref
solver_generator/util/math.py:5-11 + ros_tools math)."""

from __future__ import annotations

import math

import numpy as np
import torch


def rotation_matrix(angle: torch.Tensor) -> torch.Tensor:
    """2D rotation matrix of a tensor angle -> [..., 2, 2]."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Four-quadrant arctangent with the reference's arithmetic.

    The same Cephes atanf polynomial (degree 9, branchless range
    reduction to |t| <= tan 22.5deg, quadrant fixup) as the JAX package,
    so traced costs that use it agree with the reference to f32 rounding.
    The sign of y is carried analytically (`sy * a`), so autodiff at
    y == 0 gives d/dy = 1/x, as torch.atan2 does there. Written with
    `torch.where` only: safe under torch.func transforms.
    """
    eps = 1e-30
    sy = torch.where(y >= 0.0, 1.0, -1.0).to(y.dtype)
    sx = torch.where(x >= 0.0, 1.0, -1.0).to(x.dtype)
    ax_ = torch.clamp(sx * x, min=eps)  # |x|
    t = (sy * y) / ax_  # |y|/|x|

    hi = t > 2.414213562373095
    mid = (t > 0.4142135623730950) & ~hi
    t_hi = -1.0 / torch.where(hi, t, torch.ones_like(t))
    t_mid = (t - 1.0) / (t + 1.0)
    r = torch.where(hi, t_hi, torch.where(mid, t_mid, t))
    y0 = torch.where(hi, math.pi / 2, torch.where(mid, math.pi / 4, 0.0)).to(t.dtype)
    z = r * r
    poly = (
        ((8.05374449538e-2 * z - 1.38776856032e-1) * z + 1.99777106478e-1) * z
        - 3.33329491539e-1
    ) * z * r + r
    a = y0 + poly  # atan(|y|/|x|) in [0, pi/2]
    a = torch.where(x < 0, math.pi - a, a)
    return sy * a


def haar_difference_without_abs(angle1, angle2):
    """Signed angle difference wrapped to [-pi, pi) (ref util/math.py:
    10-11). torch.remainder is a floor mod, as jnp.mod is."""
    return torch.remainder(angle1 - angle2 + math.pi, 2.0 * math.pi) - math.pi


def exponential_quantile(lam: float, p: float) -> float:
    """Quantile of Exp(lam) — ros_tools ExponentialQuantile, used for the
    Gaussian->ellipsoid chi multiplier (ellipsoid_constraints.cpp:80)."""
    return float(-np.log(1.0 - p) / lam)


def erf(x: torch.Tensor) -> torch.Tensor:
    """The error function (the reference's `jax_erf`). torch.erf and
    jax.scipy.special.erf differ in the last f32 digits."""
    return torch.erf(x)


def erfinv_approx(x: torch.Tensor) -> torch.Tensor:
    """Inverse error function: rational approximation + 2 Newton steps.

    Matches the reference's hand-rolled CasADi erfinv
    (gaussian_constraints.py:104-114) so chance-constraint margins agree.
    """
    z = torch.sqrt(-torch.log((1.0 - x) / 2.0))
    y = (((1.641345311 * z + 3.429567803) * z - 1.624906493) * z - 1.970840454) / (
        (1.637067800 * z + 3.543889200) * z + 1.0
    )
    for _ in range(2):
        y = y - (erf(y) - x) / (2.0 / math.sqrt(math.pi) * torch.exp(-y * y))
    return y


def douglas_rachford_projection(pos, obstacle_pos, anchor, radius, start_pos):
    """One Douglas-Rachford iteration projecting `pos` out of a disc
    (ros_tools math, used at linearized_constraints.cpp:142-145).

    Numpy host-side version operating on [..., 2] arrays.
    """
    p = np.asarray(pos, dtype=float)
    o = np.asarray(obstacle_pos, dtype=float)
    diff = p - o
    dist = np.linalg.norm(diff, axis=-1, keepdims=True)
    dist = np.maximum(dist, 1e-9)
    proj = o + diff / dist * max(radius, 1e-9)
    inside = (dist < radius)[..., 0]
    out = p.copy()
    if np.ndim(inside) == 0:
        return proj if inside else p
    out[inside] = proj[inside]
    return out


def linspace(start: float, end: float, num: int) -> np.ndarray:
    return np.linspace(start, end, num)


def distance(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, dtype=float) - np.asarray(b, dtype=float)))
