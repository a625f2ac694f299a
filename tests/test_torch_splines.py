"""Port vs reference: splines, spline fitting, the native geometry binding
and the math helpers of the contouring cost.

* `Spline` / `Spline2D` (at, deriv, deriv2, deriv_normalized,
  get_curvature) at seeded random coefficients and s: values within 1e-5
  relative, derivatives (torch.func against jax.grad, with respect to s
  and to the parameter vector) within 1e-4 relative; a straight path has
  curvature 0 and a finite curvature gradient in both packages (the
  double-where guard).
* `spline_fit.PathSpline2D` / `CubicSpline` and the native calls
  (`fit_natural_cubic`, `closest_point`, `prm_search`): bit-equal to the
  JAX package on the corridor path (both build the same geometry.cpp with
  the same flags, or both fall back to the same numpy code).
* `atan2` (y == 0, x < 0 included) with its gradient, and
  `haar_difference_without_abs`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

import mpc_planner_tpu.native as jax_native
import mpc_planner_tpu.spline_fit as jax_fit
import mpc_planner_tpu.splines as jax_splines
from mpc_planner_tpu.parameters import ParameterRegistry as JaxRegistry
from mpc_planner_tpu.utils import math as jax_math
from mpc_planner_tpu_torch import native, spline_fit, splines
from mpc_planner_tpu_torch.parameters import ParameterRegistry
from mpc_planner_tpu_torch.utils import math as torch_math

torch.set_num_threads(1)

RTOL_VALUE, RTOL_DERIV = 1e-5, 1e-4
NSEG = 5


def _registry(cls):
    reg = cls()
    for i in range(NSEG):
        for coef in "abcd":
            reg.add(f"spline_x{i}_{coef}", bundle_name=f"spline_x_{coef}")
        for coef in "abcd":
            reg.add(f"spline_y{i}_{coef}", bundle_name=f"spline_y_{coef}")
        reg.add(f"spline{i}_start", bundle_name="spline_start")
    return reg


REG_J, REG_T = _registry(JaxRegistry), _registry(ParameterRegistry)


def _params(rng, straight=False):
    """A coefficient vector: increasing segment starts, random cubics (a
    straight line along x when `straight`)."""
    p = np.zeros(REG_T.npar)
    starts = np.cumsum(rng.uniform(0.8, 2.0, NSEG)) - 1.0
    for i in range(NSEG):
        for coef in "abcd":
            for axis in "xy":
                v = rng.normal(0.0, 0.3)
                if straight:
                    v = {"a": 0.0, "b": 0.0, "c": 1.0 if axis == "x" else 0.0,
                         "d": starts[i] if axis == "x" else 0.0}[coef]
                p[REG_T.index(f"spline_{axis}{i}_{coef}")] = v
        p[REG_T.index(f"spline{i}_start")] = starts[i]
    return p.astype(np.float32)


def _eval(mod, reg, xp, which, s, p):
    path = mod.Spline2D(reg.bind(p), NSEG, s)
    if which == "at_x":
        return path.at(s)[0]
    if which == "at_y":
        return path.at(s)[1]
    if which == "deriv":
        return path.deriv(s)[1]
    if which == "deriv2":
        return path.deriv2(s)[0]
    if which == "deriv_normalized":
        return path.deriv_normalized(s)[0]
    if which == "curvature":
        return path.get_curvature(s)
    if which == "spline_v":  # a 1-D Spline through the same registry
        return mod.Spline(reg.bind(p), "spline_x", NSEG, s).at(s) * xp.ones(())
    raise ValueError(which)


WHICH = ["at_x", "at_y", "deriv", "deriv2", "deriv_normalized", "curvature", "spline_v"]


@pytest.mark.parametrize("which", WHICH)
def test_spline_values_and_derivatives(which):
    rng = np.random.default_rng(WHICH.index(which))
    for trial in range(6):
        p = _params(rng)
        s = np.float32(rng.uniform(-0.5, 7.0))

        def fj(s_, p_):
            return _eval(jax_splines, REG_J, jnp, which, s_, p_)

        def ft(s_, p_):
            return _eval(splines, REG_T, torch, which, s_, p_)

        sj, pj = jnp.asarray(s), jnp.asarray(p)
        st, pt = torch.tensor(s), torch.as_tensor(p)
        ref, out = float(fj(sj, pj)), float(ft(st, pt))
        assert abs(out - ref) <= RTOL_VALUE * max(abs(ref), 1.0), (trial, out, ref)
        for argnum in (0, 1):
            dref = np.asarray(jax.grad(fj, argnums=argnum)(sj, pj))
            dout = grad(ft, argnums=argnum)(st, pt).numpy()
            assert np.abs(dout - dref).max() <= RTOL_DERIV * max(np.abs(dref).max(), 1.0), (
                trial, argnum)


def test_straight_path_curvature_is_zero_with_finite_gradient():
    p = _params(np.random.default_rng(5), straight=True)
    for s in (0.3, 2.0, 4.5):
        st, pt = torch.tensor(np.float32(s)), torch.as_tensor(p)
        sj, pj = jnp.asarray(np.float32(s)), jnp.asarray(p)
        k_t = splines.Spline2D(REG_T.bind(pt), NSEG, st).get_curvature(st)
        k_j = jax_splines.Spline2D(REG_J.bind(pj), NSEG, sj).get_curvature(sj)
        assert float(k_t) == 0.0 and float(k_j) == 0.0
        g_t = grad(lambda s_, p_: splines.Spline2D(REG_T.bind(p_), NSEG, s_).get_curvature(s_),
                   argnums=(0, 1))(st, pt)
        g_j = jax.grad(lambda s_, p_: jax_splines.Spline2D(REG_J.bind(p_), NSEG, s_)
                       .get_curvature(s_), argnums=(0, 1))(sj, pj)
        for a, b in zip(g_t, g_j):
            assert np.all(np.isfinite(a.numpy())) and np.all(np.isfinite(np.asarray(b)))
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_blend_weights_match_and_sum_to_one():
    starts = np.array([0.0, 1.0, 2.0, 3.0, 4.5], np.float32)
    for s in (-1.0, 0.5, 1.5, 2.98, 3.5, 9.0):
        w_t = splines._blend_weights(torch.tensor(np.float32(s)), torch.as_tensor(starts))
        w_j = jax_splines._blend_weights(jnp.asarray(np.float32(s)), jnp.asarray(starts))
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=RTOL_VALUE, atol=1e-7)
        assert abs(float(w_t.sum()) - 1.0) < 1e-6


# -- host fitting and the native binding ------------------------------------
CORRIDOR_X = np.linspace(0.0, 30.0, 16)
CURVED_X = np.array([0.0, 1.0, 2.5, 4.0, 6.0, 8.0, 11.0])
CURVED_Y = np.array([0.0, 0.5, 0.2, -0.5, 0.0, 1.0, 0.4])


def test_native_available_in_both_packages():
    assert native.available() == jax_native.available()


@pytest.mark.parametrize("xy", [(CORRIDOR_X, np.zeros(16)), (CURVED_X, CURVED_Y)],
                         ids=["corridor", "curved"])
def test_path_spline_bit_equal(xy):
    x, y = xy
    pj, pt = jax_fit.PathSpline2D(x, y), spline_fit.PathSpline2D(x, y)
    np.testing.assert_array_equal(pt.s, pj.s)
    np.testing.assert_array_equal(pt.sx.coeffs, pj.sx.coeffs)
    np.testing.assert_array_equal(pt.sy.coeffs, pj.sy.coeffs)
    ss = np.linspace(-1.0, pj.length + 1.0, 37)
    np.testing.assert_array_equal(pt.at(ss), pj.at(ss))
    np.testing.assert_array_equal(pt.deriv(ss), pj.deriv(ss))
    np.testing.assert_array_equal(pt.orientation(ss), pj.orientation(ss))
    rng = np.random.default_rng(2)
    for _ in range(12):
        pos = np.array([rng.uniform(-1, 31), rng.uniform(-3, 3)])
        hint = float(rng.uniform(0, pj.length))
        assert pt.closest_point(pos) == pj.closest_point(pos)
        assert (pt.closest_point(pos, s_hint=hint, window=5.0)
                == pj.closest_point(pos, s_hint=hint, window=5.0))
    for start in (0, 3, pj.n_segments - 2, pj.n_segments + 2):
        a, b = pt.segment_param_arrays(start, 5), pj.segment_param_arrays(start, 5)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_cubic_spline_and_native_fit_bit_equal():
    t = np.cumsum(np.random.default_rng(4).uniform(0.2, 1.5, 12))
    y = np.sin(t)
    np.testing.assert_array_equal(spline_fit.CubicSpline(t, y).coeffs,
                                  jax_fit.CubicSpline(t, y).coeffs)
    np.testing.assert_array_equal(spline_fit.fit_natural_cubic(t, y),
                                  jax_fit.fit_natural_cubic(t, y))
    if native.available():
        np.testing.assert_array_equal(native.fit_natural_cubic(t, y),
                                      jax_native.fit_natural_cubic(t, y))


def test_prm_search_bit_equal():
    """The port's and the reference's binding of prm_search on one seeded
    space-time graph (the layout of tests/test_native.py)."""
    if not native.available():
        pytest.skip("native geometry library unavailable in both packages")
    rng = np.random.default_rng(3)
    N, dt, n, n_goals, M = 10, 0.2, 24, 3, 3
    pos = np.concatenate([
        np.zeros((1, 2)), rng.uniform([-1, -3], [9, 3], size=(n - 1 - n_goals, 2)),
        np.stack([np.full(n_goals, 8.0), np.linspace(-1, 1, n_goals)], -1)])
    tk = np.concatenate([[0], rng.integers(1, N, n - 1 - n_goals),
                         np.full(n_goals, N)]).astype(np.int64)
    pred = (rng.uniform([1, -1], [6, 1], size=(M, 1, 2))
            + rng.uniform(-0.3, 0.3, size=(M, 1, 2)) * np.arange(N + 1)[None, :, None] * dt)
    clear = np.full(M, 0.7)
    gc = rng.uniform(0.0, 1.0, n_goals)
    out = native.prm_search(pos, tk, n_goals, pred, clear, dt, 3.0, 12, 12, goal_cost=gc)
    ref = jax_native.prm_search(pos, tk, n_goals, pred, clear, dt, 3.0, 12, 12, goal_cost=gc)
    assert out is not None and out == ref


# -- math ----------------------------------------------------------------------
def test_atan2_values_and_gradient():
    rng = np.random.default_rng(6)
    y = np.concatenate([rng.normal(0, 2, 40), np.zeros(6), [1e-8, -1e-8]]).astype(np.float32)
    x = np.concatenate([rng.normal(0, 2, 40), [1.0, -1.0, 3.0, -0.5, 2.0, -2.0],
                        [-1.0, 1.0]]).astype(np.float32)
    out = torch_math.atan2(torch.as_tensor(y), torch.as_tensor(x)).numpy()
    ref = np.asarray(jax_math.atan2(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, rtol=RTOL_VALUE, atol=1e-6)
    np.testing.assert_allclose(out, np.arctan2(y, x), atol=1e-6)
    gt = torch.func.vmap(grad(lambda a, b: torch_math.atan2(a, b), argnums=(0, 1)))(
        torch.as_tensor(y), torch.as_tensor(x))
    gj = jax.vmap(jax.grad(jax_math.atan2, argnums=(0, 1)))(jnp.asarray(y), jnp.asarray(x))
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_DERIV, atol=1e-6)
    # on the y == 0 ray: d/dy = 1/x (not 0), also for x < 0
    zero = y == 0.0
    np.testing.assert_allclose(gt[0].numpy()[zero], 1.0 / x[zero], rtol=1e-6)


def test_haar_difference_without_abs():
    rng = np.random.default_rng(7)
    a = rng.uniform(-20, 20, 200).astype(np.float32)
    b = rng.uniform(-20, 20, 200).astype(np.float32)
    a[:4] = [np.pi, -np.pi, 0.0, 3 * np.pi]
    b[:4] = [0.0, 0.0, 0.0, 0.0]
    out = torch_math.haar_difference_without_abs(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    ref = np.asarray(jax_math.haar_difference_without_abs(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)
    assert np.all(out >= -np.pi - 1e-6) and np.all(out < np.pi + 1e-6)
