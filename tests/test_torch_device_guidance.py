"""Port vs reference, on the CPU: the device-sampled guidance backend
(guidance/device_prm.py), mirroring tests/test_device_guidance.py.

jax.random and torch's generator differ, so the sweep is compared on the
reference's own draws: the test makes them as `_sample_and_score` does
(split(key, 3), randint on kg, uniform on ku and kl) and hands them to the
port's `score`. Tolerances: positions and cost 1e-5 relative (float32, the
same formula; einsum and cumsum may sum in another order), side and
feasible equal. The planner's `update`, given the same draws, must choose
the same classes and warm starts as the reference's (the same candidates,
positions to 1e-5). The port's own draws are held to their distributions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_planner_tpu.guidance.device_prm import DeviceSampledPlanner as JaxSampled
from mpc_planner_tpu.guidance.device_prm import _sample_and_score
from mpc_planner_tpu.spline_fit import PathSpline2D as JaxPath
from mpc_planner_tpu.utils.config import default_config as jax_default_config
from mpc_planner_tpu_torch.guidance import make_guidance_planner
from mpc_planner_tpu_torch.guidance.device_prm import DeviceSampledPlanner, draw, score
from mpc_planner_tpu_torch.spline_fit import PathSpline2D
from mpc_planner_tpu_torch.utils.config import default_config
from tests.test_prm import _scene

torch.set_num_threads(1)

N = 10
RTOL = 1e-5


def _configs(**t_mpc):
    t_mpc = dict(guidance_backend="sampled", sampled_n_samples=512, **t_mpc)
    jc, tc = jax_default_config(N=N), default_config(N=N)
    return (jc.replace(t_mpc=jc.t_mpc.__class__(**t_mpc)),
            tc.replace(t_mpc=tc.t_mpc.__class__(**t_mpc)))


def jax_draws(seed, S, n_goals, w_lat):
    """The reference's draws for PRNGKey(seed) (device_prm.py:61-75)."""
    ku, kl, kg = jax.random.split(jax.random.PRNGKey(seed), 3)
    w = jnp.float32(w_lat)
    return (np.asarray(jax.random.randint(kg, (S,), 0, n_goals)),
            np.asarray(jax.random.uniform(ku, (S, 2))),
            np.asarray(jax.random.uniform(kl, (S, 2), minval=-w, maxval=w)))


def _sweep_inputs(rng, N, M, G):
    start = np.array([0.3, -0.2])
    goals = np.stack([np.full(G, 5.0), np.linspace(-1.5, 1.5, G)], axis=-1)
    pred = np.stack([rng.uniform(1.0, 9.0, M), rng.uniform(-3.5, 3.5, M)], axis=-1)[:, None, :] \
        + np.arange(N + 1)[None, :, None] * 0.2 * rng.normal(0, 0.5, (M, 1, 2))
    clear = rng.uniform(0.5, 0.8, M)
    s_prof = np.concatenate([[0.0], np.cumsum(np.minimum(1.5, 0.3 * np.arange(N)) * 0.2)])
    basis = DeviceSampledPlanner(default_config(N=N), device="cpu")._basis(N).numpy()
    return basis, start, goals, pred, clear, s_prof


@pytest.mark.parametrize("seed,N,M,S", [(0, 10, 3, 256), (1, 20, 12, 512), (2, 30, 12, 1024)])
def test_score_on_jax_draws(seed, N, M, S):
    rng = np.random.default_rng(seed)
    G = 5
    basis, start, goals, pred, clear, s_prof = _sweep_inputs(rng, N, M, G)
    w_lat, track, gw = 2.0, 1.9, 2.0
    f32 = np.float32
    ref = _sample_and_score(
        jax.random.PRNGKey(seed), jnp.asarray(basis, f32), jnp.asarray(start, f32),
        jnp.asarray(goals, f32), jnp.asarray(pred, f32), jnp.asarray(clear, f32), f32(w_lat),
        f32(track), jnp.asarray(s_prof, f32), f32(gw), n_samples=S, n_goals=G)
    ref = [np.asarray(x) for x in ref]

    def t(x):
        return torch.as_tensor(np.array(x, f32))

    gidx, u, lat = jax_draws(seed, S, G, w_lat)
    out = score(t(basis), t(start), t(goals), t(pred), t(clear), torch.as_tensor(np.array(gidx), dtype=torch.int64),
                t(u), t(lat), t(track), t(s_prof), t(gw))
    pos, side, cost, feas = (x.numpy() for x in out)
    assert side.dtype == np.int8 and pos.shape == (S, N + 1, 2)
    np.testing.assert_allclose(pos, ref[0], rtol=RTOL, atol=RTOL * np.abs(ref[0]).max())
    np.testing.assert_allclose(cost, ref[2], rtol=RTOL)
    np.testing.assert_array_equal(side, ref[1])
    np.testing.assert_array_equal(feas, ref[3])
    assert feas.any() and (side != 0).any()


def _planner_pair(cfgs, draws_from_jax=True):
    jc, tc = cfgs
    jp, tp = JaxSampled(jc), DeviceSampledPlanner(tc, device="cpu")
    if draws_from_jax:
        tp._draws = lambda S, G, w: tuple(
            torch.as_tensor(np.array(x)) for x in jax_draws(tp.seed, S, G, w))
    return jp, tp


def _update_both(jp, tp, cfgs, obstacles):
    jc, tc = cfgs
    js, jd = _scene(jc, obstacles)
    ts, td = _scene(tc, obstacles)
    xs = np.linspace(0, 6, 13)
    return (jp.update(js, JaxPath(xs, np.zeros(13)), jd.obstacle_block, 0.0, 1.5),
            tp.update(ts, PathSpline2D(xs, np.zeros(13)), td.obstacle_block, 0.0, 1.5))


def _assert_same_choice(ref, out):
    """The same candidates: class, obstacles, flags, positions and s."""
    assert len(out) == len(ref) > 0
    for a, b in zip(out, ref):
        assert (a.signature, a.obstacle_ids, a.previously_selected, a.braking) == \
            (b.signature, b.obstacle_ids, b.previously_selected, b.braking)
        np.testing.assert_allclose(a.positions, b.positions, rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(a.s, b.s, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("obstacles,spc", [([(1.2, 0.0)], 1), ([(1.2, 0.0), (2.4, 0.5)], 1),
                                           ([(1.2, 0.0)], 3)])
def test_update_chooses_as_reference(obstacles, spc):
    cfgs = _configs(samples_per_class=spc)
    jp, tp = _planner_pair(cfgs)
    ref, out = _update_both(jp, tp, cfgs, obstacles)
    _assert_same_choice(ref, out)
    if spc == 1 and len(obstacles) == 1:  # both passing sides among the classes
        sides = {t.signature[0] for t in out if len(t.signature) == 1}
        assert {+1, -1} <= sides


def test_update_with_braking_class():
    cfgs = _configs(braking_class=True)
    ref, out = _update_both(*_planner_pair(cfgs), cfgs, [(1.2, 0.0)])
    assert out[-1].braking and ref[-1].braking
    _assert_same_choice(ref, out)


def test_empty_scene_falls_back():
    cfgs = _configs()
    ref, out = _update_both(*_planner_pair(cfgs), cfgs, [])
    _assert_same_choice(ref, out)
    assert out[0].s[-1] > 1.0


def test_consistency_bookkeeping():
    cfgs = _configs()
    jp, tp = _planner_pair(cfgs)
    ref, out = _update_both(jp, tp, cfgs, [(1.2, 0.0)])
    jp.override_selected(ref[0])
    tp.override_selected(out[0])
    ref2, out2 = _update_both(jp, tp, cfgs, [(1.2, 0.0)])
    _assert_same_choice(ref2, out2)
    matched = [t for t in out2 if t.previously_selected]
    assert matched and matched[0].signature == out[0].signature


def test_own_draws_deterministic_and_collision_free():
    """The port's own generator: the same trajectories on every call (seeded
    each cycle), shaped as the reference's, clear of the obstacles."""
    _, tc = _configs()
    state, data = _scene(tc, [(1.2, 0.0), (2.4, 0.5)])
    path = PathSpline2D(np.linspace(0, 6, 13), np.zeros(13))
    g = make_guidance_planner(tc, device="cpu")
    t1 = g.update(state, path, data.obstacle_block, 0.0, 1.5)
    t2 = DeviceSampledPlanner(tc, device="cpu").update(state, path, data.obstacle_block, 0.0, 1.5)
    assert len(t1) == len(t2) >= 2
    blk = data.obstacle_block
    pred = np.concatenate([blk.position[:, None, :], blk.pred_position], axis=1)[:, : N + 1]
    for a, b in zip(t1, t2):
        np.testing.assert_array_equal(a.positions, b.positions)
        assert a.positions.shape == (N + 1, 2) and a.s.shape == (N + 1,)
        assert np.all(np.diff(a.s) >= -1e-6)
        np.testing.assert_allclose(a.positions[0], [state.get("x"), state.get("y")], atol=1e-5)
        assert np.linalg.norm(a.positions[None] - pred, axis=-1).min() > tc.robot_radius + 0.2


def test_draw_distributions():
    """draw: gidx uniform over the goals, u uniform on [0, 1), lat uniform on
    [-w, w): range and moments over 200,000 samples (5 sigma)."""
    S, G, w = 200_000, 5, 1.7
    gidx, u, lat = draw(torch.Generator().manual_seed(3), S, G, w)
    assert gidx.dtype == torch.int64 and int(gidx.min()) == 0 and int(gidx.max()) == G - 1
    counts = torch.bincount(gidx, minlength=G).double() / S
    assert torch.allclose(counts, torch.full((G,), 1.0 / G, dtype=torch.float64), atol=5 * 0.4 / np.sqrt(S))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert float(lat.min()) >= -w and float(lat.max()) < w
    for x, lo, hi in ((u, 0.0, 1.0), (lat, -w, w)):
        mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
        assert abs(float(x.double().mean()) - mean) < 5 * np.sqrt(var / x.numel())
        assert abs(float(x.double().var()) - var) < 0.01 * var
