"""Port vs reference, on the CPU: SH-MPC (the scenario constraint module,
mpc_planner_tpu/modules/scenario_constraints.py).

`jax.random` and torch generators differ, so the draws cannot match: the
JAX package's own draws are handed to the port (interop), and everything
downstream of the draw is held to the reference; the port's sampler is
held to the distributions it draws from.

* Halfspaces, single and multi-modal: the same draws give a1, a2, b and
  margin within 1e-6 of max |ref| (float32 in both; the reference's layout
  is [S*M, N-1] per solver, the port's [N-1, S*M]).
* Selection: the kept rows and their order equal `lax.top_k`'s, exact ties
  included (identical draws of a dummy obstacle, tied margins across the
  cut-off).
* The sampler: 4,096 draws have the prediction's mean and its covariance
  R diag(major^2, minor^2) R^T within 5%; mode frequencies within 0.02 of
  the mixture's; anisotropic noise follows the mode's heading
  (tests/test_scenario.py:141, on the port's draws).
* One planner cycle and a warm one of `configuration_safe_horizon`
  (N=10, 4 solvers, 32 samples) with the JAX draws: parameter blocks
  within 1e-6, Z of every solver and of the winner within 5e-3, exit codes,
  winner, support counts and pruning flags equal, certificates within
  1e-5, the save_data record equal; the same on `safe_horizon_hard` and on
  rosnavigation's SH-MPC, whose decomp rows follow the scenario rows (the
  dual row offset), and on a forced escalation (qp_mu_stall = 0, the same
  draws re-solved at the full budget).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_planner_tpu.modules import scenario_constraints as jsc
from mpc_planner_tpu_torch import interop
from mpc_planner_tpu_torch.modules import scenario_constraints as tsc
from torch_port_cases import advance, jax_scenario_draws, shmpc_cycle, shmpc_planner_pair

torch.set_num_threads(1)


def _prediction(rng, M, n, K=None):
    """Seeded predictions: positions around the robot, headings, axes."""
    lead = (M,) if K is None else (M, K)
    return dict(position=rng.uniform(-3, 6, lead + (n, 2)), angle=rng.uniform(-3, 3, lead + (n,)),
                major=rng.uniform(0.05, 0.8, lead + (n,)), minor=rng.uniform(0.05, 0.4, lead + (n,)))


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _close(out, ref, what, rtol=1e-6):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, what
    err = np.abs(out - ref).max()
    assert err <= rtol * np.abs(ref).max(), (what, err)


@pytest.mark.parametrize("modes", [1, 3], ids=["single", "mixture"])
def test_halfspaces_of_the_jax_draws_match(modes):
    rng = np.random.default_rng(0)
    B, S, M, n = 3, 20, 4, 7
    K = None if modes == 1 else modes
    pred = {k: v.astype(np.float32) for k, v in _prediction(rng, M, n, K).items()}
    radius = rng.uniform(0.3, 0.5, M).astype(np.float32)
    p_ws = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    rr = 0.325
    logprob = None if K is None else np.log(rng.dirichlet(np.ones(K), M)).astype(np.float32)
    noise, mode = jax_scenario_draws(5, B, S, M, n, logprob)
    args = [pred[k] for k in ("position", "angle", "major", "minor")]
    for b in range(B):
        key = jax.random.split(jax.random.PRNGKey(5), B)[b]
        if K is None:
            ref = jsc._device_scenario_halfspaces(key, *map(jnp.asarray, args), jnp.asarray(radius),
                                                  jnp.asarray(p_ws), jnp.float32(rr), n_samples=S)
        else:
            ref = jsc._device_scenario_halfspaces_mm(
                key, *map(jnp.asarray, args), jnp.asarray(logprob), jnp.asarray(radius),
                jnp.asarray(p_ws), jnp.float32(rr), n_samples=S)
        t_noise, t_mode = interop.scenario_draws_to_torch(noise[b:b + 1], None if K is None
                                                          else mode[b:b + 1], device="cpu")
        if K is None:
            out = tsc._device_scenario_halfspaces(t_noise, *map(_t, args), _t(radius), _t(p_ws), rr)
        else:
            out = tsc._device_scenario_halfspaces_mm(t_noise, t_mode, *map(_t, args), _t(radius),
                                                     _t(p_ws), rr)
        for name, o, r in zip(("a1", "a2", "b", "margin"), out, ref):
            _close(o[0].numpy(), np.asarray(r).T, name)


def test_selection_matches_lax_top_k_with_ties():
    rng = np.random.default_rng(1)
    B, n, L, nC = 2, 5, 60, 24
    margin = rng.normal(0, 1, (B, n, L)).astype(np.float32)
    margin[0, 0, 10:30] = 0.5  # a run of equal margins across the cut-off
    margin[0, 1, :] = -3.0  # every row equal
    margin[1, 2, ::3] = margin[1, 2, 0]  # ties spread over the row
    margin[1, 3, :40] = margin[1, 3, 40:].max() + 1.0  # 40 equal rows above the rest
    a1, a2, b = (rng.normal(0, 1, (B, n, L)).astype(np.float32) for _ in range(3))
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(margin), nC)
    out = tsc._select_tightest(*map(torch.as_tensor, (a1, a2, b, margin)), nC)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref_idx))
    for o, src in zip(out[:3], (a1, a2, b)):
        np.testing.assert_array_equal(o.numpy(), np.take_along_axis(src, np.asarray(ref_idx), -1))
    # the JAX helper, per solver on its [S*M, N-1] layout
    for bb in range(B):
        r = jsc._select_tightest(*(jnp.asarray(x[bb].T) for x in (a1, a2, b, margin)), nC)
        np.testing.assert_array_equal(out[3][bb].numpy(), np.asarray(r[3]))
    # exact ties from identical draws: a dummy obstacle without uncertainty
    noise = torch.randn(1, 50, 2, n, 2, generator=torch.Generator().manual_seed(0))
    pos = np.stack([np.full((n, 2), 2.0), np.full((n, 2), 100.0)]).astype(np.float32)
    axes = np.stack([np.full(n, 0.3), np.zeros(n)]).astype(np.float32)
    hs = tsc._device_scenario_halfspaces(noise, _t(pos), _t(np.zeros((2, n))), _t(axes), _t(axes),
                                         _t([0.4, 0.0]), _t(np.zeros((n, 2))), 0.3)
    _, ref_idx = jax.lax.top_k(jnp.asarray(hs[3].numpy()), 60)
    np.testing.assert_array_equal(tsc._select_tightest(*hs, 60)[3].numpy(), np.asarray(ref_idx))


def _module_on_cpu(seed=3):
    """A port scenario module attached to a stand-in planner on the CPU."""
    from types import SimpleNamespace

    import mpc_planner_tpu_torch.presets as torch_presets

    cfg, _, modules = torch_presets.system_jackalsimulator("safe_horizon", N=8)
    module = modules.get("ScenarioConstraints")
    module.n_samples = 4096
    module._planner = SimpleNamespace(solver=SimpleNamespace(device=torch.device("cpu")))
    module._sample_seed = seed
    return module


def test_sampler_mean_and_covariance():
    module = _module_on_cpu()
    rng = np.random.default_rng(2)
    M, n = 3, 4
    pred = _prediction(rng, M, n)
    noise, mode = module.draw(1, M, n)
    assert mode is None and tuple(noise.shape) == (1, 4096, M, n, 2)
    sx, sy = tsc._scenario_samples(noise, None, *(_t(pred[k]) for k in
                                                  ("position", "angle", "major", "minor")))
    xy = torch.stack([sx[0], sy[0]], -1).double().numpy()  # [n, S, M, 2]
    for k in range(n):
        for m in range(M):
            c, s = np.cos(pred["angle"][m, k]), np.sin(pred["angle"][m, k])
            R = np.array([[c, -s], [s, c]])
            cov = R @ np.diag([pred["major"][m, k] ** 2, pred["minor"][m, k] ** 2]) @ R.T
            d = xy[k, :, m]
            scale = np.sqrt(np.trace(cov))
            assert np.abs(d.mean(0) - pred["position"][m, k]).max() < 0.05 * scale
            assert np.abs(np.cov(d.T) - cov).max() < 0.05 * np.abs(cov).max()


def test_sampler_mode_frequencies():
    module = _module_on_cpu()
    probs = np.array([[0.7, 0.3, 0.0], [0.2, 0.5, 0.3]])
    logprob = _t(np.log(np.maximum(probs, 1e-12)))
    _, mode = module.draw(2, 2, 3, logprob)
    assert tuple(mode.shape) == (2, 4096, 2)
    for m in range(2):
        freq = np.bincount(mode[:, :, m].reshape(-1).numpy(), minlength=3) / (2 * 4096)
        assert np.abs(freq - probs[m]).max() < 0.02


def test_sampler_respects_mode_orientation():
    """tests/test_scenario.py:141 on the port's draws: a mode whose long
    axis points at the robot cuts much closer than one across its path."""
    module = _module_on_cpu(seed=3)
    module.n_samples = 256
    n, M, K = 9, 1, 2
    noise, mode = module.draw(1, M, n, _t(np.log(np.full((M, K), 0.5))))

    def tightest_b(angle):
        hs = tsc._device_scenario_halfspaces_mm(
            noise, mode, _t(np.tile([5.0, 0.0], (M, K, n, 1))), _t(np.full((M, K, n), angle)),
            _t(np.full((M, K, n), 1.5)), _t(np.full((M, K, n), 0.01)), _t([0.4]),
            _t(np.zeros((n, 2))), 0.3)
        a1, _, b, _ = tsc._select_tightest(*hs, 8)
        return float(torch.where(a1 > 0.9, b, np.inf).min())

    b_facing, b_across = tightest_b(0.0), tightest_b(np.pi / 2)
    assert b_facing < b_across - 1.0
    assert b_across > 3.5


@pytest.mark.parametrize("name", ["shmpc", "shmpc_hard", "rosnavigation_shmpc"])
def test_planner_cycles_match_reference(name):
    js, ts = shmpc_planner_pair(name)
    module = ts["module"]
    assert (module.n_samples, module.cfg.scenario_constraints.parallel_solvers) == (32, 4)
    if name == "rosnavigation_shmpc":  # the decomp rows follow the scenario rows
        assert module._h_row_offset() == 0 and ts["planner"].ocp.nh == 36
    shmpc_cycle(js, ts)
    if name == "shmpc":
        for side in (js, ts):
            advance(side)
        shmpc_cycle(js, ts, p_rtol=None)  # the warm cycle: carried duals, the same draws


def test_forced_escalation():
    js, ts = shmpc_planner_pair("shmpc")
    for side in (js, ts):
        side["planner"].solver.qp_mu_stall = 0.0
    shmpc_cycle(js, ts)
    assert [escalated for _, _, escalated in ts["steps"]] == [False, True]
    assert "scenario_escalation" in ts["planner"].profiler.stats
