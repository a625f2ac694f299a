"""Port vs reference, on the CPU: the scenario-theory layer
(mpc_planner_tpu/modules/scenario_theory.py), mirror of
tests/test_scenario_theory.py run against the port's own copy.

* eps(s) satisfies its defining identity, its edge cases and monotonicity;
  `sample_size` returns the minimal draw and is monotone; the numpy
  functions equal the reference's.
* `epsilon_posterior_torch` (f32, torch.lgamma) against the numpy version
  in float64 and against `epsilon_posterior_jax`, for s = 0..S at S = 64
  and S = 657 (the default draw at N=30 with 4 solvers): within 1e-5.
  (At n = 657 the log-binomial is ~3,600 in magnitude before its division
  by n - s; a few f32 units of lgamma stay below 1e-5 of eps.)
* The port's scenario module sizes its draw from the risk as the
  reference's does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import comb

from mpc_planner_tpu.modules import scenario_theory as jax_theory
from mpc_planner_tpu.modules.scenario_constraints import ScenarioConstraintModule as JaxModule
from mpc_planner_tpu.utils.config import default_config as jax_default_config
from mpc_planner_tpu_torch.modules.scenario_constraints import ScenarioConstraintModule
from mpc_planner_tpu_torch.modules.scenario_theory import (
    epsilon_posterior,
    epsilon_posterior_torch,
    sample_size,
)
from mpc_planner_tpu_torch.utils.config import default_config

torch.set_num_threads(1)


def test_epsilon_posterior_defining_identity():
    # eps(s) satisfies (1 - eps)^(S - s) = beta / (S * C(S, s)) exactly
    for s, S, beta in [(0, 100, 0.01), (3, 647, 1e-4), (10, 500, 1e-3), (24, 1000, 1e-5)]:
        eps = epsilon_posterior(s, S, beta)
        lhs = (1.0 - eps) ** (S - s)
        rhs = beta / (S * comb(S, s, exact=True))
        assert abs(lhs - rhs) / rhs < 1e-10
        assert 0.0 < eps < 1.0
        assert eps == jax_theory.epsilon_posterior(s, S, beta)


def test_epsilon_posterior_edge_cases():
    assert epsilon_posterior(100, 100, 0.01) == 1.0
    assert epsilon_posterior(150, 100, 0.01) == 1.0
    eps = epsilon_posterior(np.arange(0, 50), 500, 1e-3)
    assert eps.shape == (50,)
    assert np.all(np.diff(eps) > 0)
    np.testing.assert_array_equal(eps, jax_theory.epsilon_posterior(np.arange(0, 50), 500, 1e-3))
    assert epsilon_posterior(5, 400, 1e-3) < epsilon_posterior(5, 200, 1e-3)
    with pytest.raises(ValueError):
        epsilon_posterior(3, 100, 1.5)


def test_sample_size_minimal():
    for risk, beta, d in [(0.05, 1.3e-4, 3), (0.1, 0.01, 3), (0.05, 0.01, 10), (0.01, 1e-3, 3)]:
        S = sample_size(risk, beta, d)
        assert epsilon_posterior(d, S, beta) <= risk
        assert epsilon_posterior(d, S - 1, beta) > risk
        assert S == jax_theory.sample_size(risk, beta, d)


def test_sample_size_monotonicity():
    assert sample_size(0.01, 1e-3, 3) > sample_size(0.05, 1e-3, 3)
    assert sample_size(0.05, 1e-3, 10) > sample_size(0.05, 1e-3, 3)
    assert sample_size(0.05, 1e-5, 3) > sample_size(0.05, 1e-2, 3)
    with pytest.raises(ValueError):
        sample_size(0.0, 1e-3, 3)


@pytest.mark.parametrize("S, beta", [(64, 1e-3), (657, 0.01 / (4 * 29))], ids=["S64", "S657"])
def test_epsilon_torch_matches_numpy_and_jax(S, beta):
    s = np.arange(0, S + 1, dtype=np.float64)
    out = epsilon_posterior_torch(torch.as_tensor(s, dtype=torch.float32), S, beta)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), epsilon_posterior(s, S, beta), rtol=0, atol=1e-5)
    ref = np.asarray(jax_theory.epsilon_posterior_jax(jnp.asarray(s, jnp.float32), S, beta))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    assert float(out[-1]) == 1.0
    # any shape, on the caller's device
    grid = epsilon_posterior_torch(torch.as_tensor(s[:6].reshape(2, 3)), S, beta)
    assert grid.shape == (2, 3) and grid.device.type == "cpu"


def test_risk_governs_scenario_draw():
    cfg = default_config(N=10)
    sc = cfg.scenario_constraints
    assert sc.n_samples is None  # derived is the default
    module = ScenarioConstraintModule(cfg)
    beta_bar = sc.confidence / (sc.parallel_solvers * (cfg.N - 1))
    assert module.n_samples == sample_size(cfg.probabilistic.risk, beta_bar, sc.support_bound)
    assert module.n_samples == JaxModule(jax_default_config(N=10)).n_samples
    tight = cfg.replace(probabilistic=dataclasses.replace(cfg.probabilistic, risk=0.01))
    assert ScenarioConstraintModule(tight).n_samples > module.n_samples
    explicit = cfg.replace(scenario_constraints=dataclasses.replace(sc, n_samples=64))
    assert ScenarioConstraintModule(explicit).n_samples == 64
    # the shapes of the card's runs: N=30 and N=20 with 4 solvers, and 1,024 solvers
    for N, solvers, S in ((30, 4, 657), (20, 4, 647), (30, 1024, 778)):
        c = default_config(N=N)
        c = c.replace(scenario_constraints=dataclasses.replace(c.scenario_constraints,
                                                               parallel_solvers=solvers))
        assert ScenarioConstraintModule(c).n_samples == S
