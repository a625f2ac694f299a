"""Scenario-optimization guarantee layer for SH-MPC.

Counterpart of mpc_planner_tpu/modules/scenario_theory.py (its docstring
has the derivation): the nonconvex scenario bound of Campi, Garatti and
Ramponi (IEEE TAC 63(12), 2018). For a scenario program over ``S`` i.i.d.
scenarios whose solution is supported by ``s`` of them, with confidence at
least ``1 - beta`` the violation probability is at most::

    eps(S) = 1
    eps(s) = 1 - (beta / (S * binom(S, s))) ** (1 / (S - s)),  s < S

`sample_size` sizes the draw a priori from the configured risk;
`epsilon_posterior` evaluates the bound at an observed support count, and
`epsilon_posterior_torch` does the same on the solver's device, once per
cycle and solver, inside the SH-MPC device step. The confidence is split
over the parallel solvers and the N-1 constrained stages (the module's
`_beta_stage`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import gammaln as _gammaln


def epsilon_posterior(s, n_samples: int, beta: float):
    """eps(s): the violation probability certified at confidence 1-beta for
    a solution with support cardinality ``s`` of ``n_samples`` scenarios.
    Vectorized over ``s``; 1.0 where ``s >= n_samples``."""
    s_arr = np.asarray(s, dtype=np.float64)
    n = float(n_samples)
    if n < 1 or not (0.0 < beta < 1.0):
        raise ValueError("need n_samples >= 1 and beta in (0, 1)")
    s_clip = np.minimum(s_arr, n)
    ln_binom = _gammaln(n + 1.0) - _gammaln(s_clip + 1.0) - _gammaln(n - s_clip + 1.0)
    denom = np.maximum(n - s_clip, 1.0)
    ln_term = (math.log(beta) - math.log(n) - ln_binom) / denom
    eps = 1.0 - np.exp(ln_term)
    out = np.where(s_arr >= n, 1.0, eps)
    return float(out) if np.isscalar(s) or np.ndim(s) == 0 else out


def epsilon_posterior_torch(s: torch.Tensor, n_samples: int, beta: float) -> torch.Tensor:
    """`epsilon_posterior` in f32 on the device of ``s`` (support counts of
    any shape): the reference's `epsilon_posterior_jax` with torch.lgamma."""
    n = float(n_samples)
    s = s.to(torch.float32)
    s_clip = torch.clamp(s, max=n)
    n1 = torch.full_like(s, n + 1.0)
    ln_binom = torch.lgamma(n1) - torch.lgamma(s_clip + 1.0) - torch.lgamma(n - s_clip + 1.0)
    denom = torch.clamp(n - s_clip, min=1.0)
    ln_term = (math.log(beta) - math.log(n) - ln_binom) / denom
    eps = 1.0 - torch.exp(ln_term)
    return torch.where(s >= n, 1.0, eps)


def sample_size(risk: float, beta: float, support_bound: int,
                max_samples: int = 1_000_000) -> int:
    """Smallest S with ``epsilon_posterior(support_bound, S, beta) <= risk``
    (``support_bound`` sizes the draw only; the certificate uses the
    observed count)."""
    if not (0.0 < risk < 1.0):
        raise ValueError("risk must be in (0, 1)")
    if support_bound < 0:
        raise ValueError("support_bound must be >= 0")
    lo = support_bound + 1
    hi = lo
    while hi < max_samples and epsilon_posterior(support_bound, hi, beta) > risk:
        hi *= 2
    if epsilon_posterior(support_bound, hi, beta) > risk:
        raise ValueError(
            f"sample_size(risk={risk}, beta={beta}, support_bound="
            f"{support_bound}) exceeds max_samples={max_samples}")
    while lo < hi:
        mid = (lo + hi) // 2
        if epsilon_posterior(support_bound, mid, beta) <= risk:
            hi = mid
        else:
            lo = mid + 1
    return int(hi)
