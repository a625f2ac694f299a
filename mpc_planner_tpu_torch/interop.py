"""State exchange with the JAX package (mpc_planner_tpu).

Converts the reference's numpy-side state into the port's tensors on a
given device (the card unless the caller names another): a parameter block P, a warm start Z, xinit, the warm duals
(lam_l, lam_u, ok) of a `SolveResult`, a reference `QPData`, and the
SH-MPC scenario draws. Every
function takes plain arrays or objects with the reference's field names,
so this module imports neither jax nor the reference package. The system
has no weights; these arrays are its whole state.
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_planner_tpu_torch import default_device
from mpc_planner_tpu_torch.solver.qp import QPData


def to_tensor(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """Any array-like (numpy, a jax array) -> a tensor with its own copy
    of the data (a jax array's numpy view is read-only), on `device`
    (None: the card, as every entry point of the port)."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=default_device(device))


def parameter_block(P, device=None) -> torch.Tensor:
    """[.., N+1, npar] parameter block (ParameterBlock.data or an array)."""
    return to_tensor(getattr(P, "data", P), device)


def warm_start(Z, device=None) -> torch.Tensor:
    """[.., N+1, nvar] warm-start trajectory."""
    return to_tensor(Z, device)


def xinit(x, device=None) -> torch.Tensor:
    """[.., nx] initial state."""
    return to_tensor(x, device)


def warm_duals(lam_l, lam_u, ok, device=None):
    """(lam_l, lam_u, ok) of a reference SolveResult as the port's solvers
    take them: duals as f32, `ok` (whether the previous solve converged)
    as bool."""
    return to_tensor(lam_l, device), to_tensor(lam_u, device), to_tensor(ok, device, torch.bool)


def qp_data(qp, device=None) -> QPData:
    """A reference QPData (batched, any array type) -> the port's QPData."""
    return QPData(*(to_tensor(getattr(qp, f), device) for f in QPData._fields))


def scenario_draws_to_torch(noise, mode_idx=None, device=None):
    """The JAX package's SH-MPC draws as the port's scenario module takes
    them (ScenarioConstraintModule.draw): noise [B, S, M, N-1, 2] as f32 and
    the mixture's mode per sample, mode_idx [B, S, M], as int64 (or None)."""
    return (to_tensor(noise, device),
            None if mode_idx is None else to_tensor(mode_idx, device, torch.int64))


def check_same_registry(ref_params, port_params) -> None:
    """Raise ValueError unless the two ParameterRegistry objects map the
    same names to the same indices with the same bundles, so that
    [N+1, npar] blocks mean the same in both packages."""
    if ref_params.save_map() != port_params.save_map():
        raise ValueError("parameter maps differ")
    if ref_params._bundles != port_params._bundles:
        raise ValueError("parameter bundles differ")
