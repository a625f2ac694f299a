"""State exchange with the JAX package (mpc_planner_tpu).

Converts the reference's numpy-side state into the port's tensors on a
given device: a parameter block P, a warm start Z, xinit, the warm duals
(lam_l, lam_u, ok) of a `SolveResult`, and a reference `QPData`. Every
function takes plain arrays or objects with the reference's field names,
so this module imports neither jax nor the reference package. The system
has no weights; these arrays are its whole state.
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_planner_tpu_torch.solver.qp import QPData


def to_tensor(x, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """Any array-like (numpy, a jax array) -> a tensor with its own copy
    of the data (a jax array's numpy view is read-only)."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def parameter_block(P, device="cpu") -> torch.Tensor:
    """[.., N+1, npar] parameter block (ParameterBlock.data or an array)."""
    return to_tensor(getattr(P, "data", P), device)


def warm_start(Z, device="cpu") -> torch.Tensor:
    """[.., N+1, nvar] warm-start trajectory."""
    return to_tensor(Z, device)


def xinit(x, device="cpu") -> torch.Tensor:
    """[.., nx] initial state."""
    return to_tensor(x, device)


def warm_duals(lam_l, lam_u, ok, device="cpu"):
    """(lam_l, lam_u, ok) of a reference SolveResult as the port's solvers
    take them: duals as f32, `ok` (whether the previous solve converged)
    as bool."""
    return to_tensor(lam_l, device), to_tensor(lam_u, device), to_tensor(ok, device, torch.bool)


def qp_data(qp, device="cpu") -> QPData:
    """A reference QPData (batched, any array type) -> the port's QPData."""
    return QPData(*(to_tensor(getattr(qp, f), device) for f in QPData._fields))


def check_same_registry(ref_params, port_params) -> None:
    """Raise ValueError unless the two ParameterRegistry objects map the
    same names to the same indices with the same bundles, so that
    [N+1, npar] blocks mean the same in both packages."""
    if ref_params.save_map() != port_params.save_map():
        raise ValueError("parameter maps differ")
    if ref_params._bundles != port_params._bundles:
        raise ValueError("parameter bundles differ")
