"""Faults planted in the port's timed path, for the checks that the
comparison catches them: the CPU tests at a small size
(tests/test_mpcbench_faults.py) and the card at the cell's own size
(tools/control.py --fault).

    with plant("half_left_out"):
        ...  # every batched solve leaves the second half of its batch at its start
"""

from __future__ import annotations

import contextlib
from unittest import mock


def unchanged(res, Z0):
    """A solve that returns its start."""
    return res._replace(Z=Z0.clone())


def half_left_out(res, Z0):
    """The second half of the batch left at its start."""
    Z = res.Z.clone()
    Z[Z.shape[0] // 2:] = Z0[Z.shape[0] // 2:]
    return res._replace(Z=Z)


def altered(res, Z0):
    """An answer altered where it is produced: one state of one stage moved."""
    Z = res.Z.clone()
    Z[:, 5, 3] += 0.05
    return res._replace(Z=Z)


SOLVE_FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out, "altered": altered}


def _broken_solve(fault):
    from mpc_planner_tpu_torch.solver import sqp

    original = sqp.SQPSolver.batch_impl

    def broken(self, Z0, P, xinit, num_iterations, warm0=None, escalated=False):
        res = original(self, Z0, P, xinit, num_iterations, warm0=warm0, escalated=escalated)
        Zs = Z0.clone()
        Zs[:, 0, self.ocp.nu:] = xinit
        return fault(res, Zs)

    return mock.patch.object(sqp.SQPSolver, "batch_impl", broken)


def _wrong_selection():
    """T-MPC++ keeps the most expensive feasible planner, not the cheapest."""
    import torch

    from mpc_planner_tpu_torch.modules import guidance_constraints as gc

    original = gc.GuidanceConstraintModule._fused_step

    def broken(self, reg, n_iter, warm, **inputs):
        packed, Zall, ll, lu = original(self, reg, n_iter, warm, **inputs)
        B = Zall.shape[0]
        nz = Zall[0].numel()
        codes, pobj = packed[nz:nz + B], packed[nz + B:nz + 2 * B]
        cost = torch.where(codes == 1, pobj * inputs["consistency"], -torch.inf)
        worst = torch.argmax(cost)
        packed = packed.clone()
        packed[:nz] = Zall[worst].reshape(-1)
        packed[-2] = worst.to(packed.dtype)
        return packed, Zall, ll, lu

    return mock.patch.object(gc.GuidanceConstraintModule, "_fused_step", broken)


def plant(name):
    """A context manager with the fault `name` planted (None: none)."""
    if name is None:
        return contextlib.nullcontext()
    if name == "wrong_selection":
        return _wrong_selection()
    return _broken_solve(SOLVE_FAULTS[name])
