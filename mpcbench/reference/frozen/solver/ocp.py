"""OCP assembly: modules + model + registry -> stage functions on tensors.

Counterpart of mpc_planner_tpu/solver/ocp.py (ref solver_generator/
generate_solver.py:13-61 + solver_definition.py:5-77). Every stage
function takes ONE stage (z [nvar], p [npar]) or one trajectory and is
written so that `torch.func` (vmap, jacfwd, grad, hessian) can transform
it: the solver batches and differentiates them, there is no code
generation.

Stage convention (acados-equivalent, generate_acados_solver.py:41-52):
  * running cost  at stages 0..N-1 (expression built with stage_idx=1)
  * terminal cost at node N        (expression built with stage_idx=N-1,
                                    evaluated on x_N with u = 0)
  * h-constraints at stages 0..N-1
  * box bounds: u at 0..N-1, x at 1..N (x_0 fixed to xinit)
"""

from __future__ import annotations


import numpy as np
import torch
from torch.func import vmap

from mpcbench.reference.frozen.modules.base import BoundModel, ModuleManager
from mpcbench.reference.frozen.parameters import ParameterRegistry


class OCP:
    """Static OCP specification + stage functions."""

    def __init__(self, model, modules: ModuleManager, cfg):
        self.model = model
        self.modules = modules
        self.cfg = cfg
        self.N = cfg.N
        self.dt = cfg.integrator_step
        self.nu = model.nu
        self.nx = model.nx
        self.nvar = model.nvar
        self.num_segments = cfg.contouring.num_segments  # read by the CA models' spline update

        # Parameter registry (offline half of every module)
        self.params = ParameterRegistry()
        modules.define_parameters(self.params)
        self.params.freeze()
        self.npar = max(self.params.npar, 1)

        # Constraint bounds (solver_definition.py:60-77)
        self.lh = modules.constraint_lower_bounds()
        self.uh = modules.constraint_upper_bounds()
        self.nh = len(self.lh)

        # Box bounds over z
        self.lb_z = np.asarray(model.lower_bound, dtype=float)
        self.ub_z = np.asarray(model.upper_bound, dtype=float)

    # -- stage functions ---------------------------------------------------
    def running_cost(self, z, p):
        """Stage cost (stage_idx=1 expression, applied at k=0..N-1)."""
        bound = BoundModel(self.model, z)
        params = self.params.bind(p)
        return z.new_zeros(()) + self.modules.objective(bound, params, self.cfg, 1)

    def terminal_cost(self, z, p):
        """Terminal cost (stage_idx=N-1 expression, applied at node N)."""
        bound = BoundModel(self.model, z)
        params = self.params.bind(p)
        return z.new_zeros(()) + self.modules.objective(bound, params, self.cfg, self.cfg.N - 1)

    def constraint_fn(self, z, p):
        """h(z, p) [nh] (stage_idx=1 expression)."""
        bound = BoundModel(self.model, z)
        params = self.params.bind(p)
        hs = self.modules.constraints(bound, params, self.cfg, 1)
        if not hs:
            return z.new_zeros((0,))
        return torch.stack(hs)

    def dynamics_fn(self, z, p):
        """x_{k+1} = F(z_k; p_k) via RK4 with 3 substeps."""
        return self.model.discrete_dynamics(z, p, self.dt, num_steps=3, ocp=self)

    def zero_inputs(self, z):
        """z with its u-block set to 0 (the terminal node's convention)."""
        return torch.cat([z.new_zeros(z.shape[:-1] + (self.nu,)), z[..., self.nu:]], dim=-1)

    def total_cost(self, Z, P):
        """Nonlinear objective of a trajectory Z [N+1, nvar], P [N+1, npar]."""
        run = vmap(self.running_cost)(Z[: self.N], P[: self.N])
        return run.sum() + self.terminal_cost(self.zero_inputs(Z[self.N]), P[self.N])

    def rollout(self, x0, U, P):
        """Forward simulate controls U [N, nu] from x0 [nx] -> X [N+1, nx]."""
        xs = [x0]
        for k in range(self.N):
            xs.append(self.dynamics_fn(torch.cat([U[k], xs[-1]]), P[k]))
        return torch.stack(xs)

    def eq_residual(self, Z, P):
        """max_k |F(z_k) - x_{k+1}|_inf (acados res_eq analog,
        acados_solver_interface.cpp:176-181)."""
        x_next = vmap(self.dynamics_fn)(Z[: self.N], P[: self.N])
        return (x_next - Z[1:, self.nu:]).abs().max()
