"""How far one SH-MPC solve moves when its inputs move by a rounding error.

Cell F's second cycle (system_jackalsimulator("safe_horizon"), N=30, 4
scenario solvers x 657 samples, corridor_scene(12, seed 0); cycle 1's plan
as the warm start, cold duals) is the step where the scenario rows first
bind. On the card, K3 and its plain version end that step up to ~1.4 apart
per solver from bit-equal inputs (chip_smoke.py, phase 20). This script
rebuilds the step on the CPU and prints, per RTI iteration count, the
largest |Z| difference between:

  host     K3's own body (ops/csrc/rti_kernel.cuh, built with the host
           compiler: cuda_rti.HostRTI) and the plain version
           (ops/rti.py::solve_rti_torch) on the same inputs;
  moved    the plain version and the plain version from a warm start moved
           by 1e-6 (seeded normal noise on stages 1..N).

When the two columns are of one size, the gap between the routes is the
step's own sensitivity, not a difference in what the kernel computes.

    python -m mpc_planner_tpu_torch.experiments.shmpc_sensitivity

Runs on the CPU (it needs g++ for the host build, into _build/).
"""

from __future__ import annotations

import os

import torch

from mpc_planner_tpu_torch import presets
from mpc_planner_tpu_torch.ops.cuda_qp import BUILD_DIR
from mpc_planner_tpu_torch.ops.cuda_rti import HostRTI
from mpc_planner_tpu_torch.ops.rti import solve_rti_torch
from mpc_planner_tpu_torch.planner import Planner

MOVE = 1e-6
ITERATIONS = (1, 3, 10)


def binding_step():
    """(solver, Z0 with x0 pinned, P, RTI count) of cell F's cycle 2 on the
    CPU, as its device step hands them to the batched solve."""
    cfg, model, modules = presets.system_jackalsimulator("safe_horizon")
    planner = Planner(model, modules, cfg, device="cpu")
    state, data = presets.corridor_scene(cfg, n_pedestrians=12, seed=0)
    planner.on_data_received(data, "reference_path")
    if not planner.solve_mpc(state, data).success:
        raise RuntimeError("cycle 1 failed")
    modules.get("ScenarioConstraints")._prev_duals = None
    state.from_array(planner._Z[1, model.nu:].copy())
    solver, inputs = planner.solver, {}
    solve = solver.batch_impl

    def keep_first(Z0, P, xinit, n_iter, *args, **kwargs):
        inputs.setdefault("step", (Z0.clone(), P.clone(), xinit.clone(), n_iter))
        return solve(Z0, P, xinit, n_iter, *args, **kwargs)

    solver.batch_impl = keep_first
    planner.solve_mpc(state, data)
    Z0, P, xinit, n_iter = inputs["step"]
    Z0[:, 0, model.nu:] = xinit
    return solver, Z0, P, n_iter


def main():
    torch.set_num_threads(4)
    solver, Z0, P, _ = binding_step()
    host = HostRTI(solver._stage_code, os.path.join(BUILD_DIR, "shmpc_sensitivity"))
    move = MOVE * torch.randn(Z0.shape, generator=torch.Generator().manual_seed(0))
    move[:, 0] = 0.0
    for n in ITERATIONS:
        kw = dict(num_iterations=n, it0=solver.qp_iterations, warm_iters=solver.warm_qp_iters,
                  mu0=solver.mu0, sigma_fixed=solver.warm_sigma, lm=solver.lm,
                  mirror_x_only=solver._mirror_x_only, lb_template=solver._lb_template,
                  ub_template=solver._ub_template)
        plain = solve_rti_torch(Z0, P, solver.ocp, **kw).Z
        gaps = {"host": host.solve(Z0, P, **kw).Z - plain,
                "moved": solve_rti_torch(Z0 + move, P, solver.ocp, **kw).Z - plain}
        print(f"{n} RTI iterations: max |dZ| per solver "
              + "; ".join(f"{k} {[round(v, 4) for v in d.abs().amax(dim=(1, 2)).tolist()]}"
                          for k, d in gaps.items()))


if __name__ == "__main__":
    main()
