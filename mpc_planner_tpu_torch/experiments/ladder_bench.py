"""BASELINE.md config-ladder benchmark on one card.

The port's counterpart of experiments/ladder_bench.py. Measures batched MPC
throughput (solves/s per GPU) and p99 batch latency for every rung of the
ladder (BASELINE.md "Config ladder"):

  1. goal        unicycle goal-tracking, no obstacles
  2. mpcc        MPCC contouring on a spline path
  3. ellipsoid   + ellipsoidal avoidance (8 obstacles)
  4. cc-static   CC-MPC Gaussian chance constraints + static free-space
                 polytopes from an occupancy grid (decomp)
  5. tmpc        T-MPC++ guidance + ellipsoid safety (bench.py's workload)
  6. shmpc       SH-MPC scenario halfspaces on the plain contouring model
  7. shmpc-slack SH-MPC on the slack model
  8. tmpc-n30    T-MPC++ at N=30
  9. ca-mpc      curvature-aware contouring + ellipsoids, curved path
 10. bicycle     bicycle MPCC, curved path
 11. bicycle-ca  its curvature-aware variant

Each rung: one cold solve_batch (`compile_s` is its wall time, the first
build of the rung's K3 library included), one untimed chain of CYCLES warm
cycles, then REPS timed chains from the same warm start, each cycle
warm-started from the last one's trajectory and converged duals (bench.py's
methodology). On the card every rung must resolve to the fused route (K3,
one launch a solve): a rung that does not fails the run.

    python -m mpc_planner_tpu_torch.experiments.ladder_bench [BATCH] [RTI] [--device cpu]
    LADDER_RUNGS=goal,tmpc python -m mpc_planner_tpu_torch.experiments.ladder_bench

Prints one JSON line per rung, then one markdown table.
"""

from __future__ import annotations

import json
import os

import numpy as np

from mpc_planner_tpu_torch import default_device
from mpc_planner_tpu_torch.experiments.common import (
    build_solver,
    check_route,
    device_parser,
    perturbed_batch,
    resolve_device,
    timed,
    timed_chains,
    warm_carry,
)

BATCH = 1024
RTI = 10
REPS = 15
CYCLES = 4


def corridor_costmap():
    res = 0.2
    grid = np.zeros((40, 120), dtype=np.uint8)  # y in [-4,4], x in [0,24]
    meta = {"origin_x": 0.0, "origin_y": -4.0, "resolution": res}
    grid[int(6.0 / res), :] = 255
    grid[int(2.0 / res), :] = 255
    return grid, meta


def make_rungs():
    """[(name, cfg, model, modules, state, data)] of the 11 rungs, in order."""
    from mpc_planner_tpu_torch.models import SecondOrderUnicycleModel
    from mpc_planner_tpu_torch.modules import (
        DecompConstraintModule,
        GaussianConstraintModule,
        GoalModule,
        ModuleManager,
        MPCBaseModule,
    )
    from mpc_planner_tpu_torch.presets import (
        configuration_basic,
        configuration_bicycle,
        configuration_curvature_aware,
        configuration_no_obstacles,
        configuration_safe_horizon,
        configuration_safe_horizon_hard,
        configuration_tmpc,
        corridor_scene,
    )
    from mpc_planner_tpu_torch.utils.config import default_config

    rungs = []

    # 1. goal tracking, no obstacles
    cfg = default_config(N=20).replace(max_obstacles=0)
    model = SecondOrderUnicycleModel()
    mgr = ModuleManager()
    base = mgr.add_module(MPCBaseModule(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    mgr.add_module(GoalModule(cfg))
    state, data = corridor_scene(cfg, n_pedestrians=0)
    data.reference_path = None
    data.goal = np.array([5.0, 0.0])
    data.goal_received = True
    rungs.append(("goal", cfg, model, mgr, state, data))

    # 2. MPCC, no obstacles
    cfg = default_config(N=20).replace(max_obstacles=0)
    model, mgr = configuration_no_obstacles(cfg)
    state, data = corridor_scene(cfg, n_pedestrians=0)
    rungs.append(("mpcc", cfg, model, mgr, state, data))

    # 3. + ellipsoids (8 obstacles)
    cfg = default_config(N=20).replace(max_obstacles=8)
    model, mgr = configuration_basic(cfg)
    state, data = corridor_scene(cfg, n_pedestrians=8)
    rungs.append(("ellipsoid", cfg, model, mgr, state, data))

    # 4. CC-MPC + static polytopes
    cfg = default_config(N=20).replace(max_obstacles=8)
    model, mgr = configuration_no_obstacles(cfg)
    mgr.add_module(GaussianConstraintModule(cfg))
    mgr.add_module(DecompConstraintModule(cfg))
    state, data = corridor_scene(cfg, n_pedestrians=8)
    data.costmap, data.costmap_meta = corridor_costmap()
    rungs.append(("cc-static", cfg, model, mgr, state, data))

    # 5. T-MPC++ (headline)
    cfg = default_config(N=20)
    model, mgr = configuration_tmpc(cfg)
    state, data = corridor_scene(cfg, n_pedestrians=8)
    rungs.append(("tmpc", cfg, model, mgr, state, data))

    # 6. SH-MPC scenario constraints (hard variant, nvar=7)
    cfg = default_config(N=20).replace(max_obstacles=8)
    model, mgr = configuration_safe_horizon_hard(cfg)
    state, data = corridor_scene(cfg, n_pedestrians=8)
    rungs.append(("shmpc", cfg, model, mgr, state, data))

    # 7. SH-MPC slack model (nvar=8)
    cfg = default_config(N=20).replace(max_obstacles=8)
    model, mgr = configuration_safe_horizon(cfg)
    state, data = corridor_scene(cfg, n_pedestrians=8)
    rungs.append(("shmpc-slack", cfg, model, mgr, state, data))

    # 8. T-MPC++ at N=30, the reference jackalsimulator's horizon
    cfg = default_config(N=30)
    model, mgr = configuration_tmpc(cfg)
    state, data = corridor_scene(cfg, n_pedestrians=8)
    rungs.append(("tmpc-n30", cfg, model, mgr, state, data))

    # 9. CA-MPC: curvature-aware contouring + 8 ellipsoids (nvar=7)
    cfg = default_config(N=20).replace(max_obstacles=8)
    model, mgr = configuration_curvature_aware(cfg)
    state, data = _curved_scene(cfg, n_pedestrians=8)
    rungs.append(("ca-mpc", cfg, model, mgr, state, data))

    # 10./11. Bicycle MPCC + its CA variant (nvar=9)
    cfg = default_config(N=20).replace(max_obstacles=8)
    model, mgr = configuration_bicycle(cfg)
    state, data = _curved_scene(cfg, n_pedestrians=8)
    rungs.append(("bicycle", cfg, model, mgr, state, data))

    cfg = default_config(N=20).replace(max_obstacles=8)
    model, mgr = configuration_bicycle(cfg, curvature_aware=True)
    state, data = _curved_scene(cfg, n_pedestrians=8)
    rungs.append(("bicycle-ca", cfg, model, mgr, state, data))

    return rungs


def _curved_scene(cfg, n_pedestrians: int = 8):
    """Corridor scene on a gently curved path (the CA models' s_dot
    projection term is trivial on a straight line)."""
    from mpc_planner_tpu_torch.presets import corridor_scene

    state, data = corridor_scene(cfg, n_pedestrians=n_pedestrians)
    t = np.linspace(0, np.pi, 20)
    data.reference_path = {"x": 30.0 * t / np.pi, "y": 2.0 * np.sin(t)}
    return state, data


def rung_problem(name: str, batch: int, device):
    """(solver, Z0b, Pb, xb) of one rung: its solver on `device` (asserted
    on K3 on the card) and `batch` perturbed copies of its OCP instance."""
    _, cfg, model, mgr, state, data = {r[0]: r for r in make_rungs()}[name]
    solver, Z0, P, xinit = build_solver(cfg, model, mgr, state, data, device)
    check_route(solver, True)
    return (solver, *perturbed_batch(np.random.default_rng(0), Z0, P, xinit, batch, model.nu,
                                     device))


def measure_rung(name: str, batch: int = BATCH, rti: int = RTI, cycles: int = CYCLES,
                 reps: int = REPS, device=None):
    """One rung's measurement: (its row, the reference's JSON keys; its
    solver; the last timed cycle's SolveResult). On the card unless `device`
    says otherwise."""
    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS

    device = default_device(device)
    solver, Z0b, Pb, xb = rung_problem(name, batch, device)
    res, compile_s = timed(lambda: solver.solve_batch(Z0b, Pb, xb, num_iterations=rti), device)
    times, (_, last) = timed_chains(solver, warm_carry(res), Pb, xb, rti, cycles, reps, device)
    feas = int((last.exit_code == EXIT_SUCCESS).sum())
    row = {
        "rung": name,
        "nvar": solver.ocp.nvar,
        "nh": solver.ocp.nh,
        "batch_ms_mean": round(float(np.mean(times) * 1e3), 2),
        "batch_ms_p99": round(float(np.percentile(times, 99) * 1e3), 2),
        "solves_per_sec": round(batch / float(np.mean(times)), 1),
        "feasible": f"{feas}/{batch}",
        "compile_s": round(compile_s, 1),
    }
    return row, solver, last


def run_rung(name: str, batch: int = BATCH, rti: int = RTI, cycles: int = CYCLES,
             reps: int = REPS, device=None) -> dict:
    """One rung's row (measure_rung), printed as a JSON line."""
    row, _, _ = measure_rung(name, batch, rti, cycles, reps, device)
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    ap = device_parser(__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=BATCH)
    ap.add_argument("rti", nargs="?", type=int, default=RTI)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    only = os.environ.get("LADDER_RUNGS")
    results = [run_rung(name, args.batch, args.rti, CYCLES, REPS, device)
               for name, *_ in make_rungs() if not only or name in only.split(",")]

    per = "GPU" if device.type == "cuda" else device.type
    print(f"\n| rung | nh | mean ms (B={args.batch}) | p99 ms | solves/s/{per} | feasible |")
    print("|---|---|---|---|---|---|")
    for r in results:
        print(
            f"| {r['rung']} | {r['nh']} | {r['batch_ms_mean']} | "
            f"{r['batch_ms_p99']} | {r['solves_per_sec']} | {r['feasible']} |"
        )


if __name__ == "__main__":
    main()
