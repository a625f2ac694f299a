"""N=30 latency study: warm-QP iteration sweep + small-batch latency.

The port's counterpart of experiments/n30_latency.py. The reference
jackalsimulator's horizon is N=30 @ dt=0.2 (settings.yaml:2-3). A solve is
latency-bound in N x IP_iters sequential steps, so the lever is the
warm-QP IP iteration count (`solver.qp_warm_iterations`, which the port
hands K3 as `warm_iters`).

This experiment, on the card (the default route, K3, asserted):
  1. chains steady-state cycles at N=30, B=1024 for warm iters 6/5/4,
     recording ms/cycle + steady feasibility + divergence vs the 6-iter
     chain (quality gate: same solutions to f32 tolerance);
  2. the same at B=128 (the reference's single lane block) and B=5 (the
     T-MPC++ robot's batch: 4 homotopy classes + the free planner), the
     per-robot latency.

    python -m mpc_planner_tpu_torch.experiments.n30_latency [--cycles 8] [--reps 8] [--device cpu]
"""

from __future__ import annotations

import json

import numpy as np

from mpc_planner_tpu_torch.experiments.common import (
    build_solver,
    check_route,
    device_parser,
    perturbed_batch,
    resolve_device,
    timed,
    warm_carry,
    warm_chain,
)

BATCHES = (1024, 128, 5)


def run_chain(solver, Z0b, Pb, xb, rti, cycles, reps, device):
    """A cold solve, then `reps` timed chains of `cycles` warm cycles from
    its result: (seconds per cycle of each chain, feasible after the cold
    solve, feasible in the last cycle, the last chain's final Z [B, N+1,
    nvar] as numpy)."""
    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS

    res = solver.solve_batch(Z0b, Pb, xb, num_iterations=rti)
    feas0 = int((res.exit_code == EXIT_SUCCESS).sum())
    warm0 = warm_carry(res)
    out = warm_chain(solver, warm0, Pb, xb, rti, cycles)  # first loads
    times = []
    for _ in range(reps):
        out, seconds = timed(lambda: warm_chain(solver, warm0, Pb, xb, rti, cycles), device)
        times.append(seconds / cycles)
    (Z_final, _, _, _), last = out
    feas_steady = int((last.exit_code == EXIT_SUCCESS).sum())
    return np.asarray(times), feas0, feas_steady, Z_final.cpu().numpy()


def latency_rows(batches=BATCHES, warm_iters=(6, 5, 4), horizon=30, rti=10, cycles=8, reps=8,
                 device=None):
    """The table's rows (dicts, the reference's JSON keys) for each batch
    and warm-iteration count; prints the table and a JSON line per row."""
    from mpc_planner_tpu_torch.presets import configuration_tmpc, corridor_scene
    from mpc_planner_tpu_torch.utils.config import default_config

    print("| B | warm IP iters | mean ms | p99 ms | solves/s | steady feasible "
          "| max|dZ| vs 6 |")
    print("|---|---|---|---|---|---|---|")
    rows = []
    for B in batches:
        Z_ref = None
        for wi in warm_iters:
            cfg = default_config(N=horizon)
            cfg = cfg.replace(solver=cfg.solver.__class__(qp_warm_iterations=wi))
            model, mgr = configuration_tmpc(cfg)
            state, data = corridor_scene(cfg, n_pedestrians=8)
            solver, Z0, P, xinit = build_solver(cfg, model, mgr, state, data, device)
            check_route(solver, True)
            rng = np.random.default_rng(0)
            Z0b, Pb, xb = perturbed_batch(rng, Z0, P, xinit, B, model.nu, device)

            times, feas0, feas_steady, Z_final = run_chain(
                solver, Z0b, Pb, xb, rti, cycles, reps, device)
            if wi == warm_iters[0]:
                Z_ref = Z_final
                dz = 0.0
            else:
                dz = float(np.max(np.abs(Z_final - Z_ref)))
            mean_ms = float(np.mean(times)) * 1e3
            p99_ms = float(np.percentile(times, 99)) * 1e3
            print(f"| {B} | {wi} | {mean_ms:.1f} | {p99_ms:.1f} "
                  f"| {B/np.mean(times):,.0f} | {feas_steady}/{B} | {dz:.2e} |", flush=True)
            row = {
                "B": B, "warm_iters": wi, "mean_ms": round(mean_ms, 2),
                "p99_ms": round(p99_ms, 2),
                "solves_per_sec": round(float(B / np.mean(times)), 1),
                "feasible_cold": feas0, "feasible_steady": feas_steady,
                "max_dz_vs_first": dz,
            }
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None):
    ap = device_parser(__doc__.split("\n\n")[0])
    ap.add_argument("--cycles", type=int, default=8)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--rti", type=int, default=10)
    ap.add_argument("--warm-iters", type=int, nargs="*", default=[6, 5, 4])
    ap.add_argument("--horizon", type=int, default=30)
    args = ap.parse_args(argv)
    latency_rows(BATCHES, tuple(args.warm_iters), args.horizon, args.rti, args.cycles, args.reps,
                 resolve_device(args.device))


if __name__ == "__main__":
    main()
