"""Does the SH-MPC closed loop's outcome depend on the route?

A step where SH-MPC's scenario rows bind ends ~1 apart on K3 and on the
torch backend from identical inputs (shmpc_sensitivity.py shows why). This
drives corridor_benchmark's scene (make_peds, social forces, robot-aware
pedestrians) for one seed with configuration_safe_horizon twice: on the
default route (solver.rti_fused="auto": K3, one launch a solve) and with
rti_fused="off" (K1 per RTI iteration, seconds a step on the host), both
cut to --max-steps, and prints each run's outcome and where the two robot
trajectories part.

    python -m mpc_planner_tpu_torch.experiments.shmpc_route [--peds 12] [--seed 0] [--max-steps 40] [--device cpu]

On the CPU both routes are the plain solver, so the trajectories agree.
"""

from __future__ import annotations

import json

import numpy as np

from mpc_planner_tpu_torch.experiments.common import (
    check_route,
    device_parser,
    resolve_device,
    with_solver,
)

PART = 0.01  # m: the trajectories have parted once the robots are this far apart


def drive(rti_fused, peds, seed, max_steps, device):
    """One corridor run of SH-MPC on the route `rti_fused`: SimResult."""
    from mpc_planner_tpu_torch.experiments.corridor_benchmark import PATH_X, build_config, make_peds
    from mpc_planner_tpu_torch.planner import Planner
    from mpc_planner_tpu_torch.presets import configuration_safe_horizon
    from mpc_planner_tpu_torch.sim import ClosedLoopSimulator

    cfg = with_solver(build_config(), rti_fused=rti_fused)
    model, modules = configuration_safe_horizon(cfg)
    planner = Planner(model, modules, cfg, device=device)
    check_route(planner.solver, rti_fused != "off")
    sim = ClosedLoopSimulator(planner, cfg, make_peds(peds, seed),
                              {"x": PATH_X, "y": np.zeros_like(PATH_X)}, social_forces=True,
                              seed=seed, robot_aware=True)
    return sim.run(max_steps=max_steps)


def compare(peds=12, seed=0, max_steps=40, device=None):
    """Both routes' outcomes and where their trajectories part; prints one
    JSON line per route and one for the comparison, and returns them."""
    out = {}
    for route, key in (("default", "auto"), ("unfused", "off")):
        res = drive(key, peds, seed, max_steps, device)
        valid = [bool(r.get("scenario_cert_valid")) for r in res.module_records
                 if "scenario_risk_certificate" in r]
        out[route] = res
        print(json.dumps({
            "route": route, "rti_fused": key, "peds": peds, "seed": seed, "steps": res.steps,
            "completed": res.completed, "collisions": res.collisions,
            "infeasible": res.infeasible_cycles, "x_final": float(res.trajectory[-1][0]),
            "cert_valid_frac": float(np.mean(valid)) if valid else None,
            "cycle_ms_median": float(np.median(res.cycle_times[1:]) * 1e3)
            if len(res.cycle_times) > 1 else None}), flush=True)
    a, b = (np.asarray(out[r].trajectory) for r in ("default", "unfused"))
    n = min(len(a), len(b))
    gap = np.linalg.norm(a[:n] - b[:n], axis=1)
    parted = np.flatnonzero(gap > PART)
    summary = {"steps_compared": n, "max_gap_m": float(gap.max()),
               "final_gap_m": float(gap[-1]),
               "first_step_apart": int(parted[0]) + 1 if parted.size else None,
               "same_outcome": all(getattr(out["default"], k) == getattr(out["unfused"], k)
                                   for k in ("completed", "collisions", "infeasible_cycles"))}
    print(json.dumps(summary), flush=True)
    return out, summary


def main(argv=None):
    ap = device_parser(__doc__.split("\n\n")[0])
    ap.add_argument("--peds", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-steps", type=int, default=40,
                    help="steps of each run (the unfused route takes seconds a step)")
    args = ap.parse_args(argv)
    compare(args.peds, args.seed, args.max_steps, resolve_device(args.device))


if __name__ == "__main__":
    main()
