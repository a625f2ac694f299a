"""The reference's headline closed-loop experiment: a corridor with
crossing pedestrians, T-MPC++ vs non-parallel MPC
(mpc_planner_jackalsimulator/README.md + docs/duration_with_baseline.png:
task duration over 4/8/12 pedestrians).

The port's counterpart of experiments/corridor_benchmark.py: the same
flags (`--cpu` becomes `--device cpu`), the same pedestrians for a seed,
the same table rows and JSON keys, on the port's closed-loop simulator.
It runs on the card unless given `--device cpu`; the route is the config
key solver.rti_fused ("auto": K3 on the card), asserted per row.

    python -m mpc_planner_tpu_torch.experiments.corridor_benchmark [--device cpu] [--seeds 3]

Prints a markdown table of task duration / collisions / completion.
`run_row` is one row of it as a function.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from mpc_planner_tpu_torch.experiments.common import check_route, device_parser, resolve_device

PATH_X = np.linspace(0, 25, 14)


def make_peds(n, seed):
    """Crossing pedestrians in the corridor INTERIOR (the reference's
    pedestrian_simulator corridor: agents walk across the corridor,
    the goal region stays clear — mpc_planner_jackalsimulator
    README corridor GIF). Goals on the far side make them re-cross."""
    from mpc_planner_tpu_torch.sim import Pedestrian

    rng = np.random.default_rng(seed)
    peds = []
    for _ in range(n):
        x = rng.uniform(4.0, 20.0)
        y = rng.uniform(-2.5, 2.5)
        vy = rng.uniform(0.3, 0.9) * (1 if rng.random() < 0.5 else -1)
        wp_a = np.array([x + rng.uniform(-2.0, 2.0), 3.0 * np.sign(vy)])
        wp_b = np.array([x + rng.uniform(-2.0, 2.0), -3.0 * np.sign(vy)])
        peds.append(Pedestrian(
            position=np.array([x, y]),
            velocity=np.array([rng.uniform(-0.3, 0.3), vy]),
            radius=0.4,
            waypoints=[wp_a, wp_b],  # cyclic crossing, pedsim-style
        ))
    return peds


def config_table(name: str):
    """{row label: configuration function} of `--config`."""
    from mpc_planner_tpu_torch import presets

    return {
        "all": {"T-MPC++": presets.configuration_tmpc,
                "MPC (ellipsoid)": presets.configuration_basic},
        "tmpc": {"T-MPC++": presets.configuration_tmpc},
        "basic": {"MPC (ellipsoid)": presets.configuration_basic},
        "shmpc": {"SH-MPC (slack)": presets.configuration_safe_horizon},
        "ca": {"CA T-MPC++": presets.configuration_tmpc_ca},
    }[name]


def build_config(horizon=20, no_braking_class=False, backend=None, samples_per_class=None,
                 no_prm_smoothing=False, qp_warm_iterations=0, scenario_solvers=None,
                 scenario_samples=None, scenario_constraints=None, scenario_span=None):
    """The row's config from the command line's overrides."""
    from mpc_planner_tpu_torch.utils.config import default_config

    cfg = default_config(N=horizon)
    t_mpc = {}
    if no_braking_class:
        t_mpc["braking_class"] = False
    if backend:
        t_mpc["guidance_backend"] = backend
    if samples_per_class:
        t_mpc["samples_per_class"] = samples_per_class
    if no_prm_smoothing:
        t_mpc["prm_spline_smoothing"] = False
    if t_mpc:
        cfg = cfg.replace(t_mpc=dataclasses.replace(cfg.t_mpc, **t_mpc))
    if qp_warm_iterations:
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver,
                                                     qp_warm_iterations=qp_warm_iterations))
    scenario = {k: v for k, v in (("parallel_solvers", scenario_solvers),
                                  ("n_samples", scenario_samples),
                                  ("n_constraints", scenario_constraints)) if v}
    if scenario_span is not None:
        scenario["warmstart_span"] = scenario_span
    if scenario:
        cfg = cfg.replace(scenario_constraints=dataclasses.replace(cfg.scenario_constraints,
                                                                   **scenario))
    return cfg


def certificate_stats(mod_records):
    """SH-MPC scenario-theory summary (per-cycle risk certificates from
    module saveData): fraction of cycles with a valid certificate, its
    distribution, and support/saturation stats; None without SH-MPC."""
    certs = np.asarray([
        r["scenario_risk_certificate"] for r in mod_records
        if "scenario_risk_certificate" in r])
    if not certs.size:
        return None
    valid = np.asarray([
        bool(r.get("scenario_cert_valid")) for r in mod_records
        if "scenario_risk_certificate" in r])
    support = np.asarray([
        r.get("scenario_support_max", -1) for r in mod_records
        if "scenario_risk_certificate" in r])
    return {
        "n_cycles": int(certs.size),
        "cert_valid_frac": round(float(valid.mean()), 3),
        "cert_eps_median": round(float(np.median(certs[valid])), 4)
        if valid.any() else None,
        "cert_eps_p95": round(float(np.percentile(certs[valid], 95)), 4)
        if valid.any() else None,
        "support_max_median": float(np.median(support[support >= 0]))
        if (support >= 0).any() else None,
        "support_max_peak": int(support.max()) if support.size else None,
        "n_samples": int(mod_records[0].get("scenario_n_samples", -1)),
    }


def run_row(make_config, cfg, n_peds, seeds, max_steps, device, label="", robot_blind=False,
            profile=False, json_line=False):
    """One row: `seeds` corridor runs of `n_peds` pedestrians, at most
    `max_steps` control cycles each, with ONE planner reset between seeds
    (the reference node persists across its num_experiments segments the
    same way). Prints the table row (then the profile, the SH-MPC
    certificate summary and the JSON line, as asked) and returns the JSON
    row as a dict."""
    from mpc_planner_tpu_torch.planner import Planner
    from mpc_planner_tpu_torch.sim import ClosedLoopSimulator

    path = {"x": PATH_X, "y": np.zeros_like(PATH_X)}
    durations, collisions, completed, infeasible = [], 0, 0, 0
    cycle_times, mod_records = [], []
    model, modules = make_config(cfg)
    planner = Planner(model, modules, cfg, device=device)
    check_route(planner.solver, cfg.solver.rti_fused != "off")
    gmod = modules.get("GuidanceConstraints")
    if gmod is not None:
        n_planners = gmod.n_planners
    elif modules.get("ScenarioConstraints") is not None:
        n_planners = cfg.scenario_constraints.parallel_solvers
    else:
        n_planners = 1
    for seed in range(seeds):
        planner.reset()
        sim = ClosedLoopSimulator(
            planner, cfg, make_peds(n_peds, seed), path,
            social_forces=True, seed=seed,
            # pedsim's social-forces pedestrians treat the robot as an agent
            # and avoid it (the reference's corridor conditions);
            # robot_blind reproduces the harsher robot-invisible variant.
            robot_aware=not robot_blind,
        )
        res = sim.run(max_steps=max_steps)
        durations.append(res.duration)
        collisions += res.collisions
        completed += int(res.completed)
        infeasible += res.infeasible_cycles
        # Skip the first 3 cycles per seed (the kernels' first loads)
        cycle_times.extend(res.cycle_times[3:])
        mod_records.extend(res.module_records)
    cyc = np.asarray(cycle_times) * 1e3
    cyc_s = f"{cyc.mean():.1f}/{np.percentile(cyc, 99):.1f}" if cyc.size else "-"
    print(f"| {label} | {n_peds} | {n_planners} | {completed}/{seeds} "
          f"| {np.mean(durations):.1f} | {collisions} | {infeasible} | {cyc_s} |", flush=True)
    if profile:
        print(planner.profiler.summary(), flush=True)
        planner.profiler.reset()
    cert_stats = certificate_stats(mod_records)
    if cert_stats is not None:
        print(f"  scenario certificate: {cert_stats}", flush=True)
    row = {
        "config": label, "backend": cfg.t_mpc.guidance_backend,
        "peds": n_peds, "B": n_planners, "completed": completed,
        "seeds": seeds,
        "duration_mean": round(float(np.mean(durations)), 1),
        "collisions": collisions, "infeasible": infeasible,
        "cycle_ms_mean": round(float(cyc.mean()), 2) if cyc.size else None,
        "cycle_ms_p99": round(float(np.percentile(cyc, 99)), 2) if cyc.size else None,
        "scenario_certificate": cert_stats,
    }
    if json_line:
        print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    ap = device_parser(__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--max-steps", type=int, default=200)
    ap.add_argument("--peds", type=int, nargs="*", default=[4, 8, 12])
    ap.add_argument("--config", choices=["tmpc", "basic", "shmpc", "ca", "all"], default="all")
    ap.add_argument("--scenario-solvers", type=int, default=None,
                    help="SH-MPC parallel scenario solvers (shmpc config; "
                         "the second BASELINE.md scale axis)")
    ap.add_argument("--scenario-constraints", type=int, default=None,
                    help="halfspaces kept per stage (top-k cap; the "
                         "reference uses 24 — raise to diagnose support "
                         "saturation in dense scenes)")
    ap.add_argument("--scenario-span", type=float, default=None,
                    help="lateral warmstart span [m] across scenario "
                         "solvers (multistart; 0 = reference-faithful "
                         "single warmstart)")
    ap.add_argument("--scenario-samples", type=int, default=None,
                    help="explicit scenario samples per solver (default: "
                         "derived from probabilistic.risk via the scenario "
                         "bound; see modules/scenario_theory.py)")
    ap.add_argument("--backend", choices=["lateral", "prm", "sampled"],
                    default=None, help="guidance backend override (A/B runs)")
    ap.add_argument("--samples-per-class", type=int, default=None,
                    help="warmstart variations per homotopy class — scales "
                         "the T-MPC batch to 100s-1000s of parallel guesses "
                         "(the BASELINE.md scale axis; the batch solves on the card)")
    ap.add_argument("--horizon", type=int, default=20,
                    help="MPC horizon N (the reference jackalsimulator runs 30)")
    ap.add_argument("--qp-warm-iterations", type=int, default=0,
                    help="override warm-QP IP iterations (0 = auto; the "
                         "N=30 latency lever, experiments/n30_latency.py)")
    ap.add_argument("--no-braking-class", action="store_true")
    ap.add_argument("--no-prm-smoothing", action="store_true",
                    help="A/B: linear polyline PRM resampling instead of "
                         "cubic-spline smoothing")
    ap.add_argument("--robot-blind", action="store_true",
                    help="pedestrians ignore the robot (pedsim's social-"
                         "forces agents avoid it; that is the default)")
    ap.add_argument("--json", action="store_true", help="also print one JSON line per row")
    ap.add_argument("--profile", action="store_true",
                    help="print the planner's per-scope host profile after each row")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("| config | pedestrians | B | completion | duration [s] | collisions "
          "| infeasible | cycle ms (mean/p99) |")
    print("|---|---|---|---|---|---|---|---|")
    for label, make_config in config_table(args.config).items():
        for n_peds in args.peds:
            cfg = build_config(
                args.horizon, args.no_braking_class, args.backend, args.samples_per_class,
                args.no_prm_smoothing, args.qp_warm_iterations, args.scenario_solvers,
                args.scenario_samples, args.scenario_constraints, args.scenario_span)
            run_row(make_config, cfg, n_peds, args.seeds, args.max_steps, device, label=label,
                    robot_blind=args.robot_blind, profile=args.profile, json_line=args.json)


if __name__ == "__main__":
    main()
