"""Agreement + timing check for the fused RTI kernel K3 against the unfused
route (K1 per RTI iteration) and the plain route (torch), on the card.

The port's counterpart of experiments/fused_rti_check.py. Each route is a
solver whose config key solver.rti_fused (and qp_backend) selects it, and
each is asserted. At B=BATCH, 10 RTI iterations, from perturbed converged
plans (a control loop's warm start: the agreement tolerances of
chip_smoke.py phase 8), cold duals and then each route's own warm duals:
the relative error on Z (max |d| / max |Z|) must stay below 5e-3 and the
exit codes may differ in at most 1% of the batch. (From raw noisy starts a
few elements end at another local solution on any pair of routes.) Then
the KKT residuals of one fused solution and the time of each route at
B=BATCH and at B=1.

    python -m mpc_planner_tpu_torch.experiments.fused_rti_check [BATCH] [--device cpu]

Exits 1 when an agreement check fails. On the CPU "fused" is K3's plain
version (ops/rti.py), the others the plain QP.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mpc_planner_tpu_torch.experiments.common import (
    device_parser,
    perturbed_batch,
    resolve_device,
    route_solver,
    timed,
    warm_carry,
)

RTI = 10
Z_TOL = 5e-3  # relative error on Z, chip_smoke.py phase 8
CODE_FRACTION = 0.01  # of the batch whose exit codes may differ
CONVERGED_NOISE = 0.01  # moves the converged plans into a next cycle's warm starts


def timeit(fn, device, reps=10, warmup=2):
    """Seconds per call, `reps` calls between two device syncs after `warmup`."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(reps):
            fn()

    return timed(run, device)[1] / reps


def agreement(fused, other, label):
    """The comparison of two routes' SolveResults: a dict with the relative
    Z error, the count of differing exit codes and whether both pass."""
    z_err = float((fused.Z - other.Z).abs().max() / other.Z.abs().max().clamp(min=1e-12))
    codes = int((fused.exit_code != other.exit_code).sum())
    B = fused.Z.shape[0]
    ok = z_err < Z_TOL and codes <= CODE_FRACTION * B
    print(f"{label}: max|Z_fused - Z_{label.split()[-1]}|/max|Z| = {z_err:.2e} (< {Z_TOL:g}); "
          f"exit codes differ in {codes}/{B} (<= {CODE_FRACTION:.0%}): {'PASS' if ok else 'FAIL'}")
    return dict(label=label, z_rel_err=z_err, codes_differ=codes, ok=ok)


def check(batch=1024, rti=RTI, device=None, N=20, reps=(5, 5, 1), latency=True):
    """The agreement rows and the times {route: ms} at B=batch (and B=1
    when `latency`); prints them. `reps` = timed calls of the fused, the
    unfused and the plain route."""
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.solver.kkt import kkt_residuals
    from mpc_planner_tpu_torch.utils.config import default_config

    cfg = default_config(N=N)
    model, modules = presets.configuration_tmpc(cfg)
    _, Z0, P, xinit = presets.preset_problem(cfg, model, modules, 8, 0)
    solvers = {r: route_solver(model, modules, cfg, r, device) for r in ("fused", "unfused", "plain")}
    fused = solvers["fused"]
    rng = np.random.default_rng(0)
    Z0b, Pb, xb = perturbed_batch(rng, Z0, P, xinit, batch, model.nu, device)

    # Warm starts: converged plans, moved as a next cycle's would be.
    Zs = fused.solve_batch(Z0b, Pb, xb, num_iterations=rti).Z
    noise = rng.normal(0, CONVERGED_NOISE, Zs.shape).astype(np.float32)
    Zp = Zs + torch.as_tensor(noise, device=device)

    cold = {r: s.solve_batch(Zp, Pb, xb, num_iterations=rti) for r, s in solvers.items()}
    warm = {r: s.solve_batch(Zp, Pb, xb, num_iterations=rti, warm_duals=warm_carry(cold[r])[1:])
            for r, s in solvers.items()}
    rows = []
    for stage, res in (("cold", cold), ("warm", warm)):
        for other in ("unfused", "plain"):
            rows.append(agreement(res["fused"], res[other], f"{stage}: fused vs {other}"))
    print(f"res_eq fused max = {float(cold['fused'].res_eq.max()):.2e}")

    f0 = cold["fused"]
    r = kkt_residuals(fused, f0.Z[0], Pb[0], f0.lam_l[0], f0.lam_u[0])
    print(f"fused KKT: stat={r.stationarity:.2e} eq={r.eq_residual:.2e} "
          f"box={r.primal_box:.2e} h={r.primal_h:.2e} comp={r.complementarity:.2e}")

    times = {}
    for (route, s), n in zip(solvers.items(), reps):
        times[route] = 1e3 * timeit(lambda s=s: s.solve_batch(Zp, Pb, xb, num_iterations=rti),
                                    device, reps=n, warmup=1)
    print(f"B={batch} {rti} RTI: " + " | ".join(
        f"{route} {ms:.2f} ms ({batch / ms * 1e3:.0f}/s)" for route, ms in times.items()))
    if latency:
        for route in ("fused", "unfused"):
            s = solvers[route]
            times[f"{route} B=1"] = 1e3 * timeit(
                lambda s=s: s.solve_batch(Zp[:1], Pb[:1], xb[:1], num_iterations=rti), device,
                reps=reps[0 if route == "fused" else 1])
        print(f"B=1: unfused {times['unfused B=1']:.2f} ms | fused {times['fused B=1']:.2f} ms")
    return rows, times


def main(argv=None):
    ap = device_parser(__doc__.split("\n\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=1024)
    args = ap.parse_args(argv)
    rows, _ = check(args.batch, device=resolve_device(args.device))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
