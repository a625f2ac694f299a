"""Single-card batch-scaling sweep: throughput vs batch size.

The port's counterpart of experiments/batch_sweep.py. Measures full
T-MPC++ solves (presets.flagship_problem: N=20, 10 RTI) at several batch
sizes on one card, on the default route (K3, one launch a solve, asserted),
and prints beside each B how K3's launcher runs it: staged in shared memory
or not, the blocks the card holds at once at that footprint, and the waves
the batch takes (ops/csrc/residency.cuh), so that the steps of the curve
can be read off.

    python -m mpc_planner_tpu_torch.experiments.batch_sweep [--device cpu]
"""

from __future__ import annotations

import numpy as np

from mpc_planner_tpu_torch.experiments.common import (
    check_route,
    device_parser,
    perturbed_batch,
    resolve_device,
    timed,
    warm_carry,
    warm_chain,
)

SIZES = (128, 256, 512, 1024, 2048)
RTI = 10
CYCLES = 8  # chained steady-state cycles per timed call (bench.py's methodology)
REPS = 8


def residency_text(solver, B: int) -> str:
    """'staged, 1 wave of 924 resident blocks' for K3 at batch B; '-' off the card."""
    if solver.device.type != "cuda":
        return "-"
    from mpc_planner_tpu_torch.ops.cuda_rti import rti_residency

    staged, resident, waves = rti_residency(solver._stage_code, B, solver.ocp.N)
    return (f"{'staged' if staged else 'unstaged'}, {waves} wave{'s' * (waves != 1)} "
            f"of {resident} resident blocks")


def sweep(sizes=SIZES, rti=RTI, cycles=CYCLES, reps=REPS, device=None, N=20):
    """Rows (B, mean ms, p99 ms, solves/s, residency) of chained warm cycles
    at each batch size; prints them. Returns the rows and the last size's
    final carry (Z, lam_l, lam_u, ok) with its inputs (warm0, Pb, xb)."""
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.solver.sqp import SQPSolver
    from mpc_planner_tpu_torch.utils.config import default_config

    cfg = default_config(N=N)
    model, ocp, Z0, P, xinit = presets.flagship_problem(cfg)
    solver = SQPSolver(ocp, device=device)
    check_route(solver, True)
    rng = np.random.default_rng(0)

    print(f"N={ocp.N} nvar={ocp.nvar} nh={ocp.nh}, {rti} RTI iters/solve")
    rows, last = [], None
    for B in sizes:
        Z0b, Pb, xb = perturbed_batch(rng, Z0, P, xinit, B, model.nu, device)
        warm0 = warm_carry(solver.solve_batch(Z0b, Pb, xb, num_iterations=rti))
        out = warm_chain(solver, warm0, Pb, xb, rti, cycles)  # first loads
        ts = []
        for _ in range(reps):
            out, seconds = timed(lambda: warm_chain(solver, warm0, Pb, xb, rti, cycles), device)
            ts.append(seconds / cycles)
        mean, p99 = float(np.mean(ts)), float(np.percentile(ts, 99))
        res_text = residency_text(solver, B)
        rows.append((B, mean * 1e3, p99 * 1e3, B / mean, res_text))
        last = (out, warm0, Pb, xb)
        print(f"B={B:5d}: mean {mean*1e3:7.2f} ms  p99 {p99*1e3:7.2f} ms  "
              f"{B/mean:9.0f} solves/s/chip  K3 {res_text}", flush=True)

    print("\n| B | mean ms | p99 ms | solves/s/chip | K3 blocks |")
    print("|---|---|---|---|---|")
    for B, m, p, thr, res_text in rows:
        print(f"| {B} | {m:.1f} | {p:.1f} | {thr:,.0f} | {res_text} |")
    return rows, last


def main(argv=None):
    args = device_parser(__doc__.split("\n\n")[0]).parse_args(argv)
    sweep(device=resolve_device(args.device))


if __name__ == "__main__":
    main()
