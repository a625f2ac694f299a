"""Benchmark: batched T-MPC++-scene MPC solves on one card.

The port's counterpart of the reference's bench.py and of
__graft_entry__.py::entry. The workload is the reference's: MPC solves per
second at N=20 on the Jackal T-MPC++ corridor scene (contouring + guidance
with ellipsoid constraints, presets.flagship_problem), 10 SQP-RTI
iterations per solve, B=1024 warm starts perturbed by N(0, 0.05) on the
states. One cold solve_batch (its feasible count is reported), then `reps`
chains of `cycles` control cycles, each warm-started from the last one's
trajectory and converged duals; a cycle's time is its chain's wall time
(between two device syncs) over `cycles`.

On the card the solver must resolve to the fused route (K3, one launch a
solve): anything else fails the run. `flops_per_solve` is K3's operation
count for one warm solve (ops/cuda_rti.py::rti_work) and `pct_of_bound` the
share of the card's bound (ops/cuda_qp.py::bound_ms) that a cycle reaches.
The reference's analytic count of the IP-Riccati work is printed beside it.

    python -m mpc_planner_tpu_torch.bench [--device cpu]

Prints the run on standard error and ONE JSON line on standard output:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "flops_per_solve": N, "pct_of_bound": N}
"""

from __future__ import annotations

import json
import sys

import numpy as np

from mpc_planner_tpu_torch import default_device
from mpc_planner_tpu_torch.experiments.common import (
    card_text,
    check_route,
    device_parser,
    perturbed_batch,
    resolve_device,
    timed,
    timed_chains,
    warm_carry,
)

BASELINE_SOLVES_PER_SEC = 150.0  # 5 planners x 30 Hz (reference, CPU)
BATCH = 1024
REPS = 10
CYCLES = 8  # control cycles chained per timed call
RTI_ITERATIONS = 10


def _kernel_flops_per_solve(ocp, cfg) -> float:
    """Analytic FLOP count of the in-kernel IP-Riccati work for ONE
    solve (the Pallas kernel body is opaque to XLA's cost model).

    Leading terms per stage per IP iteration, counting multiply+add as
    2 FLOPs: the Gauss-Newton Hessian contribution J^T Sigma J over the
    `nrows` inequality rows (2*nrows*nvar^2), the Riccati block products
    A'PA / A'PB / B'PB + the nu-block Cholesky (~6*nvar^3), and the
    barrier/residual row work (~12*nrows*nvar). Mehrotra's
    predictor-corrector reuses the factorization for a second RHS
    (x1.5). Warm QPs run max(6, qp_iterations*2//3) IP iterations
    (solver/sqp.py); the steady-state chain is all-warm.
    """
    nvar, nx, nu, N = ocp.nvar, ocp.nx, ocp.nu, ocp.N
    nrows = ocp.nh + 2 * nvar  # module rows + variable bounds
    qp_iters = max(6, cfg.solver.qp_iterations * 2 // 3)
    per_stage = 1.5 * (
        2.0 * nrows * nvar**2 + 6.0 * nvar**3 + 12.0 * nrows * nvar
    )
    return float(cfg.solver.iterations * qp_iters * (N + 1) * per_stage)


def _build(device):
    """The flagship OCP instance at N=20 and its solver on `device` (the
    reference's __graft_entry__._build): (cfg, model, solver, Z0, P, xinit),
    the arrays as numpy. On the card the solver is asserted on K3."""
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.solver.sqp import SQPSolver
    from mpc_planner_tpu_torch.utils.config import default_config

    cfg = default_config(N=20)
    model, ocp, Z0, P, xinit = presets.flagship_problem(cfg)
    solver = SQPSolver(ocp, device=device)
    check_route(solver, True)
    return cfg, model, solver, Z0, P, xinit


def run(batch: int = BATCH, cycles: int = CYCLES, reps: int = REPS, rti: int = RTI_ITERATIONS,
        device=None) -> dict:
    """The benchmark; prints its lines on stderr and returns the JSON line's
    dict. On the card unless `device` says otherwise (then the metric is
    named for that device and `pct_of_bound`, the card's, is None)."""
    from mpc_planner_tpu_torch.ops.cuda_qp import bound_ms
    from mpc_planner_tpu_torch.ops.cuda_rti import warm_work
    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS

    device = default_device(device)
    cfg, model, solver, Z0, P, xinit = _build(device)
    Z0b, Pb, xb = perturbed_batch(np.random.default_rng(0), Z0, P, xinit, batch, model.nu, device)
    on_card = device.type == "cuda"
    print(f"# device: {card_text(device)}; route: "
          f"{'K3 (fused)' if solver.rti_fused else 'plain torch'}", file=sys.stderr)

    # The cold path (it also builds K3 on a first run); feasibility from it.
    res = solver.solve_batch(Z0b, Pb, xb, num_iterations=rti)
    n_success = int((res.exit_code == EXIT_SUCCESS).sum())
    print(f"# warmup: {n_success}/{batch} feasible", file=sys.stderr)

    # Steady-state control loop: cycle k+1 warm-starts from cycle k's
    # trajectory and converged duals.
    times, (_, last) = timed_chains(solver, warm_carry(res), Pb, xb, rti, cycles, reps, device)
    feas_steady = int((last.exit_code == EXIT_SUCCESS).sum())

    # One cold solve_batch call, as a user makes it
    _, t_single = timed(lambda: solver.solve_batch(Z0b, Pb, xb, num_iterations=rti), device)

    flops_per_solve, bytes_per_solve = warm_work(solver, rti)
    solves_per_sec = batch / float(np.mean(times))
    p99_ms = float(np.percentile(times, 99) * 1e3)
    achieved_flops = solves_per_sec * flops_per_solve
    bound, bound_by = bound_ms(flops_per_solve * batch, bytes_per_solve * batch)
    pct_bound = 100.0 * bound / (float(np.mean(times)) * 1e3) if on_card else None
    print(
        f"# batch={batch} cycle mean={np.mean(times)*1e3:.1f}ms "
        f"p99={p99_ms:.1f}ms rti={rti} "
        f"steady feasible={feas_steady}/{batch} "
        f"(single cold solve_batch: {t_single*1e3:.1f}ms)",
        file=sys.stderr,
    )
    if on_card:
        print(
            f"# roofline: ~{flops_per_solve/1e6:.1f} MFLOP/solve (K3's count, "
            f"ops/cuda_rti.py::rti_work) -> {achieved_flops/1e12:.3f} TFLOP/s; the card's bound "
            f"for a cycle is {bound:.4f} ms (by {bound_by}) = {pct_bound:.3f}% of it reached; "
            f"the reference's analytic IP-Riccati count "
            f"{_kernel_flops_per_solve(solver.ocp, cfg)/1e6:.1f} MFLOP/solve",
            file=sys.stderr,
        )
    return {
        "metric": "tmpc_solves_per_sec_per_gpu" if on_card else f"tmpc_solves_per_sec_{device.type}",
        "value": round(solves_per_sec, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_sec / BASELINE_SOLVES_PER_SEC, 2),
        "flops_per_solve": round(flops_per_solve),
        "pct_of_bound": None if pct_bound is None else round(pct_bound, 3),
    }


def entry(device=None):
    """(fn, example_args): one SQP-RTI solve of the flagship OCP at 2
    iterations, without escalation (the reference's
    __graft_entry__.py::entry); on the card, K3."""
    import torch

    from mpc_planner_tpu_torch.solver.sqp import SolveResult

    device = default_device(device)
    _, _, solver, Z0, P, xinit = _build(device)

    def fn(Z0, P, xinit):
        res = solver.batch_impl(Z0[None], P[None], xinit[None], 2)
        return SolveResult(*(f[0] for f in res))

    example_args = tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                         for a in (Z0, P, xinit))
    return fn, example_args


def main(argv=None):
    args = device_parser(__doc__.split("\n\n")[0]).parse_args(argv)
    print(json.dumps(run(device=resolve_device(args.device))))


if __name__ == "__main__":
    main()
