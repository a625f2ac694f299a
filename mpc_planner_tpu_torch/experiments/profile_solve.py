"""Breakdown of the batched unfused solve: linearization vs MIRROR vs QP
kernel.

The port's counterpart of experiments/profile_solve.py, on the unfused
route (solver.rti_fused="off": per RTI iteration the eager linearization,
then K1, asserted). K1 runs the MIRROR in its prologue, so the QP rows time
K1 twice, on the raw stage Hessians with the MIRROR inside (what the route
launches) and on Hessians regularized beforehand, and the MIRROR row is the
MIRROR alone (K2 on the stack, SQPSolver._mirror_nvar). Every piece is
chained CHAIN times, each call fed by the last one's result, and timed by
CUDA events around the chain (the host clock between syncs on the CPU).

    python -m mpc_planner_tpu_torch.experiments.profile_solve [BATCH] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_planner_tpu_torch.experiments.common import (
    device_parser,
    perturbed_batch,
    route_solver,
    resolve_device,
    timed,
    warm_carry,
)

RTI = 10
CHAIN = 16
REPS = 3


def chain_ms(step, x0, device, chain=CHAIN, reps=REPS):
    """Milliseconds per call of x -> step(x), CHAIN calls chained, the least
    of `reps` timed chains after one untimed."""

    def run():
        x = x0
        for _ in range(chain):
            x = step(x)
        return x

    run()
    if device.type != "cuda":
        return min(timed(run, device)[1] for _ in range(reps)) * 1e3 / chain
    ms = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize(device)
        ms.append(start.elapsed_time(end))
    return min(ms) / chain


def breakdown(batch=1024, rti=RTI, chain=CHAIN, reps=REPS, device=None, N=20):
    """The rows {label: ms per call} of the breakdown; prints them."""
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.ops.cuda_qp import solve_qp_cuda
    from mpc_planner_tpu_torch.utils.config import default_config

    cfg = default_config(N=N)
    model, modules = presets.configuration_tmpc(cfg)
    ocp, Z0, P, xinit = presets.preset_problem(cfg, model, modules, 8, 0)
    solver = route_solver(model, modules, cfg, "unfused", device)
    rng = np.random.default_rng(0)
    Z0b, Pb, xb = perturbed_batch(rng, Z0, P, xinit, batch, model.nu, device)
    nu, nx = ocp.nu, ocp.nx
    print(f"B={batch} N={ocp.N} nvar={ocp.nvar} nh={ocp.nh} nrows={solver.nrows}")

    def ms_of(step, x0):
        return chain_ms(step, x0, device, chain, reps)

    rows = {}
    # full solve (one control cycle, warm duals carried), as bench.py
    res = solver.solve_batch(Z0b, Pb, xb, num_iterations=rti)

    def cycle(carry):
        Z, ll, lu, ok = carry
        return warm_carry(solver.batch_impl(Z, Pb, xb, rti, warm0=(ll, lu, ok)))

    rows["full"] = t_full = ms_of(cycle, warm_carry(res))
    print(f"full warm cycle ({rti} RTI): {t_full:8.2f} ms ({batch / t_full * 1e3:.0f} solves/s)")

    # linearization alone (no mirror): Z' = Z + eps * g
    rows["linearize"] = t_lin = ms_of(
        lambda Z: Z + 1e-7 * solver._linearize(Z, Pb, raw_hessian=True).g, Z0b)
    print(f"linearize (no mirror):  {t_lin:8.2f} ms")

    qp0 = solver._linearize(Z0b, Pb, raw_hessian=True)
    Bb, Np1, nv, _ = qp0.H.shape
    Hflat = qp0.H.reshape(Bb * Np1, nv, nv)

    # the MIRROR alone: the structure-aware stack the unfused route ran
    # before K1 took it in (K2 on the card)
    rows["mirror"] = t_mir = ms_of(lambda H: solver._mirror_nvar(H) + 1e-9 * H, Hflat)
    print(f"mirror (unpacked jacobi): {t_mir:8.2f} ms")

    qpm = qp0._replace(H=solver._mirror_nvar(Hflat).reshape(Bb, Np1, nv, nv))
    mirror = dict(mirror_lm=solver.lm, mirror_x_only=solver._mirror_x_only)
    it = solver.qp_iterations
    for label, qp, kw in (("qp cold, MIRROR inside", qp0, mirror), ("qp cold", qpm, {})):
        def cold_step(q, kw=kw):
            sol = solve_qp_cuda(q, nu, nx, iterations=it, mu0=solver.mu0, **kw)
            return q._replace(g=q.g + 1e-7 * sol.dz)

        rows[label] = t = ms_of(cold_step, qp)
        print(f"{label} kernel ({it} it): {t:8.2f} ms")

    warm_iters = solver.warm_qp_iters  # what the route runs after its first QP
    for label, qp, kw in (("qp warm, MIRROR inside", qp0, mirror), ("qp warm", qpm, {})):
        sol0 = solve_qp_cuda(qp, nu, nx, iterations=it, mu0=solver.mu0, **kw)

        def warm_step(carry, kw=kw):
            q, ll, lu, mu = carry
            sol = solve_qp_cuda(q, nu, nx, iterations=warm_iters, mu0=solver.mu0,
                                warm_duals=(ll, lu, mu < 1e-2), **kw)
            return q._replace(g=q.g + 1e-7 * sol.dz), sol.lam_l, sol.lam_u, sol.mu

        rows[label] = t = ms_of(warm_step, (qp, sol0.lam_l, sol0.lam_u, sol0.mu))
        print(f"{label} kernel ({warm_iters} it): {t:8.2f} ms")

    est = (t_lin * rti + rows["qp cold, MIRROR inside"]
           + rows["qp warm, MIRROR inside"] * (rti - 1))
    rows["sum of parts"] = est
    print(f"sum of parts estimate:  {est:8.2f} ms (vs {t_full:.2f} measured)")
    return rows


def main(argv=None):
    ap = device_parser(__doc__.split("\n\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=1024)
    args = ap.parse_args(argv)
    breakdown(args.batch, device=resolve_device(args.device))


if __name__ == "__main__":
    main()
