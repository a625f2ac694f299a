"""Horizon sweep: sequential vs parallel-in-horizon (associative-scan)
Riccati on the plain QP path, beside K1 on the same QPs.

The port's counterpart of experiments/horizon_sweep.py (the same flags,
the same QPs for a seed, plus `--device` and a K1 column). Measures the
batched IP QP solve (the inner loop of the SQP) across horizon lengths to
locate the crossover where the O(log N)-depth scan beats the O(N)-depth
sequential sweeps; both are eager torch, launch-bound on the card. K1
(ops/cuda_qp.py::solve_qp_cuda, one warp per QP) solves the same QPs where
an element's working set fits the 227 KB of shared memory a block can
have; "-" where it does not, and on the CPU (where K1's wrapper would take
the sequential plain version).

    python -m mpc_planner_tpu_torch.experiments.horizon_sweep [--batch 256] [--iters 8] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_planner_tpu_torch.experiments.common import device_parser, resolve_device, timed

CHAIN = 4  # solves chained per timed call, each perturbed by the last one's step
REPS = 3  # timed calls; the least is kept


def make_qp(rng, B, N, device="cpu", nu=2, nx=5, nh=8):
    """A batch of random well-posed stagewise QPs (the reference experiment's
    draws, in its order): (QPData on `device`, nu, nx)."""
    from mpc_planner_tpu_torch.solver.qp import QPData

    nvar = nu + nx
    nrows = nvar + nh

    def spd(n, scale=1.0):
        M = rng.normal(0, 1, (B, N + 1, n, n))
        return scale * (M @ M.transpose(0, 1, 3, 2) + 2.0 * np.eye(n))

    H = spd(nvar, 0.5)
    H[:, N, :nu, :] = 0.0
    H[:, N, :, :nu] = 0.0
    H[:, N, nu:, nu:] += np.eye(nx)
    g = rng.normal(0, 1, (B, N + 1, nvar))
    A = np.tile(np.eye(nx), (B, N, 1, 1)) + 0.05 * rng.normal(0, 1, (B, N, nx, nx))
    Bm = 0.3 * rng.normal(0, 1, (B, N, nx, nu))
    c = 0.05 * rng.normal(0, 1, (B, N, nx))
    D_h = rng.normal(0, 1, (B, N + 1, nh, nvar))
    D_box = np.broadcast_to(np.eye(nvar), (B, N + 1, nvar, nvar))
    D = np.concatenate([D_box, D_h], axis=2)
    lb = -2.0 - np.abs(rng.normal(0, 1, (B, N + 1, nrows)))
    ub = 2.0 + np.abs(rng.normal(0, 1, (B, N + 1, nrows)))
    mask = np.ones((B, N + 1, nrows))
    mask[:, 0, nu:nvar] = 0.0
    mask[:, N, :nu] = 0.0
    mask[:, N, nvar:] = 0.0

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)

    return QPData(H=f32(H), g=f32(g), A=f32(A), B=f32(Bm), c=f32(c), D=f32(D),
                  lb=f32(lb), ub=f32(ub), mask_l=f32(mask), mask_u=f32(mask)), nu, nx


def solver_of(route: str, nu: int, nx: int, iters: int):
    """qp -> dz of one route: "seq" and "par" (solver/qp.py::solve_qp with
    horizon_parallel off / on), "k1" (K1 on H regularized already)."""
    from mpc_planner_tpu_torch.ops.cuda_qp import solve_qp_cuda
    from mpc_planner_tpu_torch.solver.qp import solve_qp

    if route == "k1":
        return lambda d: solve_qp_cuda(d, nu, nx, iterations=iters).dz
    hp = route == "par"
    return lambda d: solve_qp(d, nu, nx, iterations=iters, horizon_parallel=hp).dz


def chained(solve, qp):
    """CHAIN solves, each gradient perturbed by the last step, so that no
    solve can be skipped or overlapped: the last dz."""
    dz = torch.zeros_like(qp.g)
    for _ in range(CHAIN):
        dz = solve(qp._replace(g=qp.g + 1e-6 * dz))
    return dz


def time_route(solve, qp, device):
    """Seconds per solve: the least of REPS timed chains, after one untimed."""
    chained(solve, qp)
    return min(timed(lambda: chained(solve, qp), device)[1] for _ in range(REPS)) / CHAIN


def k1_fits(N, nu, nx, nh) -> bool:
    """Whether one element of K1 (its QP in global memory) fits a block's
    shared memory at horizon N."""
    from mpc_planner_tpu_torch.ops import cuda_qp

    return cuda_qp.load_kernels().qp_shared_bytes(N, nu, nx, nh, False, False) <= 227 * 1024


def sweep(horizons, batch, iters, device):
    """Rows (N, seq ms, par ms, K1 ms or None) over `horizons`; prints them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    print(f"# device={device} B={batch} ip_iters={iters}")
    print(f"{'N':>5} {'seq ms':>9} {'par ms':>9} {'par/seq':>8} {'K1 ms':>9}")
    rows = []
    for N in horizons:
        qp, nu, nx = make_qp(rng, batch, N, device)
        t_seq = time_route(solver_of("seq", nu, nx, iters), qp, device)
        t_par = time_route(solver_of("par", nu, nx, iters), qp, device)
        nh = qp.D.shape[2] - nu - nx
        t_k1 = None
        if device.type == "cuda" and k1_fits(N, nu, nx, nh):
            t_k1 = time_route(solver_of("k1", nu, nx, iters), qp, device)
        k1 = f"{t_k1 * 1e3:>9.3f}" if t_k1 is not None else f"{'-':>9}"
        print(f"{N:>5} {t_seq*1e3:>9.2f} {t_par*1e3:>9.2f} {t_par/t_seq:>8.2f} {k1}", flush=True)
        rows.append((N, t_seq * 1e3, t_par * 1e3, None if t_k1 is None else t_k1 * 1e3))
    return rows


def main(argv=None):
    ap = device_parser(__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--horizons", type=int, nargs="+", default=[10, 20, 30, 60, 120, 240])
    args = ap.parse_args(argv)
    sweep(args.horizons, args.batch, args.iters, resolve_device(args.device))


if __name__ == "__main__":
    main()
