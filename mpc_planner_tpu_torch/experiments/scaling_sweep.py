"""Multi-device scaling sweep for the batched T-MPC solve.

The port's counterpart of experiments/scaling_sweep.py. Measures
`parallel.distributed_solve_step` (the solve split over the ranks of a
process group + the global-argmin selection + the winner broadcast to
every rank) at FLAGSHIP shapes (presets.flagship_problem: N=20, the full
T-MPC++ module set) over world sizes, with a fixed batch per rank (weak
scaling): throughput per device and weak-scaling efficiency.

For each world size W of `--devices` it starts W processes, one rank each
(the way parallel/dryrun.py::run_ranks starts them):
  * on the CPU (`--device cpu`) the ranks join over gloo; absolute times
    are CPU times, only the scaling shape and the collectives' overheads
    mean anything;
  * on the card (the default) over NCCL, rank r on cuda:r; world sizes
    above the card count are skipped. Each rank solves on K3 (asserted).

    python -m mpc_planner_tpu_torch.experiments.scaling_sweep [--device cpu] [--devices 1 2]

Also reports the cross-device payloads of the selection step (analytic:
the argmin all-gather carries two floats per row; the winner broadcast is
one [N+1, nvar] f32 trajectory ~= 0.6 kB) — the only communication in the
control cycle.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mpc_planner_tpu_torch.experiments.common import (
    check_route,
    device_parser,
    perturbed_batch,
    sync,
)

REPS = 5
MODULE = "mpc_planner_tpu_torch.experiments.scaling_sweep"
RANK_FLAG = "(set for the ranks it starts)"


def rank_step(device, per_device, rti, reps=REPS, N=20):
    """This rank's part of one world size: the global batch made from the
    seed, its own slice solved by `distributed_solve_step`, `reps` timed
    steps after one untimed. Returns the rank's record (every rank holds
    the same winner)."""
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.parallel import batch_mesh, distributed_solve_step, shard_batch
    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS, SQPSolver
    from mpc_planner_tpu_torch.utils.config import default_config

    cfg = default_config(N=N)
    model, ocp, Z0, P, xinit = presets.flagship_problem(cfg)
    mesh = batch_mesh(device)
    solver = SQPSolver(ocp, device=mesh.device)
    check_route(solver, True)
    B = per_device * mesh.world_size
    batch = perturbed_batch(np.random.default_rng(0), Z0, P, xinit, B, model.nu, "cpu")
    args = shard_batch(mesh, (*batch, np.ones((B,), np.float32)))

    step = distributed_solve_step(solver, mesh, num_iterations=rti)
    out = step(*args)
    sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = step(*args)
    sync(mesh.device)
    dt = (time.perf_counter() - t0) / reps
    Zw, idx, found, res = out
    feasible = torch.tensor([int((res.exit_code == EXIT_SUCCESS).sum())], device=mesh.device)
    if mesh.group is not None:
        torch.distributed.all_reduce(feasible, group=mesh.group)
    return dict(devices=mesh.world_size, rank=mesh.rank, B=B, ms=dt * 1e3, solves_per_s=B / dt,
                per_device=B / dt / mesh.world_size, feasible=int(feasible), winner=int(idx),
                found=bool(found), winner_Z=Zw.cpu().tolist(), N=ocp.N, nvar=ocp.nvar,
                nh=ocp.nh, npar=ocp.npar, backend=solver.qp_backend, fused=solver.rti_fused)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(world_size, device, per_device, rti, reps=REPS, N=20, timeout=1200.0):
    """Start `world_size` ranks (gloo on the CPU, NCCL on cards), each
    running rank_step; rank 0's record. Raises if a rank fails; ends every
    process it started."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory() as tmp:
        init = (f"tcp://127.0.0.1:{_free_port()}" if device == "cuda"
                else "file://" + os.path.join(tmp, "rendezvous"))
        procs = [subprocess.Popen(
            [sys.executable, "-m", MODULE, "--device", device,
             "--rank", str(r), "--world-size", str(world_size), "--init-method", init,
             "--per-device", str(per_device), "--rti", str(rti), "--reps", str(reps),
             "--horizon", str(N)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=root)
            for r in range(world_size)]
        deadline = time.monotonic() + timeout
        records = []
        try:
            for r, p in enumerate(procs):
                out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} exited {p.returncode}:\n{out}\n{err}")
                records.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return records[0]


def sweep(devices=(1, 2, 4, 8), device="cuda", per_device=16, rti=10, reps=REPS, N=20):
    """Rows (rank 0's records) over the world sizes; prints them and the
    table."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run the ranks on the CPU")
        devices = [n for n in devices if n <= torch.cuda.device_count()]
    rows = []
    for n_dev in devices:
        rec = run_world(n_dev, device, per_device, rti, reps, N)
        if not rows:
            print(f"flagship OCP: N={rec['N']} nvar={rec['nvar']} nh={rec['nh']} "
                  f"npar={rec['npar']} backend={rec['backend']} fused={rec['fused']}")
        rows.append(rec)
        print(f"devices={n_dev:2d} B={rec['B']:4d} {rec['ms']:9.2f} ms/step "
              f"{rec['solves_per_s']:9.0f} solves/s {rec['per_device']:9.0f} /s/device "
              f"feasible={rec['feasible']}/{rec['B']} winner={rec['winner']} "
              f"found={rec['found']}", flush=True)

    base = rows[0]["per_device"]
    print("\n| devices | B | ms/step | solves/s | solves/s/device | efficiency |")
    print("|---|---|---|---|---|---|")
    for rec in rows:
        rec["efficiency"] = rec["per_device"] / base
        print(f"| {rec['devices']} | {rec['B']} | {rec['ms']:.1f} | {rec['solves_per_s']:.0f} | "
              f"{rec['per_device']:.0f} | {rec['efficiency'] * 100:.0f}% |")
    Np1, nvar = N + 1, rows[0]["nvar"]
    print(f"\nselection payloads: argmin all-gather = 2 floats/row; "
          f"winner broadcast = {Np1}x{nvar} f32 = {Np1*nvar*4} bytes")
    return rows


def main(argv=None):
    ap = device_parser(__doc__.split("\n\n")[0])
    ap.add_argument("--per-device", type=int, default=16,
                    help="batch elements per device (weak scaling)")
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--rti", type=int, default=10)
    ap.add_argument("--reps", type=int, default=REPS, help=RANK_FLAG)
    ap.add_argument("--horizon", type=int, default=20, help=RANK_FLAG)
    ap.add_argument("--rank", type=int, default=None, help=RANK_FLAG)
    ap.add_argument("--world-size", type=int, default=None, help=RANK_FLAG)
    ap.add_argument("--init-method", default=None, help=RANK_FLAG)
    args = ap.parse_args(argv)
    if args.rank is None:
        sweep(args.devices, args.device, args.per_device, args.rti, args.reps, args.horizon)
        return
    torch.set_num_threads(1)
    from mpc_planner_tpu_torch.parallel import initialize_distributed

    device = f"cuda:{args.rank}" if args.device == "cuda" else args.device
    initialize_distributed(args.init_method, args.world_size, args.rank, device=device)
    try:
        rec = rank_step(device, args.per_device, args.rti, args.reps, args.horizon)
        print(json.dumps(rec), flush=True)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
