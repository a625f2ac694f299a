"""Splitting T-MPC++'s parallel solves over ranks.

The port's counterpart of examples/04_mesh_fanout.py. The reference runs
its 4+1 parallel homotopy-class planners on OpenMP threads
(guidance_constraints.cpp:279). Here the parallel planners are one batch
axis of one solver, and that axis splits over the ranks of a
torch.distributed process group (parallel/): each rank solves its own
slice, and the best-feasible selection (ref FindBestPlanner) is one
all-gather and the winner's broadcast.

`--ranks R` starts R processes: on the CPU they join over gloo; on cards
over NCCL, rank r on cuda:r (NCCL puts no two ranks on one GPU). With one
rank on the card the group is NCCL with world size 1.

    python -m mpc_planner_tpu_torch.examples.mesh_fanout [--device cpu] [--ranks 2]
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from mpc_planner_tpu_torch.examples import parser

B = 128  # parallel guesses: perturbed warm starts standing in for homotopy classes


def solve_rank(device):
    """One rank's part: its slice of B perturbed flagship problems (N=10),
    the global winner."""
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.parallel import batch_mesh, distributed_solve_step, shard_batch
    from mpc_planner_tpu_torch.solver.sqp import SQPSolver
    from mpc_planner_tpu_torch.utils.config import default_config

    cfg = default_config(N=10)
    cfg = cfg.replace(solver=cfg.solver.__class__(iterations=4, qp_iterations=10))
    model, ocp, Z0, P, xinit = presets.flagship_problem(cfg)
    rng = np.random.default_rng(0)
    Zb = np.tile(Z0[None], (B, 1, 1)).astype(np.float32)
    Zb[:, 1:, model.nu:] += rng.normal(0, 0.05, Zb[:, 1:, model.nu:].shape).astype(np.float32)
    batch = (Zb, np.tile(P[None], (B, 1, 1)), np.tile(xinit[None], (B, 1)), np.ones(B))

    mesh = batch_mesh(device)
    step = distributed_solve_step(SQPSolver(ocp, device=mesh.device), mesh, cfg.solver.iterations)
    Zw, idx, found, res = step(*shard_batch(mesh, batch))
    feasible = int((res.exit_code == 1).sum())
    print(f"rank {mesh.rank}/{mesh.world_size} on {mesh.device}: {res.Z.shape[0]} solves, "
          f"{feasible} feasible; selected planner {int(idx)} (found={bool(found)})", flush=True)
    assert bool(found)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = parser(__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--rank", type=int, default=None, help="(set for the ranks it starts)")
    ap.add_argument("--init-method", default=None, help="(set for the ranks it starts)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    from mpc_planner_tpu_torch.parallel import initialize_distributed

    if args.rank is None and args.ranks > 1:  # start the ranks, wait for them
        init = f"tcp://127.0.0.1:{_free_port()}"
        procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, "--device", args.device,
                                   "--ranks", str(args.ranks), "--rank", str(r), "--init-method", init],
                                  env=dict(os.environ, OMP_NUM_THREADS="1"))
                 for r in range(args.ranks)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(codes):
            raise SystemExit(f"a rank failed: exit codes {codes}")
        print(f"{args.ranks} ranks finished")
        return
    device = args.device
    if args.rank is not None:
        if device == "cuda":  # one card per rank
            device = f"cuda:{args.rank}"
        initialize_distributed(args.init_method, args.ranks, args.rank, device=device)
    elif device != "cpu":  # one rank on the card: NCCL, world size 1
        initialize_distributed(f"tcp://127.0.0.1:{_free_port()}", 1, 0, device=device)
    try:
        solve_rank(device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
