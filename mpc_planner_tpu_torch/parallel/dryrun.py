"""The multi-rank dry run: the flagship program split over the ranks of a
process group, the counterpart of __graft_entry__.py::dryrun_multichip.

Rungs (each a few parallel solves per rank, so that CPU processes finish
in about a minute):
  * flagship_N20: configuration_tmpc at N=20 (nh = 12 guidance + 12
    ellipsoid = 24), two chained control cycles through
    `distributed_solve_step`: cycle 2 starts every planner from the
    broadcast winner shifted by one stage, carries cycle 1's converged QP
    duals and puts the consistency bonus (0.9) on the winner
    (guidance_constraints.cpp:358-359);
  * flagship_N30_cold: the same program at the reference Jackal's horizon,
    one cold cycle (any flagship_N<horizon>[_cold] names such a rung);
  * scenario: one SH-MPC rung at N=15, one scenario solver per rank:
    scenario draws on the device, the per-solver halfspaces and top-24
    selection written into the parameter blocks, the slack model's split
    solve and the best-cost selection;
  * bicycle: configuration_bicycle at N=20 (nu=3, nx=6, nvar=9, the widest
    stage), one cold cycle of two RTI iterations; the reference's dry run
    has no nvar=9 rung.
The flagship and bicycle batches hold 2 planners per rank, their warm
starts and velocity weights perturbed from a seed so that the winner is
decided by a margin.

One rank per process:

    python -m mpc_planner_tpu_torch.parallel.dryrun --init-method file:///tmp/rdv \\
        --world-size 2 --rank 0 --device cpu [--rungs flagship_N20,bicycle]

prints one JSON line per rung. `run_ranks` starts all ranks on the CPU
(gloo) and collects their lines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

RUNGS = ("flagship_N20", "flagship_N30_cold", "scenario", "bicycle")
PLANNERS_PER_RANK = 2
WARM_CONSISTENCY = 0.9


def _solver_config(N: int, iterations: int):
    from mpc_planner_tpu_torch.utils.config import default_config

    cfg = default_config(N=N)
    return cfg.replace(solver=cfg.solver.__class__(iterations=iterations, qp_iterations=6))


def _perturbed_batch(Z0, P, xinit, B: int, nu: int, seed: int, weight_index: int):
    """B copies of one problem that end at distinct optima, standing in for
    distinct homotopy classes: the states of stages 1..N moved by N(0, 0.05)
    noise and the weight at `weight_index` of P scaled by a factor in
    [0.7, 1.3], both drawn for the global batch (so every rank sees the
    same rows). Without the weights the rows converge to one optimum and
    the winner is decided by rounding."""
    rng = np.random.default_rng(seed)
    Zb = np.tile(Z0[None], (B, 1, 1)).astype(np.float32)
    Zb[:, 1:, nu:] += rng.normal(0, 0.05, Zb[:, 1:, nu:].shape).astype(np.float32)
    Pb = np.tile(P[None], (B, 1, 1)).astype(np.float32)
    Pb[:, :, weight_index] *= rng.uniform(0.7, 1.3, (B, 1)).astype(np.float32)
    return Zb, Pb, np.tile(xinit[None], (B, 1)).astype(np.float32)


def flagship_rung(mesh, N: int, chain: bool, seed: int = 0, make_config=None,
                  iterations: int = None) -> Dict:
    """The flagship (or `make_config`'s OCP) at horizon N over the mesh:
    one cold cycle, and with `chain` a warm-chained second one, of
    `iterations` RTI iterations (default 2 chained, 1 cold). Returns the
    winners' indices, found flags and the last winner's Z."""
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.parallel.distributed import distributed_solve_step
    from mpc_planner_tpu_torch.parallel.mesh import shard_batch
    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS, SQPSolver

    iterations = iterations or (2 if chain else 1)
    cfg = _solver_config(N, iterations)
    model, modules = (make_config or presets.configuration_tmpc)(cfg)
    ocp, Z0, P, xinit = presets.preset_problem(cfg, model, modules)
    solver = SQPSolver(ocp, device=mesh.device)
    B = PLANNERS_PER_RANK * mesh.world_size
    batch = _perturbed_batch(Z0, P, xinit, B, model.nu, seed, ocp.params.save_map()["velocity"])
    Zb, Pb, xb, ones = shard_batch(mesh, batch + (np.ones(B, np.float32),))
    Zw, idx, found, res = distributed_solve_step(solver, mesh, iterations)(Zb, Pb, xb, ones)
    idxs, founds = [int(idx)], [bool(found)]
    if chain:
        Zshift = torch.cat([Zw[1:], Zw[-1:]])
        rows = torch.arange(B, device=mesh.device)
        consistency = torch.where(rows == idx, WARM_CONSISTENCY, 1.0)
        consistency = shard_batch(mesh, consistency)
        warm = distributed_solve_step(solver, mesh, iterations, warm=True)
        Zw, idx, found, _ = warm(Zshift.expand_as(Zb).contiguous(), Pb, xb, consistency,
                                 res.lam_l, res.lam_u, res.exit_code == EXIT_SUCCESS)
        idxs.append(int(idx))
        founds.append(bool(found))
    return dict(N=N, nvar=model.nvar, nh=ocp.nh, B=B, idx=idxs, found=founds,
                Z=Zw.cpu().numpy().tolist())


def scenario_rung(mesh, N: int = 15, n_samples: int = 32, seed: int = 0) -> Dict:
    """One SH-MPC program: a scenario solver per rank, each with its own
    draw (every rank draws the global batch from one seeded generator and
    takes its rows), on configuration_safe_horizon's slack model, every
    solver from the same warm start."""
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.modules.scenario_constraints import (
        _device_scenario_halfspaces,
        _select_tightest,
    )
    from mpc_planner_tpu_torch.parallel.distributed import distributed_solve_step
    from mpc_planner_tpu_torch.parallel.mesh import shard_batch
    from mpc_planner_tpu_torch.solver.sqp import SQPSolver

    cfg = _solver_config(N, 1)
    model, modules = presets.configuration_safe_horizon(cfg)
    ocp, Z0, P, xinit = presets.preset_problem(cfg, model, modules)
    solver = SQPSolver(ocp, device=mesh.device)
    B, M, dev = mesh.world_size, cfg.max_obstacles, mesh.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((B, n_samples, M, N - 1, 2), generator=gen, device=dev)
    p_ws = torch.as_tensor(Z0[1:N][:, [model.index("x"), model.index("y")]], dtype=torch.float32,
                           device=dev)
    hs = _device_scenario_halfspaces(
        noise, torch.full((M, N - 1, 2), 50.0, device=dev), torch.zeros(M, N - 1, device=dev),
        torch.full((M, N - 1), 0.3, device=dev), torch.full((M, N - 1), 0.3, device=dev),
        torch.full((M,), 0.4, device=dev), p_ws, cfg.robot_radius)
    a1, a2, b, _ = _select_tightest(*hs, n_constraints=cfg.scenario_constraints.n_constraints)
    Pb = torch.as_tensor(np.tile(P[None], (B, 1, 1)), dtype=torch.float32, device=dev)
    for name, val in (("scenario_a1", a1), ("scenario_a2", a2), ("scenario_b", b)):
        idxs = torch.as_tensor(ocp.params.bundle_indices(name), device=dev)
        Pb[:, 1:N, idxs] = val.repeat(1, 1, cfg.n_discs)
    Pb[:, N] = Pb[:, N - 1]
    # every solver from the same warm start, as the reference's rung: the
    # draws make the solvers differ
    Zb, xb = (np.tile(a[None], (B,) + (1,) * a.ndim).astype(np.float32) for a in (Z0, xinit))
    Zb, Pb, xb, ones = shard_batch(mesh, (Zb, Pb, xb, np.ones(B, np.float32)))
    Zw, idx, found, _ = distributed_solve_step(solver, mesh, 1)(Zb, Pb, xb, ones)
    return dict(N=N, nvar=model.nvar, nh=ocp.nh, B=B, idx=[int(idx)], found=[bool(found)],
                Z=Zw.cpu().numpy().tolist())


def dryrun_multirank(device=None, rungs: Sequence[str] = RUNGS, seed: int = 0) -> List[Dict]:
    """Run `rungs` over the current process group (or this process alone)
    on `device` (None: the card). Every rank returns the same winners."""
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.parallel.mesh import batch_mesh

    mesh = batch_mesh(device)
    out = []
    for rung in rungs:
        t0 = time.perf_counter()
        if rung.startswith("flagship_N"):
            horizon, _, cold = rung[len("flagship_N"):].partition("_")
            rec = flagship_rung(mesh, int(horizon), chain=cold != "cold", seed=seed)
        elif rung == "scenario":
            rec = scenario_rung(mesh, seed=seed)
        elif rung == "bicycle":
            # two RTI iterations: from the perturbed starts one leaves the
            # bicycle's dynamics defects above tol_eq_residual
            rec = flagship_rung(mesh, 20, chain=False, seed=seed,
                                make_config=presets.configuration_bicycle, iterations=2)
        else:
            raise ValueError(f"unknown rung {rung!r} (one of {RUNGS} or flagship_N<horizon>[_cold])")
        if not all(rec["found"]):
            raise RuntimeError(f"rung {rung}: no feasible planner in a cycle: {rec}")
        out.append(dict(rung=rung, rank=mesh.rank, world_size=mesh.world_size,
                        seconds=time.perf_counter() - t0, **rec))
    return out


def run_ranks(world_size: int, rungs: Sequence[str] = RUNGS, timeout: float = 600.0,
              seed: int = 0) -> List[List[Dict]]:
    """Start `world_size` CPU ranks (gloo, a file rendezvous in a temporary
    directory, one torch thread each), run `rungs` on each, and return
    each rank's records. Raises if a rank fails or the time limit passes;
    every process is ended before it returns."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mpc_planner_tpu_torch.parallel.dryrun", "--init-method", init,
             "--world-size", str(world_size), "--rank", str(r), "--device", "cpu",
             "--rungs", ",".join(rungs), "--seed", str(seed)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=root)
            for r in range(world_size)]
        deadline = time.monotonic() + timeout
        results = []
        try:
            for r, p in enumerate(procs):
                out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} exited {p.returncode}:\n{out}\n{err}")
                results.append([json.loads(line) for line in out.splitlines()
                                if line.startswith("{")])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init-method", default=None,
                    help="tcp://host:port or file:///path (default: torch's environment variables)")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--rungs", default=",".join(RUNGS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    import torch.distributed as dist

    from mpc_planner_tpu_torch.parallel.distributed import initialize_distributed

    initialize_distributed(args.init_method, args.world_size, args.rank, device=args.device)
    try:
        for rec in dryrun_multirank(args.device, args.rungs.split(","), seed=args.seed):
            print(json.dumps(rec), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
