"""Port vs reference, on the CPU: the batch split over ranks
(mpc_planner_tpu_torch/parallel), mirroring tests/test_parallel.py and
tests/test_multihost.py.

* `argmin_objective` and `global_argmin`, with ties and infeasible rows:
  the same index and found flag as the reference's, in one process and
  over 2 and 3 gloo ranks (each rank a subprocess holding its own rows).
* The single-process path (no process group): `batch_mesh`,
  `shard_batch`, `host_shard_slice` and a `sharded_solve_fn` solve held to
  the reference's on its 8-device virtual mesh (5e-3).
* `distributed_solve_step` over 2 and 4 gloo ranks (the dry run's
  flagship rung at N=10: two warm-chained cycles, carried duals, the
  consistency bonus on the winner) against the reference's
  `distributed_solve_step` on a 2- and a 4-device virtual mesh: the same
  winner and found flag in both cycles, the winner's Z within 5e-3.
* The dry run's four rungs (nvar=9 included) over 2 ranks: every cycle
  finds a planner and every rank reports the same winners.
Rank processes import no JAX; each has a file rendezvous of its own and a
time limit.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_planner_tpu.parallel import distributed as jax_distributed
from mpc_planner_tpu.parallel import mesh as jax_mesh
from mpc_planner_tpu_torch.parallel import (
    argmin_objective,
    batch_mesh,
    global_argmin,
    global_batch_size,
    host_shard_slice,
    shard_batch,
    sharded_solve_fn,
)
from mpc_planner_tpu_torch.parallel.dryrun import RUNGS, _perturbed_batch, run_ranks

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600

# pobj / feasible rows: the minimum tied across the ranks' boundaries (rows
# 2, 3, 5), an infeasible row
POBJ = np.array([5.0, 3.0, 2.0, 2.0, 4.0, 2.0], np.float32)
FEAS = np.array([True, True, True, True, False, True])


def test_argmin_objective_selection():
    """tests/test_parallel.py's cases, and a tie: the same answers."""
    cases = [(POBJ, FEAS, {}), (POBJ, FEAS, dict(consistency_weight=0.5, previous_selected=4)),
             (POBJ, FEAS, dict(consistency_weight=0.5, previous_selected=5)),
             (POBJ, np.zeros(6, bool), {}), (np.full(6, 2.0, np.float32), FEAS, {})]
    for pobj, feas, kw in cases:
        ref = jax_mesh.argmin_objective(jnp.asarray(pobj), jnp.asarray(feas), **kw)
        out = argmin_objective(torch.as_tensor(pobj), torch.as_tensor(feas), **kw)
        assert (int(out[0]), bool(out[1])) == (int(ref[0]), bool(ref[1]))
    # the first of the tied minima 2.0 (rows 2, 3, 5); the infeasible
    # row 4 cannot win through the bonus; row 5 can
    assert int(argmin_objective(torch.as_tensor(POBJ), torch.as_tensor(FEAS))[0]) == 2
    assert int(argmin_objective(torch.as_tensor(POBJ), torch.as_tensor(FEAS), 0.5, 4)[0]) == 2
    assert int(argmin_objective(torch.as_tensor(POBJ), torch.as_tensor(FEAS), 0.5, 5)[0]) == 5
    assert int(global_argmin(torch.as_tensor(POBJ), torch.as_tensor(FEAS))[0]) == 2


ARGMIN_SCRIPT = """
import json, sys
import numpy as np, torch
from mpc_planner_tpu_torch.parallel import batch_mesh, global_argmin, host_shard_slice
from mpc_planner_tpu_torch.parallel import initialize_distributed
init, world, rank, pobj, feas = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
initialize_distributed(init, world, rank, device="cpu")
pobj, feas = np.array(json.loads(pobj), np.float32), np.array(json.loads(feas), bool)
sl = host_shard_slice(len(pobj))
idx, found = global_argmin(torch.as_tensor(pobj[sl]), torch.as_tensor(feas[sl]), batch_mesh("cpu"))
print(json.dumps([int(idx), bool(found)]), flush=True)
assert "jax" not in sys.modules
torch.distributed.destroy_process_group()
"""


def _ranks(script, world, tmp_path, *args):
    init = "file://" + str(tmp_path / "rendezvous")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", script, init, str(world), str(r), *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                              cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, out + err
            outs.append(json.loads(out.splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", ["tie", "infeasible_min", "none_feasible"])
def test_global_argmin_over_ranks(world, case, tmp_path):
    pobj, feas = {"tie": (POBJ, FEAS), "infeasible_min": (POBJ, POBJ > 2.0),
                  "none_feasible": (POBJ, np.zeros(6, bool))}[case]
    ref = jax_distributed.global_argmin(jnp.asarray(pobj), jnp.asarray(feas))
    outs = _ranks(ARGMIN_SCRIPT, world, tmp_path, json.dumps(pobj.tolist()),
                  json.dumps(feas.tolist()))
    assert outs == [[int(ref[0]), bool(ref[1])]] * world


def test_single_process_split_and_solve():
    """No process group: this process holds the whole batch; a split solve
    of 8 identical goal problems equals the reference's on its 8-device
    mesh (5e-3) and is the same on every row."""
    from mpc_planner_tpu.solver import SQPSolver as JaxSolver
    from mpc_planner_tpu.solver.ocp import OCP as JaxOCP
    from mpc_planner_tpu_torch.solver.ocp import OCP
    from mpc_planner_tpu_torch.solver.sqp import SQPSolver
    from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
    from torch_port_cases import jackal_goal_pair, parameter_blocks

    mesh = batch_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    assert global_batch_size(16) == 16 and host_shard_slice(16) == slice(0, 16)
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    np.testing.assert_array_equal(shard_batch(mesh, (x,))[0].numpy(), x)

    js, ts = jackal_goal_pair(n_pedestrians=2)
    jocp, tocp = JaxOCP(js.model, js.modules, js.cfg), OCP(ts.model, ts.modules, ts.cfg)
    Pj, Pt = parameter_blocks(js, ts, jocp.params, tocp.params)
    np.testing.assert_array_equal(Pj, Pt)
    Z0 = initialize_with_state(ts.model, ts.cfg.N, ts.state)
    B = 8
    batch = (np.tile(Z0[None], (B, 1, 1)).astype(np.float32), np.tile(Pt[None], (B, 1, 1)).astype(np.float32),
             np.tile(ts.state.as_array()[None], (B, 1)).astype(np.float32))
    res = sharded_solve_fn(SQPSolver(tocp, device="cpu"), mesh, 2)(*shard_batch(mesh, batch))
    jm = jax_mesh.batch_mesh()
    ref = jax_mesh.sharded_solve_fn(JaxSolver(jocp), jm, num_iterations=2)(*jax_mesh.shard_batch(jm, batch))
    Z = res.Z.numpy()
    assert np.all(res.exit_code.numpy() == 1) and np.all(np.asarray(ref.exit_code) == 1)
    np.testing.assert_allclose(Z[0], Z[-1], atol=1e-5)
    np.testing.assert_allclose(Z, np.asarray(ref.Z), atol=5e-3)


def _jax_flagship_rung(world, N, seed=0):
    """The dry run's flagship rung on the reference: the same rows through
    its distributed_solve_step on a `world`-device virtual mesh."""
    from __graft_entry__ import _build
    from mpc_planner_tpu.utils.config import default_config

    cfg = default_config(N=N)
    cfg = cfg.replace(solver=cfg.solver.__class__(iterations=2, qp_iterations=6))
    model, ocp, solver, Z0, P, xinit = _build(cfg)
    B = 2 * world
    mesh = jax_mesh.batch_mesh(jax.devices()[:world])
    Zb, Pb, xb = _perturbed_batch(Z0, P, xinit, B, model.nu, seed, ocp.params.save_map()["velocity"])
    Zb, Pb, xb, ones = jax_mesh.shard_batch(mesh, (Zb, Pb, xb, np.ones(B, np.float32)))
    Zw, idx, found, res = jax_distributed.distributed_solve_step(solver, mesh, 2)(Zb, Pb, xb, ones)
    Zshift = np.asarray(jnp.concatenate([Zw[1:], Zw[-1:]]), np.float32)
    Z2, cons = jax_mesh.shard_batch(mesh, (np.tile(Zshift[None], (B, 1, 1)),
                                           np.where(np.arange(B) == int(idx), 0.9, 1.0).astype(np.float32)))
    warm = jax_distributed.distributed_solve_step(solver, mesh, 2, warm=True)
    Zw2, idx2, found2, _ = warm(Z2, Pb, xb, cons, res.lam_l, res.lam_u, res.exit_code == 1)
    return [int(idx), int(idx2)], [bool(found), bool(found2)], np.asarray(Zw2)


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_step_matches_reference(world):
    with ThreadPoolExecutor(1) as pool:  # the ranks run while the reference compiles
        ranks = pool.submit(run_ranks, world, rungs=("flagship_N10",), timeout=TIMEOUT)
        idx, found, Z = _jax_flagship_rung(world, N=10)
        ranks = ranks.result()
    for (rec,) in ranks:
        assert (rec["world_size"], rec["B"], rec["nh"]) == (world, 2 * world, 24)
        assert rec["idx"] == idx and rec["found"] == found == [True, True]
        np.testing.assert_allclose(np.asarray(rec["Z"]), Z, atol=5e-3)
        assert rec["Z"] == ranks[0][0]["Z"]  # the broadcast winner, on every rank


def test_dryrun_rungs_over_two_ranks():
    ranks = run_ranks(2, timeout=TIMEOUT)
    assert [r["rung"] for r in ranks[0]] == list(RUNGS)
    by_rung = {r["rung"]: r for r in ranks[0]}
    assert by_rung["bicycle"]["nvar"] == 9 and by_rung["scenario"]["B"] == 2
    assert len(by_rung["flagship_N20"]["idx"]) == 2
    assert by_rung["flagship_N30_cold"]["N"] == 30 and len(by_rung["flagship_N30_cold"]["idx"]) == 1
    for rec in ranks[0]:
        assert all(rec["found"]) and np.isfinite(rec["Z"]).all()
    for a, b in zip(ranks[0], ranks[1]):
        assert (a["idx"], a["found"], a["Z"]) == (b["idx"], b["found"], b["Z"])
