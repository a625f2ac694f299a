"""The port's measuring programs (mpc_planner_tpu_torch/bench.py and
experiments/ladder_bench.py) against the reference's bench.py,
__graft_entry__.py::entry and experiments/ladder_bench.py, on the CPU.

- The ladder: the same 11 rungs in the same order, and for each rung the
  same OCP sizes and the same instance (Z0, P, xinit bit-equal: the host
  passes run the same float64 numpy arithmetic); its numpy helpers
  bit-equal; a row has the reference's keys.
- The bench: its JSON keys, K3's operation count per solve, the reference's
  analytic count, and `entry` bit-equal to the solver it wraps.

The rungs' solves against the reference are in test_torch_ladder_solves*.py.
"""

import numpy as np
import pytest
import torch

from torch_port_cases import reference_program

CPU = torch.device("cpu")
RUNGS = ("goal", "mpcc", "ellipsoid", "cc-static", "tmpc", "shmpc", "shmpc-slack", "tmpc-n30",
         "ca-mpc", "bicycle", "bicycle-ca")
ROW_KEYS = {"rung", "nvar", "nh", "batch_ms_mean", "batch_ms_p99", "solves_per_sec", "feasible",
            "compile_s"}  # the reference's row (experiments/ladder_bench.py:267-276)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "flops_per_solve", "pct_of_bound"}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_ladder():
    return reference_program("experiments/ladder_bench.py", "reference_ladder_bench")


def test_the_same_rungs_in_the_same_order(ref_ladder):
    from mpc_planner_tpu_torch.experiments import ladder_bench

    assert [r[0] for r in ladder_bench.make_rungs()] == [r[0] for r in ref_ladder.make_rungs()]
    assert [r[0] for r in ladder_bench.make_rungs()] == list(RUNGS)


def test_ladder_scenes_are_bit_equal(ref_ladder):
    from mpc_planner_tpu.utils.config import default_config as jax_config
    from mpc_planner_tpu_torch.experiments import ladder_bench
    from mpc_planner_tpu_torch.utils.config import default_config

    (grid, meta), (ref_grid, ref_meta) = ladder_bench.corridor_costmap(), ref_ladder.corridor_costmap()
    assert np.array_equal(grid, ref_grid) and grid.dtype == ref_grid.dtype and meta == ref_meta
    state, data = ladder_bench._curved_scene(default_config(N=20), 8)
    ref_state, ref_data = ref_ladder._curved_scene(jax_config(N=20), 8)
    assert np.array_equal(state.as_array(), ref_state.as_array())
    for k in ("x", "y"):
        assert np.array_equal(data.reference_path[k], ref_data.reference_path[k])
    ours = [(o.index, o.position, o.prediction.positions) for o in data.dynamic_obstacles]
    ref = [(o.index, o.position, o.prediction.positions) for o in ref_data.dynamic_obstacles]
    assert len(ours) == len(ref) and sum(o[0] >= 0 for o in ours) == 8
    for (i, p, pred), (ri, rp, rpred) in zip(ours, ref):
        assert i == ri and np.array_equal(p, rp) and np.array_equal(pred, rpred)


@pytest.mark.parametrize("name", RUNGS)
def test_rung_builds_the_reference_instance(ref_ladder, name):
    """build_solver of both packages on the rung: the same (nvar, nh, npar)
    and the same Z0, P and xinit."""
    from mpc_planner_tpu_torch.experiments import ladder_bench
    from mpc_planner_tpu_torch.experiments.common import build_solver

    rung = next(r for r in ladder_bench.make_rungs() if r[0] == name)
    ref_rung = next(r for r in ref_ladder.make_rungs() if r[0] == name)
    solver, Z0, P, xinit = build_solver(*rung[1:], CPU)
    ref_solver, rZ0, rP, rxinit = ref_ladder.build_solver(*ref_rung[1:])
    sizes = lambda o: (o.nvar, o.nh, o.npar)  # noqa: E731
    assert sizes(solver.ocp) == sizes(ref_solver.ocp)
    for ours, ref in ((Z0, rZ0), (P, rP), (xinit, rxinit)):
        ref = np.asarray(ref)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


def test_run_rung_row_has_the_reference_keys(capsys):
    import json

    from mpc_planner_tpu_torch.experiments import ladder_bench

    row = ladder_bench.run_rung("goal", batch=4, rti=2, cycles=2, reps=2, device="cpu")
    assert set(row) == ROW_KEYS
    assert row["rung"] == "goal" and (row["nvar"], row["nh"]) == (6, 0)
    assert row["feasible"].endswith("/4") and row["batch_ms_mean"] > 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == row


def test_ladder_main_keeps_the_cli(capsys, monkeypatch):
    import json

    from mpc_planner_tpu_torch.experiments import ladder_bench

    monkeypatch.setenv("LADDER_RUNGS", "goal")
    monkeypatch.setattr(ladder_bench, "REPS", 1)
    monkeypatch.setattr(ladder_bench, "CYCLES", 1)
    ladder_bench.main(["3", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[0])["rung"] == "goal" and json.loads(lines[0])["feasible"].endswith("/3")
    assert "| rung | nh | mean ms (B=3) | p99 ms | solves/s/cpu | feasible |" in lines
    assert lines[-1].startswith("| goal | 0 |")


# -- the bench ------------------------------------------------------------------------------
def test_bench_run_keys_and_operation_count():
    from mpc_planner_tpu_torch import bench
    from mpc_planner_tpu_torch.ops.cuda_rti import warm_work

    out = bench.run(batch=4, cycles=2, reps=2, rti=2, device="cpu")
    assert set(out) == BENCH_KEYS
    assert out["metric"] == "tmpc_solves_per_sec_cpu"  # a CPU run is not named a GPU metric
    assert out["unit"] == "solves/s" and out["value"] > 0 and out["pct_of_bound"] is None
    assert out["vs_baseline"] == round(out["value"] / 150.0, 2)
    _, _, solver, _, _, _ = bench._build(CPU)
    assert out["flops_per_solve"] == round(warm_work(solver, 2)[0])


def test_bench_analytic_count_is_the_reference():
    from __graft_entry__ import _build as jax_build
    from mpc_planner_tpu.utils.config import default_config as jax_config
    from mpc_planner_tpu_torch import bench

    ref_bench = reference_program("bench.py", "reference_bench")
    jcfg = jax_config(N=20)
    _, jocp, _, _, _, _ = jax_build(jcfg)
    cfg, _, solver, _, _, _ = bench._build(CPU)
    assert bench._kernel_flops_per_solve(solver.ocp, cfg) == ref_bench._kernel_flops_per_solve(
        jocp, jcfg)
    assert bench.BASELINE_SOLVES_PER_SEC == ref_bench.BASELINE_SOLVES_PER_SEC
    assert (bench.BATCH, bench.REPS, bench.CYCLES, bench.RTI_ITERATIONS) == (
        ref_bench.BATCH, ref_bench.REPS, ref_bench.CYCLES, ref_bench.RTI_ITERATIONS)


def test_entry_is_the_solver_at_two_iterations():
    from mpc_planner_tpu_torch import bench

    fn, args = bench.entry(device="cpu")
    assert [a.dtype for a in args] == [torch.float32] * 3 and args[0].device == CPU
    out = fn(*args)
    _, _, solver, _, _, _ = bench._build(CPU)
    want = solver.batch_impl(args[0][None], args[1][None], args[2][None], 2)
    for got, ref in zip(out, want):
        assert torch.equal(got, ref[0])
    assert out.Z.shape == args[0].shape and bool(torch.isfinite(out.Z).all())
