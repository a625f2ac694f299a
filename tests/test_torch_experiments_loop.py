"""The port's closed-loop experiments (mpc_planner_tpu_torch/
experiments: corridor_benchmark, verify_prm_drive, guidance_ab) held to the
reference's experiments of the same name under experiments/.

Each comparison runs the reference experiment with `--cpu` and the port's with
`--device cpu` as subprocesses on the same small arguments, one torch or
XLA thread each, and compares their JSON rows:
  * corridor_benchmark (`--config basic --peds 4 --seeds 1 --horizon 10
    --max-steps 15 --json`): completed, collisions and infeasible equal,
    duration_mean within one control period cfg.dt;
  * guidance_ab (`--scenes 2 --peds 6`): classes_per_scene and
    collision_free_frac of the lateral and prm rows equal (both backends run
    on the host and draw what the reference draws); the sampled row has run
    and found a class (jax.random and torch generators differ).
The reference's native prm_search reads the running winding through a
pointer that push_back can move (the port's copy of geometry.cpp reads it
by index), so its PRM classes change from process to process; its experiment
runs here on its numpy fallback, which has the same contract.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")

# The reference's guidance_ab experiment with its native geometry library off.
JAX_NUMPY_FALLBACK = (
    "import runpy, sys; import mpc_planner_tpu.native as native; "
    "native._build_error = 'off'; "
    "runpy.run_path('experiments/guidance_ab.py', run_name='__main__')")


def _start(argv):
    return subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=ENV, cwd=ROOT)


def _json_rows(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out + err
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def _both(jax_argv, port_module, args):
    """Both experiments' JSON rows, run side by side."""
    jax_proc = _start([sys.executable, *jax_argv, *args])
    port_proc = _start([sys.executable, "-m", f"mpc_planner_tpu_torch.experiments.{port_module}",
                        "--device", "cpu", *args])
    return _json_rows(jax_proc), _json_rows(port_proc)


def test_corridor_benchmark_row_matches_the_reference():
    from mpc_planner_tpu_torch.utils.config import default_config

    args = ["--config", "basic", "--peds", "4", "--seeds", "1", "--horizon", "10",
            "--max-steps", "15", "--json"]
    (ref,), (port,) = _both(["experiments/corridor_benchmark.py", "--cpu"], "corridor_benchmark",
                            args)
    assert set(port) == set(ref)
    for key in ("config", "backend", "peds", "B", "seeds", "scenario_certificate"):
        assert port[key] == ref[key], key
    for key in ("completed", "collisions", "infeasible"):  # equal
        assert port[key] == ref[key], (key, port, ref)
    dt = default_config(N=10).dt
    assert abs(port["duration_mean"] - ref["duration_mean"]) <= dt  # within one control period


def _reference_make_peds():
    """The reference experiment's own make_peds (a closure in its main), compiled
    from its source."""
    with open(os.path.join(ROOT, "experiments", "corridor_benchmark.py")) as f:
        tree = ast.parse(f.read())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "make_peds")
    from mpc_planner_tpu_torch.sim import Pedestrian

    namespace = {"np": np, "Pedestrian": Pedestrian}
    exec(compile(ast.Module(body=[node], type_ignores=[]), "corridor_benchmark.py", "exec"),
         namespace)
    return namespace["make_peds"]


@pytest.mark.parametrize("n,seed", [(4, 0), (8, 1), (12, 2)])
def test_make_peds_draws_the_reference_pedestrians(n, seed):
    from mpc_planner_tpu_torch.experiments.corridor_benchmark import make_peds

    ours, ref = make_peds(n, seed), _reference_make_peds()(n, seed)
    assert len(ours) == len(ref) == n
    for a, b in zip(ours, ref):  # bit for bit
        assert np.array_equal(a.position, b.position) and np.array_equal(a.velocity, b.velocity)
        assert a.radius == b.radius and len(a.waypoints) == len(b.waypoints) == 2
        assert all(np.array_equal(u, v) for u, v in zip(a.waypoints, b.waypoints))


def test_corridor_run_row_wires_the_overrides(capsys):
    """run_row on the CPU: the overrides reach the planner (3 homotopy
    planners per class + the free one), the row has the reference's keys."""
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.experiments import corridor_benchmark as cb

    torch.set_num_threads(1)
    cfg = cb.build_config(horizon=8, samples_per_class=3, qp_warm_iterations=3)
    assert cfg.t_mpc.samples_per_class == 3 and cfg.solver.qp_warm_iterations == 3
    row = cb.run_row(presets.configuration_tmpc, cfg, 4, 1, 3, torch.device("cpu"),
                     label="T-MPC++", json_line=True)
    assert row["B"] == cfg.t_mpc.n_paths * 3 + 1 and row["seeds"] == 1
    out = capsys.readouterr().out
    assert out.startswith("| T-MPC++ | 4 | 13 | ") and json.loads(out.splitlines()[-1]) == row


def test_verify_prm_drive_runs_the_prm_backend():
    from mpc_planner_tpu_torch.experiments import verify_prm_drive
    from mpc_planner_tpu_torch.guidance import VisibilityPRMPlanner

    torch.set_num_threads(1)
    result, guidance, _ = verify_prm_drive.drive(torch.device("cpu"), max_steps=4)
    assert isinstance(guidance, VisibilityPRMPlanner)
    assert result.steps == 4 and result.collisions == 0 and result.infeasible_cycles == 0
    assert result.trajectory[-1][0] > 0.0  # moved up the corridor


def test_guidance_ab_rows_match_the_reference():
    ref, port = _both(["-c", JAX_NUMPY_FALLBACK, "--cpu"], "guidance_ab",
                      ["--scenes", "2", "--peds", "6"])
    ref, port = ({r["backend"]: r for r in rows} for rows in (ref, port))
    assert list(port) == list(ref) == ["lateral", "prm", "sampled"]
    for backend in ("lateral", "prm"):  # host backends: equal
        for key in ("classes_per_scene", "collision_free_frac"):
            assert port[backend][key] == ref[backend][key], (backend, key, port, ref)
    assert port["sampled"]["classes_per_scene"] >= 1.0  # ran, found a class


@pytest.mark.parametrize("name", ["corridor_benchmark", "verify_prm_drive", "guidance_ab"])
def test_experiment_takes_the_card_by_default(name):
    """Without CUDA and without --device cpu the experiment raises before any
    work; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    module = __import__(f"mpc_planner_tpu_torch.experiments.{name}", fromlist=["main"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])


def _flags(path):
    """The option strings an experiment's argparse knows, from its source."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return {a.value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument"
            for a in n.args if isinstance(a, ast.Constant) and a.value.startswith("--")}


@pytest.mark.parametrize("name", ["corridor_benchmark", "guidance_ab"])
def test_experiment_keeps_the_reference_flags(name):
    """Every flag of the reference experiment, `--cpu` becoming `--device`."""
    ref = _flags(os.path.join(ROOT, "experiments", f"{name}.py"))
    ours = _flags(os.path.join(ROOT, "mpc_planner_tpu_torch", "experiments", f"{name}.py"))
    ours |= {"--device"}  # common.device_parser
    assert "--cpu" in ref and (ref - {"--cpu"}) <= ours


def test_shmpc_route_compares_the_two_routes():
    """shmpc_route on the CPU: both routes are the plain solver there, so the
    two closed loops are the same run."""
    from mpc_planner_tpu_torch.experiments import shmpc_route

    torch.set_num_threads(1)
    runs, summary = shmpc_route.compare(peds=4, seed=0, max_steps=2, device=torch.device("cpu"))
    assert set(runs) == {"default", "unfused"} and summary["steps_compared"] == 2
    assert summary["max_gap_m"] == 0.0 and summary["same_outcome"]
