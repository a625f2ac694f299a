"""The port's sweep experiments (mpc_planner_tpu_torch/experiments:
horizon_sweep, batch_sweep, n30_latency, profile_solve, fused_rti_check,
scaling_sweep, nvar8_stress) on the CPU at tiny sizes (B <= 8, N = 10,
2 RTI iterations, 2 gloo ranks): each prints its rows, and what it times is
the solver's own result on the same inputs, bit-equal on the CPU.

horizon_sweep is held to the reference experiment: its make_qp draws the same
QPs from a seed (bit-equal), and the port's sequential and scan solves
agree with the reference's solve_qp on them to 5e-3 relative (the
reference's kernel-vs-XLA tolerance, tests/test_pallas_qp.py:70).
"""

import ast
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_planner_tpu_torch.experiments.common import perturbed_batch, warm_carry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
REL = 5e-3


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_experiment(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "experiments", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


# -- horizon_sweep ------------------------------------------------------------------------
def test_horizon_sweep_draws_the_reference_qps():
    from mpc_planner_tpu_torch.experiments.horizon_sweep import make_qp

    ref, _, _ = _reference_experiment("horizon_sweep").make_qp(np.random.default_rng(0), 3, 10)
    ours, nu, nx = make_qp(np.random.default_rng(0), 3, 10)
    assert (nu, nx) == (2, 5)
    for field in ref._fields:  # bit for bit
        assert np.array_equal(getattr(ours, field).numpy(), np.asarray(getattr(ref, field))), field


@pytest.mark.parametrize("N", [10, 20])
def test_horizon_sweep_routes_match_the_reference(N):
    from mpc_planner_tpu.solver.qp import solve_qp as jax_solve_qp
    from mpc_planner_tpu_torch.experiments.horizon_sweep import make_qp, solver_of

    ref_qp, nu, nx = _reference_experiment("horizon_sweep").make_qp(np.random.default_rng(N), 4, N)
    qp, _, _ = make_qp(np.random.default_rng(N), 4, N)
    for route, hp in (("seq", False), ("par", True)):
        with jax.default_matmul_precision("highest"):
            ref = jax.vmap(lambda e: jax_solve_qp(e, nu, nx, iterations=8, horizon_parallel=hp))(
                ref_qp).dz
        ours = solver_of(route, nu, nx, 8)(qp)
        assert _rel(ours.numpy(), jnp.asarray(ref)) < REL, route  # 5e-3 relative


def test_horizon_sweep_prints_its_rows(capsys):
    from mpc_planner_tpu_torch.experiments import horizon_sweep

    rows = horizon_sweep.sweep([10, 12], 2, 2, CPU)
    assert [r[0] for r in rows] == [10, 12] and all(r[1] > 0 and r[2] > 0 for r in rows)
    assert all(r[3] is None for r in rows)  # K1 runs on the card only
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].split() == ["N", "seq", "ms", "par", "ms", "par/seq", "K1", "ms"]
    assert [line.split()[0] for line in lines[2:]] == ["10", "12"]


# -- batch_sweep, n30_latency: the timed chain is the solver's chain -----------------------
def _flagship(N=10):
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.solver.sqp import SQPSolver
    from mpc_planner_tpu_torch.utils.config import default_config

    model, ocp, Z0, P, xinit = presets.flagship_problem(default_config(N=N))
    return model, SQPSolver(ocp, device=CPU), Z0, P, xinit


def _solver_chain(solver, warm0, Pb, xb, rti, cycles):
    """The chain of warm cycles, each a solve_batch with the last cycle's duals."""
    carry = warm0
    for _ in range(cycles):
        carry = warm_carry(solver.solve_batch(carry[0], Pb, xb, num_iterations=rti,
                                              warm_duals=carry[1:]))
    return carry


def test_batch_sweep_rows_and_its_timed_chain(capsys):
    from mpc_planner_tpu_torch.experiments import batch_sweep

    rows, (out, warm0, Pb, xb) = batch_sweep.sweep((4, 8), rti=2, cycles=2, reps=1, device=CPU,
                                                   N=10)
    assert [r[0] for r in rows] == [4, 8] and all(r[1] > 0 and r[3] > 0 for r in rows)
    table = [line for line in capsys.readouterr().out.splitlines() if line.startswith("| ")]
    assert table[0] == "| B | mean ms | p99 ms | solves/s/chip | K3 blocks |"
    assert [line.split()[1] for line in table[1:]] == ["4", "8"]
    # what it timed: warm cycles of the same solver on the same inputs
    _, solver, _, _, _ = _flagship()
    expect = _solver_chain(solver, warm0, Pb, xb, 2, 2)
    for got, want in zip(out[0], expect):
        assert torch.equal(got, want)


def test_n30_latency_rows_and_its_timed_chain(capsys):
    from mpc_planner_tpu_torch.experiments import n30_latency

    rows = n30_latency.latency_rows((4,), (6, 4), horizon=10, rti=2, cycles=2, reps=1, device=CPU)
    keys = {"B", "warm_iters", "mean_ms", "p99_ms", "solves_per_sec", "feasible_cold",
            "feasible_steady", "max_dz_vs_first"}  # the reference's JSON keys
    assert [(r["B"], r["warm_iters"]) for r in rows] == [(4, 6), (4, 4)]
    assert all(set(r) == keys for r in rows) and rows[0]["max_dz_vs_first"] == 0.0
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == rows

    model, solver, Z0, P, xinit = _flagship()
    Z0b, Pb, xb = perturbed_batch(np.random.default_rng(0), Z0, P, xinit, 4, model.nu, CPU)
    _, feas0, _, Z_final = n30_latency.run_chain(solver, Z0b, Pb, xb, 2, 2, 1, CPU)
    res = solver.solve_batch(Z0b, Pb, xb, num_iterations=2)
    assert feas0 == int((res.exit_code == 1).sum())
    assert np.array_equal(Z_final, _solver_chain(solver, warm_carry(res), Pb, xb, 2, 2)[0].numpy())


# -- profile_solve, fused_rti_check, nvar8_stress -----------------------------------------
def test_profile_solve_breakdown(capsys):
    from mpc_planner_tpu_torch.experiments import profile_solve

    rows = profile_solve.breakdown(4, rti=2, chain=1, reps=1, device=CPU, N=10)
    assert set(rows) == {"full", "linearize", "mirror", "qp cold, MIRROR inside", "qp cold",
                         "qp warm, MIRROR inside", "qp warm", "sum of parts"}
    assert all(np.isfinite(v) and v > 0 for v in rows.values())
    out = capsys.readouterr().out
    assert "full warm cycle (2 RTI)" in out and "sum of parts estimate" in out


def test_fused_rti_check_agrees_and_times_every_route(capsys):
    from mpc_planner_tpu_torch.experiments import fused_rti_check

    rows, times = fused_rti_check.check(4, rti=2, device=CPU, N=10, reps=(1, 1, 1))
    assert [r["label"] for r in rows] == ["cold: fused vs unfused", "cold: fused vs plain",
                                          "warm: fused vs unfused", "warm: fused vs plain"]
    assert all(r["ok"] for r in rows), rows  # Z 5e-3 relative, exit codes within 1%
    assert set(times) == {"fused", "unfused", "plain", "fused B=1", "unfused B=1"}
    assert "fused KKT:" in capsys.readouterr().out


def test_fused_route_on_the_cpu_is_k3s_plain_version():
    """route_solver("fused") on the CPU runs solve_rti_cuda's plain version:
    the same result as ops/rti.py::solve_rti_torch called directly."""
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.experiments.common import route_solver
    from mpc_planner_tpu_torch.ops.rti import solve_rti_torch
    from mpc_planner_tpu_torch.utils.config import default_config

    cfg = default_config(N=10)
    model, modules = presets.configuration_tmpc(cfg)
    _, Z0, P, xinit = presets.preset_problem(cfg, model, modules, 8, 0)
    s = route_solver(model, modules, cfg, "fused", CPU)
    assert s.rti_fused and s.qp_backend == "torch"
    Zb, Pb, xb = perturbed_batch(np.random.default_rng(0), Z0, P, xinit, 3, model.nu, CPU)
    res = s.batch_impl(Zb, Pb, xb, 2)
    Zx = Zb.clone()
    Zx[:, 0, model.nu:] = xb
    ref = solve_rti_torch(Zx, Pb, s.ocp, lb_template=s._lb_template, ub_template=s._ub_template,
                          num_iterations=2, it0=s.qp_iterations, warm_iters=s.warm_qp_iters,
                          mu0=s.mu0, mehrotra=True, sigma_fixed=s.warm_sigma, lm=s.lm,
                          mirror_x_only=s._mirror_x_only)
    assert torch.equal(res.Z, ref.Z)


def test_nvar8_stress_passes_on_the_plain_versions():
    from mpc_planner_tpu_torch.experiments import nvar8_stress

    status, line, Z = nvar8_stress.stress(4, 2, CPU, N=10)
    assert status == "PASS" and line.startswith("PASS: max|Z_fused - Z_plain| = ")
    assert Z.shape == (4, 11, 8) and np.isfinite(Z).all()  # the slack model: nvar = 8
    assert nvar8_stress.stress(4, 2, CPU, N=10)[1] == line  # the same digest again


# -- scaling_sweep: two gloo ranks ----------------------------------------------------------
def test_scaling_sweep_two_gloo_ranks(capsys):
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.parallel import argmin_objective
    from mpc_planner_tpu_torch.experiments import scaling_sweep
    from mpc_planner_tpu_torch.solver.sqp import SQPSolver
    from mpc_planner_tpu_torch.utils.config import default_config

    rows = scaling_sweep.sweep([1, 2], "cpu", per_device=2, rti=2, reps=1, N=10)
    assert [(r["devices"], r["B"]) for r in rows] == [(1, 2), (2, 4)]
    assert rows[0]["efficiency"] == 1.0 and all(r["found"] for r in rows)
    assert "| devices | B | ms/step |" in capsys.readouterr().out

    # the step's winner: the solver's rows over the whole batch, the argmin
    model, ocp, Z0, P, xinit = presets.flagship_problem(default_config(N=10))
    solver = SQPSolver(ocp, device=CPU)
    Zb, Pb, xb = perturbed_batch(np.random.default_rng(0), Z0, P, xinit, 4, model.nu, CPU)
    parts = [solver.batch_impl(Zb[s], Pb[s], xb[s], 2) for s in (slice(0, 2), slice(2, 4))]
    pobj = torch.cat([p.pobj for p in parts])
    feasible = torch.cat([p.exit_code == 1 for p in parts])
    idx, found = argmin_objective(pobj, feasible)
    assert rows[1]["winner"] == int(idx) and bool(found)
    owner, row = divmod(int(idx), 2)
    assert torch.equal(torch.tensor(rows[1]["winner_Z"]), parts[owner].Z[row])  # bit-equal


# -- every sweep experiment: the card by default, the reference's flags -------------------------
SWEEPS = ["horizon_sweep", "batch_sweep", "n30_latency", "profile_solve", "fused_rti_check",
          "scaling_sweep", "nvar8_stress"]


@pytest.mark.parametrize("name", SWEEPS)
def test_experiment_takes_the_card_by_default(name):
    """Without CUDA and without --device cpu the experiment raises before any
    work; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    module = __import__(f"mpc_planner_tpu_torch.experiments.{name}", fromlist=["main"])
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


def _flags(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return {a.value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument"
            for a in n.args if isinstance(a, ast.Constant) and a.value.startswith("--")}


@pytest.mark.parametrize("name", ["horizon_sweep", "n30_latency", "scaling_sweep"])
def test_experiment_keeps_the_reference_flags(name):
    """Every flag of the reference experiment; `--tpu` becomes `--device`."""
    ref = _flags(os.path.join(ROOT, "experiments", f"{name}.py")) - {"--tpu"}
    ours = _flags(os.path.join(ROOT, "mpc_planner_tpu_torch", "experiments", f"{name}.py"))
    assert ref and ref <= ours | {"--device"}
