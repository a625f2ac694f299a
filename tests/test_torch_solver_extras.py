"""Port vs reference, on the CPU: the solver behaviours of
tests/test_solver.py that no other port test mirrors, the MIRROR variants
of tests/test_mirror.py, and the goal-tracking golden.

* `bound_limited_vars` (repair of fault (g); mirror of
  tests/test_solver.py:407): the same hits as the JAX solver's on the same
  solution, numpy or tensor; stage-0 states skipped.
* SQP mode (solver_type="SQP"): a converged solve freezes early with exit
  code 1 and matches a long RTI run; an unreachable tolerance ends with
  exit code 0 (max iterations); both held against the JAX solver (Z within
  5e-3, the same exit codes).
* Cross-cycle dual warm starts, single and batched with a per-element ok
  mask: the warm solve matches the cold one and the JAX warm solve within
  5e-3.
* The in-cycle escalation with stubbed solves (tests/test_solver.py:269,
  :335): failed or stalled elements whose duals were applied are re-solved
  at the full budget and adopted by the same rule in both packages; the
  retry is off with `qp_retry_cold` False.
* The warm IP budget: auto is 4, an explicit `qp_warm_iterations` wins.
* `jacobi_eigh` / `mirror_jacobi` against the JAX functions and against
  `mirror_unpacked` (tests/test_mirror.py:15, :33).
* tests/golden/goal_tracking.npz reproduced by the port's solver within
  5e-3 absolute (tests/test_regression.py:23-49, :86-102).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_planner_tpu.models as jax_models
import mpc_planner_tpu.modules as jax_modules
import mpc_planner_tpu_torch.models as torch_models
import mpc_planner_tpu_torch.modules as torch_modules
from mpc_planner_tpu.ops import jacobi_eigh as jax_jacobi
from mpc_planner_tpu.parameters import ParameterBlock as JaxParameterBlock
from mpc_planner_tpu.solver.ocp import OCP as JaxOCP
from mpc_planner_tpu.solver.sqp import SQPSolver as JaxSQPSolver
from mpc_planner_tpu.types import ModuleData as JaxModuleData
from mpc_planner_tpu.types import RealTimeData as JaxRealTimeData
from mpc_planner_tpu.utils.config import default_config as jax_default_config
from mpc_planner_tpu_torch.ops import jacobi_eigh
from mpc_planner_tpu_torch.parameters import ParameterBlock
from mpc_planner_tpu_torch.solver.ocp import OCP
from mpc_planner_tpu_torch.solver.sqp import SolveResult, SQPSolver
from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
from mpc_planner_tpu_torch.types import ModuleData, RealTimeData, State
from mpc_planner_tpu_torch.utils.config import default_config

torch.set_num_threads(1)

ATOL_Z = 5e-3
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _goal_setup(pkg: str, goal=(4.0, 1.0), N: int = 10, **solver):
    """tests/test_solver.py::_goal_setup in package `pkg`: goal tracking on
    the 4-state unicycle (conftest's cfg: N=10, 4 RTI, 10 IP iterations,
    `solver` overrides). Returns (model, ocp, solver, P, Z0, xinit)."""
    jax_side = pkg == "jax"
    default = jax_default_config if jax_side else default_config
    models, modules = (jax_models, jax_modules) if jax_side else (torch_models, torch_modules)
    cfg = default(N=N)
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, **dict(dict(iterations=4, qp_iterations=10), **solver)))
    model = models.SecondOrderUnicycleModel()
    mgr = modules.ModuleManager()
    base = mgr.add_module(modules.MPCBaseModule(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    mgr.add_module(modules.GoalModule(cfg))
    if jax_side:
        ocp = JaxOCP(model, mgr, cfg)
        sqp, data, Block, MD = JaxSQPSolver(ocp), JaxRealTimeData(), JaxParameterBlock, JaxModuleData
    else:
        ocp = OCP(model, mgr, cfg)
        sqp, data, Block, MD = SQPSolver(ocp, device="cpu"), RealTimeData(), ParameterBlock, ModuleData
    data.goal = np.array(goal)
    data.goal_received = True
    pblock = Block(ocp.params, cfg.N + 1)
    mgr.set_parameters_all(data, MD(), pblock)
    state = State(torch_models.SecondOrderUnicycleModel())
    Z0 = initialize_with_state(torch_models.SecondOrderUnicycleModel(), cfg.N, state)
    return model, ocp, sqp, pblock.data, Z0, state.as_array()


def test_bound_limited_vars():
    _, _, jsolver, _, _, _ = _goal_setup("jax")
    model, ocp, solver, P, Z0, xinit = _goal_setup("torch")
    res = solver.solve(Z0, P, xinit)
    Z = res.Z.numpy().copy()
    Z[3, 0] = float(np.asarray(ocp.lb_z)[0])  # one input pinned to its lower bound
    hits = solver.bound_limited_vars(Z)
    assert (3, model.inputs[0], "lower") in hits
    assert hits == jsolver.bound_limited_vars(Z)
    assert solver.bound_limited_vars(torch.as_tensor(Z)) == hits
    # stage-0 states are skipped even at their bounds
    Z[0, model.nu] = float(np.asarray(ocp.lb_z)[model.nu])
    assert not any(k == 0 and name in model.states for k, name, _ in solver.bound_limited_vars(Z))
    assert solver.bound_limited_vars(Z) == jsolver.bound_limited_vars(Z)


def test_sqp_mode_converges_and_freezes():
    sqp = dict(iterations=15, qp_iterations=10, solver_type="SQP")
    out = {}
    for pkg in ("jax", "torch"):
        _, _, solver, P, Z0, xinit = _goal_setup(pkg, **sqp)
        assert solver.solver_type == "SQP"
        out[pkg] = solver.solve(Z0, P, xinit)
    res, ref = out["torch"], out["jax"]
    assert int(res.exit_code) == int(ref.exit_code) == 1  # converged within 15 iterations
    assert int(res.iters) < 15  # froze early
    assert abs(int(res.iters) - int(ref.iters)) <= 1
    np.testing.assert_allclose(res.Z.numpy(), np.asarray(ref.Z), atol=ATOL_Z, rtol=0)
    # the converged solution matches a long RTI run
    _, _, rti, P, Z0, xinit = _goal_setup("torch", iterations=15, qp_iterations=10)
    np.testing.assert_allclose(res.Z.numpy(), rti.solve(Z0, P, xinit).Z.numpy(), atol=2e-2)


def test_sqp_mode_max_iter_exit_code():
    sqp = dict(iterations=2, qp_iterations=10, solver_type="SQP", tol_stationarity=1e-9)
    codes = []
    for pkg in ("jax", "torch"):
        _, _, solver, P, Z0, xinit = _goal_setup(pkg, goal=(8.0, 3.0), **sqp)
        codes.append(int(solver.solve(Z0, P, xinit).exit_code))
    assert codes == [0, 0]  # the iterate is usable: max iterations, not a failure


def test_cross_cycle_dual_warmstart():
    out = {}
    for pkg in ("jax", "torch"):
        _, _, solver, P, Z0, xinit = _goal_setup(pkg)
        res1 = solver.solve(Z0, P, xinit)
        assert int(res1.exit_code) == 1
        assert np.all(np.asarray(res1.lam_l) >= 0)
        warm = (np.asarray(res1.lam_l), np.asarray(res1.lam_u), True)
        Z1 = np.asarray(res1.Z)
        out[pkg] = (solver.solve(Z1, P, xinit, warm_duals=warm), solver.solve(Z1, P, xinit))
    (warm_t, cold_t), (warm_j, _) = out["torch"], out["jax"]
    assert int(warm_t.exit_code) == 1
    np.testing.assert_allclose(warm_t.Z.numpy(), cold_t.Z.numpy(), atol=ATOL_Z, rtol=0)
    np.testing.assert_allclose(warm_t.Z.numpy(), np.asarray(warm_j.Z), atol=ATOL_Z, rtol=0)


def test_cross_cycle_dual_warmstart_batched():
    B = 3
    ok = np.array([True, False, True])  # element 1 falls back to a cold start
    out = {}
    for pkg in ("jax", "torch"):
        _, _, solver, P, Z0, xinit = _goal_setup(pkg)
        Zb, Pb, xb = (np.tile(a[None], (B,) + (1,) * a.ndim) for a in (Z0, P, xinit))
        res1 = solver.solve_batch(Zb, Pb, xb)
        assert np.all(np.asarray(res1.exit_code) == 1)
        warm = (np.asarray(res1.lam_l), np.asarray(res1.lam_u), ok)
        Z1 = np.asarray(res1.Z)
        out[pkg] = (solver.solve_batch(Z1, Pb, xb, warm_duals=warm), solver.solve_batch(Z1, Pb, xb))
    (warm_t, cold_t), (warm_j, _) = out["torch"], out["jax"]
    assert np.all(warm_t.exit_code.numpy() == 1)
    np.testing.assert_allclose(warm_t.Z.numpy(), cold_t.Z.numpy(), atol=ATOL_Z, rtol=0)
    np.testing.assert_allclose(warm_t.Z.numpy(), np.asarray(warm_j.Z), atol=ATOL_Z, rtol=0)


# (exit codes, final mu) of the stubbed warm solve, of the stubbed full-budget
# re-solve, and the outcome both packages must reach (tests/test_solver.py:
# 269-333 and :335-390)
ESCALATIONS = {
    "failure": (([-1, 1, -1], [0.0] * 3), ([1, 1, 1], [0.0] * 3), [1, 1, -1], [2.0, 1.0, 1.0]),
    "stall": (([1, 1, 1], [1.0, 1e-9, 0.5]), ([1, -1, 1], [1e-9] * 3), [1, 1, 1], [2.0, 1.0, 1.0]),
}


@pytest.mark.parametrize("case", sorted(ESCALATIONS))
def test_warm_escalation_with_stubbed_solves(case):
    """Element 0: failed (or stalled) with applied duals: replaced by the
    full-budget solve. Element 1: kept. Element 2: its duals were rejected
    (ok=False: it already solved cold inside the warm call): not retried."""
    warm_stub, cold_stub, codes, pobj = ESCALATIONS[case]
    model, ocp, solver, P, Z0, xinit = _goal_setup("torch")
    B, N, nrows = 3, ocp.N, solver.nrows
    Zb, Pb, xb = (np.tile(a[None], (B,) + (1,) * a.ndim).astype(np.float32) for a in (Z0, P, xinit))
    real = solver.solve_batch(Zb, Pb, xb)

    def fake(stub, tag):
        exit_codes, mus = stub
        return SolveResult(
            Z=torch.full((B, N + 1, model.nvar), tag), exit_code=torch.tensor(exit_codes, dtype=torch.int32),
            pobj=torch.full((B,), tag), res_eq=torch.zeros(B), qp_mu=torch.tensor(mus),
            iters=torch.ones(B, dtype=torch.int32), lam_l=torch.zeros(B, N + 1, nrows),
            lam_u=torch.zeros(B, N + 1, nrows))

    calls = []

    def stub_batch_impl(Z0, P, xinit, n, warm0=None, escalated=False):
        calls.append(warm0 is not None)
        if warm0 is not None:
            return fake(warm_stub, 1.0)
        assert escalated  # the retry runs the full-budget program
        return fake(cold_stub, 2.0)

    solver.batch_impl = stub_batch_impl
    warm = (real.lam_l, real.lam_u, np.array([True, True, False]))
    res = solver.solve_batch(Zb, Pb, xb, warm_duals=warm)
    assert calls == [True, False]
    np.testing.assert_array_equal(res.exit_code.numpy(), codes)
    np.testing.assert_allclose(res.pobj.numpy(), pobj)
    assert float(res.Z[0, 0, 0]) == 2.0 and float(res.Z[1, 0, 0]) == 1.0
    # without the retry: no second dispatch, the warm result as it came
    calls.clear()
    solver.qp_retry_cold = False
    res2 = solver.solve_batch(Zb, Pb, xb, warm_duals=warm)
    assert calls == [True]
    np.testing.assert_array_equal(res2.exit_code.numpy(), warm_stub[0])


def test_warm_iterations_auto_default():
    for pkg in ("jax", "torch"):
        _, _, solver, _, _, _ = _goal_setup(pkg)
        assert solver.warm_qp_iters == 4
        assert _goal_setup(pkg, qp_warm_iterations=6)[2].warm_qp_iters == 6


def _sym_stack(rng, M, n):
    A = rng.normal(size=(M, n, n)).astype(np.float32)
    return (A + A.transpose(0, 2, 1)) * 0.5


@pytest.mark.parametrize("shape", [(40, 7), (3, 4, 4)], ids=["stack", "leading_dims"])
def test_jacobi_eigh_and_mirror_jacobi_match_reference(shape):
    rng = np.random.default_rng(42)
    H = _sym_stack(rng, int(np.prod(shape[:-1])), shape[-1]).reshape(shape[:-1] + (shape[-1],) * 2)
    lm = 1e-3 if shape[-1] == 7 else 1e-4
    Ht = torch.as_tensor(H)
    w, V = jacobi_eigh.jacobi_eigh(Ht)
    wj, Vj = jax_jacobi.jacobi_eigh(jnp.asarray(H))
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), atol=1e-5 * np.abs(H).max())
    np.testing.assert_allclose(V.numpy(), np.asarray(Vj), atol=1e-4)
    np.testing.assert_allclose((V @ torch.diag_embed(w) @ V.mT).numpy(), H, atol=1e-5 * np.abs(H).max())
    ref = np.asarray(jax_jacobi.mirror_jacobi(jnp.asarray(H), lm))
    out = jacobi_eigh.mirror_jacobi(Ht, lm).numpy()
    assert out.shape == H.shape
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5
    # the unpacked form agrees with the row-update form (tests/test_mirror.py:15)
    assert np.abs(jacobi_eigh.mirror_unpacked(Ht, lm).numpy() - out).max() / np.abs(out).max() < 5e-3


def test_goal_tracking_golden():
    """tests/test_regression.py:23-49: goal (6, 2) from v=0.5, N=15, 10 RTI
    iterations, one solve on the CPU."""
    cfg = default_config(N=15)
    model = torch_models.SecondOrderUnicycleModel()
    mgr = torch_modules.ModuleManager()
    base = mgr.add_module(torch_modules.MPCBaseModule(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    mgr.add_module(torch_modules.GoalModule(cfg))
    ocp = OCP(model, mgr, cfg)
    solver = SQPSolver(ocp, device="cpu")
    data = RealTimeData()
    data.goal = np.array([6.0, 2.0])
    data.goal_received = True
    pblock = ParameterBlock(ocp.params, cfg.N + 1)
    mgr.set_parameters_all(data, ModuleData(), pblock)
    state = State(model)
    state.set("v", 0.5)
    Z0 = initialize_with_state(model, cfg.N, state)
    Z = solver.solve(Z0, pblock.data, state.as_array(), num_iterations=10).Z.numpy()
    golden = np.load(os.path.join(GOLDEN_DIR, "goal_tracking.npz"))["Z"]
    assert Z.shape == golden.shape
    assert np.abs(Z - golden).max() < 5e-3
