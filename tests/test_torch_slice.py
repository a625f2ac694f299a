"""Port vs reference: the slice end to end on the CPU.

`Planner.solve_mpc` for system_jackal("goal") over 3 closed-loop cycles
on the corridor scene, and `SQPSolver.solve_batch` at B=4, cold and with
carried warm duals where one element's warm solve fails so that the
full-budget escalation fires in both packages.
Tolerance: 5e-3 absolute on Z (tests/test_regression.py:102).
"""

import numpy as np
import pytest
import torch

from mpc_planner_tpu.planner import Planner as JaxPlanner
from mpc_planner_tpu.solver.ocp import OCP as JaxOCP
from mpc_planner_tpu.solver.sqp import SQPSolver as JaxSQPSolver
from mpc_planner_tpu_torch import interop
from mpc_planner_tpu_torch.planner import Planner as TorchPlanner
from mpc_planner_tpu_torch.solver.ocp import OCP as TorchOCP
from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS, SQPSolver as TorchSQPSolver
from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
from torch_port_cases import SOLVER_SMALL, jackal_goal_pair, parameter_blocks, perturbed_warmstarts

ATOL_Z = 5e-3
B = 4


def test_planner_closed_loop_matches_jax():
    js, ts = jackal_goal_pair(n_pedestrians=6, seed=7, **SOLVER_SMALL)
    jp = JaxPlanner(js.model, js.modules, js.cfg)
    tp = TorchPlanner(ts.model, ts.modules, ts.cfg)
    assert tp.solver.qp_backend == "torch"
    start = ts.state.get_position()
    for cycle in range(3):
        out_j = jp.solve_mpc(js.state, js.data)
        out_t = tp.solve_mpc(ts.state, ts.data)
        assert out_t.success and out_j.success, cycle
        np.testing.assert_allclose(tp._Z, np.asarray(jp._Z), atol=ATOL_Z, rtol=0)
        np.testing.assert_allclose(out_t.trajectory.positions, out_j.trajectory.positions,
                                   atol=ATOL_Z, rtol=0)
        # both robots take the port's step
        z = torch.as_tensor(np.concatenate(
            [[tp.get_solution(0, "a"), tp.get_solution(0, "w")], ts.state.as_array()]),
            dtype=torch.float32)
        x_next = ts.model.discrete_dynamics(z, None, ts.cfg.dt).numpy()
        for side in (js, ts):
            side.state.from_array(x_next)
    assert ts.state.get("x") > start[0] + 0.05  # the robot moves toward the goal


@pytest.fixture(scope="module")
def batch():
    js, ts = jackal_goal_pair(n_pedestrians=6, seed=7, **SOLVER_SMALL)
    jsolver = JaxSQPSolver(JaxOCP(js.model, js.modules, js.cfg))
    tsolver = TorchSQPSolver(TorchOCP(ts.model, ts.modules, ts.cfg))
    P_j, P_t = parameter_blocks(js, ts, jsolver.ocp.params, tsolver.ocp.params)
    np.testing.assert_array_equal(P_j, P_t)
    Z0 = initialize_with_state(ts.model, ts.cfg.N, ts.state)
    Zb = perturbed_warmstarts(Z0, ts.model.nu, B, seed=2)
    Pb = np.tile(P_t[None], (B, 1, 1)).astype(np.float32)
    xb = np.tile(ts.state.as_array()[None], (B, 1)).astype(np.float32)
    return jsolver, tsolver, Zb, Pb, xb


def _spy(obj, name, log):
    """Record the `escalated` flag of every call to obj.<name>."""
    real = getattr(obj, name)

    def wrapped(*args, **kw):
        log.append(bool(kw.get("escalated", False)))
        return real(*args, **kw)

    setattr(obj, name, wrapped)
    return real


def _assert_same(res_t, res_j):
    np.testing.assert_array_equal(res_t.exit_code.numpy(), np.asarray(res_j.exit_code))
    np.testing.assert_allclose(res_t.Z.numpy(), np.asarray(res_j.Z), atol=ATOL_Z, rtol=0)


def test_solve_batch_cold_matches_jax(batch):
    jsolver, tsolver, Zb, Pb, xb = batch
    res_j = jsolver.solve_batch(Zb, Pb, xb)
    res_t = tsolver.solve_batch(interop.warm_start(Zb), interop.parameter_block(Pb),
                                interop.xinit(xb))
    assert np.all(np.asarray(res_j.exit_code) == EXIT_SUCCESS)
    _assert_same(res_t, res_j)


def test_solve_batch_warm_escalation_matches_jax(batch):
    """Warm duals carried from a cold solve; element 1's warm start is
    badly perturbed and the cycle runs one RTI iteration, so its warm
    solve ends with a dynamics defect above tol_eq: both packages
    dispatch the full-budget escalation for it in the same cycle and
    keep whichever result is better."""
    jsolver, tsolver, Zb, Pb, xb = batch
    first = jsolver.solve_batch(Zb, Pb, xb)
    Z1 = np.asarray(first.Z).copy()
    rng = np.random.default_rng(0)
    Z1[1, 1:, 2:] += rng.normal(0.0, 0.5, Z1[1, 1:, 2:].shape).astype(np.float32)
    warm = (np.asarray(first.lam_l), np.asarray(first.lam_u), np.ones(B, bool))

    j_log, t_log = [], []
    real_j = _spy(jsolver, "_get_compiled", j_log)
    real_t = _spy(tsolver, "batch_impl", t_log)
    try:
        res_j = jsolver.solve_batch(Z1, Pb, xb, num_iterations=1, warm_duals=warm)
        res_t = tsolver.solve_batch(interop.warm_start(Z1), interop.parameter_block(Pb),
                                    interop.xinit(xb), num_iterations=1,
                                    warm_duals=interop.warm_duals(*warm))
    finally:
        jsolver._get_compiled = real_j
        tsolver.batch_impl = real_t
    assert j_log == [False, True] and t_log == [False, True]  # escalation fired
    assert res_t.exit_code[1] != EXIT_SUCCESS
    _assert_same(res_t, res_j)
    np.testing.assert_allclose(res_t.lam_l.numpy(), np.asarray(res_j.lam_l),
                               atol=5e-3 * np.abs(np.asarray(res_j.lam_l)).max(), rtol=0)


def test_cuda_backend_needs_cuda_device(batch):
    """qp_backend="cuda" on a CPU device raises; "auto" picks torch."""
    _, tsolver, *_ = batch
    assert tsolver.qp_backend == "torch"
    ocp = tsolver.ocp
    cfg = ocp.cfg.replace(solver=ocp.cfg.solver.__class__(qp_backend="cuda"))
    with pytest.raises(ValueError, match="CUDA device"):
        TorchSQPSolver(TorchOCP(ocp.model, ocp.modules, cfg), device="cpu")
