"""Port vs reference: the batched interior-point Riccati QP (the plain
version of the CUDA QP kernel K1).

The same QPData (built by the JAX solver from seeded numpy inputs and
handed over through interop.qp_data) goes to the port's `solve_qp`, the
JAX `solve_qp` and `solve_qp_pallas(..., interpret=True)`. Cases: cold,
and warm duals on the next RTI iteration's QP, Mehrotra on and off, on the goal OCP (nh=0) and on
system_jackal("goal") with the robot close to a pedestrian (nh=12, the
general-row code the TPU kernel tests never reach). Tolerance: 5e-3 of
max |ref| on dz and lambda, the reference's own kernel-vs-XLA bound
(tests/test_pallas_qp.py:70).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_planner_tpu.models import SecondOrderUnicycleModel
from mpc_planner_tpu.modules import GoalModule, ModuleManager, MPCBaseModule
from mpc_planner_tpu.ops.pallas_qp import solve_qp_pallas
from mpc_planner_tpu.parameters import ParameterBlock
from mpc_planner_tpu.solver.ocp import OCP
from mpc_planner_tpu.solver.qp import solve_qp as jax_solve_qp
from mpc_planner_tpu.solver.sqp import SQPSolver
from mpc_planner_tpu.solver.warmstart import initialize_with_state
from mpc_planner_tpu.types import ModuleData, RealTimeData, State
from mpc_planner_tpu.utils.config import default_config
from mpc_planner_tpu_torch import interop
from mpc_planner_tpu_torch.ops import cuda_qp
from mpc_planner_tpu_torch.solver.qp import solve_qp
from torch_port_cases import (
    SOLVER_SMALL, jackal_goal_pair, perturbed_warmstarts, place_near_pedestrian,
)

TOL = 5e-3
ITER = 8  # cold QPs (the reference's kernel tests use 8)
ITER_WARM = 4  # warm QPs: the SQP loop's warm budget (solver.warm_qp_iters)
B = 4


def _goal_qp():
    cfg = default_config(N=10)
    cfg = cfg.replace(solver=cfg.solver.__class__(**SOLVER_SMALL))
    model = SecondOrderUnicycleModel()
    mgr = ModuleManager()
    base = mgr.add_module(MPCBaseModule(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    mgr.add_module(GoalModule(cfg))
    data = RealTimeData()
    data.goal = np.array([4.0, 1.0])
    data.goal_received = True
    return model, cfg, mgr, data, State(model)


def _jackal_qp():
    js, _ = jackal_goal_pair(n_pedestrians=6, seed=3)
    # 2 m behind a pedestrian at 1 m/s: obstacle rows active, duals unique
    # (some placements make an obstacle row and a box row active together,
    # where the duals are not unique and no two solvers agree on them)
    place_near_pedestrian(js.state, js.data, gap=2.0, speed=1.0)
    return js.model, js.cfg, js.modules, js.data, js.state


def _build(case):
    model, cfg, mgr, data, state = _goal_qp() if case == "goal" else _jackal_qp()
    ocp = OCP(model, mgr, cfg)
    solver = SQPSolver(ocp)
    pblock = ParameterBlock(ocp.params, cfg.N + 1)
    mgr.set_parameters_all(data, ModuleData(), pblock)
    pblock.data[cfg.N] = pblock.data[cfg.N - 1]
    Z0 = initialize_with_state(model, cfg.N, state)
    Zb = perturbed_warmstarts(Z0, model.nu, B)
    Pb = np.tile(pblock.data[None], (B, 1, 1)).astype(np.float32)
    linearize = jax.vmap(solver._linearize)
    qp = linearize(jnp.asarray(Zb), jnp.asarray(Pb))
    with jax.default_matmul_precision("highest"):
        first = jax.vmap(lambda d: jax_solve_qp(d, model.nu, model.nx, iterations=ITER))(qp)
    # The warm QP is the SQP loop's next one: relinearized at Z + dz and
    # started from the first QP's duals.
    qp_next = linearize(jnp.asarray(Zb) + first.dz, jnp.asarray(Pb))
    return model, ocp, qp, qp_next, first


@pytest.fixture(scope="module", params=["goal", "jackal"])
def case(request):
    model, ocp, qp, qp_next, first = _build(request.param)
    # element 2's duals are rejected (ok=False): it starts cold
    ok = np.array([True, True, False, True])
    return dict(name=request.param, model=model, nh=ocp.nh, qp=qp, qp_next=qp_next,
                warm=(np.asarray(first.lam_l), np.asarray(first.lam_u), ok))


def _reference(case, warm, mehrotra, kind):
    model = case["model"]
    qp = case["qp"] if warm is None else case["qp_next"]
    nu, nx = model.nu, model.nx
    it = ITER if warm is None else ITER_WARM
    with jax.default_matmul_precision("highest"):
        if kind == "pallas":
            wd = None if warm is None else (jnp.asarray(warm[0]), jnp.asarray(warm[1]), jnp.asarray(warm[2]))
            return solve_qp_pallas(qp, nu, nx, iterations=it, interpret=True,
                                   warm_duals=wd, mehrotra=mehrotra)
        if warm is None:
            return jax.vmap(lambda d: jax_solve_qp(d, nu, nx, iterations=it, mehrotra=mehrotra))(qp)
        return jax.vmap(lambda d, wl, wu, ok: jax_solve_qp(
            d, nu, nx, iterations=it, warm_duals=(wl, wu, ok), mehrotra=mehrotra))(
            qp, *(jnp.asarray(w) for w in warm))


def _rel(out, ref):
    ref = np.asarray(ref)
    return np.abs(out.numpy() - ref).max() / (np.abs(ref).max() + 1e-9)


@pytest.mark.parametrize("kind", ["xla", "pallas"])
@pytest.mark.parametrize("mehrotra", [True, False])
@pytest.mark.parametrize("warm", [False, True])
def test_solve_qp_matches_reference(case, warm, mehrotra, kind):
    model = case["model"]
    wd = case["warm"] if warm else None
    ref = _reference(case, wd, mehrotra, kind)
    qp = case["qp_next"] if warm else case["qp"]
    out = solve_qp(interop.qp_data(qp), model.nu, model.nx, iterations=ITER_WARM if warm else ITER,
                   warm_duals=None if wd is None else interop.warm_duals(*wd), mehrotra=mehrotra)
    assert _rel(out.dz, ref.dz) < TOL
    assert _rel(out.lam_l, ref.lam_l) < TOL
    assert _rel(out.lam_u, ref.lam_u) < TOL
    assert _rel(out.mu, ref.mu) < TOL


def test_jackal_case_exercises_general_rows(case):
    """The nh=12 case has active obstacle rows (non-negligible duals on
    the general rows), so the Dh code paths carry weight."""
    if case["name"] != "jackal":
        assert case["nh"] == 0
        return
    assert case["nh"] == 12
    lam_h = case["warm"][0][:, :-1, case["model"].nvar:]
    assert lam_h.max() > 1e-2


def test_qp_wrapper_on_cpu_is_plain(case):
    """On CPU tensors the kernel wrapper runs the plain solve_qp and
    launches nothing."""
    model = case["model"]
    qp = interop.qp_data(case["qp"])
    cuda_qp.reset_launch_counts()
    a = cuda_qp.solve_qp_cuda(qp, model.nu, model.nx, iterations=3)
    b = solve_qp(qp, model.nu, model.nx, iterations=3)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert cuda_qp.launch_counts == {"qp": 0, "mirror": 0}
