"""Port vs reference for the fused SQP-RTI route (K3) and the Riccati probe
(K4), on the CPU.

* The derivative code generated for each OCP (ops/stage_codegen.py), built
  with the host compiler, against torch.func at 64 seeded (z, p): f, Jf,
  the running and terminal cost's gradient and Hessian, h, Jh, within
  1e-5 of max |ref| (the same float32 arithmetic up to libm's sin/cos and
  summation order), for system_jackal("goal") and the goal-only unicycle
  OCP (nh=0). An unsupported op raises ValueError.
* The fused route's plain version (SQPSolver._solve_batch_fused on CPU
  tensors) against the JAX package's XLA solve at N=10, B=4: cold, warm
  duals, one RTI iteration, escalated; 5e-3 absolute on Z
  (tests/test_regression.py:102) and equal exit codes. One slow-marked case
  against the JAX fused kernel itself in Pallas interpret mode.
* Route resolution (rti_fused, and the qp_backend "auto" gate).
* K4's plain factorization against a float64 numpy recursion (1e-4 of
  max |P|: float32 against float64 over 160 contracting steps).
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, jacfwd, vmap

from mpc_planner_tpu.models import SecondOrderUnicycleModel as JaxUnicycle
from mpc_planner_tpu.modules import GoalModule as JaxGoal
from mpc_planner_tpu.modules import ModuleManager as JaxModules
from mpc_planner_tpu.modules import MPCBaseModule as JaxBase
from mpc_planner_tpu.solver.ocp import OCP as JaxOCP
from mpc_planner_tpu.solver.sqp import SQPSolver as JaxSQPSolver
from mpc_planner_tpu.utils.config import default_config as jax_default_config
from mpc_planner_tpu_torch import interop
from mpc_planner_tpu_torch.experiments import riccati_probe
from mpc_planner_tpu_torch.models import SecondOrderUnicycleModel
from mpc_planner_tpu_torch.modules import GoalModule, ModuleManager, MPCBaseModule
from mpc_planner_tpu_torch.ops import cuda_qp
from mpc_planner_tpu_torch.ops.cuda_rti import linearize_cuda, solve_rti_cuda
from mpc_planner_tpu_torch.ops.rti import solve_rti_torch
from mpc_planner_tpu_torch.ops.stage_codegen import StageCode, host_evaluator
from mpc_planner_tpu_torch.parameters import ParameterBlock
from mpc_planner_tpu_torch.solver import sqp
from mpc_planner_tpu_torch.solver.ocp import OCP as TorchOCP
from mpc_planner_tpu_torch.solver.sqp import SQPSolver as TorchSQPSolver
from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
from mpc_planner_tpu_torch.types import ModuleData, RealTimeData, State
from mpc_planner_tpu_torch.utils.config import default_config
from torch_port_cases import SOLVER_SMALL, jackal_goal_pair, parameter_blocks, perturbed_warmstarts

TOL_CODEGEN = 1e-5
ATOL_Z = 5e-3
B = 4


def _goal_only(cfg, model_cls, manager_cls, base_cls, goal_cls):
    """Goal tracking on the 4-state unicycle (nh = 0), built by either
    package."""
    modules = manager_cls()
    base = modules.add_module(base_cls(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    modules.add_module(goal_cls(cfg))
    return model_cls(), modules


def _torch_goal_ocp(N=10):
    cfg = default_config(N=N)
    model, modules = _goal_only(cfg, SecondOrderUnicycleModel, ModuleManager, MPCBaseModule,
                                GoalModule)
    return TorchOCP(model, modules, cfg)


# -- generated derivative code -------------------------------------------------
@pytest.fixture(scope="module", params=["jackal_goal", "unicycle_goal"])
def generated(request, tmp_path_factory):
    """The OCP, its generated code built with the host compiler, and 64
    seeded (z, p) points."""
    cxx = os.environ.get("CXX", "c++")
    if shutil.which(cxx) is None or shutil.which("ninja") is None:
        pytest.skip(f"needs a C++ compiler ({cxx}) and ninja")
    rng = np.random.default_rng(0)
    if request.param == "jackal_goal":
        _, ts = jackal_goal_pair(n_pedestrians=6, seed=3)
        ocp = TorchOCP(ts.model, ts.modules, ts.cfg)
        pblock = ParameterBlock(ocp.params, ocp.N + 1)
        ts.modules.set_parameters_all(ts.data, ModuleData(), pblock)
        P = pblock.data
    else:
        ocp = _torch_goal_ocp()
        P = rng.normal(0.0, 1.0, (ocp.N + 1, ocp.npar))
    # stage rows of the block with small noise (chi and the radii stay positive)
    p = P[rng.integers(1, ocp.N, 64)] + rng.normal(0.0, 0.01, (64, ocp.npar))
    z = rng.normal(0.0, 1.0, (64, ocp.nvar))
    evaluate = host_evaluator(StageCode(ocp), str(tmp_path_factory.mktemp(request.param)))
    return ocp, torch.as_tensor(z, dtype=torch.float32), torch.as_tensor(p, dtype=torch.float32), evaluate


def test_generated_derivatives_match_torch_func(generated):
    ocp, z, p, evaluate = generated
    out = evaluate(z.numpy(), p.numpy())
    ref = dict(f=vmap(ocp.dynamics_fn)(z, p), Jf=vmap(jacfwd(ocp.dynamics_fn))(z, p),
               g=vmap(grad(ocp.running_cost))(z, p), H=vmap(hessian(ocp.running_cost))(z, p),
               gT=vmap(grad(ocp.terminal_cost))(z, p), HT=vmap(hessian(ocp.terminal_cost))(z, p))
    if ocp.nh:
        ref.update(h=vmap(ocp.constraint_fn)(z, p), Jh=vmap(jacfwd(ocp.constraint_fn))(z, p))
    else:
        assert out["h"].shape == (64, 0) and out["Jh"].shape == (64, 0, ocp.nvar)
    for name, r in ref.items():
        r = r.numpy()
        assert out[name].shape == r.shape, name
        assert np.abs(out[name] - r).max() <= TOL_CODEGEN * np.abs(r).max(), name


def test_generated_new_ops_match_torch_func(tmp_path):
    """exp, log, tan, atan, erf, abs, maximum, minimum and cat in the
    generated code (values, gradients, Hessians on the dual numbers of
    dual.cuh) against torch.func, away from the ties of max/min/abs."""
    cxx = os.environ.get("CXX", "c++")
    if shutil.which(cxx) is None or shutil.which("ninja") is None:
        pytest.skip(f"needs a C++ compiler ({cxx}) and ninja")
    ocp = _torch_goal_ocp()

    def cost(z, p):
        a, w, x, y, psi, v = (z[i] for i in range(6))
        parts = torch.cat([torch.stack([torch.exp(0.3 * a), torch.log(2.0 + x * x)]),
                           torch.stack([torch.tan(0.4 * psi), torch.atan(y * v)])])
        soft = torch.maximum(a * x, w + p[0]) + torch.minimum(y, v * v) + torch.abs(psi - 0.1)
        return parts.sum(dim=0) + torch.erf(0.5 * w + x) * soft + torch.erf(p[1]) * torch.exp(p[0])

    ocp.running_cost = cost
    rng = np.random.default_rng(4)
    z = torch.as_tensor(rng.normal(0.0, 1.0, (64, ocp.nvar)), dtype=torch.float32)
    p = torch.as_tensor(rng.normal(0.0, 1.0, (64, ocp.npar)), dtype=torch.float32)
    out = host_evaluator(StageCode(ocp), str(tmp_path))(z.numpy(), p.numpy())
    zd, pd = z.double(), p.double()
    for name, ref in (("g", vmap(grad(cost))(zd, pd)), ("H", vmap(hessian(cost))(zd, pd))):
        assert np.abs(out[name] - ref.numpy()).max() <= TOL_CODEGEN * ref.abs().max(), name


def test_unsupported_op_raises():
    ocp = _torch_goal_ocp()
    ocp.dynamics_fn = lambda z, p: torch.cosh(z[ocp.nu:])  # (exp, log, tan, erf, ... are covered)
    with pytest.raises(ValueError, match="dynamics: aten op aten.cosh"):
        StageCode(ocp).generate()


# -- the fused route against the JAX package ------------------------------------
@pytest.fixture(scope="module")
def batch():
    js, ts = jackal_goal_pair(n_pedestrians=6, seed=7, **SOLVER_SMALL)
    jsolver = JaxSQPSolver(JaxOCP(js.model, js.modules, js.cfg))
    tsolver = TorchSQPSolver(TorchOCP(ts.model, ts.modules, ts.cfg), device="cpu")
    P_j, P_t = parameter_blocks(js, ts, jsolver.ocp.params, tsolver.ocp.params)
    Z0 = initialize_with_state(ts.model, ts.cfg.N, ts.state)
    Zb = perturbed_warmstarts(Z0, ts.model.nu, B, seed=2)
    Pb = np.tile(P_t[None], (B, 1, 1)).astype(np.float32)
    xb = np.tile(ts.state.as_array()[None], (B, 1)).astype(np.float32)
    return jsolver, tsolver, Zb, Pb, xb


@pytest.mark.parametrize("case", ["cold", "warm", "one_iteration", "escalated"])
def test_solve_batch_fused_matches_jax(batch, case):
    """The port's fused route (its plain version on the CPU) against the
    JAX XLA path that solve_batch dispatches to (_get_compiled), with the
    same warm-start ladder."""
    jsolver, tsolver, Zb, Pb, xb = batch
    n = 1 if case == "one_iteration" else 4
    escalated = case == "escalated"
    args_j = (jnp.asarray(Zb), jnp.asarray(Pb), jnp.asarray(xb))
    args_t = (interop.warm_start(Zb, device="cpu"), interop.parameter_block(Pb, device="cpu"),
              interop.xinit(xb, device="cpu"))
    warm_j = warm_t = None
    if case == "warm":
        first = jsolver._get_compiled(4, True)(*args_j)
        warm = (np.asarray(first.lam_l), np.asarray(first.lam_u), np.asarray(first.qp_mu) < 1e-2)
        warm_j = (jnp.asarray(warm[0]), jnp.asarray(warm[1]), jnp.asarray(warm[2]))
        warm_t = interop.warm_duals(*warm, device="cpu")
    if warm_j is None:
        res_j = jsolver._get_compiled(n, True, escalated=escalated)(*args_j)
    else:
        res_j = jsolver._get_compiled(n, True, True)(*args_j, *warm_j)
    res_t = tsolver._solve_batch_fused(*args_t, n, warm0=warm_t, escalated=escalated)
    np.testing.assert_array_equal(res_t.exit_code.numpy(), np.asarray(res_j.exit_code))
    np.testing.assert_allclose(res_t.Z.numpy(), np.asarray(res_j.Z), atol=ATOL_Z, rtol=0)


@pytest.mark.slow
def test_solve_batch_fused_matches_jax_interpret():
    """Against the JAX fused kernel itself (ops/pallas_rti.py) in Pallas
    interpret mode, on the goal-only OCP (nh = 0)."""
    N = 10
    jc = jax_default_config(N=N)
    jc = jc.replace(solver=jc.solver.__class__(**SOLVER_SMALL))
    jmodel, jmods = _goal_only(jc, JaxUnicycle, JaxModules, JaxBase, JaxGoal)
    jsolver = JaxSQPSolver(JaxOCP(jmodel, jmods, jc))
    tc = default_config(N=N)
    tc = tc.replace(solver=tc.solver.__class__(**SOLVER_SMALL))
    tmodel, tmods = _goal_only(tc, SecondOrderUnicycleModel, ModuleManager, MPCBaseModule,
                               GoalModule)
    tsolver = TorchSQPSolver(TorchOCP(tmodel, tmods, tc), device="cpu")
    data = RealTimeData()
    data.goal = np.array([4.0, 1.0])
    data.goal_received = True
    pblock = ParameterBlock(tsolver.ocp.params, N + 1)
    tmods.set_parameters_all(data, ModuleData(), pblock)
    interop.check_same_registry(jsolver.ocp.params, tsolver.ocp.params)
    state = State(tmodel)
    Zb = perturbed_warmstarts(initialize_with_state(tmodel, N, state), tmodel.nu, B, seed=5)
    Pb = np.tile(pblock.data[None], (B, 1, 1)).astype(np.float32)
    xb = np.tile(state.as_array()[None], (B, 1)).astype(np.float32)
    jsolver.interpret = True
    res_j = jsolver._solve_batch_fused(jnp.asarray(Zb), jnp.asarray(Pb), jnp.asarray(xb), 3)
    res_t = tsolver._solve_batch_fused(interop.warm_start(Zb, device="cpu"),
                                       interop.parameter_block(Pb, device="cpu"),
                                       interop.xinit(xb, device="cpu"), 3)
    np.testing.assert_array_equal(res_t.exit_code.numpy(), np.asarray(res_j.exit_code))
    np.testing.assert_allclose(res_t.Z.numpy(), np.asarray(res_j.Z), atol=ATOL_Z, rtol=0)


def test_wrappers_on_cpu_are_plain(batch):
    """On CPU tensors solve_rti_cuda and linearize_cuda run the plain
    versions and launch nothing; the plain linearization is the unfused
    one where the QP reads it (terminal u-block and inactive rows masked)."""
    _, tsolver, Zb, Pb, xb = batch
    Z, P = interop.warm_start(Zb, device="cpu"), interop.parameter_block(Pb, device="cpu")
    nu, N = tsolver.ocp.nu, tsolver.ocp.N
    kw = dict(lb_template=tsolver._lb_template, ub_template=tsolver._ub_template,
              lm=tsolver.lm, mirror_x_only=tsolver._mirror_x_only)
    cuda_qp.reset_launch_counts()
    out = linearize_cuda(Z, P, tsolver._stage_code, **kw)
    res = solve_rti_cuda(Z, P, tsolver._stage_code, num_iterations=2, it0=10, warm_iters=4, **kw)
    assert not any(cuda_qp.launch_counts.values())
    ref_res = solve_rti_torch(Z, P, tsolver.ocp, num_iterations=2, it0=10, warm_iters=4, **kw)
    torch.testing.assert_close(res.Z, ref_res.Z, rtol=0, atol=0)
    ref = tsolver._linearize(Z, P)
    keep = torch.ones_like(ref.H)
    keep[:, N, :nu, :] = 0
    keep[:, N, :, :nu] = 0
    torch.testing.assert_close(out.H * keep, ref.H * keep, rtol=0, atol=0)
    for f in ("g", "A", "B", "c", "D"):
        torch.testing.assert_close(getattr(out, f), getattr(ref, f), rtol=0, atol=0)
    torch.testing.assert_close(out.mask_l, ref.mask_l, rtol=0, atol=0)
    torch.testing.assert_close(out.lb * ref.mask_l, ref.lb * ref.mask_l, rtol=0, atol=0)


# -- route resolution -------------------------------------------------------------
def _solver(**solver_cfg):
    ocp = _torch_goal_ocp()
    cfg = ocp.cfg.replace(solver=ocp.cfg.solver.__class__(**solver_cfg))
    return TorchSQPSolver(TorchOCP(ocp.model, ocp.modules, cfg), device="cpu")


def test_rti_fused_route_resolution(monkeypatch):
    cpu = _solver()  # "auto" on a CPU device: the torch backend, unfused
    assert not cpu.rti_fused and "torch" in cpu.rti_fused_reason
    assert not _solver(rti_fused="on").rti_fused
    with pytest.raises(ValueError, match="rti_fused"):
        _solver(rti_fused="yes")
    # as if on a CUDA device (the backend check patched): "on" and "auto"
    # take the route unless corrector-only warm QPs or SQP mode keep it
    # unfused; "off" never does, and each says why
    monkeypatch.setattr(sqp, "resolve_qp_backend", lambda *args: "cuda")
    for setting in ("on", "auto"):
        fused = _solver(rti_fused=setting)
        assert fused.rti_fused and fused.rti_fused_reason == ""
        corrector_only = _solver(rti_fused=setting, qp_warm_corrector_only=True)
        assert not corrector_only.rti_fused and "corrector" in corrector_only.rti_fused_reason
        assert not _solver(rti_fused=setting, solver_type="SQP").rti_fused
    off = _solver(rti_fused="off")
    assert not off.rti_fused and "off" in off.rti_fused_reason


def test_auto_backend_needs_an_instantiated_qp_kernel():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for nu, nx in cuda_qp.QP_SHAPES:
        assert sqp.resolve_qp_backend("auto", cuda, nu, nx) == "cuda"
    assert sqp.resolve_qp_backend("auto", cuda, 2, 7) == "torch"  # nu <= 3, no instantiation
    assert sqp.resolve_qp_backend("auto", cuda, 4, 5) == "torch"
    assert sqp.resolve_qp_backend("auto", cpu, 2, 5) == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        sqp.resolve_qp_backend("cuda", cpu, 2, 5)


# -- K4 -----------------------------------------------------------------------------
def test_riccati_probe_plain_matches_float64():
    H, A, Bm = riccati_probe.make_data(np.random.default_rng(1), 16)
    P = riccati_probe.factor_chain_torch(*(torch.as_tensor(np.moveaxis(x, -1, 0)) for x in (H, A, Bm)))
    H, A, Bm = (np.moveaxis(x, -1, 0).astype(np.float64) for x in (H, A, Bm))
    nu, N = riccati_probe.NU, A.shape[1]
    ref = H[:, N, nu:, nu:]
    for _ in range(riccati_probe.SWEEPS):
        for k in reversed(range(N)):
            Hk, Ak, Bk = H[:, k], A[:, k], Bm[:, k]
            PA, PB = ref @ Ak, ref @ Bk
            R = Hk[:, :nu, :nu] + np.swapaxes(Bk, 1, 2) @ PB + 1e-7 * np.eye(nu)
            S = Hk[:, :nu, nu:] + np.swapaxes(Bk, 1, 2) @ PA
            K = -np.linalg.solve(R, S)
            Pn = Hk[:, nu:, nu:] + np.swapaxes(Ak, 1, 2) @ PA + np.swapaxes(S, 1, 2) @ K
            ref = 0.5 * (Pn + np.swapaxes(Pn, 1, 2))
    assert np.abs(P.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
