"""Hand-written CUDA kernels K3 (fused SQP-RTI) and K4 (Riccati probe) vs
their plain torch versions, on a CUDA GPU. Skipped without one (the
decision is made in the `device` fixture). The machine with the card has
no JAX, so this file imports only the port; run it there without the JAX
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_rti_cuda.py

Shapes: system_jackal("goal") (N=30, nh=12), goal tracking with nh=0,
and the T-MPC++ flagship OCP (configuration_tmpc at N=20, nh=24: its
generated stage code blends 5 spline segments, with sigmoid, where,
clamp and remainder).

Tolerances: K3 5e-3 of max |Z| (the reference's fused-vs-XLA bound,
tests/test_pallas_rti.py:96-98) and at most one element of the batch with
another exit code; its linearization 1e-4 of max |ref| (the same
arithmetic up to libm's sin/cos and summation order); K4 1e-3 absolute on
P (the TPU probe's own bound, experiments/riccati_ilp_probe.py:369).

K3 runs one warp per batch element (one block each) and linearizes stage
k on lane k, so the cases also cover batches of 1, 5 and 33 elements, both
horizons (N+1 = 31 and 21), warm duals accepted for some elements only,
and an element whose parameters hold a NaN beside healthy ones.
"""

import numpy as np
import pytest
import torch

from mpc_planner_tpu_torch import presets
from mpc_planner_tpu_torch.experiments import riccati_probe
from mpc_planner_tpu_torch.models import SecondOrderUnicycleModel
from mpc_planner_tpu_torch.modules import GoalModule, ModuleManager, MPCBaseModule
from mpc_planner_tpu_torch.ops import cuda_qp
from mpc_planner_tpu_torch.ops.cuda_rti import linearize_cuda, load_rti, solve_rti_cuda
from mpc_planner_tpu_torch.ops.rti import solve_rti_torch
from mpc_planner_tpu_torch.ops.stage_codegen import StageCode
from mpc_planner_tpu_torch.parameters import ParameterBlock
from mpc_planner_tpu_torch.solver.ocp import OCP
from mpc_planner_tpu_torch.solver.sqp import SQPSolver
from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
from mpc_planner_tpu_torch.types import ModuleData, RealTimeData, State
from mpc_planner_tpu_torch.utils.config import default_config

pytestmark = pytest.mark.cuda

B = 64
N = 30


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


@pytest.fixture(scope="module")
def jackal(device):
    """A fused-route solver for system_jackal("goal") (N=30, nh=12) and a
    batch of perturbed warm starts around the corridor scene."""
    cfg, model, modules = presets.system_jackal("goal", N=N)
    cfg = cfg.replace(solver=cfg.solver.__class__(rti_fused="on"))
    state, data = presets.corridor_scene(cfg, n_pedestrians=12, seed=0)
    ocp = OCP(model, modules, cfg)
    solver = SQPSolver(ocp, device=device)
    assert solver.rti_fused and solver.qp_backend == "cuda"
    pblock = ParameterBlock(ocp.params, N + 1)
    modules.set_parameters_all(data, ModuleData(), pblock)
    pblock.data[N] = pblock.data[N - 1]
    rng = np.random.default_rng(0)
    Z0 = np.tile(initialize_with_state(model, N, state)[None], (B, 1, 1)).astype(np.float32)
    Z0[:, 1:, model.nu:] += rng.normal(0, 0.05, Z0[:, 1:, model.nu:].shape).astype(np.float32)
    Z0 = torch.as_tensor(Z0, device=device)
    x0 = torch.as_tensor(state.as_array(), dtype=torch.float32, device=device).expand(B, -1)
    Z0[:, 0, model.nu:] = x0
    P = torch.as_tensor(pblock.data, dtype=torch.float32, device=device).expand(B, -1, -1)
    kw = dict(lb_template=solver._lb_template, ub_template=solver._ub_template,
              num_iterations=10, warm_iters=solver.warm_qp_iters, mu0=solver.mu0,
              sigma_fixed=solver.warm_sigma, lm=solver.lm, mirror_x_only=solver._mirror_x_only)
    return dict(solver=solver, ocp=ocp, Z0=Z0, P=P, x0=x0, kw=kw)


@pytest.mark.parametrize("warm", [False, True])
def test_rti_kernel_matches_plain(jackal, warm):
    s, kw = jackal["solver"], jackal["kw"]
    Z0, P = jackal["Z0"], jackal["P"]
    args = dict(kw, it0=s.qp_iterations)
    if warm:  # the next cycle, from the plain cold solve with its duals
        first = solve_rti_torch(Z0, P, jackal["ocp"], **args)
        Z0 = first.Z
        args = dict(kw, it0=s.warm_qp_iters, warm_duals=(first.lam_l, first.lam_u, first.mu < 1e-2))
    ref = solve_rti_torch(Z0, P, jackal["ocp"], **args)
    cuda_qp.reset_launch_counts()
    out = solve_rti_cuda(Z0, P, s._stage_code, **args)
    torch.cuda.synchronize()
    assert cuda_qp.launch_counts["rti"] == 1
    assert _rel(out.Z, ref.Z) < 5e-3
    codes, codes_ref = s._exit_codes(out.Z, P)[0], s._exit_codes(ref.Z, P)[0]
    assert int((codes != codes_ref).sum()) <= 1


@pytest.mark.parametrize("mirror_x_only", [True, False])
def test_rti_kernel_without_general_rows(device, mirror_x_only):
    """nh=0 (goal tracking on the 4-state unicycle, N=10): K3 built for a
    second OCP, with the x-only and the full MIRROR."""
    cfg = default_config(N=10)
    model = SecondOrderUnicycleModel()
    modules = ModuleManager()
    base = modules.add_module(MPCBaseModule(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    modules.add_module(GoalModule(cfg))
    ocp = OCP(model, modules, cfg)
    solver = SQPSolver(ocp, device=device)
    data = RealTimeData()
    data.goal = np.array([4.0, 1.0])
    data.goal_received = True
    pblock = ParameterBlock(ocp.params, cfg.N + 1)
    modules.set_parameters_all(data, ModuleData(), pblock)
    rng = np.random.default_rng(1)
    Z0 = np.tile(initialize_with_state(model, cfg.N, State(model))[None], (B, 1, 1)).astype(np.float32)
    Z0[:, 1:, model.nu:] += rng.normal(0, 0.05, Z0[:, 1:, model.nu:].shape).astype(np.float32)
    Z0 = torch.as_tensor(Z0, device=device)
    P = torch.as_tensor(pblock.data, dtype=torch.float32, device=device).expand(B, -1, -1)
    kw = dict(lb_template=solver._lb_template, ub_template=solver._ub_template, num_iterations=3,
              it0=10, warm_iters=4, lm=solver.lm, mirror_x_only=mirror_x_only)
    ref = solve_rti_torch(Z0, P, ocp, **kw)
    out = solve_rti_cuda(Z0, P, StageCode(ocp), **kw)
    torch.cuda.synchronize()
    assert _rel(out.Z, ref.Z) < 5e-3


def test_linearize_kernel_matches_unfused(jackal):
    """K3's linearization vs SQPSolver._linearize (cuda backend: MIRROR in
    K2); the terminal u-block (lm*I unfused, 0 in K3, never read by the
    QP) is masked, and bounds are compared on active rows."""
    s, Z, P = jackal["solver"], jackal["Z0"], jackal["P"]
    nu, nvar = s.ocp.nu, s.ocp.nvar
    ref = s._linearize(Z, P)
    out = linearize_cuda(Z, P, s._stage_code, lb_template=s._lb_template,
                         ub_template=s._ub_template, lm=s.lm, mirror_x_only=s._mirror_x_only)
    torch.cuda.synchronize()
    keep = torch.ones_like(ref.H)
    keep[:, -1, :nu, :] = 0
    keep[:, -1, :, :nu] = 0
    assert _rel(out.H * keep, ref.H * keep) < 1e-4
    for f in ("g", "A", "B", "c"):
        assert _rel(getattr(out, f), getattr(ref, f)) < 1e-4, f
    assert _rel(out.D[:, :, nvar:], ref.D[:, :, nvar:]) < 1e-4
    assert _rel(out.lb * ref.mask_l, ref.lb * ref.mask_l) < 1e-4
    assert _rel(out.ub * ref.mask_u, ref.ub * ref.mask_u) < 1e-4
    assert torch.equal(out.mask_l, ref.mask_l) and torch.equal(out.mask_u, ref.mask_u)


def test_fused_route_solve_batch_matches_unfused(jackal):
    """solve_batch on the fused route launches K3 only, and agrees with the
    unfused route (K1 + K2) of the same OCP."""
    s = jackal["solver"]
    cfg = s.ocp.cfg.replace(solver=s.ocp.cfg.solver.__class__(rti_fused="off"))
    unfused = SQPSolver(OCP(s.ocp.model, s.ocp.modules, cfg), device=s.device)
    assert not unfused.rti_fused
    args = (jackal["Z0"], jackal["P"], jackal["x0"])
    cuda_qp.reset_launch_counts()
    res = s.solve_batch(*args)
    torch.cuda.synchronize()
    assert cuda_qp.launch_counts["rti"] >= 1
    assert cuda_qp.launch_counts["qp"] == 0 and cuda_qp.launch_counts["mirror"] == 0
    ref = unfused.solve_batch(*args)
    assert int((res.exit_code != ref.exit_code).sum()) <= 1
    assert float((res.Z - ref.Z).abs().max()) < 5e-3


@pytest.fixture(scope="module")
def flagship(device):
    """A fused-route solver for the flagship OCP (configuration_tmpc,
    N=20, nh=24) and a batch of perturbed converged plans of the batch
    workload's instance (a control loop's warm starts)."""
    cfg = default_config(N=20)
    cfg = cfg.replace(solver=cfg.solver.__class__(rti_fused="on"))
    model, ocp, Z0, P, x0 = presets.flagship_problem(cfg)
    solver = SQPSolver(ocp, device=device)
    assert solver.rti_fused and ocp.nh == 24
    g = torch.Generator(device=device).manual_seed(3)
    Z0 = torch.as_tensor(Z0, dtype=torch.float32, device=device).expand(B, -1, -1).clone()
    Z0[:, 1:, model.nu:] += 0.05 * torch.randn(Z0[:, 1:, model.nu:].shape, device=device, generator=g)
    P = torch.as_tensor(P, dtype=torch.float32, device=device).expand(B, -1, -1)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device).expand(B, -1)
    Zs = solver.batch_impl(Z0, P, x0, 10).Z
    Zp = Zs + 0.01 * torch.randn(Zs.shape, device=device, generator=g)
    Zp[:, 0, model.nu:] = x0
    kw = dict(lb_template=solver._lb_template, ub_template=solver._ub_template,
              num_iterations=10, warm_iters=solver.warm_qp_iters, mu0=solver.mu0,
              sigma_fixed=solver.warm_sigma, lm=solver.lm, mirror_x_only=solver._mirror_x_only)
    return dict(solver=solver, ocp=ocp, Z0=Zp, P=P, x0=x0, kw=kw)


@pytest.mark.parametrize("warm", [False, True])
def test_rti_kernel_flagship_matches_plain(flagship, warm):
    test_rti_kernel_matches_plain(flagship, warm)


def test_linearize_kernel_flagship_matches_unfused(flagship):
    test_linearize_kernel_matches_unfused(flagship)


@pytest.fixture(scope="module", params=["bicycle", "jackal_tmpc_gaussian"])
def new_ocp(request, device):
    """A default-route solver (rti_fused="auto" must resolve on) for an OCP
    with the new generated ops, and a batch of perturbed converged plans:
    the bicycle (configuration_bicycle: tan, atan, Dual2<9>; N=30) and the
    real Jackal's T-MPC with Gaussian chance constraints (log, exp, erf;
    N=30, nh=24)."""
    if request.param == "bicycle":
        cfg = default_config(N=N)
        model, modules = presets.configuration_bicycle(cfg)
    else:
        cfg, model, modules = presets.system_jackal("tmpc")
    ocp, Z0, P, x0 = presets.preset_problem(cfg, model, modules, n_pedestrians=8, seed=0)
    solver = SQPSolver(ocp, device=device)
    assert solver.rti_fused and solver.rti_fused_reason == ""
    g = torch.Generator(device=device).manual_seed(5)
    Z0 = torch.as_tensor(Z0, dtype=torch.float32, device=device).expand(B, -1, -1).clone()
    Z0[:, 1:, model.nu:] += 0.05 * torch.randn(Z0[:, 1:, model.nu:].shape, device=device, generator=g)
    P = torch.as_tensor(P, dtype=torch.float32, device=device).expand(B, -1, -1)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device).expand(B, -1)
    Zs = solver.batch_impl(Z0, P, x0, 10).Z
    Zp = Zs + 0.01 * torch.randn(Zs.shape, device=device, generator=g)
    Zp[:, 0, model.nu:] = x0
    kw = dict(lb_template=solver._lb_template, ub_template=solver._ub_template,
              num_iterations=10, warm_iters=solver.warm_qp_iters, mu0=solver.mu0,
              sigma_fixed=solver.warm_sigma, lm=solver.lm, mirror_x_only=solver._mirror_x_only)
    return dict(solver=solver, ocp=ocp, Z0=Zp, P=P, x0=x0, kw=kw)


@pytest.mark.parametrize("warm", [False, True])
def test_rti_kernel_new_ocps_match_plain(new_ocp, warm):
    test_rti_kernel_matches_plain(new_ocp, warm)


def test_linearize_kernel_new_ocps_match_unfused(new_ocp):
    test_linearize_kernel_matches_unfused(new_ocp)


def test_rti_wrapper_rejects_bad_input(jackal):
    s, kw = jackal["solver"], jackal["kw"]
    Z0, P = jackal["Z0"], jackal["P"]
    with pytest.raises(ValueError):
        solve_rti_cuda(Z0.double(), P, s._stage_code, **dict(kw, it0=9))
    with pytest.raises(ValueError):
        solve_rti_cuda(Z0, P, s._stage_code, **dict(kw, it0=9, num_iterations=0))


@pytest.mark.parametrize("mapping", riccati_probe.MAPPINGS)
def test_riccati_probe_matches_plain(device, mapping):
    """E=999: a ragged last block and an odd count for the interleaved pair."""
    H, A, Bm = (torch.as_tensor(x, device=device)
                for x in riccati_probe.make_data(np.random.default_rng(3), 999))
    ref = riccati_probe.factor_chain_torch(*(x.movedim(-1, 0).contiguous() for x in (H, A, Bm)))
    cuda_qp.reset_launch_counts()
    P = riccati_probe.factor_chain_cuda(H, A, Bm, mapping)
    torch.cuda.synchronize()
    assert cuda_qp.launch_counts["riccati_probe"] == 1
    assert float((P - ref.movedim(0, -1)).abs().max()) < riccati_probe.TOLERANCE


@pytest.mark.parametrize("batch", [1, 5, 33])
@pytest.mark.parametrize("shape", ["goal_N30", "flagship_N20"])
def test_rti_kernel_small_and_ragged_batches(jackal, flagship, shape, batch):
    """One block per element: any batch size launches, at N+1 = 31 and 21
    stages on the lanes, and each element's answer does not depend on the
    batch it came in."""
    case = jackal if shape == "goal_N30" else flagship
    s = case["solver"]
    Z0, P = case["Z0"][:batch].contiguous(), case["P"][:batch]
    args = dict(case["kw"], it0=s.qp_iterations)
    ref = solve_rti_torch(Z0, P, case["ocp"], **args)
    out = solve_rti_cuda(Z0, P, s._stage_code, **args)
    full = solve_rti_cuda(case["Z0"], case["P"], s._stage_code, **args)
    torch.cuda.synchronize()
    assert out.Z.shape == ref.Z.shape and out.Z.is_contiguous()
    assert _rel(out.Z, ref.Z) < 5e-3
    for f in ("Z", "lam_l", "lam_u", "mu"):
        assert torch.equal(getattr(out, f), getattr(full, f)[:batch]), f


def test_rti_kernel_warm_duals_with_mixed_ok(flagship):
    """The next cycle with the previous duals accepted for every second
    element only: the others start their first QP cold in the same launch."""
    s, kw = flagship["solver"], flagship["kw"]
    P = flagship["P"]
    first = solve_rti_torch(flagship["Z0"], P, flagship["ocp"], **dict(kw, it0=s.qp_iterations))
    ok = torch.arange(B, device=P.device) % 2 == 0
    args = dict(kw, it0=s.warm_qp_iters, warm_duals=(first.lam_l, first.lam_u, ok))
    ref = solve_rti_torch(first.Z, P, flagship["ocp"], **args)
    out = solve_rti_cuda(first.Z, P, s._stage_code, **args)
    torch.cuda.synchronize()
    assert _rel(out.Z, ref.Z) < 5e-3
    assert _rel(out.lam_l, ref.lam_l) < 5e-3


def test_rti_kernel_nan_element_stays_alone(flagship):
    """A NaN in one element's parameters: its QPs never take a finite step,
    so the warp leaves its Z where it started; its neighbours' answers are
    those of a launch without it."""
    s, kw = flagship["solver"], flagship["kw"]
    Z0 = flagship["Z0"][:5].contiguous()
    P = flagship["P"][:5].clone()
    args = dict(kw, it0=s.qp_iterations)
    clean = solve_rti_cuda(Z0, P, s._stage_code, **args)
    P[2] = float("nan")
    out = solve_rti_cuda(Z0, P, s._stage_code, **args)
    torch.cuda.synchronize()
    assert torch.equal(out.Z[2], Z0[2])
    healthy = [0, 1, 3, 4]
    assert torch.isfinite(out.Z[healthy]).all()
    for f in ("Z", "lam_l", "lam_u", "mu"):
        assert torch.equal(getattr(out, f)[healthy], getattr(clean, f)[healthy]), f


def test_rti_kernel_large_batch_keeps_the_qp_in_global_scratch(flagship):
    """The launcher keeps an element's linearized QP in shared memory only
    while the whole batch is resident on the card at once; the fixture's
    B=64 is, a few copies of it are not, so that launch writes its QPs to
    global scratch. Same arithmetic: the answers are those of the B=64
    launch."""
    s = flagship["solver"]
    args = dict(flagship["kw"], it0=s.qp_iterations)
    staged = load_rti(s._stage_code).mpc_rti_shared_bytes(flagship["Z0"].shape[1] - 1, 1)
    resident = cuda_qp.load_kernels().qp_resident_blocks(staged)
    assert B <= resident
    n = resident // B + 1
    small = solve_rti_cuda(flagship["Z0"], flagship["P"], s._stage_code, **args)
    out = solve_rti_cuda(flagship["Z0"].repeat(n, 1, 1), flagship["P"].repeat(n, 1, 1),
                         s._stage_code, **args)
    torch.cuda.synchronize()
    assert _rel(out.Z, small.Z.repeat(n, 1, 1)) < 1e-5
    assert _rel(out.lam_l, small.lam_l.repeat(n, 1, 1)) < 1e-5
    assert _rel(out.mu, small.mu.repeat(n)) < 1e-4
