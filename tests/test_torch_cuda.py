"""Hand-written CUDA kernels K1 (QP) and K2 (MIRROR) vs their plain torch
versions, on a CUDA GPU. Skipped without one (the decision is made in the
`device` fixture). The machine with the card has no JAX, so this file
imports only the port; run it there without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes: system_jackal("goal") (N=30, nh=12) and the T-MPC++ flagship
OCP (configuration_tmpc at N=20, nh=24, nrows=31: the batch workload).

Tolerances: MIRROR 1e-5 of max |H| (same rotations, FMA rounding only);
QP 5e-3 of max |ref| on dz and lambda (closed-form R-hat inverse, a
carried D zeta and row sums taken as 32 partial sums in the kernel vs
Cholesky, a recomputed D zeta and torch's sums in the plain version: the
reference's own kernel-vs-XLA bound).

K1 runs one warp per batch element (one block each), so the cases also
cover batches of 1, 5 and 33 elements, an element whose data holds a NaN
beside healthy ones, warm duals accepted for some elements only, and both
horizons (N+1 = 31 and 21).

K1 with the MIRROR inside (raw Hessians in, `mirror_lm`) against its plain
version (mirror_nvar, then solve_qp), 5e-3, at the flagship shape and at the
three (nu, nx) no earlier OCP reached: (3, 6) the bicycle (N=30), (2, 4)
dingo's point mass (N=30), (3, 5) rosnavigation's slack T-MPC with decomp
rows (N=20, nh=36), in both launch modes. `rti_fused="auto"` resolves on
for every buildable preset, and off, with a reason, for an OCP with an op
the stage-code generator does not cover.
"""

from dataclasses import replace as dataclass_replace

import numpy as np
import pytest
import torch

from mpc_planner_tpu_torch import presets
from mpc_planner_tpu_torch.models import SecondOrderUnicycleModel
from mpc_planner_tpu_torch.modules import GoalModule, ModuleManager, MPCBaseModule
from mpc_planner_tpu_torch.ops import cuda_qp
from mpc_planner_tpu_torch.ops.jacobi_eigh import mirror_unpacked
from mpc_planner_tpu_torch.parameters import ParameterBlock
from mpc_planner_tpu_torch.solver.ocp import OCP
from mpc_planner_tpu_torch.solver.qp import solve_qp
from mpc_planner_tpu_torch.solver.sqp import SQPSolver
from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
from mpc_planner_tpu_torch.types import ModuleData, RealTimeData, State
from mpc_planner_tpu_torch.utils.config import default_config

pytestmark = pytest.mark.cuda

B = 64


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_qp.load_kernels()
    return torch.device("cuda:0")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


@pytest.mark.parametrize("n", range(2, 10))
def test_mirror_kernel_matches_plain(device, n):
    g = torch.Generator(device=device).manual_seed(n)
    H = torch.randn(500, n, n, device=device, generator=g)
    H = 0.5 * (H + H.mT)
    out = cuda_qp.mirror_cuda(H, 1e-3)
    torch.cuda.synchronize()
    assert _rel(out, mirror_unpacked(H, 1e-3)) < 1e-5


def test_mirror_wrapper_counts_and_checks(device):
    H = torch.eye(5, device=device).expand(3, 5, 5).contiguous()
    cuda_qp.reset_launch_counts()
    cuda_qp.mirror_cuda(H, 1e-6)
    assert cuda_qp.launch_counts["mirror"] == 1
    with pytest.raises(ValueError):
        cuda_qp.mirror_cuda(H.double(), 1e-6)
    with pytest.raises(ValueError):
        cuda_qp.mirror_cuda(torch.eye(10, device=device)[None], 1e-6)
    assert cuda_qp.launch_counts["mirror"] == 1


def _solver_and_batch(model, modules, cfg, data, state, device, noise=0.05):
    ocp = OCP(model, modules, cfg)
    solver = SQPSolver(ocp, device=device)
    pblock = ParameterBlock(ocp.params, cfg.N + 1)
    modules.set_parameters_all(data, ModuleData(), pblock)
    pblock.data[cfg.N] = pblock.data[cfg.N - 1]
    g = torch.Generator(device=device).manual_seed(0)
    Z0 = torch.as_tensor(initialize_with_state(model, cfg.N, state), dtype=torch.float32,
                         device=device).expand(B, -1, -1).clone()
    Z0[:, 1:, model.nu:] += noise * torch.randn(Z0[:, 1:, model.nu:].shape, device=device, generator=g)
    P = torch.as_tensor(pblock.data, dtype=torch.float32, device=device).expand(B, -1, -1)
    x0 = torch.as_tensor(state.as_array(), dtype=torch.float32, device=device).expand(B, -1)
    return solver, Z0, P, x0


@pytest.fixture(scope="module")
def jackal(device):
    """QPs of system_jackal("goal") (N=30, nh=12) around perturbed
    converged plans, and the next RTI iteration's QPs with warm duals."""
    cfg, model, modules = presets.system_jackal("goal", N=30)
    cfg = cfg.replace(solver=cfg.solver.__class__(qp_backend="torch"))
    state, data = presets.corridor_scene(cfg, n_pedestrians=12, seed=0)
    solver, Z0, P, x0 = _solver_and_batch(model, modules, cfg, data, state, device)
    g = torch.Generator(device=device).manual_seed(1)
    Zs = solver.batch_impl(Z0, P, x0, 10).Z
    Zp = Zs + 0.01 * torch.randn(Zs.shape, device=device, generator=g)
    qp = solver._linearize(Zp, P)
    first = solve_qp(qp, model.nu, model.nx, iterations=9)
    qp_next = solver._linearize(Zp + first.dz, P)
    return dict(model=model, qp=qp, qp_next=qp_next,
                warm=(first.lam_l, first.lam_u, first.mu < 1e-2))


@pytest.mark.parametrize("mehrotra", [True, False])
@pytest.mark.parametrize("warm", [False, True])
def test_qp_kernel_matches_plain(jackal, warm, mehrotra):
    m = jackal["model"]
    qp = jackal["qp_next"] if warm else jackal["qp"]
    kw = dict(iterations=4 if warm else 9, mehrotra=mehrotra,
              warm_duals=jackal["warm"] if warm else None)
    ref = solve_qp(qp, m.nu, m.nx, **kw)
    cuda_qp.reset_launch_counts()
    out = cuda_qp.solve_qp_cuda(qp, m.nu, m.nx, **kw)
    torch.cuda.synchronize()
    assert cuda_qp.launch_counts["qp"] == 1
    for f in ("dz", "lam_l", "lam_u", "mu"):
        assert _rel(getattr(out, f), getattr(ref, f)) < 5e-3, f


@pytest.fixture(scope="module")
def flagship(device):
    """QPs of the flagship OCP (configuration_tmpc, N=20, nh=24) around
    perturbed converged plans of the batch workload's instance, and the
    next RTI iteration's QPs with warm duals."""
    cfg = default_config(N=20)
    cfg = cfg.replace(solver=cfg.solver.__class__(qp_backend="torch"))
    model, ocp, Z0, P, x0 = presets.flagship_problem(cfg)
    assert (ocp.nh, ocp.nvar + ocp.nh) == (24, 31)
    solver = SQPSolver(ocp, device=device)
    g = torch.Generator(device=device).manual_seed(2)
    Z0 = torch.as_tensor(Z0, dtype=torch.float32, device=device).expand(B, -1, -1).clone()
    Z0[:, 1:, model.nu:] += 0.05 * torch.randn(Z0[:, 1:, model.nu:].shape, device=device, generator=g)
    P = torch.as_tensor(P, dtype=torch.float32, device=device).expand(B, -1, -1)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device).expand(B, -1)
    Zs = solver.batch_impl(Z0, P, x0, 10).Z
    Zp = Zs + 0.01 * torch.randn(Zs.shape, device=device, generator=g)
    qp = solver._linearize(Zp, P)
    first = solve_qp(qp, model.nu, model.nx, iterations=9)
    qp_next = solver._linearize(Zp + first.dz, P)
    return dict(model=model, qp=qp, qp_next=qp_next,
                warm=(first.lam_l, first.lam_u, first.mu < 1e-2),
                raw=_raw_qps(solver, Zp, P))


def _raw_qps(solver, Zp, P):
    """The QPs at Zp with their RAW Hessians, the plain cold solve (MIRROR,
    then solve_qp), and the next QPs with its duals: what K1 gets from the
    solver's unfused route."""
    m = solver.ocp.model
    kw = dict(mirror_lm=solver.lm, mirror_x_only=solver._mirror_x_only)
    qp = solver._linearize(Zp, P, raw_hessian=True)
    first = solve_qp(cuda_qp._mirrored(qp, m.nu, kw["mirror_lm"], kw["mirror_x_only"]), m.nu, m.nx,
                     iterations=9)
    qp_next = solver._linearize(Zp + first.dz, P, raw_hessian=True)
    return dict(model=m, qp=qp, qp_next=qp_next, first=first, kw=kw,
                warm=(first.lam_l, first.lam_u, first.mu < 1e-2))


def _check_mirror_qp(raw, warm):
    """K1 on raw Hessians against mirror_nvar + solve_qp: cold with
    Mehrotra, or warm duals with a fixed sigma."""
    m, kw = raw["model"], raw["kw"]
    qp = raw["qp_next"] if warm else raw["qp"]
    args = dict(iterations=4 if warm else 9, mehrotra=not warm,
                warm_duals=raw["warm"] if warm else None)
    ref = solve_qp(cuda_qp._mirrored(qp, m.nu, kw["mirror_lm"], kw["mirror_x_only"]), m.nu, m.nx,
                   **args)
    cuda_qp.reset_launch_counts()
    out = cuda_qp.solve_qp_cuda(qp, m.nu, m.nx, **args, **kw)
    torch.cuda.synchronize()
    assert cuda_qp.launch_counts["qp"] == 1 and cuda_qp.launch_counts["mirror"] == 0
    scale = float(raw["first"].dz.abs().max())  # a warm step may be ~0 itself
    assert float((out.dz - ref.dz).abs().max()) < 5e-3 * max(float(ref.dz.abs().max()), scale)
    for f in ("lam_l", "lam_u", "mu"):
        assert torch.isfinite(getattr(out, f)).all(), f
        assert _rel(getattr(out, f), getattr(ref, f)) < 5e-3, f
    return out


@pytest.mark.parametrize("warm", [False, True], ids=["cold_mehrotra", "warm_fixed_sigma"])
def test_qp_kernel_with_mirror_flagship_matches_plain(flagship, warm):
    _check_mirror_qp(flagship["raw"], warm)


def test_qp_kernel_with_mirror_full_and_x_only_agree(flagship):
    """The probe found the flagship's u-block diagonal and decoupled: the
    full 7 x 7 Jacobi and the x-only one then regularize alike (1e-4)."""
    raw = flagship["raw"]
    m = raw["model"]
    assert raw["kw"]["mirror_x_only"]
    a = cuda_qp.solve_qp_cuda(raw["qp"], m.nu, m.nx, iterations=9, **raw["kw"])
    b = cuda_qp.solve_qp_cuda(raw["qp"], m.nu, m.nx, iterations=9,
                              mirror_lm=raw["kw"]["mirror_lm"], mirror_x_only=False)
    torch.cuda.synchronize()
    assert _rel(a.dz, b.dz) < 1e-3


def test_qp_kernel_with_mirror_large_batch(device, flagship):
    """Past the resident batch the launcher keeps the QP in global memory;
    the MIRROR runs there too, and the answers are those of the B=64 launch."""
    raw = flagship["raw"]
    m, qp = raw["model"], raw["qp"]
    ext = cuda_qp.load_kernels()
    Np1, nrows, nvar = qp.D.shape[1:]
    resident = ext.qp_resident_blocks(ext.qp_shared_bytes(Np1 - 1, m.nu, m.nx, nrows - nvar, True, True))
    assert B <= resident
    copies = resident // B + 1

    def tiled(x):
        return x.repeat(copies, *([1] * (x.dim() - 1)))

    big = qp._replace(**{f: tiled(getattr(qp, f)) for f in qp._fields})
    small = cuda_qp.solve_qp_cuda(qp, m.nu, m.nx, iterations=9, **raw["kw"])
    out = cuda_qp.solve_qp_cuda(big, m.nu, m.nx, iterations=9, **raw["kw"])
    torch.cuda.synchronize()
    for f in ("dz", "lam_l", "lam_u", "mu"):
        assert _rel(getattr(out, f), tiled(getattr(small, f))) < 1e-5, f


def test_qp_mirror_global_scratch_only_where_it_saves_a_wave(device):
    """The regularized Hessians go to a global scratch (which the wrapper
    then allocates) only where shared memory would cost the batch a wave of
    blocks: on an H100, the goal shape at N=30, B=1024 (924 resident blocks
    with the triangles, 1,056 without); never in the staged mode."""
    ext = cuda_qp.load_kernels()
    with_t = ext.qp_resident_blocks(ext.qp_shared_bytes(30, 2, 5, 12, False, True))
    without = ext.qp_resident_blocks(ext.qp_shared_bytes(30, 2, 5, 12, False, False))
    assert with_t < without
    assert ext.qp_mirror_in_global(without, 30, 2, 5, 12)  # one wave instead of two
    assert not ext.qp_mirror_in_global(with_t, 30, 2, 5, 12)  # one wave either way
    assert not ext.qp_mirror_in_global(5, 30, 2, 5, 12)  # staged


def _new_family(name):
    """(cfg, model, modules, costmap) of a family whose (nu, nx) no earlier
    OCP reached, at its system's horizon."""
    if name == "bicycle":
        cfg = default_config(N=30)
        return (cfg, *presets.configuration_bicycle(cfg), False)
    if name == "dingo_lmpcc":
        return (*presets.system_dingo("lmpcc"), False)
    return (*presets.system_rosnavigation("tmpc"), True)


@pytest.fixture(scope="module", params=["bicycle", "dingo_lmpcc", "rosnavigation_tmpc"])
def new_family(request, device):
    cfg, model, modules, costmap = _new_family(request.param)
    cfg = cfg.replace(solver=dataclass_replace(cfg.solver, qp_backend="torch", iterations=10))
    ocp, Z0, P, x0 = presets.preset_problem(cfg, model, modules, n_pedestrians=8, seed=0,
                                            costmap=costmap)
    solver = SQPSolver(ocp, device=device)
    g = torch.Generator(device=device).manual_seed(4)
    Z0 = torch.as_tensor(Z0, dtype=torch.float32, device=device).expand(B, -1, -1).clone()
    Z0[:, 1:, model.nu:] += 0.05 * torch.randn(Z0[:, 1:, model.nu:].shape, device=device, generator=g)
    P = torch.as_tensor(P, dtype=torch.float32, device=device).expand(B, -1, -1)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device).expand(B, -1)
    Zs = solver.batch_impl(Z0, P, x0, 10).Z
    Zp = Zs + 0.01 * torch.randn(Zs.shape, device=device, generator=g)
    return _raw_qps(solver, Zp, P)


@pytest.mark.parametrize("warm", [False, True], ids=["cold_mehrotra", "warm_fixed_sigma"])
def test_qp_kernel_with_mirror_at_new_shapes(new_family, warm):
    m = new_family["model"]
    assert (m.nu, m.nx) in {(3, 6), (2, 4), (3, 5)}
    _check_mirror_qp(new_family, warm)


PRESETS = [("jackalsimulator", v) for v in ("tmpc", "basic", "no_obstacles", "lmpcc",
                                            "curvature_aware", "tmpc_ca", "safe_horizon",
                                            "safe_horizon_hard")] + [
    ("jackal", v) for v in ("tmpc", "ca", "goal", "lmpcc")] + [
    ("dingo", "tmpc"), ("dingo", "lmpcc"), ("rosnavigation", "tmpc"), ("rosnavigation", "lmpcc"),
    ("rosnavigation", "safe_horizon")]


@pytest.mark.parametrize("name,variant", PRESETS)
def test_rti_fused_auto_resolves_on_for_every_preset(device, name, variant):
    cfg, model, modules = presets.select_system(name, variant)
    solver = SQPSolver(OCP(model, modules, cfg))  # no device given: the card
    assert solver.device.type == "cuda" and solver.qp_backend == "cuda"
    assert solver.rti_fused and solver.rti_fused_reason == ""


def test_rti_fused_auto_resolves_off_for_an_unsupported_op(device):
    class Cosh(GoalModule):  # cosh: an op the stage-code generator does not cover
        def cost(self, model, params, cfg, stage_idx):
            return super().cost(model, params, cfg, stage_idx) + torch.cosh(model.get("v"))

    cfg = default_config(N=10)
    modules = ModuleManager()
    base = modules.add_module(MPCBaseModule(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    modules.add_module(Cosh(cfg))
    ocp = OCP(SecondOrderUnicycleModel(), modules, cfg)
    solver = SQPSolver(ocp, device=device)
    assert not solver.rti_fused and solver.qp_backend == "cuda"
    assert "cosh" in solver.rti_fused_reason and "running_cost" in solver.rti_fused_reason
    on = cfg.replace(solver=cfg.solver.__class__(rti_fused="on"))
    with pytest.raises(ValueError, match="cosh"):
        SQPSolver(OCP(SecondOrderUnicycleModel(), modules, on), device=device)


@pytest.mark.parametrize("warm", [False, True], ids=["cold_mehrotra", "warm_fixed_sigma"])
def test_qp_kernel_flagship_matches_plain(flagship, warm):
    """K1's general-row path at nh=24: cold with Mehrotra, warm duals with
    a fixed sigma (the RTI loop's two kinds of QP)."""
    m = flagship["model"]
    qp = flagship["qp_next"] if warm else flagship["qp"]
    kw = dict(iterations=4 if warm else 9, mehrotra=not warm,
              warm_duals=flagship["warm"] if warm else None)
    ref = solve_qp(qp, m.nu, m.nx, **kw)
    cuda_qp.reset_launch_counts()
    out = cuda_qp.solve_qp_cuda(qp, m.nu, m.nx, **kw)
    torch.cuda.synchronize()
    assert cuda_qp.launch_counts["qp"] == 1
    for f in ("dz", "lam_l", "lam_u", "mu"):
        assert _rel(getattr(out, f), getattr(ref, f)) < 5e-3, f


def test_qp_kernel_without_general_rows(device):
    """nh=0 (goal tracking on the 4-state unicycle): the kernel gets the
    one-row dummy Dh and its (nu=2, nx=4) instantiation."""
    cfg = default_config(N=10)
    model = SecondOrderUnicycleModel()
    modules = ModuleManager()
    base = modules.add_module(MPCBaseModule(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    modules.add_module(GoalModule(cfg))
    data = RealTimeData()
    data.goal = np.array([4.0, 1.0])
    data.goal_received = True
    solver, Z0, P, x0 = _solver_and_batch(model, modules, cfg, data, State(model), device)
    qp = solver._linearize(Z0, P)
    ref = solve_qp(qp, model.nu, model.nx, iterations=8)
    out = cuda_qp.solve_qp_cuda(qp, model.nu, model.nx, iterations=8)
    torch.cuda.synchronize()
    assert _rel(out.dz, ref.dz) < 5e-3
    assert _rel(out.lam_l, ref.lam_l) < 5e-3


def test_qp_wrapper_rejects_unsupported(device, jackal):
    m = jackal["model"]
    with pytest.raises(ValueError):
        cuda_qp.solve_qp_cuda(jackal["qp"], 4, 3, iterations=1)  # no (4, 3) instantiation
    bad = jackal["qp"]._replace(H=jackal["qp"].H.double())
    with pytest.raises(ValueError):
        cuda_qp.solve_qp_cuda(bad, m.nu, m.nx, iterations=1)


def test_sqp_cuda_backend_matches_torch(device):
    """The whole batched SQP-RTI solve on both backends (N=10, B=64)."""
    cfg, model, modules = presets.system_jackal("goal", N=10)
    state, data = presets.corridor_scene(cfg, n_pedestrians=12, seed=0)
    results = {}
    for backend in ("cuda", "torch"):
        c = cfg.replace(solver=cfg.solver.__class__(qp_backend=backend))
        solver, Z0, P, x0 = _solver_and_batch(model, modules, c, data, state, device)
        assert solver.qp_backend == backend
        results[backend] = solver.solve_batch(Z0, P, x0)
    a, b = results["cuda"], results["torch"]
    assert torch.equal(a.exit_code, b.exit_code)
    assert float((a.Z - b.Z).abs().max()) < 5e-3


def _slice(qp, idx):
    return qp._replace(**{f: getattr(qp, f)[idx].contiguous() for f in qp._fields})


@pytest.mark.parametrize("batch", [1, 5, 33])
@pytest.mark.parametrize("shape", ["goal_N30", "flagship_N20"])
def test_qp_kernel_small_and_ragged_batches(jackal, flagship, shape, batch):
    """One block per element: any batch size launches, N+1 = 31 (nh=12) and
    N+1 = 21 (nh=24), and each element's answer does not depend on the
    batch it came in."""
    case = jackal if shape == "goal_N30" else flagship
    m = case["model"]
    qp = _slice(case["qp"], slice(0, batch))
    ref = solve_qp(qp, m.nu, m.nx, iterations=9)
    out = cuda_qp.solve_qp_cuda(qp, m.nu, m.nx, iterations=9)
    full = cuda_qp.solve_qp_cuda(case["qp"], m.nu, m.nx, iterations=9)
    torch.cuda.synchronize()
    for f in ("dz", "lam_l", "lam_u", "mu"):
        assert getattr(out, f).shape == getattr(ref, f).shape
        assert getattr(out, f).is_contiguous()
        assert _rel(getattr(out, f), getattr(ref, f)) < 5e-3, f
        assert torch.equal(getattr(out, f), getattr(full, f)[:batch]), f


def test_qp_kernel_nan_element_freezes_alone(flagship):
    """A NaN in one element's g: its step is never finite, so the warp
    freezes that element (dz stays 0, the duals stay at their start) and
    the elements around it are solved as if it were not there."""
    m = flagship["model"]
    qp = _slice(flagship["qp"], slice(0, 5))
    g = qp.g.clone()
    g[2, 7, 3] = float("nan")
    bad = qp._replace(g=g)
    ref = solve_qp(bad, m.nu, m.nx, iterations=9)
    out = cuda_qp.solve_qp_cuda(bad, m.nu, m.nx, iterations=9)
    clean = cuda_qp.solve_qp_cuda(qp, m.nu, m.nx, iterations=9)
    torch.cuda.synchronize()
    assert float(out.dz[2].abs().max()) == 0.0 and float(ref.dz[2].abs().max()) == 0.0
    assert _rel(out.lam_l[2], ref.lam_l[2]) < 1e-5 and _rel(out.lam_u[2], ref.lam_u[2]) < 1e-5
    assert _rel(out.mu[2:3], ref.mu[2:3]) < 1e-4
    healthy = [0, 1, 3, 4]
    for f in ("dz", "lam_l", "lam_u", "mu"):
        assert torch.isfinite(getattr(out, f)[healthy]).all(), f
        assert torch.equal(getattr(out, f)[healthy], getattr(clean, f)[healthy]), f


@pytest.mark.parametrize("mehrotra", [True, False])
def test_qp_kernel_warm_duals_with_mixed_ok(flagship, mehrotra):
    """Warm duals accepted for every second element only: the others start
    cold inside the same launch."""
    m = flagship["model"]
    wl, wu, _ = flagship["warm"]
    ok = torch.arange(B, device=wl.device) % 2 == 0
    kw = dict(iterations=4, mehrotra=mehrotra, warm_duals=(wl, wu, ok))
    ref = solve_qp(flagship["qp_next"], m.nu, m.nx, **kw)
    out = cuda_qp.solve_qp_cuda(flagship["qp_next"], m.nu, m.nx, **kw)
    torch.cuda.synchronize()
    for f in ("dz", "lam_l", "lam_u", "mu"):
        assert _rel(getattr(out, f), getattr(ref, f)) < 5e-3, f


@pytest.mark.parametrize("shape", ["goal_N30", "flagship_N20"])
def test_qp_kernel_large_batch_reads_the_qp_from_global_memory(device, jackal, flagship, shape):
    """The launcher stages an element's QP into shared memory only while the
    whole batch is resident on the card at once; the fixture's B=64 is, a
    few copies of it are not, so that launch takes the other path (the QP
    read through L1/L2, more warps an SM). Same arithmetic: the answers are
    those of the B=64 launch."""
    case = jackal if shape == "goal_N30" else flagship
    m, qp = case["model"], case["qp"]
    ext = cuda_qp.load_kernels()
    Np1, nrows, nvar = qp.D.shape[1:]
    staged = ext.qp_shared_bytes(Np1 - 1, m.nu, m.nx, nrows - nvar, True, False)
    resident = ext.qp_resident_blocks(staged)
    assert B <= resident
    copies = resident // B + 1

    def tiled(x):
        return x.repeat(copies, *([1] * (x.dim() - 1)))

    big = qp._replace(**{f: tiled(getattr(qp, f)) for f in qp._fields})
    small = cuda_qp.solve_qp_cuda(qp, m.nu, m.nx, iterations=9)
    out = cuda_qp.solve_qp_cuda(big, m.nu, m.nx, iterations=9)
    torch.cuda.synchronize()
    for f in ("dz", "lam_l", "lam_u", "mu"):
        assert _rel(getattr(out, f), tiled(getattr(small, f))) < 1e-5, f
