"""The warp-per-element kernels K1 and K3 on the CPU: their work counts,
their bodies built with the host compiler, and the port's own geometry
source.

* `qp_work`, `mirror_work`, `riccati_step_flops`, `rti_work`, `probe_work`
  and `bound_ms` give the values counted by hand from ip_solve.cuh and
  mirror.cuh at the goal shape (N=30, nu=2, nx=5, nh=12) and the flagship
  shape (N=20, nh=24).
* K1's body (ops/csrc/ip_solve.cuh, built by g++ with a team of one lane:
  ops/csrc/qp_host.cpp) against the JAX package's `solve_qp` on the same
  QPData (built by the JAX solver from seeded numpy inputs): cold and warm
  duals with one element's duals rejected, Mehrotra on and off, nh=12 and
  nh=0; 5e-3 of max |ref| on dz, the duals and mu (the reference's own
  kernel-vs-XLA bound, tests/test_pallas_qp.py:70). An element with a NaN in
  g freezes alone.
* K3's body (ops/csrc/rti_kernel.cuh with the OCP's generated stage code,
  built the same way) against the JAX package's XLA solve at N=10, B=4
  (5e-3 absolute on Z, tests/test_regression.py:102), against the port's
  plain solve_rti_torch with warm duals accepted for some elements only,
  and its linearization against linearize_torch (1e-5 of max |ref|: the
  same float32 arithmetic up to libm's sin/cos).
* The wrappers keep element-major [B, ...] inputs and outputs on the CPU.
* mpc_planner_tpu_torch/csrc/geometry.cpp is byte-equal to the JAX
  package's mpc_planner_tpu/native/src/geometry.cpp.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_planner_tpu
import mpc_planner_tpu_torch
from mpc_planner_tpu.solver.ocp import OCP as JaxOCP
from mpc_planner_tpu.solver.sqp import SQPSolver as JaxSQPSolver
from mpc_planner_tpu_torch import interop, native
from mpc_planner_tpu_torch.experiments import riccati_probe
from mpc_planner_tpu_torch.ops import cuda_qp, cuda_rti
from mpc_planner_tpu_torch.ops.rti import linearize_torch, solve_rti_torch
from mpc_planner_tpu_torch.solver.ocp import OCP as TorchOCP
from mpc_planner_tpu_torch.solver.qp import solve_qp
from mpc_planner_tpu_torch.solver.sqp import SQPSolver as TorchSQPSolver
from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
from torch_port_cases import (
    SOLVER_SMALL, jackal_goal_pair, jax_qp_case, jax_qp_reference, parameter_blocks,
    perturbed_warmstarts,
)

TOL = 5e-3
B = 4
ITER, ITER_WARM = 8, 4


# -- work counts --------------------------------------------------------------
def test_riccati_step_flops_hand_count():
    # nu=2, nx=5: PA+PB 350, R-hat 48, S-hat 110, inverse 9, K 40, P_new 400, symmetrize 50
    assert cuda_qp.riccati_step_flops(2, 5) == 350 + 48 + 110 + 9 + 40 + 400 + 50


@pytest.mark.parametrize("shape, per_iteration, flops, nbytes", [
    # flagship N=20, nh=24: rows 651, nz 147. Per IP iteration: complementarity 3906,
    # weights 3255, H-bar 42483, residual 1600, gradient 2058, factorization 20140,
    # Mehrotra targets 58590, two linear solves 2 x 31528, step lengths 19530, update 18522
    ((20, 2, 5, 24), 233140, 7 * 651 + 9 * 233140 + 6 * 651, 4 * (6806 + 1450)),
    # goal N=30, nh=12: rows 589, nz 217: 3534 + 2945 + 31465 + 2400 + 3038 + 30210 + 53010
    # + 2 x 29174 + 17670 + 16926
    ((30, 2, 5, 12), 219546, 13 * 589 + 9 * 219546, 4 * (6718 + 1396)),
], ids=["flagship", "goal"])
def test_qp_work_hand_counts(shape, per_iteration, flops, nbytes):
    assert cuda_qp.qp_work(*shape, iterations=9) == (flops, nbytes)
    one, two = cuda_qp.qp_work(*shape, iterations=1)[0], cuda_qp.qp_work(*shape, iterations=2)[0]
    assert two - one == per_iteration
    # a fixed-sigma iteration solves once and skips the predictor's passes
    fixed = (cuda_qp.qp_work(*shape, iterations=2, mehrotra=False)[0]
             - cuda_qp.qp_work(*shape, iterations=1, mehrotra=False)[0])
    assert 0.4 * per_iteration < fixed < 0.7 * per_iteration
    # warm duals add two dual arrays and the flags to the bytes
    rows = (shape[0] + 1) * (shape[1] + shape[2] + shape[3])
    assert cuda_qp.qp_work(*shape, iterations=9, warm=True)[1] == nbytes + 4 * (2 * rows + 1)


def test_mirror_and_probe_work_hand_counts():
    # n=5: symmetrize 20, 60 rotations x (12 + 90), reassembly 375; 2 x 25 floats
    assert cuda_qp.mirror_work(5) == (20 + 60 * 102 + 375, 200)
    flops, nbytes = riccati_probe.probe_work(1024)
    assert flops == 1024 * 8 * 20 * 1007
    assert nbytes == 4 * 1024 * (21 * 49 + 20 * 35 + 25)


def test_bound_says_which_limit_binds():
    ms, by = cuda_qp.bound_ms(67e12, 1.0)
    assert by == "operations" and ms == pytest.approx(1e3)
    ms, by = cuda_qp.bound_ms(1.0, 3.35e12)
    assert by == "bytes" and ms == pytest.approx(1e3)
    # K1 at the flagship batch: operations bind (2.1 MFLOP against 33 KB an element)
    flops, nbytes = cuda_qp.qp_work(20, 2, 5, 24, 9)
    ms, by = cuda_qp.bound_ms(1024 * flops, 1024 * nbytes)
    assert by == "operations" and ms == pytest.approx(1024 * 2106723 / 67e12 * 1e3)


# -- K1's body on the host against the JAX package --------------------------------
def _need_compiler():
    cxx = os.environ.get("CXX", "c++")
    if shutil.which(cxx) is None or shutil.which("ninja") is None:
        pytest.skip(f"needs a C++ compiler ({cxx}) and ninja")


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    _need_compiler()
    return str(tmp_path_factory.mktemp("host_kernels"))


@pytest.fixture(scope="module", params=["goal", "jackal"])
def qp_case(request):
    """The QPs of test_torch_qp.py, built by the JAX solver."""
    return jax_qp_case(request.param, B, ITER)


def _rel(out, ref):
    ref = np.asarray(ref)
    return np.abs(out.numpy() - ref).max() / (np.abs(ref).max() + 1e-9)


@pytest.mark.parametrize("mehrotra", [True, False])
@pytest.mark.parametrize("warm", [False, True])
def test_qp_kernel_body_matches_reference(qp_case, build_dir, warm, mehrotra):
    model = qp_case["model"]
    nu, nx = model.nu, model.nx
    qp = qp_case["qp_next"] if warm else qp_case["qp"]
    it = ITER_WARM if warm else ITER
    ref = jax_qp_reference(qp_case, warm, mehrotra, it)
    out = cuda_qp.solve_qp_host(
        interop.qp_data(qp), nu, nx, it, build_dir, mehrotra=mehrotra,
        warm_duals=interop.warm_duals(*qp_case["warm"]) if warm else None)
    for f in ("dz", "lam_l", "lam_u", "mu"):
        assert getattr(out, f).shape == np.asarray(getattr(ref, f)).shape, f
        assert _rel(getattr(out, f), getattr(ref, f)) < TOL, f


def test_qp_kernel_body_freezes_a_nan_element_alone(qp_case, build_dir):
    """A NaN in one element's g: no step of it is finite, so it keeps its
    start (dz = 0, the cold duals), exactly as the plain version; the
    other elements' answers do not change."""
    model = qp_case["model"]
    qp = interop.qp_data(qp_case["qp"])
    g = qp.g.clone()
    g[1, 3, 2] = float("nan")
    bad = qp._replace(g=g)
    out = cuda_qp.solve_qp_host(bad, model.nu, model.nx, ITER, build_dir)
    clean = cuda_qp.solve_qp_host(qp, model.nu, model.nx, ITER, build_dir)
    ref = solve_qp(bad, model.nu, model.nx, iterations=ITER)
    assert float(out.dz[1].abs().max()) == 0.0 and float(ref.dz[1].abs().max()) == 0.0
    torch.testing.assert_close(out.lam_l[1], ref.lam_l[1], rtol=1e-6, atol=0)
    torch.testing.assert_close(out.lam_u[1], ref.lam_u[1], rtol=1e-6, atol=0)
    healthy = [0, 2, 3]
    for f in ("dz", "lam_l", "lam_u", "mu"):
        assert torch.isfinite(getattr(out, f)[healthy]).all(), f
        torch.testing.assert_close(getattr(out, f)[healthy], getattr(clean, f)[healthy],
                                   rtol=0, atol=0)


def test_qp_wrapper_keeps_element_major_layout(qp_case):
    """[B, ...] in, [B, ...] contiguous out, on the CPU the plain values."""
    model = qp_case["model"]
    qp = interop.qp_data(qp_case["qp"])
    out = cuda_qp.solve_qp_cuda(qp, model.nu, model.nx, iterations=3)
    ref = solve_qp(qp, model.nu, model.nx, iterations=3)
    nrows = model.nvar + qp_case["nh"]
    assert out.dz.shape == (B, 11, model.nvar) and out.lam_l.shape == (B, 11, nrows)
    assert out.mu.shape == (B,)
    for x, y in zip(out, ref):
        assert x.is_contiguous()
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not supported"):
        cuda_qp._qp_arguments(qp, 4, 3, None)


# -- K3's body on the host ----------------------------------------------------------
@pytest.fixture(scope="module")
def rti_case(build_dir):
    js, ts = jackal_goal_pair(n_pedestrians=6, seed=7, **SOLVER_SMALL)
    jsolver = JaxSQPSolver(JaxOCP(js.model, js.modules, js.cfg))
    tsolver = TorchSQPSolver(TorchOCP(ts.model, ts.modules, ts.cfg))
    _, P_t = parameter_blocks(js, ts, jsolver.ocp.params, tsolver.ocp.params)
    Zb = perturbed_warmstarts(initialize_with_state(ts.model, ts.cfg.N, ts.state), ts.model.nu, B,
                              seed=2)
    Pb = np.tile(P_t[None], (B, 1, 1)).astype(np.float32)
    xb = np.tile(ts.state.as_array()[None], (B, 1)).astype(np.float32)
    Zb[:, 0, ts.model.nu:] = xb
    host = cuda_rti.HostRTI(tsolver._stage_code, build_dir)
    kw = dict(lb_template=tsolver._lb_template, ub_template=tsolver._ub_template, lm=tsolver.lm,
              mirror_x_only=tsolver._mirror_x_only)
    return dict(jsolver=jsolver, tsolver=tsolver, host=host, Zb=Zb, Pb=Pb, xb=xb, kw=kw)


def test_rti_kernel_body_matches_jax(rti_case):
    """The whole fused solve as the warp runs it against the JAX XLA solve
    (4 RTI iterations, cold)."""
    c = rti_case
    s = c["tsolver"]
    res_j = c["jsolver"]._get_compiled(4, True)(jnp.asarray(c["Zb"]), jnp.asarray(c["Pb"]),
                                               jnp.asarray(c["xb"]))
    out = c["host"].solve(interop.warm_start(c["Zb"]), interop.parameter_block(c["Pb"]),
                          num_iterations=4, it0=s.qp_iterations, warm_iters=s.warm_qp_iters,
                          mu0=s.mu0, sigma_fixed=s.warm_sigma, **c["kw"])
    assert out.Z.shape == c["Zb"].shape and out.Z.is_contiguous()
    np.testing.assert_allclose(out.Z.numpy(), np.asarray(res_j.Z), atol=TOL, rtol=0)
    codes = s._exit_codes(out.Z, interop.parameter_block(c["Pb"]))[0]
    np.testing.assert_array_equal(codes.numpy(), np.asarray(res_j.exit_code))


@pytest.mark.parametrize("staged", [False, True], ids=["qp_in_scratch", "qp_staged"])
@pytest.mark.parametrize("ok", [[True, True, True, True], [True, False, True, False]],
                         ids=["all_warm", "mixed_ok"])
def test_rti_kernel_body_matches_plain_with_warm_duals(rti_case, ok, staged):
    c = rti_case
    s, ocp = c["tsolver"], c["tsolver"].ocp
    Z, P = interop.warm_start(c["Zb"]), interop.parameter_block(c["Pb"])
    kw = dict(c["kw"], num_iterations=3, warm_iters=s.warm_qp_iters, mu0=s.mu0,
              sigma_fixed=s.warm_sigma)
    first = solve_rti_torch(Z, P, ocp, it0=s.qp_iterations, **kw)
    warm = (first.lam_l, first.lam_u, torch.tensor(ok))
    ref = solve_rti_torch(first.Z, P, ocp, it0=s.warm_qp_iters, warm_duals=warm, **kw)
    out = c["host"].solve(first.Z, P, it0=s.warm_qp_iters, warm_duals=warm, staged=staged, **kw)
    for f in ("Z", "lam_l", "lam_u", "mu"):
        a, b = getattr(out, f), getattr(ref, f)
        assert float((a - b).abs().max()) < TOL * float(b.abs().max()) + 1e-9, f


def test_linearize_kernel_body_matches_plain(rti_case):
    c = rti_case
    s = c["tsolver"]
    Z, P = interop.warm_start(c["Zb"]), interop.parameter_block(c["Pb"])
    out = c["host"].linearize(Z, P, **c["kw"])
    ref = linearize_torch(s.ocp, Z, P, s._lb_template, s._ub_template, s.lm, s._mirror_x_only)
    for f in ("H", "g", "A", "B", "c", "D"):
        a, b = getattr(out, f), getattr(ref, f)
        assert a.shape == b.shape, f
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), f
    assert torch.equal(out.mask_l, ref.mask_l) and torch.equal(out.mask_u, ref.mask_u)
    for a, b, m in ((out.lb, ref.lb, ref.mask_l), (out.ub, ref.ub, ref.mask_u)):
        assert float(((a - b) * m).abs().max()) <= 1e-5 * float((b * m).abs().max())


def test_rti_work_adds_up(rti_case):
    """K3's count is ten linearizations of the generated stage code plus
    the ladder's QPs; its bytes are the arrays of the contract."""
    code = rti_case["tsolver"]._stage_code
    stage = code.flops()
    assert set(stage) == {"dynamics", "running_cost", "terminal_cost", "constraints"}
    assert all(v > 0 for v in stage.values())
    N, nu, nx, nvar, nh, npar = 10, 2, 5, 7, 12, code.ocp.npar
    mirror = cuda_qp.mirror_work(nx)[0]
    linearize = (N * (stage["running_cost"] + stage["dynamics"] + stage["constraints"] + mirror
                      + 2 * (nvar + nh) + nx)
                 + stage["terminal_cost"] + mirror + 2 * (nvar + nh))
    flops, nbytes = cuda_rti.rti_work(code, N, 10, 9, 4, mirror_x_only=True)
    assert flops == (10 * (linearize + 11 * nvar) + cuda_qp.qp_work(N, nu, nx, nh, 9)[0]
                     + 9 * cuda_qp.qp_work(N, nu, nx, nh, 4)[0])
    rows = 11 * (nvar + nh)
    assert nbytes == 4 * (11 * nvar + 11 * npar + 2 * rows + 11 * nvar + 2 * rows + 1)
    assert cuda_rti.rti_work(code, N, 10, 9, 4, warm=True)[1] == nbytes + 4 * (2 * rows + 1)


def test_rti_wrappers_keep_element_major_layout(rti_case):
    c = rti_case
    s = c["tsolver"]
    Z, P = interop.warm_start(c["Zb"]), interop.parameter_block(c["Pb"])
    res = cuda_rti.solve_rti_cuda(Z, P, s._stage_code, num_iterations=2, it0=10, warm_iters=4,
                                  **c["kw"])
    assert res.Z.shape == Z.shape and res.lam_l.shape == (B, 11, 19) and res.mu.shape == (B,)
    inputs, outputs = cuda_rti._solve_arguments(Z, P.expand(B, -1, -1), s._stage_code,
                                                s._lb_template, s._ub_template, None)
    assert all(t.is_contiguous() for t in inputs + outputs)
    assert inputs[0].shape == Z.shape and outputs[0].shape == Z.shape  # no axis moved
    with pytest.raises(ValueError, match="float32"):
        cuda_rti._solve_arguments(Z.double(), P, s._stage_code, s._lb_template, s._ub_template,
                                  None)


# -- the native geometry source ---------------------------------------------------------
def test_geometry_source_is_the_ports_own_and_byte_equal():
    port_root = os.path.dirname(os.path.abspath(mpc_planner_tpu_torch.__file__))
    jax_root = os.path.dirname(os.path.abspath(mpc_planner_tpu.__file__))
    assert os.path.commonpath([native.SRC, port_root]) == port_root
    with open(native.SRC, "rb") as f:
        port = f.read()
    with open(os.path.join(jax_root, "native", "src", "geometry.cpp"), "rb") as f:
        ref = f.read()
    assert port == ref
