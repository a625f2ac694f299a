"""K1 with the MIRROR inside, on the CPU.

K1 may be handed the RAW stage Hessians and regularize them itself (stage k
on lane k; ops/csrc/ip_solve.cuh::mirror_stages). Its body builds with the
host compiler as a team of one lane (ops/csrc/qp_host.cpp), so the very
code of the kernel is held here:

* against the JAX package's own kernel with its in-kernel MIRROR,
  `solve_qp_pallas(mirror_in_kernel=True, interpret=True)`, on the same raw
  QPData (built by the JAX solver), with the x-only structure on and off:
  5e-3 of max |ref| on dz, the duals and mu (the reference's kernel-vs-XLA
  bound, tests/test_pallas_qp.py:70);
* against the plain version (`mirror_nvar` then `solve_qp`, which is what
  `solve_qp_cuda` runs on CPU tensors), cold and warm, at the goal and
  jackal shapes and at the three (nu, nx) no earlier OCP reached: (2, 4)
  dingo's point mass, (3, 5) rosnavigation's slack T-MPC, (3, 6) the
  bicycle, on QPs the port's own solver linearized; 5e-3;
* against itself on Hessians regularized beforehand (1e-4: the kernel keeps
  the upper triangle of V w V', the plain version both halves).
The unfused route of SQPSolver on the cuda backend hands K1 raw Hessians;
its result on CPU tensors equals the torch backend's bit for bit. `qp_work`
counts the in-kernel MIRROR. test_torch_qp_mirror_shapes.py holds the body
against the JAX kernel at the three new (nu, nx) too.
"""

import numpy as np
import pytest
import torch

from mpc_planner_tpu.ops.pallas_qp import solve_qp_pallas
from mpc_planner_tpu_torch import interop
from mpc_planner_tpu_torch.ops import cuda_qp
from mpc_planner_tpu_torch.solver.qp import solve_qp
from mpc_planner_tpu_torch.solver.sqp import SQPSolver
from torch_port_cases import (
    FAMILIES,
    host_build_dir,
    jax_qp_case,
    perturbed_warmstarts,
    qp_solutions_agree,
    side_host_pass,
    system_pair,
)

torch.set_num_threads(1)

TOL = 5e-3
B = 4
ITER, ITER_WARM = 8, 4


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    return host_build_dir(tmp_path_factory, "host_qp_mirror")


@pytest.fixture(scope="module", params=["goal", "jackal"])
def qp_case(request):
    return jax_qp_case(request.param, B, ITER)


@pytest.mark.parametrize("x_only", [True, False])
def test_qp_kernel_body_with_mirror_matches_pallas_interpret(qp_case, build_dir, x_only):
    model, lm = qp_case["model"], qp_case["lm"]
    x_only = x_only and qp_case["x_only"]
    ref = solve_qp_pallas(qp_case["qp_raw"], model.nu, model.nx, iterations=ITER, interpret=True,
                          mirror_in_kernel=True, lm=lm, mirror_x_only=x_only)
    out = cuda_qp.solve_qp_host(interop.qp_data(qp_case["qp_raw"], device="cpu"), model.nu, model.nx,
                                ITER, build_dir, mirror_lm=lm, mirror_x_only=x_only)
    qp_solutions_agree(out, ref, TOL)


@pytest.mark.parametrize("x_only", [True, False])
@pytest.mark.parametrize("warm", [False, True])
def test_qp_kernel_body_with_mirror_matches_plain(qp_case, build_dir, warm, x_only):
    model, lm = qp_case["model"], qp_case["lm"]
    x_only = x_only and qp_case["x_only"]
    qp = interop.qp_data(qp_case["qp_next_raw" if warm else "qp_raw"], device="cpu")
    kw = dict(mehrotra=True, mirror_lm=lm, mirror_x_only=x_only,
              warm_duals=interop.warm_duals(*qp_case["warm"], device="cpu") if warm else None)
    it = ITER_WARM if warm else ITER
    out = cuda_qp.solve_qp_host(qp, model.nu, model.nx, it, build_dir, **kw)
    ref = cuda_qp.solve_qp_cuda(qp, model.nu, model.nx, it, **kw)  # CPU tensors: the plain version
    qp_solutions_agree(out, ref, TOL)
    # the plain version is mirror_nvar, then solve_qp
    pre = cuda_qp._mirrored(qp, model.nu, lm, x_only)
    assert not torch.equal(pre.H, qp.H)
    again = solve_qp(pre, model.nu, model.nx, iterations=it, warm_duals=kw["warm_duals"])
    for a, b in zip(ref, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # and the kernel body on Hessians regularized beforehand gives the same
    same = cuda_qp.solve_qp_host(pre, model.nu, model.nx, it, build_dir,
                                 warm_duals=kw["warm_duals"])
    qp_solutions_agree(out, same, 1e-4)


# -- the (nu, nx) no earlier OCP reached -----------------------------------------
@pytest.fixture(scope="module", params=["dingo_lmpcc", "rosnavigation_tmpc", "bicycle"])
def new_shape(request):
    """Raw QPs of a new family, linearized by the port's own solver around
    B perturbed warm starts, and the next QPs with the first ones' duals."""
    kwargs, edit = FAMILIES[request.param]
    _, ts = system_pair(N=8, n_pedestrians=3, seed=3, **kwargs)
    if edit is not None:
        edit(ts)
    hp = side_host_pass("torch", ts, speed=1.0)
    solver = SQPSolver(hp["ocp"], device="cpu")
    Z = torch.as_tensor(perturbed_warmstarts(hp["Z0"], ts.model.nu, B))
    P = torch.as_tensor(np.tile(hp["P"][None], (B, 1, 1)).astype(np.float32))
    qp = solver._linearize(Z, P, raw_hessian=True)
    kw = dict(mirror_lm=solver.lm, mirror_x_only=solver._mirror_x_only)
    first = cuda_qp.solve_qp_cuda(qp, ts.model.nu, ts.model.nx, ITER, **kw)
    qp_next = solver._linearize(Z + first.dz, P, raw_hessian=True)
    warm = (first.lam_l, first.lam_u, torch.tensor([True, True, False, True]))
    return dict(model=ts.model, qp=qp, qp_next=qp_next, first=first, warm=warm, kw=kw)


def test_new_shapes_are_the_ones_claimed(new_shape):
    m = new_shape["model"]
    assert (m.nu, m.nx) in {(2, 4), (3, 5), (3, 6)} and (m.nu, m.nx) in cuda_qp.QP_SHAPES


@pytest.mark.parametrize("warm", [False, True])
def test_qp_kernel_body_with_mirror_at_new_shapes(new_shape, build_dir, warm):
    m, kw = new_shape["model"], new_shape["kw"]
    if warm:
        qp, it, wd = new_shape["qp_next"], ITER_WARM, new_shape["warm"]
        ref = cuda_qp.solve_qp_cuda(qp, m.nu, m.nx, it, warm_duals=wd, **kw)
    else:
        qp, it, wd, ref = new_shape["qp"], ITER, None, new_shape["first"]
    out = cuda_qp.solve_qp_host(qp, m.nu, m.nx, it, build_dir, warm_duals=wd, **kw)
    assert all(torch.isfinite(x).all() for x in out)
    qp_solutions_agree(out, ref, TOL, dz_scale=float(new_shape["first"].dz.abs().max()))


# -- the solver's unfused route and the work count ---------------------------------
def test_cuda_backend_hands_the_qp_kernel_raw_hessians(monkeypatch):
    """As if on the cuda backend (on CPU tensors the wrapper runs its plain
    version): the loop passes raw Hessians with lm and the x-only flag, never
    calls the standalone MIRROR, and ends where the torch backend ends."""
    kwargs, _ = FAMILIES["jackal_tmpc"]
    _, ts = system_pair(N=8, n_pedestrians=3, seed=3, **kwargs)
    hp = side_host_pass("torch", ts, speed=1.0)
    solver = SQPSolver(hp["ocp"], device="cpu")
    Z = torch.as_tensor(perturbed_warmstarts(hp["Z0"], ts.model.nu, B))
    P = torch.as_tensor(np.tile(hp["P"][None], (B, 1, 1)).astype(np.float32))
    x = torch.as_tensor(np.tile(hp["xinit"][None], (B, 1)).astype(np.float32))
    ref = solver.batch_impl(Z, P, x, 2)

    from mpc_planner_tpu_torch.solver import sqp
    seen = []
    plain = sqp.solve_qp_cuda

    def spy(qp, nu, nx, **kw):
        seen.append((kw["mirror_lm"], kw["mirror_x_only"]))
        return plain(qp, nu, nx, **kw)

    monkeypatch.setattr(sqp, "solve_qp_cuda", spy)
    monkeypatch.setattr(sqp, "mirror_cuda", lambda *a, **k: pytest.fail("standalone MIRROR called"))
    solver.qp_backend = "cuda"
    out = solver.batch_impl(Z, P, x, 2)
    assert seen == [(solver.lm, solver._mirror_x_only)] * 2
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_qp_work_counts_the_mirror():
    base = cuda_qp.qp_work(30, 2, 5, 12, 9)
    full = cuda_qp.qp_work(30, 2, 5, 12, 9, mirror=True)
    x_only = cuda_qp.qp_work(30, 2, 5, 12, 9, mirror=True, mirror_x_only=True)
    assert full[1] == base[1] == x_only[1]  # H comes in once either way
    assert full[0] - base[0] == 31 * cuda_qp.mirror_work(7)[0]
    assert x_only[0] - base[0] == 31 * (cuda_qp.mirror_work(5)[0] + 2)
