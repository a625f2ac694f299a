"""K1 with the MIRROR inside, on the CPU, at the (nu, nx) no OCP reached
before the remaining families: (2, 4) dingo's point mass, (3, 5)
rosnavigation's slack T-MPC, (3, 6) the bicycle; the last two run the
closed-form 3 x 3 inverse of R-hat (ops/csrc/ip_solve.cuh::sym_inv).

K1's body, built with the host compiler as a team of one lane
(ops/csrc/qp_host.cpp), is held against the JAX package's own kernel with
its in-kernel MIRROR, `solve_qp_pallas(mirror_in_kernel=True,
interpret=True)`, on raw QPData the JAX solver linearized (N=8, B=4), with
the x-only structure on and off: 5e-3 of max |ref| on dz, the duals and mu
(the reference's kernel-vs-XLA bound, tests/test_pallas_qp.py:70).
test_torch_qp_mirror.py holds the same body against the plain version at
these shapes, on QPs the port's own solver linearized.
"""

import pytest
import torch

from mpc_planner_tpu.ops.pallas_qp import solve_qp_pallas
from mpc_planner_tpu_torch import interop
from mpc_planner_tpu_torch.ops import cuda_qp
from torch_port_cases import host_build_dir, jax_qp_case, qp_solutions_agree

torch.set_num_threads(1)

TOL = 5e-3
B = 4
ITER = 8
NAMES = ["dingo_lmpcc", "rosnavigation_tmpc", "bicycle"]


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    return host_build_dir(tmp_path_factory, "host_qp_mirror_shapes")


@pytest.fixture(scope="module", params=NAMES)
def new_shape_jax(request):
    return jax_qp_case(request.param, B, ITER, raw_only=True)


@pytest.mark.parametrize("x_only", [True, False])
def test_qp_kernel_body_with_mirror_matches_pallas_interpret(new_shape_jax, build_dir, x_only):
    case = new_shape_jax
    model, lm = case["model"], case["lm"]
    assert (model.nu, model.nx) in {(2, 4), (3, 5), (3, 6)}
    x_only = x_only and case["x_only"]
    ref = solve_qp_pallas(case["qp_raw"], model.nu, model.nx, iterations=ITER, interpret=True,
                          mirror_in_kernel=True, lm=lm, mirror_x_only=x_only)
    out = cuda_qp.solve_qp_host(interop.qp_data(case["qp_raw"], device="cpu"), model.nu, model.nx,
                                ITER, build_dir, mirror_lm=lm, mirror_x_only=x_only)
    assert all(torch.isfinite(x).all() for x in out)
    qp_solutions_agree(out, ref, TOL)
