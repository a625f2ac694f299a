"""Port vs reference: the batched interior-point Riccati QP (the plain
version of the CUDA QP kernel K1).

The same QPData (built by the JAX solver from seeded numpy inputs,
torch_port_cases.py::jax_qp_case, and handed over through interop.qp_data) goes to the port's `solve_qp`, the
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

from mpc_planner_tpu.ops.pallas_qp import solve_qp_pallas
from mpc_planner_tpu_torch import interop
from mpc_planner_tpu_torch.ops import cuda_qp
from mpc_planner_tpu_torch.solver.qp import solve_qp
from torch_port_cases import jax_qp_case, jax_qp_reference

TOL = 5e-3
ITER = 8  # cold QPs (the reference's kernel tests use 8)
ITER_WARM = 4  # warm QPs: the SQP loop's warm budget (solver.warm_qp_iters)
B = 4


@pytest.fixture(scope="module", params=["goal", "jackal"])
def case(request):
    return jax_qp_case(request.param, B, ITER)


def _reference(case, warm, mehrotra, kind):
    it = ITER if warm is None else ITER_WARM
    if kind == "xla":
        return jax_qp_reference(case, warm is not None, mehrotra, it)
    model = case["model"]
    wd = None if warm is None else (jnp.asarray(warm[0]), jnp.asarray(warm[1]), jnp.asarray(warm[2]))
    with jax.default_matmul_precision("highest"):
        return solve_qp_pallas(case["qp"] if warm is None else case["qp_next"], model.nu, model.nx,
                               iterations=it, interpret=True, warm_duals=wd, mehrotra=mehrotra)


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
    assert not any(cuda_qp.launch_counts.values())
