"""Port vs reference: MIRROR regularization (the plain version of the
CUDA MIRROR kernel K2).

The port's `mirror_unpacked` is held against the JAX `mirror_unpacked`,
and the solver's `_mirror_nvar` (full and x-only) against the TPU
kernel's lane-major `_mirror_nvar_lanes` run as plain JAX on the CPU.
Same rotations, so the tolerance is 1e-5 of max |H|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_planner_tpu.ops.jacobi_eigh import mirror_unpacked as jax_mirror_unpacked
from mpc_planner_tpu.ops.pallas_qp import _mirror_nvar_lanes
from mpc_planner_tpu_torch.ops import cuda_qp
from mpc_planner_tpu_torch.ops.jacobi_eigh import mirror_unpacked
from mpc_planner_tpu_torch.solver.ocp import OCP
from mpc_planner_tpu_torch.solver.sqp import SQPSolver
from torch_port_cases import jackal_goal_pair

TOL = 1e-5


def _sym_stack(M, n, seed=0):
    A = np.random.default_rng(seed).normal(size=(M, n, n)).astype(np.float32)
    return (A + A.transpose(0, 2, 1)) * 0.5


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n", [2, 5, 7, 9])
def test_mirror_unpacked_matches_jax(n):
    H = _sym_stack(64, n, seed=n)
    ref = np.asarray(jax_mirror_unpacked(jnp.asarray(H), 1e-3))
    out = mirror_unpacked(torch.as_tensor(H), 1e-3).numpy()
    assert _rel(out, ref) < TOL


def test_mirror_eigenvalue_floor():
    """Indefinite input -> SPD output with |eig| floored at lm."""
    lm = 0.1
    H = _sym_stack(24, 5, seed=1)
    out = mirror_unpacked(torch.as_tensor(H), lm).numpy().astype(np.float64)
    w = np.linalg.eigvalsh(out)
    assert w.min() >= lm * 0.98
    expect = np.sort(np.maximum(np.abs(np.linalg.eigvalsh(H)), lm), axis=-1)
    np.testing.assert_allclose(np.sort(w, axis=-1), expect, rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def solver():
    _, ts = jackal_goal_pair()
    return SQPSolver(OCP(ts.model, ts.modules, ts.cfg))


@pytest.mark.parametrize("x_only", [True, False])
def test_mirror_nvar_matches_lanes(solver, x_only):
    """The solver's block-structured MIRROR vs the TPU kernel's lane form,
    on stage Hessians with a diagonal, decoupled u-block."""
    nu, nx, lm = solver.ocp.nu, solver.ocp.nx, solver.lm
    H = _sym_stack(40, nu + nx, seed=2)
    H[:, :nu, nu:] = 0.0
    H[:, nu:, :nu] = 0.0
    H[:, 0, 1] = H[:, 1, 0] = 0.0
    ref = np.moveaxis(np.asarray(_mirror_nvar_lanes(
        jnp.asarray(np.moveaxis(H, 0, -1)), lm, nu, nx, x_only)), -1, 0)
    solver._mirror_x_only = x_only
    out = solver._mirror_nvar(torch.as_tensor(H)).numpy()
    assert _rel(out, ref) < TOL


def test_mirror_wrapper_on_cpu_is_plain():
    """On a CPU tensor the kernel wrapper runs the plain version and
    launches nothing."""
    cuda_qp.reset_launch_counts()
    H = torch.as_tensor(_sym_stack(10, 5, seed=3))
    torch.testing.assert_close(cuda_qp.mirror_cuda(H, 1e-6), mirror_unpacked(H, 1e-6), rtol=0, atol=0)
    assert cuda_qp.launch_counts == {"qp": 0, "mirror": 0}
