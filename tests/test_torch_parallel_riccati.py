"""Port vs reference, on the CPU: the parallel-in-horizon Riccati
(solver/parallel_riccati.py) and `solve_qp(..., horizon_parallel=True)`,
mirroring tests/test_parallel_riccati.py.

* The scans' linear solve on a batch of random well-conditioned stagewise
  QPs, against the reference's `parallel_riccati.solve` (vmapped) and
  against the port's own sequential sweeps: 1e-4 relative to max |dz|.
  The scans combine in another tree order than JAX's associative_scan, so
  the agreement is to rounding, not bit for bit.
* The full interior-point solve with horizon_parallel=True against the
  reference's (5e-3 relative, the kernel-vs-XLA tolerance of
  tests/test_pallas_qp.py:70) and against the port's sequential solve.
* The config key reaches the solver: one planner cycle on the plain torch
  path with horizon_parallel=True agrees with the sequential one (5e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_planner_tpu.solver import parallel_riccati as jax_pr
from mpc_planner_tpu.solver.qp import QPData as JaxQPData
from mpc_planner_tpu.solver.qp import solve_qp as jax_solve_qp
from mpc_planner_tpu_torch.solver import parallel_riccati
from mpc_planner_tpu_torch.solver.qp import QPData, _riccati_factor, _riccati_linear, solve_qp

torch.set_num_threads(1)

SHAPES = [(2, 5), (3, 5), (3, 6)]


def _random_qps(rng, Bn=3, N=12, nu=2, nx=5, nh=4):
    """tests/test_parallel_riccati.py::_random_qp, Bn of them: numpy f32
    arrays with a leading batch axis."""
    nvar = nu + nx
    nrows = nvar + nh
    M = rng.normal(0, 1, (Bn, N + 1, nvar, nvar))
    H = 0.5 * (M @ M.transpose(0, 1, 3, 2) + 2.0 * np.eye(nvar))
    H[:, N, :nu, :] = 0.0
    H[:, N, :, :nu] = 0.0
    H[:, N, nu:, nu:] += np.eye(nx)
    D_box = np.broadcast_to(np.eye(nvar), (Bn, N + 1, nvar, nvar))
    mask = np.ones((Bn, N + 1, nrows))
    mask[:, 0, nu:nvar] = 0.0
    mask[:, N, :nu] = 0.0
    mask[:, N, nvar:] = 0.0
    fields = dict(
        H=H, g=rng.normal(0, 1, (Bn, N + 1, nvar)),
        A=np.eye(nx) + 0.05 * rng.normal(0, 1, (Bn, N, nx, nx)),
        B=0.3 * rng.normal(0, 1, (Bn, N, nx, nu)),
        c=0.05 * rng.normal(0, 1, (Bn, N, nx)),
        D=np.concatenate([D_box, rng.normal(0, 1, (Bn, N + 1, nh, nvar))], axis=2),
        lb=-2.0 - np.abs(rng.normal(0, 1, (Bn, N + 1, nrows))),
        ub=2.0 + np.abs(rng.normal(0, 1, (Bn, N + 1, nrows))),
        mask_l=mask, mask_u=mask)
    return {k: np.asarray(v, np.float32) for k, v in fields.items()}


def _torch_qp(q):
    return QPData(**{k: torch.as_tensor(v) for k, v in q.items()})


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


_JAX_SOLVES = {}


def _jax_linear_solve(nu, nx):
    """The reference's scans, vmapped over the batch and jitted once a shape."""
    if (nu, nx) not in _JAX_SOLVES:
        def one(H, A, B, g, c):
            prep = jax_pr.prepare(H, A, B, nu, nx, 1e-7)
            return jax_pr.solve(prep, g, c, B, nu, nx)

        _JAX_SOLVES[nu, nx] = jax.jit(jax.vmap(one))
    return _JAX_SOLVES[nu, nx]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("nu,nx", SHAPES)
def test_linear_solve_agreement(seed, nu, nx):
    """Same (H_bar, g_bar, r_eq): the scans against the reference's scans
    and against the port's sequential sweeps, 1e-4."""
    q = _random_qps(np.random.default_rng(seed), nu=nu, nx=nx)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(_jax_linear_solve(nu, nx)(*(jnp.asarray(q[k]) for k in "H A B g c".split())))
    t = _torch_qp(q)
    prep = parallel_riccati.prepare(t.H, t.A, t.B, nu, nx, 1e-7)
    dz_par = parallel_riccati.solve(prep, t.g, t.c, t.B, nu, nx).numpy()
    factors = _riccati_factor(t.H, t.A, t.B, nu, 1e-7)
    dz_seq = _riccati_linear(factors, t.g, t.c, t.A, t.B, nu, nx).numpy()
    assert dz_par.shape == ref.shape == (3, 13, nu + nx)
    assert _rel(dz_par, ref) < 1e-4
    assert _rel(dz_par, dz_seq) < 1e-4


@pytest.mark.parametrize("seed,nu,nx", [(seed, *shape) for seed, shape in enumerate(SHAPES)])
def test_full_ip_solve_agreement(seed, nu, nx):
    """10 IP iterations with horizon_parallel=True: against the reference's
    (5e-3) and against the port's sequential solve (5e-4, the reference's
    own bound between its two solves); one seed a shape (each shape is one
    compile of the reference's whole IP solve)."""
    q = _random_qps(np.random.default_rng(seed), nu=nu, nx=nx)
    with jax.default_matmul_precision("highest"):
        ref = jax.vmap(lambda d: jax_solve_qp(d, nu, nx, iterations=10, horizon_parallel=True))(
            JaxQPData(**{k: jnp.asarray(v) for k, v in q.items()}))
    par = solve_qp(_torch_qp(q), nu, nx, iterations=10, horizon_parallel=True)
    seq = solve_qp(_torch_qp(q), nu, nx, iterations=10)
    assert _rel(par.dz.numpy(), np.asarray(ref.dz)) < 5e-3
    assert _rel(par.lam_l.numpy(), np.asarray(ref.lam_l)) < 5e-3
    assert _rel(par.dz.numpy(), seq.dz.numpy()) < 5e-4
    assert torch.isfinite(par.mu).all()


def test_config_flag_reaches_solver():
    """solver.horizon_parallel=True acts on the plain torch path: one
    planner cycle agrees with the sequential sweeps' (5e-3)."""
    from mpc_planner_tpu_torch.planner import Planner
    from mpc_planner_tpu_torch.presets import configuration_no_obstacles, corridor_scene
    from mpc_planner_tpu_torch.utils.config import default_config

    Z = []
    for flag in (True, False):
        c = default_config(N=10)
        c = c.replace(solver=dataclasses.replace(c.solver, iterations=4, qp_iterations=10,
                                                 horizon_parallel=flag))
        model, modules = configuration_no_obstacles(c)
        planner = Planner(model, modules, c, device="cpu")
        assert planner.solver.horizon_parallel == flag and planner.solver.qp_backend == "torch"
        state, data = corridor_scene(c, n_pedestrians=0, seed=0)
        planner.on_data_received(data, "reference_path")
        assert planner.solve_mpc(state, data).success
        Z.append(planner._Z.copy())
    assert _rel(Z[0], Z[1]) < 5e-3
