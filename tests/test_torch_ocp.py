"""Port vs reference: OCP assembly for system_jackal("goal").

The registry, model and solver maps are equal; the host halves fill
equal parameter blocks; the stage functions, their derivatives and the
trajectory functions agree at random (z, p); and one linearization gives
the same QP data (rtol 1e-5, atol 1e-6; the MIRROR-ed Hessian is held at
1e-4 relative because the JAX CPU path uses LAPACK eigh there and the
port Jacobi).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import hessian, jacfwd, vmap

from mpc_planner_tpu.solver.ocp import OCP as JaxOCP
from mpc_planner_tpu.solver.sqp import SQPSolver as JaxSQPSolver
from mpc_planner_tpu_torch import interop
from mpc_planner_tpu_torch.solver.ocp import OCP as TorchOCP
from mpc_planner_tpu_torch.solver.sqp import SQPSolver as TorchSQPSolver
from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
from torch_port_cases import jackal_goal_pair, parameter_blocks, perturbed_warmstarts

RTOL, ATOL = 1e-5, 1e-6
N_POINTS = 8


@pytest.fixture(scope="module")
def pair():
    js, ts = jackal_goal_pair(n_pedestrians=6, seed=3)
    jocp = JaxOCP(js.model, js.modules, js.cfg)
    tocp = TorchOCP(ts.model, ts.modules, ts.cfg)
    P_j, P_t = parameter_blocks(js, ts, jocp.params, tocp.params)
    rng = np.random.default_rng(0)
    Z = rng.normal(0.0, 1.0, (N_POINTS, tocp.nvar)).astype(np.float32)
    # parameters: stage rows of the scene's block with small noise (chi
    # and the radii stay positive)
    rows = rng.integers(0, tocp.N, N_POINTS)
    Pz = (P_t[rows] + rng.normal(0.0, 0.01, (N_POINTS, tocp.npar))).astype(np.float32)
    return dict(js=js, ts=ts, jocp=jocp, tocp=tocp, P_j=P_j, P_t=P_t, Z=Z, Pz=Pz)


def test_maps_equal(pair):
    interop.check_same_registry(pair["jocp"].params, pair["tocp"].params)
    assert pair["jocp"].save_maps() == pair["tocp"].save_maps()
    assert pair["tocp"].nh == 12
    np.testing.assert_array_equal(pair["jocp"].lh, pair["tocp"].lh)
    np.testing.assert_array_equal(pair["jocp"].uh, pair["tocp"].uh)


def test_parameter_blocks_equal(pair):
    """The host halves (MPCBase, Goal, Ellipsoid set_parameters) fill the
    same block for the same corridor scene."""
    np.testing.assert_array_equal(pair["P_j"], pair["P_t"])


@pytest.mark.parametrize("fn", ["running_cost", "terminal_cost", "constraint_fn", "dynamics_fn"])
def test_stage_function(pair, fn):
    jf = jax.vmap(getattr(pair["jocp"], fn))
    tf = vmap(getattr(pair["tocp"], fn))
    ref = np.asarray(jf(jnp.asarray(pair["Z"]), jnp.asarray(pair["Pz"])))
    out = tf(torch.as_tensor(pair["Z"]), torch.as_tensor(pair["Pz"])).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fn", ["constraint_fn", "dynamics_fn"])
def test_stage_jacobian(pair, fn):
    ref = np.asarray(jax.vmap(jax.jacfwd(getattr(pair["jocp"], fn)))(
        jnp.asarray(pair["Z"]), jnp.asarray(pair["Pz"])))
    out = vmap(jacfwd(getattr(pair["tocp"], fn)))(
        torch.as_tensor(pair["Z"]), torch.as_tensor(pair["Pz"])).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fn", ["running_cost", "terminal_cost"])
def test_stage_hessian(pair, fn):
    ref = np.asarray(jax.vmap(jax.hessian(getattr(pair["jocp"], fn)))(
        jnp.asarray(pair["Z"]), jnp.asarray(pair["Pz"])))
    out = vmap(hessian(getattr(pair["tocp"], fn)))(
        torch.as_tensor(pair["Z"]), torch.as_tensor(pair["Pz"])).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def _trajectories(pair, B=3):
    ts = pair["ts"]
    Z0 = initialize_with_state(ts.model, ts.cfg.N, ts.state)
    Zb = perturbed_warmstarts(Z0, ts.model.nu, B, seed=1, scale=0.1)
    Pb = np.tile(pair["P_t"][None], (B, 1, 1)).astype(np.float32)
    return Zb, Pb


@pytest.mark.parametrize("fn", ["total_cost", "eq_residual"])
def test_trajectory_function(pair, fn):
    Zb, Pb = _trajectories(pair)
    ref = np.asarray(jax.vmap(getattr(pair["jocp"], fn))(jnp.asarray(Zb), jnp.asarray(Pb)))
    out = vmap(getattr(pair["tocp"], fn))(torch.as_tensor(Zb), torch.as_tensor(Pb)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_rollout(pair):
    Zb, Pb = _trajectories(pair, B=1)
    nu = pair["tocp"].nu
    x0, U = Zb[0, 0, nu:], Zb[0, :-1, :nu]
    ref = np.asarray(pair["jocp"].rollout(jnp.asarray(x0), jnp.asarray(U), jnp.asarray(Pb[0])))
    out = pair["tocp"].rollout(torch.as_tensor(x0), torch.as_tensor(U), torch.as_tensor(Pb[0])).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_linearize(pair):
    """One batched linearization: every QP field agrees; H after MIRROR
    within 1e-4 of max |H| (Jacobi here, LAPACK eigh in the JAX CPU path)."""
    Zb, Pb = _trajectories(pair)
    jsolver = JaxSQPSolver(pair["jocp"])
    tsolver = TorchSQPSolver(pair["tocp"], device="cpu")
    assert tsolver._mirror_x_only == jsolver._mirror_x_only
    ref = jax.vmap(jsolver._linearize)(jnp.asarray(Zb), jnp.asarray(Pb))
    out = tsolver._linearize(torch.as_tensor(Zb), torch.as_tensor(Pb))
    for f in out._fields:
        r, o = np.asarray(getattr(ref, f)), getattr(out, f).numpy()
        assert o.shape == r.shape, f
        if f == "H":
            assert np.abs(o - r).max() <= 1e-4 * np.abs(r).max(), f
        else:
            np.testing.assert_allclose(o, r, rtol=RTOL, atol=ATOL, err_msg=f)
