"""Port vs reference: the fused route's plain version on the T-MPC++
flagship OCP (configuration_tmpc at N=8, nh=24; the batch workload's
instance, tests/test_torch_tmpc_ocp.py). solve_rti_torch, reached through
SQPSolver._solve_batch_fused on CPU tensors, against the JAX package's XLA
solve and the port's unfused loop at B=4, cold and with warm duals: 5e-3
absolute on Z (tests/test_regression.py:102), equal exit codes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build as jax_flagship_problem
from mpc_planner_tpu.utils.config import default_config as jax_default_config
from mpc_planner_tpu_torch import interop, presets
from mpc_planner_tpu_torch.solver.sqp import SQPSolver as TorchSQPSolver
from mpc_planner_tpu_torch.utils.config import default_config
from torch_port_cases import perturbed_warmstarts

torch.set_num_threads(1)

N = 8
SOLVER = dict(iterations=3, qp_iterations=9)
ATOL_Z = 5e-3
B = 4


@pytest.fixture(scope="module")
def pair():
    jc, tc = jax_default_config(N=N), default_config(N=N)
    jc = jc.replace(solver=jc.solver.__class__(**SOLVER))
    tc = tc.replace(solver=tc.solver.__class__(**SOLVER))
    _, _, jsolver, _, _, _ = jax_flagship_problem(jc)
    _, tocp, tZ0, tP, tx = presets.flagship_problem(tc)
    return dict(jsolver=jsolver, tocp=tocp, tZ0=tZ0, tP=tP, tx=tx)


@pytest.mark.parametrize("case", ["cold", "warm"])
def test_fused_route_plain_matches_jax_and_unfused(pair, case):
    jsolver = pair["jsolver"]
    tsolver = TorchSQPSolver(pair["tocp"], device="cpu")
    nu = pair["tocp"].nu
    Zb = perturbed_warmstarts(pair["tZ0"], nu, B, seed=3)
    Pb = np.tile(pair["tP"][None], (B, 1, 1)).astype(np.float32)
    xb = np.tile(pair["tx"][None], (B, 1)).astype(np.float32)
    args_j = (jnp.asarray(Zb), jnp.asarray(Pb), jnp.asarray(xb))
    args_t = (interop.warm_start(Zb, device="cpu"), interop.parameter_block(Pb, device="cpu"),
              interop.xinit(xb, device="cpu"))
    n = SOLVER["iterations"]
    warm_j = warm_t = None
    if case == "warm":
        first = jsolver._get_compiled(n, True)(*args_j)
        warm = (np.asarray(first.lam_l), np.asarray(first.lam_u), np.asarray(first.qp_mu) < 1e-2)
        warm_j = tuple(jnp.asarray(w) for w in warm)
        warm_t = interop.warm_duals(*warm, device="cpu")
        res_j = jsolver._get_compiled(n, True, True)(*args_j, *warm_j)
    else:
        res_j = jsolver._get_compiled(n, True)(*args_j)
    res_t = tsolver._solve_batch_fused(*args_t, n, warm0=warm_t)
    res_u = tsolver.batch_impl(*args_t, n, warm0=warm_t)
    codes_j = np.asarray(res_j.exit_code)
    np.testing.assert_array_equal(res_t.exit_code.numpy(), codes_j)
    np.testing.assert_array_equal(res_u.exit_code.numpy(), codes_j)
    np.testing.assert_allclose(res_t.Z.numpy(), np.asarray(res_j.Z), atol=ATOL_Z, rtol=0)
    np.testing.assert_allclose(res_u.Z.numpy(), res_t.Z.numpy(), atol=ATOL_Z, rtol=0)
