"""Port vs reference, on the CPU: batched solves of the bicycle OCP
(configuration_bicycle: nu=3, nx=6, nvar=9, slack input) and one cheap KKT
check.

* `SQPSolver.solve_batch` on B=4 perturbed warm starts of the bicycle at
  N=10, cold and with the first solve's duals carried, against the JAX
  package's XLA solve: 5e-3 absolute on Z, equal exit codes.
* `solver/kkt.py::kkt_residuals` on a converged solve of the ellipsoid
  configuration: the port's residuals meet the ladder's bounds
  (tests/test_kkt.py:103-108) and equal the JAX package's residuals on the
  same trajectory and duals within 1e-4.
The KKT ladder's slow rungs and the dense cross-check are in
tests/test_torch_family_slow.py.
"""

import jax.numpy as jnp
import numpy as np
import torch

from mpc_planner_tpu.solver.kkt import kkt_residuals as jax_kkt_residuals
from mpc_planner_tpu.solver.sqp import SQPSolver as JaxSQPSolver
from mpc_planner_tpu_torch import interop
from mpc_planner_tpu_torch.solver.kkt import kkt_residuals
from mpc_planner_tpu_torch.solver.sqp import SQPSolver as TorchSQPSolver
from torch_port_cases import (
    FAMILIES, family_planner_pair, perturbed_warmstarts, side_host_pass, system_pair,
)

torch.set_num_threads(1)

ATOL_Z = 5e-3
B = 4


def test_bicycle_solve_batch_matches_reference():
    kwargs, _ = FAMILIES["bicycle"]
    js, ts = system_pair(N=10, n_pedestrians=3, seed=3, **kwargs)
    jp, tp = side_host_pass("jax", js, speed=1.0), side_host_pass("torch", ts, speed=1.0)
    np.testing.assert_array_equal(tp["P"], jp["P"])
    jsolver = JaxSQPSolver(jp["ocp"])
    tsolver = TorchSQPSolver(tp["ocp"], device="cpu")
    assert (tp["ocp"].nu, tp["ocp"].nx) == (3, 6)
    assert tsolver._mirror_x_only == jsolver._mirror_x_only  # the slack weight probes as diagonal
    Zb = perturbed_warmstarts(tp["Z0"], 3, B)
    Pb = np.tile(tp["P"][None], (B, 1, 1)).astype(np.float32)
    xb = np.tile(tp["xinit"][None], (B, 1)).astype(np.float32)
    ref = jsolver.solve_batch(jnp.asarray(Zb), jnp.asarray(Pb), jnp.asarray(xb))
    out = tsolver.solve_batch(interop.warm_start(Zb, device="cpu"),
                              interop.parameter_block(Pb, device="cpu"),
                              interop.xinit(xb, device="cpu"))
    np.testing.assert_array_equal(out.exit_code.numpy(), np.asarray(ref.exit_code))
    assert (out.exit_code == 1).all()
    np.testing.assert_allclose(out.Z.numpy(), np.asarray(ref.Z), atol=ATOL_Z, rtol=0)
    # the next cycle: the first solve's duals carried, one element's rejected
    ok = np.array([True, True, False, True])
    warm = (np.asarray(ref.lam_l), np.asarray(ref.lam_u), ok)
    Z1 = np.asarray(ref.Z)
    ref2 = jsolver.solve_batch(jnp.asarray(Z1), jnp.asarray(Pb), jnp.asarray(xb),
                               warm_duals=tuple(jnp.asarray(w) for w in warm))
    out2 = tsolver.solve_batch(interop.warm_start(Z1, device="cpu"),
                               interop.parameter_block(Pb, device="cpu"),
                               interop.xinit(xb, device="cpu"),
                               warm_duals=interop.warm_duals(*warm, device="cpu"))
    np.testing.assert_array_equal(out2.exit_code.numpy(), np.asarray(ref2.exit_code))
    np.testing.assert_allclose(out2.Z.numpy(), np.asarray(ref2.Z), atol=ATOL_Z, rtol=0)


def test_kkt_residuals_of_a_converged_solve():
    _, ts = family_planner_pair("ellipsoid")
    planner = ts["planner"]
    assert planner.solve_mpc(ts["state"], ts["data"]).success
    md = planner._module_data
    res = planner.solver.solve(planner._Z, md.pblock.data, md.xinit, num_iterations=25)
    assert int(res.exit_code) == 1
    kkt = kkt_residuals(planner.solver, res.Z, md.pblock.data, res.lam_l, res.lam_u)
    assert kkt.eq_residual <= 2e-3 and kkt.primal_box <= 1e-3 and kkt.primal_h <= 2e-3, kkt
    assert kkt.dual_feasibility <= 1e-8 and kkt.complementarity <= 5e-3, kkt
    assert kkt.stationarity <= 1e-2, kkt
    # the reference's own residual code on the same trajectory and duals
    js, _ = family_planner_pair("ellipsoid")
    jsolver = js["planner"].solver
    ref = jax_kkt_residuals(jsolver, res.Z.numpy(), md.pblock.data, res.lam_l.numpy(),
                            res.lam_u.numpy())
    np.testing.assert_allclose(np.array(kkt), np.array(ref), rtol=0, atol=1e-4)
