"""Port vs reference, on the CPU, slow tier (each over ~20 s: the JAX side
compiles its step): the presets and checks that the fast tier leaves out.

* One planner cycle and a warm one through `Planner.solve_mpc` for every
  remaining preset (CA-MPC, T-MPC++ on the CA model, the Jackal's CA
  variant, rosnavigation's slack T-MPC with decomp rows, dingo's T-MPC, the
  lmpcc variants, the bicycle and its CA variant): the same outcome and the
  same plan within 5e-3 absolute, as tests/test_torch_family_cycles.py.
* The KKT ladder on the port (mirror of tests/test_kkt.py::test_kkt_ladder,
  same bounds): contouring, ellipsoid, cc_static (Gaussian chance
  constraints + linearized halfspaces), tmpc.
* The dense reference cross-check (scipy trust-constr on the condensed
  problem, `solver/kkt.py::dense_reference_solve`) on the ellipsoid rung:
  objectives within 2e-4, controls within 2e-2 of max |U|
  (tests/test_kkt.py::_cross_check).
"""

import numpy as np
import pytest
import torch

from mpc_planner_tpu_torch.solver.kkt import dense_reference_solve, kkt_residuals
from torch_port_cases import advance, family_planner_pair, planner_cycle

torch.set_num_threads(1)

pytestmark = pytest.mark.slow

PRESETS = ["curvature_aware", "tmpc_ca", "jackal_ca", "rosnavigation_tmpc", "dingo_tmpc",
           "jackalsimulator_lmpcc", "jackal_lmpcc", "no_obstacles", "ellipsoid", "bicycle",
           "bicycle_ca"]


@pytest.mark.parametrize("name", PRESETS)
def test_planner_cycles_match_reference(name):
    js, ts = family_planner_pair(name)
    assert planner_cycle(js, ts).success
    for side in (js, ts):
        advance(side)
    assert planner_cycle(js, ts).success


def _converged(name):
    # tests/test_kkt.py::_setup's scene: the robot standing at the origin
    _, ts = family_planner_pair(name, n_pedestrians=0 if name == "no_obstacles" else 3, seed=3,
                                near_pedestrian=False)
    planner = ts["planner"]
    assert planner.solve_mpc(ts["state"], ts["data"]).success, f"{name}: initial solve infeasible"
    md = planner._module_data
    res = planner.solver.solve(planner._Z, md.pblock.data, md.xinit, num_iterations=25)
    assert int(res.exit_code) == 1
    return planner, md, res


@pytest.mark.parametrize("name", ["no_obstacles", "ellipsoid", "cc_static", "tmpc"])
def test_kkt_ladder(name):
    planner, md, res = _converged(name)
    kkt = kkt_residuals(planner.solver, res.Z, md.pblock.data, res.lam_l, res.lam_u)
    assert kkt.eq_residual <= 2e-3, kkt
    assert kkt.primal_box <= 1e-3, kkt
    assert kkt.primal_h <= 2e-3, kkt
    assert kkt.dual_feasibility <= 1e-8, kkt
    assert kkt.complementarity <= 5e-3, kkt
    assert kkt.stationarity <= 1e-2, kkt


def test_dense_reference_cross_check():
    planner, md, res = _converged("ellipsoid")
    nu, N = planner.ocp.nu, planner.cfg.N
    U_ours = res.Z.numpy()[:N, :nu]
    U_ref, obj_ref, _ = dense_reference_solve(planner.ocp, md.xinit, md.pblock.data, U_ours)
    obj_ours = float(res.pobj)
    assert obj_ours <= obj_ref + max(1e-4, 1e-4 * abs(obj_ref)) or (
        abs(obj_ours - obj_ref) <= max(2e-4, 2e-4 * abs(obj_ref))), (obj_ours, obj_ref)
    scale = np.abs(U_ref).max() + 1e-6
    assert np.abs(U_ours - U_ref).max() / scale < 2e-2
