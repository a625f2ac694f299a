"""Port vs reference: the system presets, the device rule and the small
host functions of the remaining modules, on the CPU.

* Every preset variant of mpc_planner_tpu/presets.py (the SH-MPC ones
  included) assembles with the same nu, nx, nh, npar, the same parameter
  names at the same indices, the same bounds and the same settings (mirror
  of tests/test_system_presets.py).
* Entry points take the card by default: without a device and without CUDA,
  `Planner`, `SQPSolver` and the `interop` helpers raise and name
  `device="cpu"`; with `device="cpu"` they run here.
* `erfinv_approx` against the JAX package's: 2e-6 absolute at risks >= 0.02,
  5e-5 down to 1e-4 (torch.erf and jax.scipy.special.erf differ in the last
  float32 digits, and the Newton steps divide that difference by the slope
  2/sqrt(pi) exp(-y^2), 1.7e-3 at risk 1e-4; the port's value is then the
  closer one to scipy's, 6e-7 against 3.6e-5), `rotation_matrix`,
  `douglas_rachford_projection`; the native `dr_project` and
  `free_polytope` of the port's own geometry library against the JAX
  package's binding, bit for bit, and against the modules' numpy versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_planner_tpu.native as jax_native
import mpc_planner_tpu.presets as jax_presets
import mpc_planner_tpu.utils.math as jax_math
import mpc_planner_tpu_torch.presets as torch_presets
import mpc_planner_tpu_torch.utils.math as torch_math
from mpc_planner_tpu.modules import decomp_constraints as jax_decomp
from mpc_planner_tpu.solver.ocp import OCP as JaxOCP
from mpc_planner_tpu_torch import default_device, interop, native
from mpc_planner_tpu_torch.modules import GaussianConstraintModule, decomp_constraints
from mpc_planner_tpu_torch.modules.linearized_constraints import LinearizedConstraintModule
from mpc_planner_tpu_torch.planner import Planner
from mpc_planner_tpu_torch.solver.ocp import OCP
from mpc_planner_tpu_torch.solver.sqp import SQPSolver
from mpc_planner_tpu_torch.utils.config import default_config

torch.set_num_threads(1)

PORTED = [
    ("jackalsimulator", "tmpc"), ("jackalsimulator", "basic"), ("jackalsimulator", "no_obstacles"),
    ("jackalsimulator", "lmpcc"), ("jackalsimulator", "curvature_aware"),
    ("jackalsimulator", "tmpc_ca"),
    ("jackal", "tmpc"), ("jackal", "ca"), ("jackal", "goal"), ("jackal", "lmpcc"),
    ("dingo", "tmpc"), ("dingo", "lmpcc"),
    ("rosnavigation", "tmpc"), ("rosnavigation", "lmpcc"),
    ("jackalsimulator", "safe_horizon"), ("jackalsimulator", "safe_horizon_hard"),
    ("rosnavigation", "safe_horizon"),
]


def _same_ocp(jocp, tocp):
    assert (tocp.nu, tocp.nx, tocp.nh, tocp.npar) == (jocp.nu, jocp.nx, jocp.nh, jocp.npar)
    interop.check_same_registry(jocp.params, tocp.params)
    assert tocp.save_maps() == jocp.save_maps()
    for a in ("lh", "uh", "lb_z", "ub_z"):
        np.testing.assert_array_equal(getattr(tocp, a), getattr(jocp, a))


@pytest.mark.parametrize("name,variant", PORTED)
def test_system_preset_assembles_as_reference(name, variant):
    jc, jmodel, jmodules = jax_presets.select_system(name, variant=variant, N=8)
    tc, tmodel, tmodules = torch_presets.select_system(name, variant=variant, N=8)
    assert tc.name == jc.name == name
    assert (tc.N, tc.dt, tc.solver.iterations) == (jc.N, jc.dt, jc.solver.iterations)
    assert type(tmodel).__name__ == type(jmodel).__name__
    assert [m.module_name for m in tmodules] == [m.module_name for m in jmodules]
    _same_ocp(JaxOCP(jmodel, jmodules, jc), OCP(tmodel, tmodules, tc))


@pytest.mark.parametrize("curvature_aware", [False, True])
def test_bicycle_configuration_assembles_as_reference(curvature_aware):
    jc, tc = jax_presets.default_config(N=8), default_config(N=8)
    jmodel, jmodules = jax_presets.configuration_bicycle(jc, curvature_aware)
    tmodel, tmodules = torch_presets.configuration_bicycle(tc, curvature_aware)
    tocp = OCP(tmodel, tmodules, tc)
    assert (tocp.nu, tocp.nx, tocp.nvar) == (3, 6, 9)
    _same_ocp(JaxOCP(jmodel, jmodules, jc), tocp)


def test_system_settings_match_reference():
    for name in torch_presets.SYSTEMS:
        jc, _, _ = jax_presets.select_system(name)
        tc, _, _ = torch_presets.select_system(name)
        assert (tc.N, tc.dt, tc.solver.iterations) == (jc.N, jc.dt, jc.solver.iterations)
    assert sorted(torch_presets.SYSTEMS) == sorted(jax_presets.SYSTEMS)


def test_jackal_tmpc_uses_gaussian_submodule():
    _, _, modules = torch_presets.select_system("jackal", variant="tmpc", N=8)
    assert isinstance(modules.get("GuidanceConstraints").submodule, GaussianConstraintModule)


# -- the device rule ---------------------------------------------------------------
def test_entry_points_take_the_card_by_default():
    """No device given: cuda:0, and without CUDA an error that names
    device="cpu" (never a silent run on the CPU)."""
    cfg, model, modules = torch_presets.select_system("jackal", variant="goal", N=8)
    assert default_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert default_device() == torch.device("cuda:0")
        return
    calls = (default_device, lambda: SQPSolver(OCP(model, modules, cfg)),
             lambda: Planner(model, modules, cfg), lambda: interop.to_tensor(np.zeros(3)),
             lambda: interop.parameter_block(np.zeros((9, 4))), lambda: interop.xinit(np.zeros(5)),
             lambda: interop.warm_start(np.zeros((9, 7))),
             lambda: interop.warm_duals(np.zeros(3), np.zeros(3), np.ones(1, bool)))
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    solver = SQPSolver(OCP(model, modules, cfg), device="cpu")
    assert solver.device.type == "cpu" and solver.qp_backend == "torch" and not solver.rti_fused
    assert Planner(model, modules, cfg, device="cpu").solver.device.type == "cpu"
    assert interop.xinit(np.zeros(5), device="cpu").device.type == "cpu"


# -- small host and math functions ---------------------------------------------------
def test_erfinv_approx_matches_reference():
    """Over the risks a chance constraint can carry (1 - 2 risk, risk in
    [1e-4, 0.45]), and against erf itself."""
    risk = np.concatenate([np.geomspace(1e-4, 0.45, 40), [0.05]]).astype(np.float32)
    x = 1.0 - 2.0 * risk
    ref = np.asarray(jax_math.erfinv_approx(jnp.asarray(x)))
    out = torch_math.erfinv_approx(torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=5e-5)
    usual = risk >= 0.02
    np.testing.assert_allclose(out.numpy()[usual], ref[usual], rtol=0, atol=2e-6)
    np.testing.assert_allclose(torch.erf(out).numpy(), x, rtol=0, atol=2e-7)
    np.testing.assert_allclose(torch_math.erf(torch.as_tensor(x)).numpy(),
                               np.asarray(jax_math.jax_erf(jnp.asarray(x))), rtol=0, atol=2e-7)


def test_small_math_helpers_match_reference():
    rng = np.random.default_rng(0)
    ang = rng.uniform(-4, 4, 7).astype(np.float32)
    np.testing.assert_allclose(torch_math.rotation_matrix(torch.as_tensor(ang)).numpy(),
                               np.asarray(jax_math.rotation_matrix(jnp.asarray(ang))), atol=1e-6)
    pos, obs = rng.normal(0, 1, (6, 2)), rng.normal(0, 1, (6, 2))
    np.testing.assert_array_equal(
        torch_math.douglas_rachford_projection(pos, obs, None, 1.2, None),
        jax_math.douglas_rachford_projection(pos, obs, None, 1.2, None))
    np.testing.assert_array_equal(torch_math.linspace(0, 1, 5), jax_math.linspace(0, 1, 5))
    assert torch_math.distance([0, 0], [3, 4]) == jax_math.distance([0, 0], [3, 4]) == 5.0


def test_native_projection_and_polytope_bit_equal_to_reference():
    if not (native.available() and jax_native.available()):
        pytest.skip("needs g++ for the native geometry library")
    rng = np.random.default_rng(1)
    pts, obs = rng.normal(0, 1, (5, 2)), rng.normal(0, 1, (5, 7, 2))
    radii = rng.uniform(0.3, 0.9, 7)
    np.testing.assert_array_equal(native.dr_project(pts, obs, radii),
                                  jax_native.dr_project(pts, obs, radii))
    seed, cloud = np.array([0.2, -0.1]), rng.uniform(-2, 2, (60, 2))
    cloud = cloud[np.linalg.norm(cloud - seed, axis=1) > 0.5]
    rows = native.free_polytope(seed, cloud, 8, 0.3)
    np.testing.assert_array_equal(rows, jax_native.free_polytope(seed, cloud, 8, 0.3))
    # the modules' numpy versions: the same region (the decomp module's own
    # sweep), and the same projected point as the linearized module's loop
    np.testing.assert_array_equal(decomp_constraints.free_polytope(seed, cloud, 8, 0.3),
                                  jax_decomp.free_polytope(seed, cloud, 8, 0.3))
    assert np.all(cloud @ rows[:, :2].T - rows[:, 2] >= -1e-9, axis=0).sum() >= 0
    grid = np.zeros((6, 5), np.uint8)
    grid[2, 3] = 200
    meta = {"origin_x": -1.0, "origin_y": 2.0, "resolution": 0.5}
    np.testing.assert_array_equal(decomp_constraints.occupied_points_from_grid(grid, meta, 127),
                                  jax_decomp.occupied_points_from_grid(grid, meta, 127))
    module = LinearizedConstraintModule(default_config(N=8))
    one = module._project_to_safety(obs[0], radii, pts[0].copy())
    np.testing.assert_array_equal(one, native.dr_project(pts[:1], obs[:1], radii)[0])
    assert np.all(np.linalg.norm(one[None] - obs[0], axis=1) >= radii - 0.35)
