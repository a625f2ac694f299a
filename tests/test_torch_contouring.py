"""Port vs reference: the contouring module's host half and the dynamic
velocity reference, on the corridor scene in both packages (N=10).

* Road halfspaces (ref contouring.cpp:190-262) from the road width, one-
  and two-way, and from explicit left/right boundaries: the same
  `static_obstacles` and parameter block (np.array_equal).
* `PathReferenceVelocityModule` (configuration_no_obstacles with
  `dynamic_velocity_reference`, a path with velocities): the same block,
  and the running cost with its gradient at seeded z within 1e-5 / 1e-4
  of max |ref|.
* `is_objective_reached`: away from and at the path's end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from mpc_planner_tpu.utils.config import default_config as jax_default_config
from mpc_planner_tpu_torch.utils.config import default_config
from torch_port_cases import host_pass

torch.set_num_threads(1)

N = 10


def _configs(**changes):
    out = []
    for make in (jax_default_config, default_config):
        cfg = make(N=N)
        for section, fields in changes.items():
            cfg = cfg.replace(**{section: getattr(cfg, section).__class__(**fields)})
        out.append(cfg)
    return out


def _bounds(state, data):
    x = data.reference_path["x"]
    data.left_bound = np.stack([x, np.full_like(x, 2.5) + 0.1 * np.sin(x)], axis=-1)
    data.right_bound = np.stack([x, np.full_like(x, -2.5)], axis=-1)


def _velocity_path(state, data):
    x = data.reference_path["x"]
    data.reference_path = dict(data.reference_path, v=1.0 + 0.5 * np.cos(x / 5.0))


@pytest.mark.parametrize("case", ["width", "two_way", "boundaries"])
def test_road_halfspaces_equal(case):
    road = dict(two_way=True) if case == "two_way" else {}
    jc, tc = _configs(road=road) if road else _configs()
    scene = _bounds if case == "boundaries" else None
    j = host_pass("jax", jc, "configuration_basic", scene=scene)
    t = host_pass("torch", tc, "configuration_basic", scene=scene)
    assert t["md"].static_obstacles.shape == (N, 2, 3)
    assert np.abs(t["md"].static_obstacles[1:]).max() > 0
    np.testing.assert_array_equal(t["md"].static_obstacles, j["md"].static_obstacles)
    np.testing.assert_array_equal(t["P"], j["P"])


def test_path_reference_velocity_equal():
    jc, tc = _configs(contouring=dict(dynamic_velocity_reference=True))
    j = host_pass("jax", jc, "configuration_no_obstacles", scene=_velocity_path)
    t = host_pass("torch", tc, "configuration_no_obstacles", scene=_velocity_path)
    assert [m.module_name for m in t["modules"]][-1] == "PathReferenceVelocity"
    np.testing.assert_array_equal(t["P"], j["P"])
    rng = np.random.default_rng(4)
    z = rng.normal(0.0, 1.0, (8, t["ocp"].nvar)).astype(np.float32)
    z[:, t["model"].index("spline")] = rng.uniform(0.0, 10.0, 8)
    p = t["P"][rng.integers(1, N, 8)].astype(np.float32)
    jf, tf = j["ocp"].running_cost, t["ocp"].running_cost
    for fj, ft, rtol in ((jf, tf, 1e-5), (jax.grad(jf), grad(tf), 1e-4)):
        ref = np.asarray(jax.vmap(fj)(jnp.asarray(z), jnp.asarray(p)))
        out = vmap(ft)(torch.as_tensor(z), torch.as_tensor(p)).numpy()
        assert np.abs(out - ref).max() <= rtol * np.abs(ref).max()


def test_is_objective_reached_equal():
    jc, tc = _configs()
    j = host_pass("jax", jc, "configuration_basic")
    t = host_pass("torch", tc, "configuration_basic")
    mj, mt = j["modules"].get("Contouring"), t["modules"].get("Contouring")
    for x in (0.0, 29.5, 30.0):
        for side in (j, t):
            side["state"].set("x", x)
        reached = mt.is_objective_reached(t["state"], t["data"])
        assert reached == mj.is_objective_reached(j["state"], j["data"])
        assert reached == (x > 29.0)
