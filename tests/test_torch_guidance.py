"""Port vs reference: the host guidance of T-MPC++ and the guidance
module's host half, on the same scene in both packages.

* `GuidancePlanner.update` (the default "lateral" backend) and
  `VisibilityPRMPlanner.update` on corridor_scene(6 pedestrians, seed 7):
  positions, s, signatures, obstacle ids and flags equal (np.array_equal),
  for a first cycle and for a second one that remembers the selected class.
* `GuidanceConstraintModule._warmstarts_from_guidance`: equal.
* The whole host pass of configuration_tmpc (`update_all`, the parameter
  fill and the module's own trajectory list): equal.
* `make_guidance_planner`: "sampled" builds the device sweep on the given
  device (tests/test_torch_device_guidance.py holds it to the reference);
  an unknown backend raises.
"""

import numpy as np
import pytest
import torch

from mpc_planner_tpu import guidance as jax_guidance
from mpc_planner_tpu.utils.config import default_config as jax_default_config
from mpc_planner_tpu_torch import guidance
from mpc_planner_tpu_torch.utils.config import default_config
from torch_port_cases import host_pass

torch.set_num_threads(1)

N = 10


def _configs(**t_mpc):
    jc, tc = jax_default_config(N=N), default_config(N=N)
    return (jc.replace(t_mpc=jc.t_mpc.__class__(**t_mpc)),
            tc.replace(t_mpc=tc.t_mpc.__class__(**t_mpc)))


def _assert_same_trajectories(out, ref):
    assert len(out) == len(ref) > 0
    for a, b in zip(out, ref):
        assert np.array_equal(a.positions, b.positions)
        assert np.array_equal(a.s, b.s)
        assert tuple(a.signature) == tuple(b.signature)
        assert tuple(a.obstacle_ids) == tuple(b.obstacle_ids)
        assert (a.previously_selected, a.braking) == (b.previously_selected, b.braking)
        assert (a.base_positions is None) == (b.base_positions is None)
        if a.base_positions is not None:
            assert np.array_equal(a.base_positions, b.base_positions)


@pytest.fixture(scope="module")
def passes():
    jc, tc = _configs()
    return host_pass("jax", jc), host_pass("torch", tc)


def test_host_pass_equal(passes):
    """Closest point, road halfspaces, ellipsoids, guidance defaults and the
    module's own guidance run: the same block and trajectories."""
    j, t = passes
    np.testing.assert_array_equal(t["P"], j["P"])
    assert t["state"].get("spline") == j["state"].get("spline")
    np.testing.assert_array_equal(t["md"].static_obstacles, j["md"].static_obstacles)
    _assert_same_trajectories(t["modules"].get("GuidanceConstraints")._trajectories,
                              j["modules"].get("GuidanceConstraints")._trajectories)


@pytest.mark.parametrize("backend", ["lateral", "prm"])
@pytest.mark.parametrize("braking", [False, True], ids=["no_braking", "braking"])
def test_guidance_update_equal(passes, backend, braking):
    """Two cycles: the second remembers the class selected in the first."""
    j, t = passes
    jc, tc = _configs(guidance_backend=backend, braking_class=braking)
    gj, gt = jax_guidance.make_guidance_planner(jc), guidance.make_guidance_planner(tc)
    assert type(gt).__name__ == type(gj).__name__
    for cycle in range(2):
        args = []
        for p in (j, t):
            args.append((p["state"], p["md"].path, p["data"].obstacle_block, p["state"].get("spline"),
                         1.5))
        ref, out = gj.update(*args[0]), gt.update(*args[1])
        _assert_same_trajectories(out, ref)
        pick = min(1, len(ref) - 1)
        gj.override_selected(ref[pick])
        gt.override_selected(out[pick])
        assert gt.selected_signature == gj.selected_signature
    assert any(tr.previously_selected for tr in out)


def test_warmstarts_from_guidance_equal(passes):
    j, t = passes
    mj, mt = j["modules"].get("GuidanceConstraints"), t["modules"].get("GuidanceConstraints")
    ref = mj._warmstarts_from_guidance(j["model"], mj._trajectories, j["Z0"])
    out = mt._warmstarts_from_guidance(t["model"], mt._trajectories, t["Z0"])
    assert out.shape == (len(mt._trajectories), N + 1, t["model"].nvar)
    np.testing.assert_array_equal(out, ref)


def test_sampled_backend_names_roadmap_item():
    from mpc_planner_tpu_torch.guidance.device_prm import DeviceSampledPlanner

    _, tc = _configs(guidance_backend="sampled")
    planner = guidance.make_guidance_planner(tc, device="cpu")
    assert isinstance(planner, DeviceSampledPlanner) and planner.device.type == "cpu"
    _, tc = _configs(guidance_backend="nope")
    with pytest.raises(ValueError, match="Unknown guidance backend"):
        guidance.make_guidance_planner(tc)
