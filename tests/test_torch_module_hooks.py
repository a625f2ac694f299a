"""Port vs reference: the module hooks and host helpers the guidance
module needs, run by both packages on the same inputs.

* `Module.nh`, `ModuleManager.constraint_number`, `save_data` /
  `save_data_all` (keys and values after construction), `BoundModel.width`
  and `BoundModel.get_bounds`, on configuration_tmpc and
  configuration_basic;
* `data_preparation.remove_distant_obstacles` and
  `propagate_all_uncertainty` on seeded pedestrians with Gaussian
  predictions (the reference propagates every prediction after
  conversion; a second pass changes nothing).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_planner_tpu.data_preparation as jax_dp
from mpc_planner_tpu import presets as jax_presets
from mpc_planner_tpu.modules.base import BoundModel as JaxBoundModel
from mpc_planner_tpu.types import State as JaxState
from mpc_planner_tpu.utils.config import default_config as jax_default_config
from mpc_planner_tpu_torch import data_preparation as dp
from mpc_planner_tpu_torch import presets
from mpc_planner_tpu_torch.modules.base import BoundModel
from mpc_planner_tpu_torch.types import State
from mpc_planner_tpu_torch.utils.config import default_config

torch.set_num_threads(1)

N = 10


@pytest.mark.parametrize("config", ["configuration_tmpc", "configuration_basic"])
def test_module_hooks_equal(config):
    jmodel, jmods = getattr(jax_presets, config)(jax_default_config(N=N))
    tmodel, tmods = getattr(presets, config)(default_config(N=N))
    assert [m.module_name for m in tmods] == [m.module_name for m in jmods]
    assert [m.nh for m in tmods] == [m.nh for m in jmods]
    assert tmods.constraint_number() == jmods.constraint_number()
    assert tmods.save_data_all() == jmods.save_data_all()
    z = np.random.default_rng(0).normal(size=tmodel.nvar).astype(np.float32)
    jb, tb = JaxBoundModel(jmodel, jnp.asarray(z)), BoundModel(tmodel, torch.as_tensor(z))
    assert tb.width == jb.width
    for name in list(tmodel.inputs) + list(tmodel.states):
        assert tb.get_bounds(name) == jb.get_bounds(name)


def _pedestrians(pkg, cfg, seed=3, n=9):
    """Seeded pedestrians with Gaussian predictions, built by `pkg`'s own
    helpers (probabilistic on: constant-velocity predictions arrive
    propagated; the rest are marked fresh to be propagated)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pos = rng.uniform([-20.0, -5.0], [40.0, 5.0])
        vel = rng.uniform(-1.0, 1.0, 2)
        o = pkg.HostObstacle(index=i, position=pos, angle=0.0, radius=0.4)
        o.prediction = pkg.get_constant_velocity_prediction(pos, vel, cfg.dt, cfg.N, True)
        if i % 2:
            o.prediction.propagated = False
            o.prediction.major[:] = 0.3
            o.prediction.minor[:] = 0.3
        out.append(o)
    return out


def test_remove_distant_and_propagate_equal():
    jc, tc = jax_default_config(N=N), default_config(N=N)
    jobs, tobs = _pedestrians(jax_dp, jc), _pedestrians(dp, tc)
    js, ts = JaxState(nx=5), State(nx=5)
    for s in (js, ts):
        s.set("x", 4.0)
        s.set("y", 1.0)
    jkeep = jax_dp.remove_distant_obstacles(jobs, js, 15.0)
    tkeep = dp.remove_distant_obstacles(tobs, ts, 15.0)
    assert [o.index for o in tkeep] == [o.index for o in jkeep]
    assert 0 < len(tkeep) < len(tobs)
    for _ in range(2):
        jax_dp.propagate_all_uncertainty(jobs, jc.dt, jc.N)
        dp.propagate_all_uncertainty(tobs, tc.dt, tc.N)
        for a, b in zip(tobs, jobs):
            assert a.prediction.propagated and b.prediction.propagated
            np.testing.assert_array_equal(a.prediction.major, b.prediction.major)
            np.testing.assert_array_equal(a.prediction.minor, b.prediction.minor)
    assert not np.all(tobs[1].prediction.major == 0.3)
