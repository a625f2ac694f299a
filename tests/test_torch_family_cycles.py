"""Port vs reference, on the CPU: one planner cycle (and a second, warm one)
per new OCP family through `Planner.solve_mpc`, at N=10 with 4 RTI
iterations: the same outcome, the same plan within 5e-3 absolute
(tests/test_regression.py:102), and for the guidance planners the same
selected planner, feasible count and batch trajectories.

* the real Jackal: `system_jackal("tmpc")`, T-MPC++ with the Gaussian
  chance-constraint submodule, B = 5 planners;
* dingo's holonomic point mass (`system_dingo("lmpcc")`, nu=2, nx=4) towards
  a goal;
* rosnavigation's lmpcc with decomp polytopes from a synthetic two-wall
  costmap.
The bicycle (a batched solve) and the KKT check are in
tests/test_torch_family_solves.py; the remaining presets, slow-marked, in
tests/test_torch_family_slow.py.
"""

import numpy as np
import pytest
import torch

from torch_port_cases import advance, family_planner_pair, planner_cycle

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["jackal_tmpc", "dingo_lmpcc", "rosnavigation_lmpcc"])
def test_planner_cycles_match_reference(name):
    js, ts = family_planner_pair(name)
    out = planner_cycle(js, ts)
    assert out.success
    if name == "jackal_tmpc":
        assert ts["module"].n_planners == 5
        assert ts["planner"].modules.save_data_all()["guidance_n_feasible"] >= 1
    if name == "dingo_lmpcc":  # the plan accelerates toward the goal
        vx = [ts["planner"].get_solution(k, "vx") for k in range(ts["planner"].N + 1)]
        assert np.isfinite(vx).all() and max(vx) > 0.05
    for side in (js, ts):
        advance(side)
    assert planner_cycle(js, ts).success  # the warm cycle: shifted plan, carried duals
