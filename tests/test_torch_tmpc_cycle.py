"""Port vs reference: T-MPC++ control cycles through `Planner.solve_mpc`
on configuration_tmpc (B = 5 planners: 4 guided + the T-MPC++ planner) at
N=10, corridor_scene(6 pedestrians, seed 7), on the CPU.

Each package's device step is recorded (the JAX module's jitted
`_get_fused_step` program, the port's `_fused_step`): the batch Z of every
planner (not only the winner: a cold solve near a branch may end at
another local solution under rounding), the exit codes, pobj and the
selected planner agree within 5e-3 (tests/test_regression.py:102).

* a cold first cycle;
* a warm second cycle, with the duals carried on the device.

The forced escalation is in tests/test_torch_tmpc_escalation.py.
"""

from torch_port_cases import compare_tmpc_steps, tmpc_cycle, tmpc_planner_pair


def test_cold_then_warm_cycle():
    jax_side, torch_side = tmpc_planner_pair()
    out = tmpc_cycle(jax_side, torch_side)
    assert out.success
    compare_tmpc_steps(jax_side, torch_side)
    assert torch_side["module"]._prev_duals is not None
    n_steps = len(torch_side["steps"])
    # the second cycle starts from the carried duals: same state and scene
    tmpc_cycle(jax_side, torch_side)
    compare_tmpc_steps(jax_side, torch_side)
    assert len(torch_side["steps"]) > n_steps
