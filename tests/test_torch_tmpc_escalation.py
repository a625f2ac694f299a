"""Port vs reference: the in-cycle escalation of the T-MPC++ module
(mpc_planner_tpu/modules/guidance_constraints.py:247-305), forced with
qp_mu_stall = 0 so that every feasible planner counts as stalled. Both
packages run the full-budget re-solve, adopt it where it succeeds, and
select again on the merged result; the recorded device steps and the
cycle's outcome agree within 5e-3 (setup of tests/test_torch_tmpc_cycle.py).
"""

from torch_port_cases import compare_tmpc_steps, tmpc_cycle, tmpc_planner_pair


def test_forced_escalation():
    jax_side, torch_side = tmpc_planner_pair()
    for side in (jax_side, torch_side):
        side["planner"].solver.qp_mu_stall = 0.0
    tmpc_cycle(jax_side, torch_side)
    assert [escalated for _, _, escalated in torch_side["steps"]] == [False, True]
    compare_tmpc_steps(jax_side, torch_side)
    assert "tmpc_escalation" in torch_side["planner"].profiler.stats
