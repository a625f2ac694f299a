"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (set-up, the window, the reference's
check in two worker processes) on the CPU at a small size, skipping the
harness's look for a card, with one fault planted in the port
(tools/faults.py): a solve that returns its start unchanged, half of the
batch left out, an answer altered where it is produced, or T-MPC++ keeping
its most expensive planner. (The exchange between cards does not exist in
these one-card cells.) A run without a fault comes out correct.
"""

import time

import pytest
import torch

from mpcbench import cells, engine
from mpcbench.tools.faults import plant

SMALL = {
    "closed_loop": {"max_steps": 6, "warmup_steps": 2,
                    "compare": {"episodes": 1, "candidates": 4, "tie": 1e-3}},
    "fleet": {"snapshots": 2, "starts_per_snapshot": 2, "warmup_cycles": 1,
              "compare": {"robots": 4, "max_cycle": 2, "candidates": 2, "block": 2}},
}

FLEET_METRICS = [{"name": "solves_per_s", "unit": "solves/s"},
                 {"name": "fleet_cycle_ms_p95", "unit": "ms"}, {"name": "setup_s", "unit": "s"}]


def small_cell(workload):
    """A corridor cell of the benchmark, or the goal planner's fleet (the
    fleet driver on the jackal-goal configuration)."""
    if workload != "goal-fleet":
        return cells.cell(workload)
    bench = cells.benchmark()
    return {"workload": {"name": workload, "chips": 1},
            "config": cells.config_file(bench, "jackal-goal"),
            "traffic": cells.traffic_file("fleet_batch"),
            "limits": dict(cells.limits_file("tmpc-fleet")),
            "end_to_end": FLEET_METRICS, "per_layer": []}


def small_run(workload, fault=None, seconds=12.0):
    cell = small_cell(workload)
    cell["traffic"].update(SMALL[cell["traffic"]["driver"]])
    cell["limits"]["checked_cycles"] = 3 if cell["traffic"]["driver"] == "closed_loop" else 2
    with plant(fault):
        result, _ = engine.run_cell(cell, workload, 2**31 + 17, seconds, False,
                                    time.perf_counter(), device="cpu", workers=2)
    return result


@pytest.mark.parametrize("workload", ["goal-corridor", "goal-fleet"])
def test_a_sound_run_is_correct(workload):
    torch.manual_seed(0)
    result = small_run(workload)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-2:] == ["checks", "_info"]


# The goal planner solves one problem a cycle: it has no half of a batch to
# leave out (the T-MPC++ planner's batch of five has, below).
@pytest.mark.parametrize("workload, fault", [
    ("goal-corridor", "unchanged"), ("goal-corridor", "altered"),
    ("goal-fleet", "unchanged"), ("goal-fleet", "half_left_out"), ("goal-fleet", "altered")])
def test_a_broken_solve_is_not_correct(workload, fault):
    result = small_run(workload, fault)
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.parametrize("fault", ["half_left_out", "wrong_selection"])
def test_a_broken_tmpc_step_is_not_correct(fault):
    result = small_run("tmpc-corridor", fault, seconds=30.0)
    assert not result["correct"]
