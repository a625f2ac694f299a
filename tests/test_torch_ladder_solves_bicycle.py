"""The ladder's bicycle-ca rung (the curvature-aware bicycle on the
ladder's curved scene, which no other test uses) on the port's plain route
against the reference's solve_batch, on the CPU.

One cold solve_batch at B=4 and 2 RTI iterations (escalation included),
the warm starts drawn as both ladders draw them (default_rng(0), N(0, 0.05)
on the states): Z within 5e-3 of max |Z| (the reference's kernel-vs-XLA
tolerance, tests/test_pallas_qp.py:70), exit codes equal
(torch_port_cases.check_ladder_rung_cold_solve). The reference's compile of
each rung takes most of the time, so the rungs are split over three files.
"""

import pytest
import torch

from torch_port_cases import check_ladder_rung_cold_solve


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["bicycle-ca"])
def test_rung_cold_solve_matches_the_reference(name):
    check_ladder_rung_cold_solve(name)
