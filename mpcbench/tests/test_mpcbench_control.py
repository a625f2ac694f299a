"""On the card: the control (the reference computed in TF32 and put in the
program's place) comes out not correct, and the program comes out correct,
at each cell's own size, on three seeds. Skips without a card.

    python -m pytest mpcbench/tests/test_mpcbench_control.py -q -m cuda
"""

import pytest
import torch

from mpcbench import cells

SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


WORKLOADS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_and_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the program runs its kernels there")
    from mpcbench.tools.control import readings

    for rec in readings(workload, SEEDS, 8.0):
        numbers, wrong, _ = rec["program"]
        assert wrong == 0 and rec["program_failed_operations"] == 0, numbers
        numbers, wrong, _ = rec["tf32"]
        assert wrong > 0, numbers
