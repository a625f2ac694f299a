"""Port vs reference, on the CPU: the OCP families of SH-MPC (the scenario
halfspaces on the slack model, on the plain contouring model, and before
rosnavigation's decomp rows), with the checks of test_torch_m7_families.py.

For each family, built by both packages on the same corridor scene (N=8,
3 pedestrians, the robot 2 m behind one):
* the host halves fill the same parameter block, bit for bit, under equal
  registries (the scenario rows at their inactive fill: the draw happens in
  the device step, test_torch_scenario.py);
* the OCP's stage functions agree with the JAX package's at 8 seeded
  (z, p): values, gradients, Jacobians and Hessians within 1e-5 of
  max |ref| (float32 in both);
* the K3 stage code generated for the OCP (ops/stage_codegen.py), built
  with the host compiler, agrees with torch.func in float64 within 5e-5 of
  max |ref|: `rti_fused="auto"` can resolve on for these OCPs.

The families are keys of torch_port_cases.FAMILIES.
"""

import pytest
import torch

from torch_port_cases import (
    check_blocks_equal,
    check_generated_code,
    check_stage_function,
    family_case,
)

torch.set_num_threads(1)

NAMES = ["shmpc", "shmpc_hard", "rosnavigation_shmpc"]


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    return family_case(request.param)


def test_parameter_blocks_bit_equal(case):
    check_blocks_equal(case)


@pytest.mark.parametrize("fn", ["running_cost", "terminal_cost", "constraint_fn", "dynamics_fn"])
def test_stage_function_and_derivative(case, fn):
    check_stage_function(case, fn, 1e-5, 1e-5)


def test_generated_stage_code_matches_torch_func(case, tmp_path):
    check_generated_code(case, str(tmp_path), 5e-5)
