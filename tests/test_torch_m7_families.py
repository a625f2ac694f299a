"""Port vs reference, on the CPU: the OCP families of the remaining
constraint modules (Gaussian chance constraints, linearized halfspaces with
the Douglas-Rachford projection and the topology mode, road bounds, decomp
polytopes) and of the remaining models and system presets (the real
Jackal's Gaussian T-MPC, CA-MPC, the bicycle and its CA variant, dingo's
point mass, rosnavigation's slack T-MPC with decomp rows).

For each family, built by both packages on the same corridor scene (N=8,
3 pedestrians, the robot 2 m behind one):
* the host halves (`update`, `set_parameters`, and where they run the
  native `dr_project` / the free-space polytope / the guidance search)
  fill the same parameter block, bit for bit, under equal registries;
* the OCP's stage functions (running and terminal cost, constraints,
  dynamics) agree with the JAX package's at 8 seeded (z, p): values within
  1e-5 of max |ref|, gradients, Jacobians and Hessians too (float32 in
  both; torch.erf and jax.scipy.special.erf, and the two libms, differ in
  the last digits; measured ~1e-7); the curvature-aware families, whose
  spline update computes s + R atan2(vt, R - e - vn) with R >= 1e5 in
  float32, are held to 1e-4;
* the K3 stage code generated for the OCP (ops/stage_codegen.py), built
  with the host compiler, agrees with torch.func in float64 within 5e-5
  of max |ref| (float32 dual numbers against float64: the worst entry is
  d2/ds2 of the blended contouring cost, 1.9e-5 at these points).

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

NAMES = ["cc", "linearized", "linearized_topology", "road", "rosnavigation_lmpcc",
         "jackal_tmpc", "curvature_aware", "bicycle", "bicycle_ca", "dingo_lmpcc",
         "rosnavigation_tmpc"]


def tolerances(name):
    """(value, derivative, generated code) relative tolerances: the
    curvature-aware families cancel R theta against R in float32."""
    if name in ("curvature_aware", "bicycle_ca"):
        return 1e-4, 1e-4, 1e-4
    return 1e-5, 1e-5, 5e-5


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    return family_case(request.param)


def test_parameter_blocks_bit_equal(case):
    check_blocks_equal(case)


@pytest.mark.parametrize("fn", ["running_cost", "terminal_cost", "constraint_fn", "dynamics_fn"])
def test_stage_function_and_derivative(case, fn):
    check_stage_function(case, fn, *tolerances(case["name"])[:2])


def test_generated_stage_code_matches_torch_func(case, tmp_path):
    check_generated_code(case, str(tmp_path), tolerances(case["name"])[2])
