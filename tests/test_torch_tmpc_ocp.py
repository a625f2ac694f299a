"""Port vs reference: the T-MPC++ flagship OCP (presets.configuration_tmpc:
MPCBase + Contouring + GuidanceConstraints with an Ellipsoid submodule;
nh = 24) at N=8.

* The parameter registries are equal name by name, index by index and
  bundle by bundle, so both packages share one [N+1, npar] block: that
  block is the flagship's whole state carried across (the system has no
  weights). The batch workload's instance (bench.py's recipe,
  __graft_entry__.py:13-39; the port's presets.flagship_problem) is
  bit-equal: Z0, P, xinit.
* Running cost, terminal cost, constraints and dynamics at seeded (z, p):
  values within 1e-5 of max |ref|, Jacobians and Hessians within 1e-4.
* The K3 stage code generated for this OCP (sigmoid, comparisons, where,
  clamp, remainder, sums), built with the host compiler, against
  torch.func: within 1e-5 of max |ref|. The reference is torch.func in
  float64 at the same float32 inputs: the two float32 derivative algebras
  (forward-mode dual numbers here, jacfwd-over-jacrev there) round apart by
  ~1.1e-5 at the worst Hessian entry of this seed, d2/ds2 of the blended
  contouring cost, while the generated code's own error against float64 is
  8.7e-6 (torch.func's in float32 2.7e-6).

The fused route's plain version on this OCP is held in
tests/test_torch_tmpc_fused.py.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, jacfwd, vmap

from __graft_entry__ import _build as jax_flagship_problem
from mpc_planner_tpu.utils.config import default_config as jax_default_config
from mpc_planner_tpu_torch import interop, presets
from mpc_planner_tpu_torch.ops.stage_codegen import StageCode, host_evaluator
from mpc_planner_tpu_torch.utils.config import default_config

torch.set_num_threads(1)

N = 8
SOLVER = dict(iterations=3, qp_iterations=9)  # tests/test_torch_tmpc_fused.py too
RTOL_VALUE, RTOL_DERIV = 1e-5, 1e-4
N_POINTS = 16


def _configs():
    jc = jax_default_config(N=N)
    tc = default_config(N=N)
    return (jc.replace(solver=jc.solver.__class__(**SOLVER)),
            tc.replace(solver=tc.solver.__class__(**SOLVER)))


@pytest.fixture(scope="module")
def pair():
    jc, tc = _configs()
    jmodel, jocp, jsolver, jZ0, jP, jx = jax_flagship_problem(jc)
    tmodel, tocp, tZ0, tP, tx = presets.flagship_problem(tc)
    rng = np.random.default_rng(0)
    z = rng.normal(0.0, 1.0, (N_POINTS, tocp.nvar))
    z[:, tmodel.index("spline")] = rng.uniform(0.0, 10.0, N_POINTS)  # on the path
    z[:2, tmodel.index("v")] = 0.0  # a standing robot
    # parameters: stage rows of the scene's block with small noise (chi
    # and the radii stay positive)
    rows = rng.integers(1, N, N_POINTS)
    p = tP[rows] + rng.normal(0.0, 0.01, (N_POINTS, tocp.npar))
    return dict(jocp=jocp, jsolver=jsolver, tocp=tocp, jZ0=jZ0, jP=jP, jx=jx, tZ0=tZ0, tP=tP,
                tx=tx, z=z.astype(np.float32), p=p.astype(np.float32))


def test_registry_and_maps_equal(pair):
    jocp, tocp = pair["jocp"], pair["tocp"]
    interop.check_same_registry(jocp.params, tocp.params)
    assert jocp.save_maps() == tocp.save_maps()
    assert (tocp.nh, tocp.nvar + tocp.nh, tocp.npar) == (24, 31, 175)
    np.testing.assert_array_equal(jocp.lh, tocp.lh)
    np.testing.assert_array_equal(jocp.uh, tocp.uh)


def test_flagship_problem_bit_equal(pair):
    """Host halves: closest point, road halfspaces, guidance default fill,
    ellipsoids; the same block in both packages."""
    np.testing.assert_array_equal(pair["tZ0"], pair["jZ0"])
    np.testing.assert_array_equal(pair["tP"], pair["jP"])
    np.testing.assert_array_equal(pair["tx"], pair["jx"])


def _close(out, ref, rtol, what):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, what
    assert np.all(np.isfinite(out)), what
    err = np.abs(out - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-6), (what, err, np.abs(ref).max())


@pytest.mark.parametrize("fn", ["running_cost", "terminal_cost", "constraint_fn", "dynamics_fn"])
def test_stage_function_and_derivative(pair, fn):
    zj, pj = jnp.asarray(pair["z"]), jnp.asarray(pair["p"])
    zt, pt = torch.as_tensor(pair["z"]), torch.as_tensor(pair["p"])
    jf, tf = getattr(pair["jocp"], fn), getattr(pair["tocp"], fn)
    _close(vmap(tf)(zt, pt).numpy(), jax.vmap(jf)(zj, pj), RTOL_VALUE, fn)
    if fn.endswith("cost"):
        _close(vmap(grad(tf))(zt, pt).numpy(), jax.vmap(jax.grad(jf))(zj, pj), RTOL_DERIV, fn)
        _close(vmap(hessian(tf))(zt, pt).numpy(), jax.vmap(jax.hessian(jf))(zj, pj), RTOL_DERIV,
               fn)
    else:
        _close(vmap(jacfwd(tf))(zt, pt).numpy(), jax.vmap(jax.jacfwd(jf))(zj, pj), RTOL_DERIV, fn)


def test_generated_stage_code_matches_torch_func(pair, tmp_path):
    cxx = os.environ.get("CXX", "c++")
    if shutil.which(cxx) is None or shutil.which("ninja") is None:
        pytest.skip(f"needs a C++ compiler ({cxx}) and ninja")
    ocp = pair["tocp"]
    evaluate = host_evaluator(StageCode(ocp), str(tmp_path))
    out = evaluate(pair["z"], pair["p"])
    z, p = torch.as_tensor(pair["z"]).double(), torch.as_tensor(pair["p"]).double()
    ref = dict(f=vmap(ocp.dynamics_fn)(z, p), Jf=vmap(jacfwd(ocp.dynamics_fn))(z, p),
               g=vmap(grad(ocp.running_cost))(z, p), H=vmap(hessian(ocp.running_cost))(z, p),
               gT=vmap(grad(ocp.terminal_cost))(z, p), HT=vmap(hessian(ocp.terminal_cost))(z, p),
               h=vmap(ocp.constraint_fn)(z, p), Jh=vmap(jacfwd(ocp.constraint_fn))(z, p))
    for name, r in ref.items():
        _close(out[name], r.numpy(), RTOL_VALUE, name)
