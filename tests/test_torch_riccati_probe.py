"""K4, the Riccati probe, on the CPU against the JAX probe.

The reference is experiments/riccati_ilp_probe.py's own `_kernel_single`
(the backward factorization `_factor_chain` :72-94, 8 sweeps with P
carried) run through `pl.pallas_call(..., interpret=True)` on its
`make_data(default_rng(0))`: 128 elements (its LANES), N=20 and N=30 (the
probe reads N from argv[1] when it is loaded, :55). Held to it, within the
probe's own 1e-3 absolute (:369):

* the port's plain `factor_chain_torch`, and `factor_chain_cuda` on CPU
  tensors, which takes that plain version for every mapping;
* the "team" mapping's step (ops/csrc/riccati_step.cuh) built with the host
  compiler as a team of one lane (ops/csrc/riccati_host.cpp), on the
  element-innermost arrays the kernel stages.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_riccati_probe.py -q
"""

import importlib.util
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mpc_planner_tpu_torch.experiments import riccati_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_probe(n_stages: int):
    path = os.path.join(ROOT, "experiments", "riccati_ilp_probe.py")
    spec = importlib.util.spec_from_file_location(f"_riccati_ilp_probe_n{n_stages}", path)
    module = importlib.util.module_from_spec(spec)
    argv = sys.argv
    sys.argv = [path, str(n_stages), "1"]
    try:
        spec.loader.exec_module(module)
    finally:
        sys.argv = argv
    return module


@pytest.fixture(scope="module", params=[20, 30])
def probe_case(request):
    """(H, A, B) element-innermost as numpy, and the JAX probe's P [5, 5, 128]."""
    probe = _load_jax_probe(request.param)
    assert probe.N == request.param
    H, A, B = probe.make_data(np.random.default_rng(0))
    single = pl.pallas_call(
        probe._kernel_single,
        out_shape=jax.ShapeDtypeStruct((probe.NX, probe.NX, probe.LANES), jnp.float32),
        interpret=True,
    )
    P = np.asarray(single(H, A, B))
    return tuple(np.array(x) for x in (H, A, B)), P


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    cxx = os.environ.get("CXX", "c++")
    if shutil.which(cxx) is None or shutil.which("ninja") is None:
        pytest.skip(f"needs a C++ compiler ({cxx}) and ninja")
    return str(tmp_path_factory.mktemp("riccati_host"))


def _agree(name, got, ref):
    err = float(np.abs(got - ref).max())
    rel = err / float(np.abs(ref).max())
    print(f"{name}: max |P - JAX| = {err:.3e} (relative {rel:.3e}), max |P| = {np.abs(ref).max():.2f}")
    assert err < riccati_probe.TOLERANCE, f"{name}: {err}"


def test_plain_matches_jax_probe(probe_case):
    (H, A, B), ref = probe_case
    P = riccati_probe.factor_chain_torch(*(torch.as_tensor(np.moveaxis(x, -1, 0)) for x in (H, A, B)))
    assert P.shape == (H.shape[-1], 5, 5)
    _agree(f"plain N={A.shape[0]}", np.moveaxis(P.numpy(), 0, -1), ref)


def test_team_body_matches_jax_probe(probe_case, build_dir):
    (H, A, B), ref = probe_case
    P = riccati_probe.factor_chain_host(*(torch.as_tensor(x) for x in (H, A, B)), build_dir)
    assert P.shape == ref.shape and bool(torch.isfinite(P).all())
    _agree(f"team body N={A.shape[0]}", P.numpy(), ref)


def test_wrapper_on_cpu_takes_the_plain_version(probe_case):
    (H, A, B), ref = probe_case
    args = [torch.as_tensor(x) for x in (H, A, B)]
    plain = riccati_probe.factor_chain_torch(*(x.movedim(-1, 0) for x in args)).movedim(0, -1)
    for mapping in riccati_probe.MAPPINGS:
        P = riccati_probe.factor_chain_cuda(*args, mapping)
        assert torch.equal(P, plain), mapping
    _agree(f"wrapper on the CPU N={A.shape[0]}", plain.numpy(), ref)


def test_wrapper_rejects_bad_input():
    H, A, B = (torch.as_tensor(x) for x in riccati_probe.make_data(np.random.default_rng(1), 3, 4))
    with pytest.raises(ValueError, match="mapping"):
        riccati_probe.factor_chain_cuda(H, A, B, "wide")
    with pytest.raises(ValueError, match="float32"):
        riccati_probe.factor_chain_cuda(H.double(), A, B, "team")
    with pytest.raises(ValueError, match="shape"):
        riccati_probe.factor_chain_cuda(H[:-1].contiguous(), A, B, "staged")


def test_probe_cases_and_work():
    assert riccati_probe.MAPPINGS[-2:] == ("staged", "team") and len(riccati_probe.MAPPINGS) == 6
    assert riccati_probe.CASES == ((20, 5), (20, 1024), (20, 131_072), (30, 5))
    flops, nbytes = riccati_probe.probe_work(5, 30)
    assert flops == 5 * 8 * 30 * 1007
    assert nbytes == 4 * 5 * (31 * 49 + 30 * 35 + 25)
