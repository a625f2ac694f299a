"""K3's library is resolved once per StageCode and process, on the CPU.

The header digest that names every generated library is computed once a
process (`stage_codegen._header_digest`), and `cuda_rti.load_rti` keeps the
loaded, typed and dimension-checked library on the StageCode it resolved
(`code.rti_lib`), so a launch after the first does no hashing, no lookup
and no retyping. Here the generated code builds with the host compiler
(`load_library(code, "cpu", ...)`), and a stand-in library takes the place
of the CUDA one for the resolver; tests/test_torch_rti_cuda.py holds the
kept handle's launches to a cold load on the card.
"""

import collections
import glob
import hashlib
import os
import shutil
import types

import numpy as np
import pytest

from mpc_planner_tpu_torch import presets
from mpc_planner_tpu_torch.models import SecondOrderUnicycleModel
from mpc_planner_tpu_torch.modules import GoalModule, ModuleManager, MPCBaseModule
from mpc_planner_tpu_torch.ops import cuda_rti, stage_codegen
from mpc_planner_tpu_torch.ops.cuda_qp import CSRC
from mpc_planner_tpu_torch.ops.stage_codegen import StageCode, host_evaluator, load_library
from mpc_planner_tpu_torch.solver.ocp import OCP
from mpc_planner_tpu_torch.utils.config import default_config


def _goal_ocp(N=10):
    """Goal tracking on the 4-state unicycle, nh=0."""
    cfg = default_config(N=N)
    model = SecondOrderUnicycleModel()
    modules = ModuleManager()
    base = modules.add_module(MPCBaseModule(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    modules.add_module(GoalModule(cfg))
    return OCP(model, modules, cfg)


def _jackal_goal_ocp():
    """system_jackal("goal"): goal tracking with 12 ellipsoid rows."""
    cfg, model, modules = presets.system_jackal("goal")
    return OCP(model, modules, cfg)


def _needs_host_compiler():
    cxx = os.environ.get("CXX", "c++")
    if shutil.which(cxx) is None or shutil.which("ninja") is None:
        pytest.skip(f"needs a C++ compiler ({cxx}) and ninja")


def _headers():
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")) + glob.glob(os.path.join(CSRC, "*.h")))


def test_header_digest_reads_each_header_once(monkeypatch):
    """After a fresh start (the cache cleared) the first digest opens each
    header once; later digests open none and give the same value, which is
    the unmemoised one."""
    opened = collections.Counter()

    def counting_open(path, *args, **kwargs):
        opened[path] += 1
        return open(path, *args, **kwargs)

    monkeypatch.setattr(stage_codegen, "open", counting_open, raising=False)
    stage_codegen._header_digest.cache_clear()
    first = stage_codegen._header_digest()
    assert sorted(opened) == _headers() and set(opened.values()) == {1}
    for _ in range(5):
        assert stage_codegen._header_digest() == first
    assert set(opened.values()) == {1}
    assert first == stage_codegen._header_digest.__wrapped__()


def test_load_library_returns_one_library_under_the_unchanged_name(tmp_path):
    """Two loads of one StageCode return the same CDLL, built in the
    directory named from the source and the headers' unmemoised digest (the
    name a build cache is found under); a second OCP gets its own library."""
    _needs_host_compiler()
    code = StageCode(_goal_ocp())
    lib = load_library(code, "cpu", str(tmp_path))
    assert load_library(code, "cpu", str(tmp_path)) is lib
    headers = stage_codegen._header_digest.__wrapped__()
    assert stage_codegen._header_digest() == headers
    digest = hashlib.sha256((code.source("cpu") + headers).encode()).hexdigest()[:16]
    assert os.path.isdir(tmp_path / f"mpc_stage_eval_{digest}")

    other = StageCode(_jackal_goal_ocp())
    lib2 = load_library(other, "cpu", str(tmp_path))
    assert lib2 is not lib and load_library(other, "cpu", str(tmp_path)) is lib2
    assert len(list(tmp_path.glob("mpc_stage_eval_*"))) == 2
    # host_evaluator finds the same library, which evaluates its own OCP
    ocp = other.ocp
    out = host_evaluator(other, str(tmp_path))(np.zeros((1, ocp.nvar)), np.ones((1, ocp.npar)))
    assert ocp.nh == 12 and out["h"].shape == (1, 12) and np.isfinite(out["h"]).all()
    assert len(list(tmp_path.glob("mpc_stage_eval_*"))) == 2


class _StandIn:
    """The exports of K3's library that the resolver and rti_residency
    call, as Python functions (each takes restype and argtypes as a ctypes
    function does), reporting `dims`."""

    def __init__(self, dims):
        def mpc_rti_dims(out):
            out[:] = dims
            return 0

        self.lib = types.SimpleNamespace(
            mpc_rti_dims=mpc_rti_dims,
            mpc_rti_scratch_floats=lambda n: 0,
            mpc_rti_shared_bytes=lambda n, staged: 4096 * (1 + staged),
            mpc_rti_resident_blocks=lambda shared: 8 * 132,
            mpc_rti_solve=lambda *args: 0,
            mpc_rti_linearize=lambda *args: 0,
        )


@pytest.fixture
def stand_in(monkeypatch):
    """cuda_rti.load_library replaced by one that returns a stand-in per
    OCP (with its dimensions, or `wrong` ones) and counts its calls."""
    calls = collections.Counter()
    made = {}
    state = {"wrong": False}

    def fake_load_library(code, target="cuda", build_dir=None, verbose=False):
        assert target == "cuda"
        calls[id(code.ocp)] += 1
        ocp = code.ocp
        dims = (ocp.nu, ocp.nx, ocp.nh + int(state["wrong"]), ocp.npar)
        return made.setdefault((id(ocp), dims), _StandIn(dims)).lib

    monkeypatch.setattr(cuda_rti, "load_library", fake_load_library)
    return types.SimpleNamespace(calls=calls, state=state)


def test_load_rti_resolves_once_per_stage_code(stand_in):
    """Fifty lookups (load_rti and rti_residency, as a launch does) of one
    StageCode resolve it once: one library load, one count, the kept typed
    handle returned every time. A second StageCode, of the same OCP or of
    another, resolves on its own."""
    ocp = _goal_ocp()
    code = StageCode(ocp)
    before = cuda_rti.resolve_counts["rti"]
    lib = cuda_rti.load_rti(code)
    assert code.rti_lib is lib
    assert lib.mpc_rti_dims.argtypes == [cuda_rti.ctypes.POINTER(cuda_rti.ctypes.c_int)]
    for _ in range(49):
        assert cuda_rti.load_rti(code) is lib
        assert cuda_rti.rti_residency(code, 2000, ocp.N) == (False, 8 * 132, 2)
    assert cuda_rti.resolve_counts["rti"] == before + 1
    assert stand_in.calls[id(ocp)] == 1

    again = StageCode(ocp)
    assert cuda_rti.load_rti(again) is lib and again.rti_lib is lib
    other = StageCode(_goal_ocp(N=20))
    assert cuda_rti.load_rti(other) is not lib
    assert cuda_rti.resolve_counts["rti"] == before + 3
    assert stand_in.calls[id(ocp)] == 2 and stand_in.calls[id(other.ocp)] == 1


def test_load_rti_keeps_nothing_for_a_library_of_other_dimensions(stand_in):
    """A library built for other dimensions raises at every lookup and is
    neither kept nor counted."""
    code = StageCode(_goal_ocp())
    stand_in.state["wrong"] = True
    before = cuda_rti.resolve_counts["rti"]
    for _ in range(2):
        with pytest.raises(RuntimeError, match="dims"):
            cuda_rti.load_rti(code)
    assert code.rti_lib is None and cuda_rti.resolve_counts["rti"] == before
    stand_in.state["wrong"] = False
    assert cuda_rti.load_rti(code) is code.rti_lib is not None
    assert cuda_rti.resolve_counts["rti"] == before + 1
