"""The last public API of the reference that the port lacked, held to the
reference on the CPU:

- the fixed-shape types of mpc_planner_tpu/types.py (Disc with position,
  Halfspace, Prediction with n_modes, DynamicObstacle, ReferencePath,
  FixedSizeTrajectory, dummy_obstacles) and the package's exports;
- the model helpers of mpc_planner_tpu/models/dynamics.py (state_index,
  xinit_indices, continuous_model_integrated, __eq__ and __hash__) on every
  model class;
- the profiler's chrome trace (mpc_planner_tpu/utils/profiling.py).

Inputs are made from a seed with numpy and handed to both packages.
Tolerance: 1e-6 relative to the values' scale (the same f32 arithmetic up
to libm's last bits); fields built from the same arrays are bit-equal.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_planner_tpu as jax_pkg
import mpc_planner_tpu.models as jax_models
import mpc_planner_tpu.types as jax_types
import mpc_planner_tpu_torch as torch_pkg
import mpc_planner_tpu_torch.models as torch_models
import mpc_planner_tpu_torch.types as torch_types
from mpc_planner_tpu_torch.utils.profiling import Profiler

TOL = 1e-6
MODELS = [name for name in torch_models.__all__ if name != "DynamicsModel"]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max(initial=0.0) <= TOL * max(1.0, np.abs(ref).max(initial=0.0))


def _same_fields(ours, ref):
    """Every field of a port dataclass equals the reference's, recursively."""
    names = [f.name for f in dataclasses.fields(ours)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    for name in names:
        a, b = getattr(ours, name), getattr(ref, name)
        if dataclasses.is_dataclass(a):
            _same_fields(a, b)
        else:
            assert str(a.dtype).split(".")[-1] == str(b.dtype), name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


# -- types --------------------------------------------------------------------------------
def test_the_package_exports_the_reference_types():
    assert set(jax_pkg.__all__) <= set(torch_pkg.__all__)
    for name in ("Disc", "Halfspace", "Prediction", "DynamicObstacle", "ReferencePath"):
        assert getattr(torch_pkg, name) is getattr(torch_types, name)


@pytest.mark.parametrize("lead", [(), (7,), (3, 4)])
def test_disc_position_matches(lead):
    rng = np.random.default_rng(len(lead))
    offset, radius = rng.normal(size=3).astype(np.float32), rng.uniform(0.2, 0.5, 3).astype(np.float32)
    pos = rng.normal(0, 5, lead + (2,)).astype(np.float32)
    psi = rng.uniform(-np.pi, np.pi, lead).astype(np.float32)
    ours = torch_types.Disc(offset=torch.as_tensor(offset), radius=torch.as_tensor(radius))
    ref = jax_types.Disc(offset=jnp.asarray(offset), radius=jnp.asarray(radius))
    out = ours.position(torch.as_tensor(pos), torch.as_tensor(psi))
    assert out.shape == lead + (3, 2)
    _close(out.numpy(), ref.position(jnp.asarray(pos), jnp.asarray(psi)))


@pytest.mark.parametrize("M,modes,N", [(4, 1, 10), (12, 3, 20)])
def test_dummy_obstacles_match(M, modes, N):
    ours = torch_types.dummy_obstacles(M, modes, N, device="cpu")
    ref = jax_types.dummy_obstacles(M, modes, N)
    _same_fields(ours, ref)
    assert ours.prediction.n_modes == ref.prediction.n_modes == modes
    far = torch_types.dummy_obstacles(M, modes, N, far=42.0, device="cpu")
    _same_fields(far, jax_types.dummy_obstacles(M, modes, N, far=42.0))


def test_dummy_obstacles_take_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_types.dummy_obstacles(2, 1, 5)


def test_types_from_the_same_arrays_hold_the_same_fields():
    rng = np.random.default_rng(0)
    M, modes, N, P, K = 5, 2, 8, 11, 6

    def both(cls, **arrays):
        return (getattr(torch_types, cls)(**{k: torch.as_tensor(v) for k, v in arrays.items()}),
                getattr(jax_types, cls)(**{k: jnp.asarray(v) for k, v in arrays.items()}))

    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    for ours, ref in (
        both("Halfspace", A=f32(N, 3, 2), b=f32(N, 3)),
        both("ReferencePath", x=f32(P), y=f32(P), psi=f32(P), v=f32(P), s=np.cumsum(
            rng.uniform(0, 1, P)).astype(np.float32), valid=np.arange(P) < 8),
        both("FixedSizeTrajectory", positions=f32(K, 2), valid=np.arange(K) < 4),
    ):
        _same_fields(ours, ref)
    arrays = dict(position=f32(M, modes, N, 2), angle=f32(M, modes, N),
                  major_radius=f32(M, modes, N), minor_radius=f32(M, modes, N),
                  probabilities=np.full((M, modes), 1.0 / modes, np.float32),
                  type=np.full((M,), 2, np.int32))
    pred, ref_pred = both("Prediction", **arrays)
    assert pred.n_modes == ref_pred.n_modes == modes
    obstacle = dict(index=np.arange(M, dtype=np.int32), position=f32(M, 2), angle=f32(M),
                    radius=f32(M))
    ours = torch_types.DynamicObstacle(**{k: torch.as_tensor(v) for k, v in obstacle.items()},
                                       prediction=pred)
    ref = jax_types.DynamicObstacle(**{k: jnp.asarray(v) for k, v in obstacle.items()},
                                    prediction=ref_pred)
    _same_fields(ours, ref)
    with pytest.raises(dataclasses.FrozenInstanceError):
        ours.radius = ours.angle


# -- model helpers -------------------------------------------------------------------------
@pytest.mark.parametrize("name", MODELS)
def test_model_helpers_match(name):
    ours, ref = getattr(torch_models, name)(), getattr(jax_models, name)()
    for s in ref.states:
        assert ours.state_index(s) == ref.state_index(s)
    assert list(ours.xinit_indices()) == list(ref.xinit_indices())
    rng = np.random.default_rng(len(name))
    n_int = ref.nx if ref.nx_integrate is None else ref.nx_integrate
    for lead in ((), (4,)):
        x = rng.normal(size=lead + (ref.nx,)).astype(np.float32)
        u = rng.normal(size=lead + (ref.nu,)).astype(np.float32)
        x_int = x[..., :n_int]
        _close(ours.continuous_model_integrated(torch.as_tensor(x), torch.as_tensor(x_int),
                                                torch.as_tensor(u)).numpy(),
               ref.continuous_model_integrated(jnp.asarray(x), jnp.asarray(x_int), jnp.asarray(u)))
        _close(ours.continuous_model(torch.as_tensor(x_int), torch.as_tensor(u)).numpy(),
               ref.continuous_model(jnp.asarray(x_int), jnp.asarray(u)))


def test_model_equality_and_hash_match():
    """Two instances of one class are equal and hash alike, instances of two
    classes are not equal, in both packages alike; a hash is the
    reference's (the same tuple of names)."""
    for a in MODELS:
        for b in MODELS:
            ours = getattr(torch_models, a)() == getattr(torch_models, b)()
            ref = getattr(jax_models, a)() == getattr(jax_models, b)()
            assert ours == ref == (a == b)
        m1, m2 = getattr(torch_models, a)(), getattr(torch_models, a)()
        assert hash(m1) == hash(m2) == hash(getattr(jax_models, a)())
        assert len({m1, m2}) == 1


def test_slack_model_continuous_model_is_the_references():
    """The port's slack model inherits continuous_model from the plain
    contouring unicycle; the reference spells it out (dynamics.py:214-217)."""
    ours = torch_models.ContouringSecondOrderUnicycleModelWithSlack()
    ref = jax_models.ContouringSecondOrderUnicycleModelWithSlack()
    assert "continuous_model" not in type(ours).__dict__
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    u = rng.normal(size=(6, 3)).astype(np.float32)
    _close(ours.continuous_model(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
           ref.continuous_model(jnp.asarray(x), jnp.asarray(u)))
    z = np.concatenate([u, x], axis=1)
    _close(ours.discrete_dynamics(torch.as_tensor(z), None, 0.2).numpy(),
           ref.discrete_dynamics(jnp.asarray(z), None, 0.2))


# -- the profiler's chrome trace ----------------------------------------------------------
def test_profiler_chrome_trace(tmp_path):
    """tests/test_config.py::test_profiler_chrome_trace on the port."""
    prof = Profiler()
    prof.record_trace = True
    with prof.scope("planning"):
        with prof.scope("optimization"):
            pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    names = [e["name"] for e in trace["traceEvents"]]
    assert "planning" in names and "optimization" in names
    assert prof.stats["planning"].count == 1
    assert "planning" in prof.summary()


def test_profiler_trace_events_and_reset():
    prof = Profiler()
    assert prof.record_trace is False
    with prof.scope("off"):
        pass
    assert prof.events == [] and prof.stats["off"].count == 1
    prof.record_trace = True
    with pytest.raises(ValueError):
        with prof.scope("raises"):
            raise ValueError("recorded all the same")
    with prof.scope("outer"):
        with prof.scope("inner"):
            pass
    assert [e["name"] for e in prof.events] == ["raises", "inner", "outer"]
    for e in prof.events:
        assert set(e) == {"name", "ph", "ts", "dur", "pid", "tid"}
        assert (e["ph"], e["pid"], e["tid"]) == ("X", 0, 0) and e["ts"] >= 0 and e["dur"] >= 0
    inner, outer = prof.events[1], prof.events[2]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    prof.reset()
    assert prof.events == [] and prof.stats == {}
    with prof.scope("after"):
        pass
    assert 0 <= prof.events[0]["ts"] < 1e6  # microseconds from the reset
