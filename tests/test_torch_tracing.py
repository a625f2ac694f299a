"""The port's tracing inside the solve step (utils/profiling.py): counters,
`pull`, `gc` spans and the clock anchors; the spans and counters that the
Planner, the T-MPC++ step and SQPSolver record into one shared Profiler;
and the benchmark's readers of them (mpcbench/metrics/).

The CPU tests run the fused route's plain version (`solver.rti_fused` set
on, as experiments/common.py::route_solver does on the CPU) at N=10. The
`cuda`-marked tests need the card; this file imports no JAX, so there:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -s
"""

import dataclasses
import gc
import json
import linecache
import re
import time
import warnings

import numpy as np
import pytest
import torch

from mpc_planner_tpu_torch import presets
from mpc_planner_tpu_torch.planner import Planner
from mpc_planner_tpu_torch.solver.sqp import EXIT_FAILURE, EXIT_SUCCESS, SQPSolver
from mpc_planner_tpu_torch.utils.config import default_config
from mpc_planner_tpu_torch.utils.profiling import CounterStats, Profiler

torch.set_num_threads(1)

SOLVER_SMALL = dict(iterations=4, qp_iterations=10)


def _planner(cfg, model, modules, device, seed):
    planner = Planner(model, modules, cfg, device=device)
    if device == "cpu":
        planner.solver.rti_fused = True  # K3's plain version
    state, data = presets.corridor_scene(cfg, n_pedestrians=6 if device == "cpu" else 12,
                                         seed=seed)
    planner.on_data_received(data, "reference_path")
    return planner, state, data


def goal_planner(device="cpu"):
    """The goal planner: system_jackal("goal"), at N=10 and 4 RTI
    iterations on the CPU, as the benchmark's goal-corridor on the card."""
    if device != "cpu":
        return _planner(*presets.system_jackal("goal"), device, 0)
    cfg, _, _ = presets.system_jackal("goal", N=10)
    return _planner(*presets.system_jackal(
        "goal", N=10, solver=dataclasses.replace(cfg.solver, **SOLVER_SMALL)), device, 0)


def tmpc_planner(device="cpu"):
    """T-MPC++: configuration_tmpc at N=10 on the CPU, and
    system_jackalsimulator("tmpc") (the benchmark's tmpc-corridor) on the card."""
    if device != "cpu":
        return _planner(*presets.system_jackalsimulator("tmpc"), device, 7)
    cfg = default_config(N=10)
    cfg = cfg.replace(solver=cfg.solver.__class__(**SOLVER_SMALL))
    return _planner(cfg, *presets.configuration_tmpc(cfg), device, 7)


def advance(planner, state, data):
    for name in planner.model.states:
        state.set(name, planner.get_solution(1, name))
    data.ego_position = state.get_position()


def spans(prof, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in prof.events if e["name"] == name]


def inside(inner, outer, eps=1e-6):
    a, b = inner
    return any(s - eps <= a and b <= e + eps for s, e in outer)


def pull_count(prof):
    return sum(s.count for k, s in prof.stats.items() if k.startswith("pull."))


# -- the Profiler ------------------------------------------------------------------------
def test_counters_sit_beside_the_scopes(tmp_path):
    prof = Profiler()
    prof.record_trace = True
    with prof.scope("outer"):
        prof.count("host_syncs")
        prof.count("host_syncs", 2)
    prof.count("escalation_flagged", 0)
    c = prof.stats["host_syncs"]
    assert isinstance(c, CounterStats) and (c.total, c.count) == (3, 2)
    assert (prof.stats["escalation_flagged"].total, prof.stats["escalation_flagged"].count) == (0, 1)
    assert [e["name"] for e in prof.events] == ["outer"]
    text = prof.summary()
    assert "host_syncs" in text and "count=3" in text
    assert "ms" not in next(line for line in text.splitlines() if line.startswith("host_syncs"))

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    counters = [e for e in trace["traceEvents"] if e["ph"] == "C"]
    assert [e["args"] for e in counters] == [{"host_syncs": 1}, {"host_syncs": 3},
                                             {"escalation_flagged": 0}]
    other = trace["otherData"]
    assert other["clock"] == "perf_counter" and other["unit"] == "us"
    assert abs(other["perf_counter_ns"] / 1e9 - prof._t0) < 1e-6
    assert abs(other["time_ns"] / 1e9 - time.time()) < 60
    assert abs(other["monotonic_ns"] / 1e9 - time.monotonic()) < 60

    prof.reset()
    assert prof.stats == {} and prof.events == []
    prof.export_chrome_trace(str(path))
    assert json.loads(path.read_text())["traceEvents"] == []


def test_pull_reads_times_and_counts():
    prof = Profiler()
    prof.record_trace = True
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = prof.pull("x", x)
    assert isinstance(out, np.ndarray) and np.array_equal(out, x.numpy())
    assert int(prof.pull("code", torch.tensor(1, dtype=torch.int32))) == 1
    assert prof.stats["pull.x"].count == 1 and prof.stats["host_syncs"].total == 2
    assert [e["name"] for e in prof.events] == ["pull.x", "pull.code"]


def _installed(prof):
    return prof._gc_callback is not None and prof._gc_callback in gc.callbacks


@pytest.mark.parametrize("track_gc,trace,expected", [
    (True, True, True), (True, False, False), (False, True, False)])
def test_gc_spans_only_when_tracked_and_tracing(track_gc, trace, expected):
    prof = Profiler(track_gc=track_gc)
    prof.record_trace = trace
    gc.collect()
    names = [e["name"] for e in prof.events]
    assert ("gc" in names) == expected
    assert (prof.stats["gc"].count >= 1 if expected else
            "gc" not in prof.stats or prof.stats["gc"].count == 0)
    assert _installed(prof) == (track_gc and trace)
    prof.record_trace = False
    assert not _installed(prof)


def test_gc_callback_does_not_outlive_its_profiler():
    prof = Profiler(track_gc=True)
    prof.record_trace = True
    callback = prof._gc_callback
    assert callback in gc.callbacks
    prof.reset()
    assert "gc" in prof.stats  # a collection never adds a key while stats are read
    del prof
    assert callback not in gc.callbacks


# -- the spans and counters of the goal planner -------------------------------------------
def test_goal_cycle_records_the_solve_step():
    planner, state, data = goal_planner()
    prof = planner.profiler
    assert prof is planner.solver.profiler
    prof.record_trace = True
    out = planner.solve_mpc(state, data)
    assert out.success
    opt = spans(prof, "optimization")
    assert len(opt) == 1
    for name in ("k3_launch", "exit_codes", "pull.exit_codes", "pull.qp_mu", "pull.Z",
                 "pull.exit_code", "pull.pobj"):
        assert len(spans(prof, name)) == 1, name
        assert inside(spans(prof, name)[0], opt), name
    for module in planner.modules:
        assert inside(spans(prof, f"update.{module.module_name}")[0], spans(prof, "update"))
        assert inside(spans(prof, f"set_parameters.{module.module_name}")[0],
                      spans(prof, "set_parameters"))
    assert prof.stats["host_syncs"].total == pull_count(prof) == 5
    assert prof.stats["escalation_flagged"].count == 1


def test_goal_plans_do_not_depend_on_tracing():
    plans = []
    for trace in (True, False):
        planner, state, data = goal_planner()
        planner.profiler.record_trace = trace
        Zs = []
        for _ in range(5):
            assert planner.solve_mpc(state, data).success
            Zs.append(planner._Z.copy())
            advance(planner, state, data)
        plans.append(np.stack(Zs))
        assert bool(planner.profiler.events) == trace
        assert planner.profiler.stats["host_syncs"].total == pull_count(planner.profiler)
    assert np.array_equal(plans[0], plans[1])


# -- the T-MPC++ step --------------------------------------------------------------------
def test_tmpc_step_spans_and_escalation_counters():
    planner, state, data = tmpc_planner()
    planner.solver.qp_mu_stall = 0.0  # every feasible planner counts as stalled
    module = planner.modules.get("GuidanceConstraints")
    steps = []
    step = module._fused_step

    def recorded(*args, escalated=False, **kw):
        out = step(*args, escalated=escalated, **kw)
        steps.append((out[0].numpy().copy(), escalated))
        return out

    module._fused_step = recorded
    prof = planner.profiler
    prof.record_trace = True
    assert planner.solve_mpc(state, data).success
    dispatch = spans(prof, "tmpc_dispatch_solve_pull")
    assert len(dispatch) == 1
    for name in ("tmpc_halfspaces", "k3_launch", "exit_codes", "tmpc_select",
                 "pull.tmpc_packed"):
        assert any(inside(s, dispatch) for s in spans(prof, name)), name
    assert all(inside(s, spans(prof, "tmpc_select")) for s in spans(prof, "pull.tmpc_best"))
    assert prof.stats["pull.tmpc_best"].count == 2 * prof.stats["tmpc_select"].count
    for name in ("tmpc_halfspaces", "k3_launch", "tmpc_select", "pull.tmpc_packed_cold"):
        assert any(inside(s, spans(prof, "tmpc_escalation")) for s in spans(prof, name)), name
    assert [e for _, e in steps] == [False, True]
    B = module.n_planners
    codes = module._unpack(steps[0][0], B)[3]
    flagged = int(((codes == EXIT_FAILURE) | (codes == EXIT_SUCCESS)).sum())
    assert flagged > 0
    assert prof.stats["escalation_flagged"].total == flagged
    assert prof.stats["escalation_solved"].total == B
    assert prof.stats["host_syncs"].total == pull_count(prof)
    assert inside(spans(prof, "guidance_update")[0], spans(prof, "update.GuidanceConstraints"))


# -- the bare solver ---------------------------------------------------------------------
def test_bare_solve_batch_records_into_its_own_profiler():
    cfg = default_config(N=10)
    cfg = cfg.replace(solver=cfg.solver.__class__(**SOLVER_SMALL))
    model, modules = presets.configuration_tmpc(cfg)
    ocp, Z0, P, xinit = presets.preset_problem(cfg, model, modules, 6, 0)
    solver = SQPSolver(ocp, device="cpu")
    solver.rti_fused = True
    solver.qp_mu_stall = 0.0  # every feasible element counts as stalled
    prof = solver.profiler
    assert isinstance(prof, Profiler)
    prof.record_trace = True
    B = 3
    Zb = np.repeat(Z0[None], B, 0) + np.random.default_rng(0).normal(0, 0.01, (B,) + Z0.shape)
    solver.solve_batch(Zb, np.repeat(P[None], B, 0), np.repeat(xinit[None], B, 0),
                       num_iterations=2)
    for name in ("k3_launch", "exit_codes", "pull.exit_codes", "pull.qp_mu",
                 "solve_batch_escalation"):
        assert name in prof.stats, name
    assert len(spans(prof, "k3_launch")) == 2  # the solve and its cold re-solve
    assert inside(spans(prof, "k3_launch")[1], spans(prof, "solve_batch_escalation"))
    assert prof.stats["escalation_flagged"].total == B
    assert prof.stats["escalation_solved"].total == B
    assert prof.stats["host_syncs"].total == 2


# -- the benchmark's readers -------------------------------------------------------------
def _run(scopes, driver="closed_loop", cycles=4):
    return {"driver": driver, "cycles": cycles, "scopes": scopes, "trace": None}


SCOPES = {"k3_launch": (0.004, 5), "exit_codes": (0.008, 5), "pull.Z": (0.010, 4),
          "pull.exit_codes": (0.006, 4), "host_syncs": (20, 20), "tmpc_escalation": (0.003, 1),
          "solve_batch_escalation": (0.001, 1), "gc": (0.002, 7), "optimization": (0.05, 4)}


@pytest.mark.parametrize("name,expected,absent", [
    ("k3_launch_ms.corridor", 1.0, "k3_launch"),
    ("exit_codes_ms.corridor", 2.0, "exit_codes"),
    ("pull_wait_ms.corridor", 4.0, "pull.Z"),
    ("host_syncs_per_cycle.corridor", 5.0, None),
    ("escalation_ms.corridor", 1.0, None),
    ("gc_ms.corridor", 0.5, "gc"),
])
def test_metric_readers(name, expected, absent):
    from mpcbench import cells

    read = cells.metric_reader(name)
    assert read(_run(SCOPES)) == pytest.approx(expected)
    assert read(_run(SCOPES, driver="fleet")) is None
    assert read(_run(SCOPES, cycles=0)) is None
    # a program without these spans (no host_syncs counter): nothing to read
    assert read(_run({k: v for k, v in SCOPES.items() if k != "host_syncs"})) is None
    if absent is not None:
        scopes = {k: v for k, v in SCOPES.items() if not k.startswith(absent)}
        if name == "pull_wait_ms.corridor":
            scopes = {k: v for k, v in SCOPES.items() if not k.startswith("pull.")}
        assert read(_run(scopes)) == 0.0
    else:
        scopes = {k: v for k, v in SCOPES.items() if "escalation" not in k}
        assert read(_run(scopes)) == (0.0 if name == "escalation_ms.corridor" else expected)


# -- on the card -------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _is_upload(warning):
    """Whether the line that raised a synchronizing-operation warning copies
    host data to the device (torch.as_tensor / torch.tensor)."""
    line = linecache.getline(warning.filename, warning.lineno)
    return re.search(r"torch\.(as_tensor|tensor)\(", line) is not None


def _sync_warnings(fn):
    """(warnings of synchronizing CUDA operations raised by fn(), the device
    trace around it)."""
    from mpcbench.device import DeviceTrace

    torch.cuda.synchronize()
    with DeviceTrace() as trace:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchronizing" in str(w.message)]
    return syncs, trace


@pytest.mark.cuda
@pytest.mark.parametrize("make", [goal_planner, tmpc_planner], ids=["goal", "tmpc"])
def test_every_host_sync_goes_through_pull(card, make):
    """One cycle of the corridor configuration on the card, after a first
    that builds K3: every device-to-host copy on the device trace, and every
    synchronizing-operation warning but those of host-to-device uploads,
    comes from a pull."""
    planner, state, data = make(device=None)
    assert planner.solve_mpc(state, data).success
    advance(planner, state, data)
    prof = planner.profiler
    prof.reset()
    syncs, trace = _sync_warnings(lambda: planner.solve_mpc(state, data))
    n = prof.stats["host_syncs"].total
    copies = [k[0] for k in trace.kernels if k[0].startswith("Memcpy")]
    dtoh = [c for c in copies if "DtoH" in c]
    in_pull = [w for w in syncs if w.filename.endswith("profiling.py")]
    outside = [w for w in syncs if w not in in_pull]
    print(f"{make.__name__}: host_syncs {n}, sync warnings {len(syncs)} ({len(in_pull)} in pull), "
          f"copies to the host {len(dtoh)}; outside pull: "
          + ", ".join(f'{w.filename.split("/")[-1]}:{w.lineno}' for w in outside))
    assert n == pull_count(prof) > 0
    assert len(in_pull) == n
    assert len(dtoh) == n
    assert all(_is_upload(w) for w in outside)


@pytest.mark.cuda
def test_a_span_holds_its_kernel_on_the_device_trace(card):
    """A span around a long kernel (a 4096^3 float32 product) and the
    synchronisation after it holds the kernel's interval as
    mpcbench/device.py maps the device trace onto perf_counter, within
    0.1 ms at either end."""
    from mpcbench.device import DeviceTrace

    prof = Profiler()
    prof.record_trace = True
    a = torch.randn(4096, 4096, device=card)
    (a @ a).sum().item()
    offsets = []
    for _ in range(5):
        with DeviceTrace() as trace:
            with prof.scope("product"):
                a @ a
                torch.cuda.synchronize()
        e = prof.events[-1]
        start = prof._t0 + e["ts"] / 1e6
        end = start + e["dur"] / 1e6
        assert trace.kernels, "the device trace holds no kernel"
        name, k_start, k_end = max(trace.kernels, key=lambda k: k[2] - k[1])
        k_start, k_end = k_start / 1e9, k_end / 1e9
        offsets.append((k_start - start, end - k_end))
    print("kernel start after the span's start, span's end after the kernel's end (ms): "
          + "; ".join(f"{a * 1e3:.4f}, {b * 1e3:.4f}" for a, b in offsets))
    for a, b in offsets:
        assert a > -1e-4 and b > -1e-4
