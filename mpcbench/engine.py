"""A run of one cell, from the parts that `cells.cell` found: the program on
the card, the traffic's generator (mpcbench/drivers/<driver>.py, named by
the mix's file), the end-to-end metrics of the window, the per-layer
metrics' readers, the device trace, and the reference's check.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import time
from typing import List, Tuple


def _card_launches():
    from mpc_planner_tpu_torch.ops import cuda_qp

    return lambda: cuda_qp.launch_counts["rti"]


def run_cell(cell: dict, name: str, seed: int, seconds: float, trace: bool,
             process_start: float, device=None, workers=None) -> Tuple[dict, List[str]]:
    """The run; `device` other than None (the card) serves the CPU tests of
    the harness, which rehearse a run at a small size on the plain route.
    `workers`: the reference's worker processes (reference/pool.py)."""
    import torch

    from mpcbench import device as dev
    from mpcbench import judge

    config, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    chips = int(cell["workload"]["chips"])
    drv = importlib.import_module(f"mpcbench.drivers.{traffic['driver']}")
    # Load from one process with one intra-op thread: the program's host
    # side is small tensors and numpy.
    torch.set_num_threads(1)
    on_card = device is None
    program = drv.Program(config, device=device)
    launches = _card_launches()
    profiler = getattr(getattr(program, "planner", None), "profiler", None)
    window = {}
    device_trace = dev.DeviceTrace() if trace else None

    @contextlib.contextmanager
    def on_window():
        if profiler is not None:
            profiler.reset()
            profiler.record_trace = trace
        window["launches0"] = launches()
        with (device_trace if device_trace is not None else contextlib.nullcontext()):
            yield
        window["launches1"] = launches()

    def after_window():
        if on_card:
            torch.cuda.synchronize()
            window["device"] = dev.device_record(chips)
        else:
            window["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                                "memory_peak_bytes": 0}

    out = drv.run(program, traffic, seed, seconds, launches=launches, on_window=on_window,
                  after_window=after_window, checked_cycles=limits["checked_cycles"])
    setup_s = out["t_start"] - process_start
    scopes = {}
    scope_spans = []
    if profiler is not None:
        scopes = {k: (s.total, s.count) for k, s in profiler.stats.items()}
        t0 = profiler._t0
        scope_spans = [(e["name"], t0 + e["ts"] / 1e6, t0 + (e["ts"] + e["dur"]) / 1e6)
                       for e in profiler.events]
    cycle_spans = [("between_cycles", out["t_start"], out["t_end"])] + [
        ("cycle", c[5], c[5] + c[0]) for c in out["cycles"]]
    run = {"driver": traffic["driver"], "cycles": len(out["cycles"]), "window_s": out["window_s"],
           "scopes": scopes, "k3_launches": window["launches1"] - window["launches0"],
           "trace": device_trace, "config": config, "traffic": traffic,
           "episodes": out.get("outcomes", {}).get("episodes", 0), "robots": out.get("robots", 1)}
    del program, profiler
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    checked = drv.reference_numbers(out, config, traffic, seed, workers=workers)
    numbers, wrong, beside = judge.verdict(checked, limits)
    ref_s = time.perf_counter() - t_ref
    failed_ops = drv.failed_operations(out)
    failed = failed_ops + wrong
    answers = len(checked.gaps)
    correct = (failed == 0 and beside["decided"] > 0
               and all(numbers[k] <= limits[k] for k in numbers))

    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            value = _reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(drv.end_to_end(out), setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    device = dict(window["device"])
    result = {"correct": bool(correct), "attempted": int(drv.attempted(out)), "failed": int(failed),
              "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = device_trace.busy_s()
        device["window_s"] = device_trace.window_s
        result["breakdown"] = {"device_ops": device_trace.top_ops(10),
                               "idle_gaps": device_trace.idle_gaps(scope_spans + cycle_spans, 10)}
    result["checks"] = judge.checks_record(numbers, limits,
                                           {"failed_operations": failed_ops, "wrong_answers": wrong})
    outcomes = drv.outcomes(out)
    info = {"outcomes": outcomes, "card": dev.card_text() if on_card else "cpu",
            "setup_s": setup_s, "reference_s": ref_s, "solves_checked": answers,
            "reported": beside, "param_gaps": checked.params,
            "solve_gaps": checked.gaps, "sensitivities": checked.sens,
            "k3_launches": run["k3_launches"], "cycles": run["cycles"],
            "window_s": out["window_s"]}
    lines = [f"mpcbench: card {info['card']}",
             f"mpcbench: outcomes {json.dumps(outcomes)}",
             f"mpcbench: setup_s {setup_s} window_s {out['window_s']} cycles {run['cycles']} "
             f"k3_launches {run['k3_launches']} reference_s {ref_s} solves {answers} "
             f"beside {json.dumps(beside)}",
             "mpcbench: host scopes ms/cycle " + json.dumps(
                 {k: round(1e3 * v[0] / max(run["cycles"], 1), 3) for k, v in scopes.items()})]
    lines += [f"check {k} {v['value']} limit {v['limit']}" for k, v in result["checks"].items()]
    result["_info"] = info
    return result, lines


def _reader(name: str):
    from mpcbench import cells

    return cells.metric_reader(name)


def result_line(result: dict) -> str:
    keys = ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    return json.dumps({k: result[k] for k in keys if k in result}, default=float)


def write_run_file(directory: str, args, result: dict) -> str:
    """The run's file: the result line's content with the planning outcomes
    and every checked answer's numbers."""
    path = os.path.join(directory, f"{args.workload}_{args.seed}_{args.trace}.json")
    with open(path, "w") as f:
        json.dump({k: v for k, v in result.items()}, f, default=float, indent=1)
    return path
