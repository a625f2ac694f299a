"""Find a cell's parts by name: `BENCHMARK.json` at the checkout's root, and
under mpcbench/ the configuration files (configs/<name>.json), the traffic
mixes (traffic/<name>.json), the per-layer metric readers
(metrics/<name>.py) and the limits of the comparison (limits/<cell>.json).

A later cell, configuration, mix or metric is a new file and a new entry;
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class MissingPart(RuntimeError):
    pass


def _json(path: str) -> dict:
    if not os.path.exists(path):
        raise MissingPart(f"{os.path.relpath(path, ROOT)} is missing")
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def config_file(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise MissingPart(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str, here: str = HERE) -> dict:
    return _json(os.path.join(here, "traffic", f"{name}.json"))


def limits_file(cell: str, here: str = HERE) -> dict:
    return _json(os.path.join(here, "limits", f"{cell}.json"))


def metric_reader(name: str, here: str = HERE):
    """The `read(run)` function of metrics/<name>.py."""
    path = os.path.join(here, "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise MissingPart(f"metrics/{name}.py is missing")
    spec = importlib.util.spec_from_file_location(f"mpcbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str, end_to_end_names: List[str]) -> bool:
    """Whether a metric is reported in `cell`: the cells it lists, or without
    a list every cell that reports the end-to-end metric it moves (for an
    end-to-end metric: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in end_to_end_names


def cell(name: str, root: str = ROOT, here: str = HERE) -> dict:
    """Everything a run of cell `name` reads."""
    bench = benchmark(root)
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise MissingPart(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if applies(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if applies(m, name, e2e_names)]
    return {"workload": w, "config": config_file(bench, w["config"], root),
            "traffic": traffic_file(w["traffic"], here), "limits": limits_file(name, here),
            "end_to_end": e2e, "per_layer": per_layer}
