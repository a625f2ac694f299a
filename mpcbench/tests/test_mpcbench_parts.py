"""Every part of every cell is found by name, and a new cell is data."""

import json
import os
import shutil

import pytest

from mpcbench import cells


def bench():
    return cells.benchmark()


def test_every_cell_finds_its_parts():
    b = bench()
    for w in b["workloads"]:
        cell = cells.cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["driver"] in ("closed_loop", "fleet")
        assert {"param_gap", "wrong_share", "solve_tol", "decide_sensitivity", "spread_factor",
                "checked_cycles"} <= set(cell["limits"])
        assert ("selection_mismatches" in cell["limits"]) == (w["config"] == "jackalsim-tmpc"
                                                              and "corridor" in w["name"])
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert callable(cells.metric_reader(m["name"]))


def test_every_metric_config_and_mix_has_a_file():
    b = bench()
    here = cells.HERE
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(here, "metrics", f"{m['name']}.py"))
    for c in b["configs"]:
        assert os.path.exists(os.path.join(cells.ROOT, c["file"]))
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(here, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(here, "limits", f"{w['name']}.json"))


def test_a_new_cell_is_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(cells.HERE, root / "mpcbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    cfg = json.load(open(os.path.join(cells.ROOT, "mpcbench/configs/jackal-goal.json")))
    cfg["name"] = "jackal-goal-copy"
    (root / "mpcbench/configs/jackal-goal-copy.json").write_text(json.dumps(cfg))
    (root / "mpcbench/traffic/corridor_short.json").write_text(json.dumps(
        dict(json.load(open(os.path.join(cells.HERE, "traffic/corridor_loop.json"))),
             max_steps=50)))
    (root / "mpcbench/limits/copy-corridor.json").write_text(
        (root / "mpcbench/limits/goal-corridor.json").read_text())
    b["configs"].append(dict(b["configs"][1], name="jackal-goal-copy",
                             file="mpcbench/configs/jackal-goal-copy.json"))
    b["workloads"].append({"name": "copy-corridor", "config": "jackal-goal-copy",
                           "traffic": "corridor_short", "chips": 1, "why": "a copy"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "goal-corridor" in m.get("workloads", []):
            m["workloads"].append("copy-corridor")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = cells.cell("copy-corridor", root=str(root), here=str(root / "mpcbench"))
    assert cell["config"]["name"] == "jackal-goal-copy"
    assert cell["traffic"]["max_steps"] == 50
    names = {m["name"] for m in cell["end_to_end"]}
    assert names == {"cycle_ms_mean", "cycle_ms_p95", "setup_s"}


def test_a_missing_part_is_named():
    with pytest.raises(cells.MissingPart):
        cells.cell("no-such-cell")
    with pytest.raises(cells.MissingPart):
        cells.metric_reader("no_such_metric")


def test_readers_return_nothing_without_a_trace():
    b = bench()
    run = {"driver": "closed_loop", "cycles": 10, "window_s": 1.0, "scopes": {},
           "k3_launches": 12, "trace": None, "config": cells.cell("goal-corridor")["config"],
           "traffic": {}, "episodes": 1, "robots": 1}
    for m in b["per_layer"]:
        value = cells.metric_reader(m["name"])(run)
        if m["source"] == "device_trace" or m["source"] == "program_span":
            assert value is None, m["name"]
    assert cells.metric_reader("k3_launches_per_cycle.corridor")(run) == 1.2


def test_the_frozen_work_count_is_read_from_the_configuration():
    from mpcbench import peaks

    config = cells.cell("tmpc-corridor")["config"]
    run = {"driver": "closed_loop", "config": config, "cycles": 10, "episodes": 2, "robots": 1}
    flops, nbytes = peaks.k3_work(run)
    w = config["k3_work"]
    assert flops == 2 * 5 * w["cold"]["flops"] + 8 * 5 * w["warm"]["flops"]
    assert nbytes == 2 * 5 * w["cold"]["bytes"] + 8 * 5 * w["warm"]["bytes"]
    assert w["commit"].startswith("d39245a")
