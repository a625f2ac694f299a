"""Port vs reference, on the CPU: the generated-maps contract
(solver/maps.py), the log helpers (utils/logging.py), the visualizer
(utils/visualization.py, Planner.visualize) and the experiment recorder
(utils/experiment.py), mirroring tests/test_visualization.py and the
save_solver_maps case of tests/test_parameters.py.

* save_solver_maps: the three YAML files equal the reference's byte for
  byte for the same OCP.
* utils/logging.py: the reference's code (docstring aside); the same text
  printed; log_throttle's module-level state throttles per key.
* Visualizer.to_json: the same JSON text for the same inputs.
* Planner.visualize on the flagship after one cycle: the same artifacts as
  the reference's planner (types, names, obstacle and ellipse items, robot
  discs and road halfspaces equal; trajectories and T-MPC candidates within
  5e-3, the planner agreement tolerance; the same selected candidate).
* ExperimentUtil: the same record fields and export layout over three
  cycles; values equal but for the solver's numbers (5e-3) and the clocks.
"""

import json
import os

import numpy as np
import pytest
import torch

import mpc_planner_tpu.utils.experiment as jax_experiment
import mpc_planner_tpu.utils.logging as jax_logging
import mpc_planner_tpu.utils.visualization as jax_visualization
from mpc_planner_tpu_torch.utils import experiment, logging, visualization

torch.set_num_threads(1)

N = 10


def _pair(make):
    """make(pkg) for both packages: (jax's, torch's)."""
    return make("jax"), make("torch")


def _tmpc(pkg, n_pedestrians=6, seed=7):
    if pkg == "jax":
        import mpc_planner_tpu.presets as presets
        from mpc_planner_tpu.planner import Planner
        kw = {}
    else:
        import mpc_planner_tpu_torch.presets as presets
        from mpc_planner_tpu_torch.planner import Planner
        kw = {"device": "cpu"}
    cfg = presets.default_config(N=N)
    cfg = cfg.replace(solver=cfg.solver.__class__(iterations=4, qp_iterations=10))
    model, modules = presets.configuration_tmpc(cfg)
    planner = Planner(model, modules, cfg, **kw)
    state, data = presets.corridor_scene(cfg, n_pedestrians=n_pedestrians, seed=seed)
    planner.on_data_received(data, "reference_path")
    return cfg, model, planner, state, data


def test_save_solver_maps_match_reference(tmp_path):
    from mpc_planner_tpu.solver.maps import save_solver_maps as jax_save
    from mpc_planner_tpu_torch.solver.maps import save_solver_maps

    paths = {}
    for pkg, save in (("jax", jax_save), ("torch", save_solver_maps)):
        if pkg == "jax":
            import mpc_planner_tpu.presets as presets
            from mpc_planner_tpu.solver.ocp import OCP
        else:
            import mpc_planner_tpu_torch.presets as presets
            from mpc_planner_tpu_torch.solver.ocp import OCP
        cfg = presets.default_config(N=N)
        model, modules = presets.configuration_basic(cfg)
        paths[pkg] = save(str(tmp_path / pkg), model, OCP(model, modules, cfg))
    assert paths["torch"].keys() == paths["jax"].keys() == {"solver_settings", "parameter_map", "model_map"}
    for name, path in paths["torch"].items():
        assert open(path).read() == open(paths["jax"][name]).read(), name
    import yaml

    settings = yaml.safe_load(open(paths["torch"]["solver_settings"]))
    assert settings["N"] == N and settings["nh"] == 12 and settings["nvar"] == 7


def test_logging_is_the_reference_code(capsys):
    def body(mod):
        src = open(mod.__file__).read()
        return src[src.index("from __future__"):]

    assert body(logging) == body(jax_logging)
    for mod in (jax_logging, logging):
        mod.print_header("h")
        mod.print_value("k", 1)
        mod.print_success("s")
        mod.print_warning("w")
    out = capsys.readouterr().out.splitlines()
    assert out[:4] == out[4:]
    logging.log_throttle(60.0, "key", "first")
    logging.log_throttle(60.0, "key", "dropped")
    logging.log_throttle(60.0, "other", "second")
    out = capsys.readouterr().out
    assert "first" in out and "second" in out and "dropped" not in out


def _fill(viz_mod, blk, model):
    rng = np.random.default_rng(0)
    viz = viz_mod.Visualizer()
    viz.add_trajectory(rng.normal(size=(N, 2)), "planned_trajectory")
    viz.add_obstacles(blk)
    viz.add_prediction_ellipses(blk, chi=2.0)
    viz.add_halfspaces(rng.normal(size=(N, 4, 3)).reshape(-1, 3), "road_constraints")
    viz.add_robot_area(np.array([0.5, -0.2]), 0.3, [(0.0, 0.325), (0.4, 0.325)])
    viz.add_tmpc_candidates(rng.normal(size=(5, N + 1, model.nvar)).astype(np.float32), model, 2)
    return viz


def test_visualizer_json_matches_reference(flagship):
    (_, jm, _, _, jd), (_, tm, _, _, td) = flagship
    np.testing.assert_array_equal(td.obstacle_block.position, jd.obstacle_block.position)
    ref = _fill(jax_visualization, jd.obstacle_block, jm).to_json()
    assert _fill(visualization, td.obstacle_block, tm).to_json() == ref


def _assert_same_artifacts(out, ref):
    assert [(a["type"], a["name"]) for a in out] == [(a["type"], a["name"]) for a in ref]
    for a, b in zip(out, ref):
        if a["type"] in ("trajectory",):
            np.testing.assert_allclose(a["points"], b["points"], atol=5e-3)
        elif a["type"] == "candidates":
            assert [i["selected"] for i in a["items"]] == [i["selected"] for i in b["items"]]
            for i, j in zip(a["items"], b["items"]):
                np.testing.assert_allclose(i["points"], j["points"], atol=5e-3)
        else:
            assert a == b


@pytest.fixture(scope="module")
def flagship():
    """The flagship planner of both packages on corridor_scene(6, seed 7), a
    scene whose T-MPC selection is decided by a margin (in scenes where
    several planners converge to one optimum the pick among them is
    rounding's); the tests below run cycles on it in turn."""
    return _pair(_tmpc)


def test_planner_visualize_matches_reference(flagship):
    (_, _, jp, js, jd), (_, _, tp, ts, td) = flagship
    assert jp.solve_mpc(js, jd).success and tp.solve_mpc(ts, td).success
    out, ref = tp.visualize(ts, td), jp.visualize(js, jd)
    kinds = {a["type"] for a in out.artifacts}
    assert {"obstacles", "prediction_ellipses", "discs", "candidates", "halfspaces"} <= kinds
    _assert_same_artifacts(json.loads(out.to_json()), json.loads(ref.to_json()))


def _same_layout(out, ref, path=""):
    """Same keys and lengths; strings, ints and flags equal; floats within
    5e-3, clocks skipped."""
    if isinstance(ref, dict):
        assert out.keys() == ref.keys(), path
        for k in ref:
            if k not in ("duration", "runtime"):
                _same_layout(out[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(out) == len(ref), path
        for i, (a, b) in enumerate(zip(out, ref)):
            _same_layout(a, b, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert isinstance(out, (float, int)) and abs(out - ref) <= 5e-3 * max(1.0, abs(ref)), path
    else:
        assert out == ref, path


def test_experiment_export_matches_reference(flagship, tmp_path):
    files = {}
    for pkg, mod, (cfg, _, planner, state, data) in zip(("jax", "torch"), (jax_experiment, experiment),
                                                       flagship):
        exp = mod.ExperimentUtil(cfg, save_folder=str(tmp_path / pkg))
        exp.num_experiments = 1
        for _ in range(3):
            planner.solve_mpc(state, data)
            exp.update(state, planner, data, runtime_s=0.01)
        exp.on_task_complete(objective_reached=False)
        files[pkg] = os.path.join(str(tmp_path / pkg), f"{cfg.name}_experiment.json")
    out, ref = (json.load(open(files[p])) for p in ("torch", "jax"))
    _same_layout(out, ref)
    assert out["summary"]["num_experiments"] == 1 and out["data"][0]["iterations"] == 3
    rec = out["data"][0]["metrics"][0]
    assert len(rec["obstacles"]) == 6  # non-dummies only
    m = rec["modules"]
    assert 0 <= m["guidance_selected_planner"] < m["guidance_n_planners"]
    assert 1 <= m["guidance_n_feasible"] <= m["guidance_n_planners"]


def test_experiment_records_no_tensor():
    """A module metric held as a tensor is recorded as plain Python."""
    assert experiment._host({"a": torch.tensor(1.5), "b": torch.arange(3), "c": np.float32(2.0),
                             "d": "s"}) == {"a": 1.5, "b": [0, 1, 2], "c": 2.0, "d": "s"}
