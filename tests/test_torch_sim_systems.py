"""Port vs reference, on the CPU: the configuration tree (repair of fault
(h)), the message schemas, the system layer and the closed-loop simulator.

* Config: the reference's defaults, the nested dict and YAML loading of
  tests/test_config.py:9-46 (the YAML case skips without pyyaml), and
  `load_config(data=...)` giving the same fields in both packages for the
  same settings dict (SH-MPC section and max_obstacle_distance included).
* msgs.py: tests/test_msgs.py's five on the port's copy, which equals the
  reference's file byte for byte.
* systems.py: tests/test_systems.py's seven on the port's planner; the
  obstacle conversion yields the same obstacles as the reference's.
* The SH-MPC closed loop of tests/test_scenario.py:72-83 on the port's
  simulator (30 steps, the derived draw, slow-marked as the reference's)
  and a 10-step twin at 64 samples a solver,
  each held against the JAX package's run on outcome: no collision, forward
  progress, the same step count. The draws differ between the packages, so
  the trajectories are not compared.
* The T-MPC++ corridor of examples/02_tmpc_corridor.py (the flagship at
  N=10, four oncoming pedestrians with social forces, 20 m) on the port's
  simulator against the JAX package's: the same completion and collision
  count, step counts within 2 (slow-marked: ~6 min on the CPU; a shorter
  twin still pays the reference's T-MPC compiles, ~2.5 min).
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import mpc_planner_tpu.msgs as jax_msgs
import mpc_planner_tpu.systems as jax_systems
import mpc_planner_tpu.utils.config as jax_config
from mpc_planner_tpu_torch import msgs, systems
from mpc_planner_tpu_torch.data_preparation import pack_obstacles
from mpc_planner_tpu_torch.planner import Planner
from mpc_planner_tpu_torch.presets import configuration_basic
from mpc_planner_tpu_torch.types import PredictionType, State
from mpc_planner_tpu_torch.utils.config import Config, default_config, load_config

torch.set_num_threads(1)


@pytest.fixture
def cfg():
    # conftest's cfg, in the port: N=10, 4 RTI, 10 IP iterations
    c = default_config(N=10)
    return c.replace(solver=c.solver.__class__(iterations=4, qp_iterations=10))


# -- config ------------------------------------------------------------------------
def test_defaults_mirror_reference_settings():
    cfg = default_config()
    assert (cfg.N, cfg.integrator_step, cfg.max_obstacles, cfg.robot_radius) == (30, 0.2, 12, 0.325)
    assert cfg.control_frequency == 20
    assert cfg.weights["contour"] == 0.05 and cfg.weights["lag"] == 0.75
    assert cfg.t_mpc.n_paths == 4
    assert cfg.scenario_constraints.parallel_solvers == 4
    ref = jax_config.default_config()
    assert dataclasses.asdict(cfg.scenario_constraints) == dataclasses.asdict(ref.scenario_constraints)
    assert cfg.max_obstacle_distance == ref.max_obstacle_distance == 30.0


def test_load_config_from_dict_nested():
    cfg = load_config(data={"N": 15, "contouring": {"num_segments": 8},
                            "t-mpc": {"use_t-mpc++": False}, "weights": {"contour": 0.2}})
    assert cfg.N == 15
    assert cfg.contouring.num_segments == 8
    assert not cfg.t_mpc.use_tmpc_pp
    assert cfg.weights["contour"] == 0.2
    assert cfg.weights["lag"] == 0.75  # merged, not replaced


def test_load_config_from_yaml(tmp_path):
    pytest.importorskip("yaml")
    p = tmp_path / "settings.yaml"
    p.write_text("N: 12\nrobot_radius: 0.5\nroad:\n  width: 8.0\n")
    cfg = load_config(str(p))
    assert (cfg.N, cfg.robot_radius, cfg.road.width) == (12, 0.5, 8.0)


def test_with_weights_immutable():
    cfg = default_config()
    cfg2 = cfg.with_weights(contour=1.0)
    assert cfg.weights["contour"] == 0.05 and cfg2.weights["contour"] == 1.0


def test_load_config_same_fields_as_reference():
    """One settings dict, both packages: every field the port carries equals
    the reference's (the reference's TPU solver keys are skipped)."""
    data = {"N": 20, "max_obstacle_distance": 12.5, "n_discs": 2,
            "scenario_constraints": {"parallel_solvers": 16, "n_samples": 200, "confidence": 0.05,
                                     "support_bound": 4, "warmstart_span": 1.5},
            "probabilistic": {"risk": 0.1}, "t-mpc": {"use_t-mpc++": False, "n_paths": 3},
            "solver": {"iterations": 6, "qp_wide_blocks": 2, "qp_mu_stall": 1e-2},
            "weights": {"slack": 5000.0}, "not_a_key": 1}
    cfg, ref = load_config(data=data), jax_config.load_config(data=data)
    for f in dataclasses.fields(Config):
        mine, theirs = getattr(cfg, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(mine):
            for sub in dataclasses.fields(mine):
                assert getattr(mine, sub.name) == getattr(theirs, sub.name), (f.name, sub.name)
        else:
            assert mine == theirs, f.name
    assert cfg.scenario_constraints.n_samples == 200 and cfg.solver.iterations == 6


# -- msgs --------------------------------------------------------------------------
def test_msgs_is_the_reference_file():
    src = {p: open(p.__file__).read() for p in (msgs, jax_msgs)}
    assert src[msgs] == src[jax_msgs]


def test_roundtrip():
    g = msgs.GaussianMsg(mean_x=[1, 2], mean_y=[3, 4], major_semiaxis=[0.1, 0.2],
                         minor_semiaxis=[0.05, 0.1])
    o = msgs.ObstacleGMMMsg(id=7, pose_x=1.0, pose_y=2.0, pose_psi=0.3, gaussians=[g],
                            probabilities=[1.0])
    arr2 = msgs.ObstacleArrayMsg.from_dict(msgs.ObstacleArrayMsg(obstacles=[o]).to_dict())
    assert arr2.obstacles[0].id == 7
    assert arr2.obstacles[0].gaussians[0].mean_x == [1, 2]


def test_to_raw_obstacle_carries_all_modes():
    g1 = msgs.GaussianMsg(mean_x=[0], mean_y=[0], major_semiaxis=[1], minor_semiaxis=[1])
    g2 = msgs.GaussianMsg(mean_x=[9], mean_y=[9], major_semiaxis=[2], minor_semiaxis=[2])
    pred = msgs.ObstacleGMMMsg(id=1, gaussians=[g1, g2], probabilities=[0.2, 0.8]).to_raw_obstacle()
    pred = pred["prediction"]
    np.testing.assert_allclose(pred["positions"], [[[0, 0]], [[9, 9]]])
    np.testing.assert_allclose(pred["major"], [[1], [2]])
    np.testing.assert_allclose(pred["probabilities"], [0.2, 0.8])


def _gmm_array(N, modes):
    gs = [msgs.GaussianMsg(mean_x=list(np.linspace(3, 5, N)), mean_y=[0.0] * N,
                           major_semiaxis=[0.2] * N, minor_semiaxis=[0.1] * N),
          msgs.GaussianMsg(mean_x=[3.0] * N, mean_y=list(np.linspace(0, 2, N)),
                           major_semiaxis=[0.3] * N, minor_semiaxis=[0.1] * N)][:modes]
    probs = [0.6, 0.4][:modes] if modes > 1 else [1.0]
    return msgs.ObstacleArrayMsg(obstacles=[msgs.ObstacleGMMMsg(
        id=0, pose_x=3.0, pose_y=0.0, gaussians=gs, probabilities=probs)])


def test_gmm_message_reaches_multimodal_block(cfg):
    N = cfg.N
    obstacles = systems.convert_obstacle_messages(cfg, State(nx=5), _gmm_array(N, 2).to_raw_obstacles())
    assert obstacles[0].prediction.positions.shape[0] == 2
    np.testing.assert_allclose(obstacles[0].prediction.probabilities, [0.6, 0.4])
    blk = pack_obstacles(obstacles, N)
    assert blk.n_modes == 2 and blk.modes_angle is not None
    np.testing.assert_allclose(blk.modes_angle[0, 1, : N - 1], np.pi / 2, atol=1e-6)
    np.testing.assert_allclose(blk.pred_position[0, -1], [5.0, 0.0])


def test_supplied_prediction_uncertainty_propagated(cfg):
    assert cfg.probabilistic.enable and cfg.probabilistic.propagate_uncertainty
    N = cfg.N
    g = msgs.GaussianMsg(mean_x=list(np.linspace(3, 5, N)), mean_y=[0.0] * N,
                         major_semiaxis=[0.5] * N, minor_semiaxis=[0.5] * N)
    arr = msgs.ObstacleArrayMsg(obstacles=[msgs.ObstacleGMMMsg(id=0, pose_x=3.0, pose_y=0.0,
                                                               gaussians=[g], probabilities=[1.0])])
    obstacles = systems.convert_obstacle_messages(cfg, State(nx=5), arr.to_raw_obstacles())
    np.testing.assert_allclose(obstacles[0].prediction.major[0],
                               0.5 * cfg.dt * np.sqrt(np.arange(1, N + 1)), rtol=1e-6)
    dummy = obstacles[-1]
    assert dummy.index == -1
    np.testing.assert_allclose(dummy.prediction.major[0],
                               0.3 * cfg.dt * np.sqrt(np.arange(1, N + 1)), rtol=1e-6)


def test_msgs_feed_conversion(cfg):
    obstacles = systems.convert_obstacle_messages(cfg, State(nx=5), _gmm_array(cfg.N, 1).to_raw_obstacles())
    assert len(obstacles) == cfg.max_obstacles
    assert obstacles[0].index == 0


# -- systems -----------------------------------------------------------------------
def _make_loop(cfg):
    model, modules = configuration_basic(cfg)
    return systems.RobotLoop(Planner(model, modules, cfg, device="cpu"), cfg), model


def test_obstacle_message_conversion(cfg):
    msgs_in = [
        {"id": 0, "position": [3.0, 1.0], "velocity": [0.5, 0.0]},
        {"id": 1, "position": [5.0, -1.0],
         "prediction": {"positions": np.tile([5.0, -1.0], (cfg.N, 1)),
                        "major": np.full(cfg.N, 0.2), "minor": np.full(cfg.N, 0.1)}},
        {"id": 2, "position": [500.0, 0.0]},  # beyond max_obstacle_distance
    ]
    obstacles = systems.convert_obstacle_messages(cfg, State(nx=5), msgs_in)
    assert len(obstacles) == cfg.max_obstacles  # padded with dummies
    ids = [o.index for o in obstacles]
    assert 0 in ids and 1 in ids and 2 not in ids
    assert next(o for o in obstacles if o.index == 1).prediction.type == int(PredictionType.GAUSSIAN)
    # the reference's conversion of the same messages, field by field
    from mpc_planner_tpu.types import State as JaxState

    ref = jax_systems.convert_obstacle_messages(jax_config.default_config(N=cfg.N), JaxState(nx=5),
                                                msgs_in)
    assert [o.index for o in ref] == ids
    for o, r in zip(obstacles, ref):
        np.testing.assert_array_equal(o.position, r.position)
        for f in ("positions", "angles", "major", "minor", "probabilities"):
            np.testing.assert_array_equal(getattr(o.prediction, f), getattr(r.prediction, f))


def test_robot_loop_drives(cfg):
    loop, _ = _make_loop(cfg)
    xs = np.linspace(0, 12, 8)
    loop.set_reference_path(xs, np.zeros_like(xs))
    pose, v, moved = np.array([0.0, 0.0, 0.0]), 0.0, False
    for _ in range(15):
        v_cmd, w_cmd, ok = loop.tick(pose, v, [])
        pose[0] += v_cmd * np.cos(pose[2]) * cfg.dt
        pose[1] += v_cmd * np.sin(pose[2]) * cfg.dt
        pose[2] += w_cmd * cfg.dt
        v = v_cmd
        moved |= ok
    assert moved
    assert pose[0] > 0.5  # forward progress


def test_braking_fallback_on_infeasible(cfg):
    loop, _ = _make_loop(cfg)
    v_cmd, w_cmd, ok = loop.tick(np.array([0.0, 0.0, 0.0]), 2.0, [])  # no path: not ready
    assert not ok
    assert v_cmd == max(2.0 - cfg.deceleration_at_infeasible * cfg.dt, 0.0)
    assert w_cmd == 0.0


def test_navigation_planner_rotate_to_goal(cfg):
    model, modules = configuration_basic(cfg)
    nav = systems.NavigationPlanner(Planner(model, modules, cfg, device="cpu"), cfg)
    plan = np.stack([np.linspace(0, 5, 6), np.zeros(6), np.full(6, np.pi / 2)], axis=1)
    assert nav.set_plan(plan)
    v, w = nav.compute_velocity_commands(np.array([5.0, 0.0, 0.0]), 0.0, [])
    assert v == 0.0 and w > 0.0
    assert not nav.is_goal_reached(np.array([5.0, 0.0, 0.0]))
    assert nav.is_goal_reached(np.array([5.0, 0.0, np.pi / 2]))


def test_flipped_robot_detection(cfg):
    loop, _ = _make_loop(cfg)
    xs = np.linspace(0, 10, 6)
    loop.set_reference_path(xs, np.zeros_like(xs))
    assert loop.tick((0.0, 0.0, 0.0), 1.0, [], roll=2.0) == (0.0, 0.0, False)
    assert loop.flipped
    loop.tick((0.0, 0.0, 0.0), 1.0, [])
    assert not loop.flipped


def test_watchdog_expiry():
    wd = systems.Watchdog(timeout=0.5)
    wd.kick(now=100.0)
    assert not wd.expired(now=100.4)
    assert wd.expired(now=100.6)
    wd.kick(now=101.0)
    assert not wd.expired(now=101.2)


def test_debug_limits_reports_bound_hits(cfg, caplog):
    cfg2 = cfg.replace(debug_limits=True)
    model, modules = configuration_basic(cfg2)
    planner = Planner(model, modules, cfg2, device="cpu")
    Z = np.zeros((cfg2.N + 1, model.nvar))
    Z[:, model.index("a")] = model.upper_bound[model.index("a")]  # saturated
    Z[:, model.index("v")] = model.lower_bound[model.index("v")]
    with caplog.at_level(logging.WARNING):
        planner._report_bound_hits(Z)
    assert "'a' hits its upper bound" in caplog.text
    assert "'v' hits its lower bound" in caplog.text


# -- the SH-MPC closed loop --------------------------------------------------------
def _closed_loop(pkg: str, steps: int, cfg_overrides=None):
    """tests/test_scenario.py:72-83 in package `pkg`: configuration_safe_horizon
    (N=10, 4 RTI) through the simulator with two pedestrians walking toward
    the robot. Returns the SimResult."""
    if pkg == "jax":
        import mpc_planner_tpu.planner as P
        import mpc_planner_tpu.presets as presets
        import mpc_planner_tpu.sim.simulator as S
        make = P.Planner
    else:
        import mpc_planner_tpu_torch.presets as presets
        import mpc_planner_tpu_torch.sim as S
        make = Planner
    c = presets.default_config(N=10)
    c = c.replace(solver=c.solver.__class__(iterations=4, qp_iterations=10), **(cfg_overrides or {}))
    model, modules = presets.configuration_safe_horizon(c)
    planner = make(model, modules, c, **({} if pkg == "jax" else {"device": "cpu"}))
    peds = [S.Pedestrian(position=np.array([5.0, 0.5]), velocity=np.array([-0.3, 0.0]), radius=0.4),
            S.Pedestrian(position=np.array([8.0, -0.5]), velocity=np.array([-0.2, 0.1]), radius=0.4)]
    xs = np.linspace(0, 14, 8)
    return S.ClosedLoopSimulator(planner, c, peds, {"x": xs, "y": np.zeros_like(xs)}).run(max_steps=steps)


def _same_outcome(res, ref, progress):
    assert res.collisions == ref.collisions == 0
    assert res.trajectory[-1][0] > progress and ref.trajectory[-1][0] > progress
    assert res.steps == ref.steps
    assert res.completed == ref.completed
    records = res.module_records
    assert len(records) == res.steps
    assert all(0.0 <= r["scenario_risk_certificate"] <= 1.0 for r in records)


def test_scenario_closed_loop_twin():
    """10 steps at 64 samples a solver: no collision, forward progress, the
    same step count."""
    out = []
    for pkg, config in (("torch", default_config), ("jax", jax_config.default_config)):
        sc = dataclasses.replace(config().scenario_constraints, n_samples=64)
        out.append(_closed_loop(pkg, 10, dict(scenario_constraints=sc)))
    _same_outcome(*out, progress=0.5)


@pytest.mark.slow
def test_scenario_closed_loop():
    """The reference's 30 steps (tests/test_scenario.py:72-83)."""
    _same_outcome(_closed_loop("torch", 30), _closed_loop("jax", 30), progress=1.5)


# -- the T-MPC++ corridor ----------------------------------------------------------
def _tmpc_corridor(pkg: str, steps: int):
    """examples/02_tmpc_corridor.py's run in package `pkg`; the SimResult."""
    if pkg == "jax":
        import mpc_planner_tpu.planner as P
        import mpc_planner_tpu.presets as presets
        import mpc_planner_tpu.sim.simulator as S
        make, kw = P.Planner, {}
    else:
        import mpc_planner_tpu_torch.presets as presets
        import mpc_planner_tpu_torch.sim as S
        make, kw = Planner, {"device": "cpu"}
    c = presets.default_config(N=10)
    model, modules = presets.configuration_tmpc(c)
    planner = make(model, modules, c, **kw)
    xs = np.linspace(0.0, 20.0, 12)
    rng = np.random.default_rng(3)
    peds = [S.Pedestrian(position=np.array([4.0 + 3.5 * i, float(rng.uniform(-1.5, 1.5))]),
                         velocity=np.array([-0.9, float(rng.uniform(-0.2, 0.2))])) for i in range(4)]
    sim = S.ClosedLoopSimulator(planner, c, peds, {"x": xs, "y": np.zeros_like(xs)},
                                social_forces=True, robot_aware=True)
    return sim.run(max_steps=steps)


@pytest.mark.slow
def test_tmpc_corridor_closed_loop():
    """The whole corridor: the same completion and collisions (none), steps
    within 2 of the reference's."""
    res, ref = _tmpc_corridor("torch", 200), _tmpc_corridor("jax", 200)
    assert res.completed and ref.completed
    assert res.collisions == ref.collisions == 0
    assert abs(res.steps - ref.steps) <= 2
