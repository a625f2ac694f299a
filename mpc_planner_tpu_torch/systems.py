"""System layer: the robot-facing control loops (reference L6).

Counterpart of mpc_planner_tpu/systems.py, in numpy around the port's
planner: the equivalents of the reference's per-robot packages
(mpc_planner_jackalsimulator/src/ros1_jackalsimulator.cpp, _jackal,
_dingo, _rosnavigation): the control loop with actuation and
braking fallback, obstacle message conversion, and a BaseLocalPlanner-
style navigation API (ros1_rosnavigation.cpp:23-133, 245-281) with
rotate-to-goal behavior. ROS topic plumbing is out of scope by design —
inputs arrive as numpy arrays through `RealTimeData`; any middleware can
feed them.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from mpc_planner_tpu_torch.data_preparation import (
    HostObstacle,
    HostPrediction,
    define_robot_area,
    ensure_obstacle_size,
    get_constant_velocity_prediction,
    pack_obstacles,
    propagate_all_uncertainty,
    remove_distant_obstacles,
)
from mpc_planner_tpu_torch.types import PredictionType, RealTimeData, State


def convert_obstacle_messages(
    cfg, state: State, raw_obstacles: List[dict]
) -> List[HostObstacle]:
    """Obstacle messages -> padded HostObstacle list.

    Mirrors ros1_jackalsimulator.cpp obstacleCallback (:298-347):
    GAUSSIAN if uncertainty present; constant-velocity prediction when
    none supplied; distance filter + sort/pad to max_obstacles +
    uncertainty propagation of ALL predictions (ref
    data_preparation.cpp:170-186 — supplied ones included; the
    constant-velocity ones, propagated at construction, are skipped via
    `HostPrediction.propagated`).

    raw entries: {"id", "position" [2], "angle", "radius"?, "velocity"? [2],
    "prediction"?: {"positions" [N,2] or [K,N,2], "major" [N] or [K,N],
    "minor" [N] or [K,N], "angles"? (same shape as major),
    "probabilities"? [K]}}. A leading K axis carries a full GMM (ref
    ObstacleGMM.msg) through to `HostPrediction.modes_*` for multi-modal
    SH-MPC sampling.
    """
    obstacles: List[HostObstacle] = []
    for msg in raw_obstacles:
        o = HostObstacle(
            index=int(msg.get("id", len(obstacles))),
            position=np.asarray(msg["position"], dtype=float),
            angle=float(msg.get("angle", 0.0)),
            radius=float(msg.get("radius", cfg.obstacle_radius)),
        )
        pred = msg.get("prediction")
        if pred is not None:
            positions = np.asarray(pred["positions"], dtype=float)
            if positions.ndim == 2:  # single mode -> [1, N, 2]
                positions = positions[None]
            K, n = positions.shape[:2]
            major = np.atleast_2d(np.asarray(pred.get("major", np.zeros(n)), dtype=float))
            minor = np.atleast_2d(np.asarray(pred.get("minor", np.zeros(n)), dtype=float))
            angles = np.atleast_2d(np.asarray(pred.get("angles", np.zeros(n)), dtype=float))
            if major.shape[0] == 1 and K > 1:
                major = np.broadcast_to(major, (K, n))
                minor = np.broadcast_to(minor, (K, n))
            if angles.shape[0] == 1 and K > 1:
                angles = np.broadcast_to(angles, (K, n))
            probs = np.asarray(pred.get("probabilities", np.ones(K)), dtype=float)
            gaussian = cfg.probabilistic.enable and (major.max() > 0 or minor.max() > 0)
            o.prediction = HostPrediction(
                type=int(PredictionType.GAUSSIAN if gaussian else PredictionType.DETERMINISTIC),
                positions=positions.copy(),
                angles=angles.copy(),
                major=major.copy(),
                minor=minor.copy(),
                probabilities=probs.copy(),
            )
        else:
            velocity = np.asarray(msg.get("velocity", np.zeros(2)), dtype=float)
            o.prediction = get_constant_velocity_prediction(
                o.position, velocity, cfg.dt, cfg.N, cfg.probabilistic.enable
            )
        obstacles.append(o)

    obstacles = remove_distant_obstacles(obstacles, state, cfg.max_obstacle_distance)
    obstacles = ensure_obstacle_size(
        obstacles, state, cfg.max_obstacles, cfg.N, cfg.dt, cfg.probabilistic.enable
    )
    if cfg.probabilistic.enable and cfg.probabilistic.propagate_uncertainty:
        propagate_all_uncertainty(obstacles, cfg.dt, cfg.N)
    return obstacles


class Watchdog:
    """Stale-loop detector (ref ros1_jackalsimulator.cpp:161-162: a timer
    that resets the environment when the loop stops making progress).

    `kick()` on every healthy event; `expired(now)` tells the embedding
    system to trigger its reset hook (sim reset service / recovery)."""

    def __init__(self, timeout: float = 5.0):
        self.timeout = timeout
        self._last = time.time()

    def kick(self, now: Optional[float] = None) -> None:
        self._last = time.time() if now is None else now

    def expired(self, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        return (now - self._last) > self.timeout


class RobotLoop:
    """Generic 20 Hz control loop (ref ros1_jackalsimulator.cpp:153-230).

    Call `tick(pose, velocity, obstacles, ...)` each cycle; returns the
    (v, w) command, with the open-loop braking fallback on infeasibility
    (:191-201).
    """

    def __init__(self, planner, cfg, watchdog_timeout: float = 5.0):
        self.planner = planner
        self.cfg = cfg
        self.state = State(planner.model)
        self.data = RealTimeData()
        self.data.robot_area = define_robot_area(
            cfg.robot.length, cfg.robot.width, cfg.n_discs
        )
        self.watchdog = Watchdog(watchdog_timeout)
        self.flipped = False

    def set_reference_path(self, x, y, v=None, left_bound=None, right_bound=None) -> None:
        self.data.reference_path = {"x": np.asarray(x, float), "y": np.asarray(y, float)}
        if v is not None:
            self.data.reference_path["v"] = np.asarray(v, float)
        self.data.left_bound = left_bound
        self.data.right_bound = right_bound
        self.data.goal = np.array([np.asarray(x, float)[-1], np.asarray(y, float)[-1]])
        self.data.goal_received = True
        self.planner.on_data_received(self.data, "reference_path")

    def set_goal(self, goal) -> None:
        self.data.goal = np.asarray(goal, dtype=float)
        self.data.goal_received = True
        self.planner.on_data_received(self.data, "goal")

    def tick(self, pose, velocity: float, raw_obstacles: List[dict],
             costmap: Optional[np.ndarray] = None,
             costmap_meta: Optional[dict] = None,
             roll: float = 0.0, pitch: float = 0.0) -> Tuple[float, float, bool]:
        """One control cycle. pose = (x, y, psi). Returns (v_cmd, w_cmd,
        success)."""
        cfg = self.cfg
        self.state.set("x", pose[0])
        self.state.set("y", pose[1])
        self.state.set("psi", pose[2])
        self.state.set("v", velocity)

        # Flipped-robot guard (ref :235-239: |roll| or |pitch| > ~90deg
        # means the robot tipped over -> stop output, flag for reset)
        self.flipped = abs(roll) > np.pi / 2.2 or abs(pitch) > np.pi / 2.2
        if self.flipped:
            return 0.0, 0.0, False

        self.data.planning_start_time = time.time()
        self.data.ego_position = self.state.get_position()
        obstacles = convert_obstacle_messages(cfg, self.state, raw_obstacles)
        self.data.dynamic_obstacles = obstacles
        self.data.obstacle_block = pack_obstacles(obstacles, cfg.N)
        self.data.costmap = costmap
        self.data.costmap_meta = costmap_meta
        self.planner.on_data_received(self.data, "dynamic obstacles")

        output = self.planner.solve_mpc(self.state, self.data)
        if output.success:
            self.watchdog.kick()
            # Actuation convention (ref :185-186): v = x_1's velocity,
            # w = u_0's angular rate
            v_cmd = self.planner.get_solution(1, "v")
            w_cmd = self.planner.get_solution(0, "w")
        else:
            # Open-loop braking (ref :191-201)
            v_cmd = max(
                velocity - cfg.deceleration_at_infeasible * cfg.dt, 0.0
            )
            w_cmd = 0.0
        if not self.cfg.enable_output:
            return 0.0, 0.0, output.success
        return float(v_cmd), float(w_cmd), output.success

    def objective_reached(self) -> bool:
        return self.planner.is_objective_reached(self.state, self.data)

    def reset(self) -> None:
        self.planner.reset(self.state, self.data)
        self.data.robot_area = define_robot_area(
            self.cfg.robot.length, self.cfg.robot.width, self.cfg.n_discs
        )


class NavigationPlanner:
    """BaseLocalPlanner-equivalent API (ref ros1_rosnavigation.cpp).

    setPlan -> set_plan, computeVelocityCommands -> compute_velocity_commands,
    isGoalReached -> is_goal_reached; includes the rotate-to-goal terminal
    behavior (:245-281).
    """

    def __init__(self, planner, cfg):
        self.loop = RobotLoop(planner, cfg)
        self.cfg = cfg
        self._goal_psi: Optional[float] = None
        self._rotating = False

    def set_plan(self, global_plan: np.ndarray) -> bool:
        """global_plan [K, 2] or [K, 3] (x, y, psi)."""
        plan = np.asarray(global_plan, dtype=float)
        if plan.shape[0] < 2:
            return False
        self.loop.set_reference_path(plan[:, 0], plan[:, 1])
        self._goal_psi = float(plan[-1, 2]) if plan.shape[1] > 2 else None
        self._rotating = False
        return True

    def compute_velocity_commands(self, pose, velocity: float,
                                  raw_obstacles: List[dict],
                                  costmap: Optional[np.ndarray] = None,
                                  costmap_meta: Optional[dict] = None) -> Tuple[float, float]:
        if self._rotating or (self._position_reached(pose) and self._goal_psi is not None):
            self._rotating = True
            return self._rotate_to_goal(pose)
        v, w, _ = self.loop.tick(pose, velocity, raw_obstacles, costmap, costmap_meta)
        return v, w

    def _position_reached(self, pose) -> bool:
        if self.loop.data.goal is None:
            return False
        return bool(
            np.linalg.norm(np.asarray(pose[:2]) - self.loop.data.goal) < 1.0
        )

    def _rotate_to_goal(self, pose) -> Tuple[float, float]:
        """In-place rotation toward the goal heading (ref :245-281)."""
        err = (self._goal_psi - pose[2] + np.pi) % (2 * np.pi) - np.pi
        if abs(err) < 0.05:
            self._rotating = False
            return 0.0, 0.0
        return 0.0, float(np.clip(1.5 * err, -0.8, 0.8))

    def is_goal_reached(self, pose) -> bool:
        if not self._position_reached(pose):
            return False
        if self._goal_psi is None:
            return True
        err = (self._goal_psi - pose[2] + np.pi) % (2 * np.pi) - np.pi
        return abs(err) < 0.05
