"""Closed-loop simulator + experiment metrics.

Counterpart of mpc_planner_tpu/sim/simulator.py (the reference's Gazebo +
pedestrian_simulator integration testing and ExperimentUtil metric
recording, mpc_planner/src/experiment_util.cpp:15-115): pedestrians move by
constant velocity or social forces, the robot integrates the planned input
through the port's dynamics, collisions and intrusions are measured every
step, and per-experiment metrics are aggregated. The pedestrians' numpy
code and its seeded generator are the reference's, so both packages walk
the same pedestrians. The simulator never sends "dynamic obstacles", so an
SH-MPC planner's scenario seed stays fixed within a run, as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from mpc_planner_tpu_torch.data_preparation import (
    HostObstacle,
    ensure_obstacle_size,
    get_constant_velocity_prediction,
    pack_obstacles,
)
from mpc_planner_tpu_torch.types import RealTimeData, State


@dataclass
class Pedestrian:
    position: np.ndarray
    velocity: np.ndarray
    radius: float = 0.4
    goal: Optional[np.ndarray] = None
    # Optional cyclic waypoint list (pedsim agents walk waypoints in a
    # loop — a goal-reached pedestrian keeps moving instead of parking
    # at its goal, possibly in contact with a stopped robot).
    waypoints: Optional[List[np.ndarray]] = None
    _wp_index: int = 0


@dataclass
class SimResult:
    """ExperimentUtil-style metrics (ref experiment_util.cpp:78-110)."""

    duration: float = 0.0
    completed: bool = False
    collisions: int = 0
    max_intrusion: float = 0.0
    infeasible_cycles: int = 0
    steps: int = 0
    mean_velocity: float = 0.0
    trajectory: List[np.ndarray] = field(default_factory=list)
    # Wall-clock per control cycle (data prep + solve), seconds — the
    # closed-loop realtime evidence (ref planner.cpp's 1/f budget).
    cycle_times: List[float] = field(default_factory=list)
    # Per-cycle module saveData records (ref ExperimentUtil iteration
    # records) — carries e.g. the SH-MPC risk certificate per cycle.
    module_records: List[dict] = field(default_factory=list)

    @property
    def cycle_ms_mean(self) -> float:
        return 1e3 * float(np.mean(self.cycle_times)) if self.cycle_times else 0.0

    @property
    def cycle_ms_p99(self) -> float:
        return 1e3 * float(np.percentile(self.cycle_times, 99)) if self.cycle_times else 0.0


class ClosedLoopSimulator:
    """Drives a Planner against simulated pedestrians."""

    def __init__(self, planner, cfg, pedestrians: List[Pedestrian],
                 reference_path: dict, social_forces: bool = False, seed: int = 0,
                 robot_aware: bool = False):
        self.planner = planner
        self.cfg = cfg
        self.model = planner.model
        self.pedestrians = pedestrians
        self.reference_path = reference_path
        self.social_forces = social_forces
        # pedestrian_simulator's social-forces pedestrians receive the robot
        # state and avoid it like another agent; robot-blind pedestrians
        # (False) walk straight into a stopped robot, which the reference's
        # corridor experiment does not exhibit.
        self.robot_aware = robot_aware
        self.rng = np.random.default_rng(seed)

    def _make_data(self, state: State) -> RealTimeData:
        cfg = self.cfg
        data = RealTimeData()
        data.robot_area = self.planner.default_robot_area()
        data.reference_path = self.reference_path
        xs = np.asarray(self.reference_path["x"])
        data.goal = np.array([xs[-1], np.asarray(self.reference_path["y"])[-1]])
        data.goal_received = True

        obstacles = []
        for i, p in enumerate(self.pedestrians):
            o = HostObstacle(index=i, position=p.position.copy(), angle=0.0,
                             radius=p.radius)
            o.prediction = get_constant_velocity_prediction(
                p.position, p.velocity, cfg.dt, cfg.N, cfg.probabilistic.enable
            )
            obstacles.append(o)
        obstacles = ensure_obstacle_size(
            obstacles, state, cfg.max_obstacles, cfg.N, cfg.dt, cfg.probabilistic.enable
        )
        data.dynamic_obstacles = obstacles
        data.obstacle_block = pack_obstacles(obstacles, cfg.N)
        data.ego_position = state.get_position()
        return data

    def _step_pedestrians(self, dt: float, robot_position=None) -> None:
        for p in self.pedestrians:
            if p.waypoints:
                # Cyclic waypoints (pedsim behavior): advance on arrival.
                p.goal = p.waypoints[p._wp_index % len(p.waypoints)]
                if np.linalg.norm(p.goal - p.position) < 0.4:
                    p._wp_index += 1
                    p.goal = p.waypoints[p._wp_index % len(p.waypoints)]
            if self.social_forces:
                # Light social-forces: goal attraction + pairwise repulsion
                force = np.zeros(2)
                if p.goal is not None:
                    to_goal = p.goal - p.position
                    d = np.linalg.norm(to_goal)
                    if d > 1e-6:
                        desired = to_goal / d * 1.3
                        force += (desired - p.velocity) / 0.5
                for q in self.pedestrians:
                    if q is p:
                        continue
                    diff = p.position - q.position
                    d = np.linalg.norm(diff)
                    if 1e-6 < d < 2.0:
                        force += diff / d * np.exp(-(d - 0.8) / 0.3) * 2.0
                if self.robot_aware and robot_position is not None:
                    diff = p.position - robot_position
                    d = np.linalg.norm(diff)
                    if 1e-6 < d < 2.0:
                        force += diff / d * np.exp(-(d - 0.8) / 0.3) * 2.0
                p.velocity = p.velocity + force * dt
                speed = np.linalg.norm(p.velocity)
                if speed > 1.8:
                    p.velocity *= 1.8 / speed
            p.position = p.position + p.velocity * dt

    def _integrate_robot(self, state: State, a: float, w: float, dt: float) -> None:
        """The true robot: the model's RK4 step in f32 on the CPU, other
        inputs (a slack) at 0."""
        z = np.zeros(self.model.nvar)
        z[self.model.index("a")] = a
        z[self.model.index("w")] = w
        z[self.model.nu :] = state.as_array()
        x_next = self.model.discrete_dynamics(torch.as_tensor(z, dtype=torch.float32),
                                              torch.zeros(1), dt)
        state.from_array(x_next.numpy())

    def run(self, max_steps: int = 200, start: Optional[np.ndarray] = None) -> SimResult:
        cfg = self.cfg
        dt = cfg.dt
        state = State(self.model)
        if start is not None:
            state.set("x", start[0])
            state.set("y", start[1])

        result = SimResult()
        data = self._make_data(state)
        self.planner.on_data_received(data, "reference_path")

        import time as _time

        velocities = []
        for step in range(max_steps):
            t0 = _time.perf_counter()
            data = self._make_data(state)
            out = self.planner.solve_mpc(state, data)
            result.cycle_times.append(_time.perf_counter() - t0)
            result.module_records.append(
                self.planner.modules.save_data_all())

            if out.success:
                a = self.planner.get_solution(0, "a")
                w = self.planner.get_solution(0, "w")
            else:
                # Open-loop braking fallback (ref ros1_jackalsimulator.cpp:
                # 191-201). The reference commands a decelerating VELOCITY
                # (clamped at 0); integrating a raw -decel acceleration for
                # a full dt instead can overshoot v below zero — into a
                # state the model's v >= lb bound makes unreachable in one
                # step (|a| <= a_max), so every subsequent QP is infeasible
                # and the robot drifts backward forever. Clamp the braking
                # acceleration so v stops exactly at 0.
                result.infeasible_cycles += 1
                v = state.get("v")
                a = -np.clip(v / dt, -cfg.deceleration_at_infeasible,
                             cfg.deceleration_at_infeasible)
                w = 0.0

            self._integrate_robot(state, a, w, dt)
            self._step_pedestrians(dt, robot_position=state.get_position())
            velocities.append(state.get("v"))
            result.trajectory.append(state.get_position())

            # Collision metric (ref /feedback/collisions intrusion,
            # ros1_jackalsimulator.cpp:380-386)
            robot_r = cfg.robot_radius
            for p in self.pedestrians:
                dist = np.linalg.norm(state.get_position() - p.position)
                intrusion = (robot_r + p.radius) - dist
                if intrusion > 0:
                    result.max_intrusion = max(result.max_intrusion, intrusion)
                    result.collisions += 1

            result.steps = step + 1
            if self.planner.is_objective_reached(state, data):
                result.completed = True
                break

        result.duration = result.steps * dt
        result.mean_velocity = float(np.mean(velocities)) if velocities else 0.0
        return result
