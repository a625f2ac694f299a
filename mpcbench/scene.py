"""The corridor world of the benchmark's traffic, in plain numpy.

The scene of the reference's headline experiment (a 25 m corridor along
x, crossing pedestrians), copied from the port's
experiments/corridor_benchmark.py::make_peds and sim/simulator.py so that
the yardstick does not move when the program does:

- `make_peds`: the same pedestrians for a seed as the port's `make_peds`.
- `step_pedestrians`: the simulator's light social forces (goal
  attraction, pairwise repulsion, repulsion from the robot), on sim time.
- `integrate_robot`: the true robot, the contouring unicycle's RK4 step
  (three substeps) in float64.
- `episode_seed`: the one function of (run seed, episode) that draws an
  episode's pedestrians.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

PATH_X = np.linspace(0.0, 25.0, 14)


@dataclass
class Pedestrian:
    position: np.ndarray
    velocity: np.ndarray
    radius: float = 0.4
    goal: Optional[np.ndarray] = None
    waypoints: List[np.ndarray] = field(default_factory=list)
    wp_index: int = 0


def make_peds(n: int, seed: int) -> List[Pedestrian]:
    """Crossing pedestrians in the corridor's interior, each walking cyclic
    waypoints on either side: the port's make_peds, draw for draw."""
    rng = np.random.default_rng(seed)
    peds = []
    for _ in range(n):
        x = rng.uniform(4.0, 20.0)
        y = rng.uniform(-2.5, 2.5)
        vy = rng.uniform(0.3, 0.9) * (1 if rng.random() < 0.5 else -1)
        wp_a = np.array([x + rng.uniform(-2.0, 2.0), 3.0 * np.sign(vy)])
        wp_b = np.array([x + rng.uniform(-2.0, 2.0), -3.0 * np.sign(vy)])
        peds.append(Pedestrian(position=np.array([x, y]),
                               velocity=np.array([rng.uniform(-0.3, 0.3), vy]),
                               radius=0.4, waypoints=[wp_a, wp_b]))
    return peds


def episode_seed(seed: int, episode: int) -> int:
    """The pedestrians' seed of episode `episode` of a run with `seed`: a
    fixed function of the two, never of the clock."""
    return int(np.random.SeedSequence([int(seed) % 2**63, int(episode)]).generate_state(1)[0])


def step_pedestrians(peds: List[Pedestrian], dt: float, robot_position=None) -> None:
    """One sim step of the social-force pedestrians (the port's simulator,
    robot-aware)."""
    for p in peds:
        if p.waypoints:
            p.goal = p.waypoints[p.wp_index % len(p.waypoints)]
            if np.linalg.norm(p.goal - p.position) < 0.4:
                p.wp_index += 1
                p.goal = p.waypoints[p.wp_index % len(p.waypoints)]
        force = np.zeros(2)
        if p.goal is not None:
            to_goal = p.goal - p.position
            d = np.linalg.norm(to_goal)
            if d > 1e-6:
                force += (to_goal / d * 1.3 - p.velocity) / 0.5
        for q in peds:
            if q is p:
                continue
            diff = p.position - q.position
            d = np.linalg.norm(diff)
            if 1e-6 < d < 2.0:
                force += diff / d * np.exp(-(d - 0.8) / 0.3) * 2.0
        if robot_position is not None:
            diff = p.position - robot_position
            d = np.linalg.norm(diff)
            if 1e-6 < d < 2.0:
                force += diff / d * np.exp(-(d - 0.8) / 0.3) * 2.0
        p.velocity = p.velocity + force * dt
        speed = np.linalg.norm(p.velocity)
        if speed > 1.8:
            p.velocity *= 1.8 / speed
        p.position = p.position + p.velocity * dt


def _unicycle(x, u):
    psi, v = x[2], x[3]
    return np.array([v * np.cos(psi), v * np.sin(psi), u[1], u[0], v])


def integrate_robot(x: np.ndarray, a: float, w: float, dt: float, substeps: int = 3) -> np.ndarray:
    """State (x, y, psi, v, spline) after `dt` under inputs (a, w): RK4 in
    `substeps` sub-intervals, as the model's discrete dynamics."""
    u = np.array([a, w], dtype=float)
    x = np.asarray(x, dtype=float).copy()
    h = dt / substeps
    for _ in range(substeps):
        k1 = _unicycle(x, u)
        k2 = _unicycle(x + 0.5 * h * k1, u)
        k3 = _unicycle(x + 0.5 * h * k2, u)
        k4 = _unicycle(x + h * k3, u)
        x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x


def braking_input(v: float, dt: float, deceleration: float) -> float:
    """The open-loop braking fallback after a cycle without a plan: the
    simulator's clamped deceleration, which stops v exactly at 0."""
    return -float(np.clip(v / dt, -deceleration, deceleration))


def intrusions(robot_xy: np.ndarray, peds: List[Pedestrian], robot_radius: float) -> int:
    """Pedestrians overlapping the robot's disc (the simulator's collision
    count for one step)."""
    return sum(int(np.linalg.norm(robot_xy - p.position) < robot_radius + p.radius) for p in peds)
