"""Host-side data preparation: robot discs, obstacle padding/sorting,
constant-velocity predictions, uncertainty propagation.

Counterpart of mpc_planner_tpu/data_preparation.py (numpy-only, copied
so the port never imports the JAX package; ref mpc_planner/src/
data_preparation.cpp). Fixed-capacity padding with far-away dummies
(+100 m, data_preparation.cpp:49-56) keeps every cycle's tensors one
shape; the output is a struct-of-arrays `ObstacleBlock` ready for
vectorized parameter fills.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from mpcbench.reference.frozen.types import PredictionType


@dataclass
class HostPrediction:
    """One obstacle's prediction (host-side, numpy)."""

    type: int = int(PredictionType.DETERMINISTIC)
    positions: np.ndarray = None  # [modes, N, 2]
    angles: np.ndarray = None  # [modes, N]
    major: np.ndarray = None  # [modes, N] (std dev for GAUSSIAN)
    minor: np.ndarray = None  # [modes, N]
    probabilities: np.ndarray = None  # [modes]
    propagated: bool = False  # uncertainty already accumulated over the horizon


@dataclass
class HostObstacle:
    """Ref data_types.h DynamicObstacle (host-side)."""

    index: int
    position: np.ndarray
    angle: float
    radius: float
    prediction: Optional[HostPrediction] = None


@dataclass
class ObstacleBlock:
    """Padded struct-of-arrays over max_obstacles.

    The `pred_*` arrays carry the most-probable mode (the deterministic
    modules consume mode 0, like the reference's `modes[0]` accesses);
    `modes_*` carry the full Gaussian mixture (fixed mode capacity, padded
    by repeating the best mode) for SH-MPC multi-modal sampling
    (ref data_types.h Prediction{modes, probabilities})."""

    position: np.ndarray  # [M, 2] current positions
    angle: np.ndarray  # [M]
    radius: np.ndarray  # [M]
    pred_position: np.ndarray  # [M, N, 2]
    pred_angle: np.ndarray  # [M, N]
    pred_major: np.ndarray  # [M, N]
    pred_minor: np.ndarray  # [M, N]
    pred_type: np.ndarray  # [M] int
    index: np.ndarray  # [M] int (-1 = dummy)
    modes_position: Optional[np.ndarray] = None  # [M, K, N, 2]
    modes_angle: Optional[np.ndarray] = None  # [M, K, N]
    modes_major: Optional[np.ndarray] = None  # [M, K, N]
    modes_minor: Optional[np.ndarray] = None  # [M, K, N]
    modes_prob: Optional[np.ndarray] = None  # [M, K]

    @property
    def n_modes(self) -> int:
        return 1 if self.modes_position is None else self.modes_position.shape[1]


def define_robot_area(length: float, width: float, n_discs: int) -> List[tuple]:
    """Multi-disc collision area (ref data_preparation.cpp:16-47).
    Returns [(offset, radius)] * n_discs."""
    center_offset = length / 2.0
    radius = width / 2.0
    if n_discs <= 0:
        raise ValueError("n_discs must be >= 1")
    if n_discs == 1:
        return [(0.0, radius)]
    area = []
    for i in range(n_discs):
        if i == 0:
            area.append((-center_offset + radius, radius))
        elif i == n_discs - 1:
            area.append((-center_offset + length - radius, radius))
        else:
            area.append(
                (-center_offset + radius + i * (length - 2.0 * radius) / (n_discs - 1.0), radius)
            )
    return area


def get_constant_velocity_prediction(
    position: np.ndarray, velocity: np.ndarray, dt: float, steps: int, probabilistic: bool
) -> HostPrediction:
    """Constant-velocity forward rollout (ref data_preparation.cpp:58-79)."""
    t = np.arange(steps)[:, None] * dt
    positions = position[None, :] + velocity[None, :] * t  # [N, 2]
    noise = 0.3 if probabilistic else 0.0
    pred = HostPrediction(
        type=int(PredictionType.GAUSSIAN if probabilistic else PredictionType.DETERMINISTIC),
        positions=positions[None],
        angles=np.zeros((1, steps)),
        major=np.full((1, steps), noise),
        minor=np.full((1, steps), noise),
        probabilities=np.ones(1),
    )
    if probabilistic:
        propagate_prediction_uncertainty(pred, dt, steps)
    return pred


def get_dummy_obstacle(state) -> HostObstacle:
    """Dummy at +100 m (ref data_preparation.cpp:49-56)."""
    return HostObstacle(
        index=-1,
        position=np.array([state.get("x") + 100.0, state.get("y") + 100.0]),
        angle=0.0,
        radius=0.0,
    )


def ensure_obstacle_size(
    obstacles: List[HostObstacle], state, max_obstacles: int, N: int, dt: float, probabilistic: bool
) -> List[HostObstacle]:
    """Sort by horizon-weighted distance & clip, or pad with dummies
    (ref data_preparation.cpp:95-168)."""
    if len(obstacles) > max_obstacles:
        pos = state.get_position()
        v = state.get("v")
        psi = state.get("psi")
        direction = np.array([np.cos(psi), np.sin(psi)])
        dists = []
        for o in obstacles:
            ego = pos[None, :] + v * np.arange(N)[:, None] * direction[None, :]
            pred = o.prediction.positions[0][:N]
            d = (np.arange(N) + 1) * 0.6 * np.linalg.norm(pred - ego, axis=-1)
            dists.append(float(np.min(d)))
        order = np.argsort(dists, kind="stable")[:max_obstacles]
        obstacles = [obstacles[i] for i in order]
        for i, o in enumerate(obstacles):
            o.index = i
    elif len(obstacles) < max_obstacles:
        for _ in range(max_obstacles - len(obstacles)):
            dummy = get_dummy_obstacle(state)
            dummy.prediction = get_constant_velocity_prediction(
                dummy.position, np.zeros(2), dt, N, probabilistic
            )
            obstacles = obstacles + [dummy]
    return obstacles


def propagate_prediction_uncertainty(pred: HostPrediction, dt: float, N: int) -> None:
    """sigma_{k+1} = sqrt(sigma_k^2 + (sigma*dt)^2) accumulation
    (ref data_preparation.cpp:170-186). Idempotent via the `propagated`
    flag so the blanket post-conversion pass (the reference propagates
    ALL predictions after conversion) does not double-apply to
    constant-velocity predictions propagated at construction."""
    if pred.type != int(PredictionType.GAUSSIAN) or pred.propagated:
        return
    pred.propagated = True
    for m in range(pred.major.shape[0]):
        major = minor = 0.0
        for k in range(min(N, pred.major.shape[1])):
            major = np.sqrt(major**2 + (pred.major[m, k] * dt) ** 2)
            minor = np.sqrt(minor**2 + (pred.minor[m, k] * dt) ** 2)
            pred.major[m, k] = major
            pred.minor[m, k] = minor


def pack_obstacles(obstacles: List[HostObstacle], N: int) -> ObstacleBlock:
    """Padded list -> struct-of-arrays for vectorized fills.

    `pred_*` hold the most-probable mode; when any obstacle carries more
    than one mode, the full padded mixture is packed into `modes_*`."""
    M = len(obstacles)
    K = max(
        [1] + [o.prediction.positions.shape[0] for o in obstacles if o.prediction is not None]
    )
    blk = ObstacleBlock(
        position=np.zeros((M, 2)),
        angle=np.zeros(M),
        radius=np.zeros(M),
        pred_position=np.zeros((M, N, 2)),
        pred_angle=np.zeros((M, N)),
        pred_major=np.zeros((M, N)),
        pred_minor=np.zeros((M, N)),
        pred_type=np.zeros(M, dtype=int),
        index=np.zeros(M, dtype=int),
    )
    if K > 1:
        blk.modes_position = np.zeros((M, K, N, 2))
        blk.modes_angle = np.zeros((M, K, N))
        blk.modes_major = np.zeros((M, K, N))
        blk.modes_minor = np.zeros((M, K, N))
        blk.modes_prob = np.zeros((M, K))
        blk.modes_prob[:, 0] = 1.0

    for i, o in enumerate(obstacles):
        blk.position[i] = o.position
        blk.angle[i] = o.angle
        blk.radius[i] = o.radius
        blk.index[i] = o.index
        if o.prediction is None:
            continue
        probs = np.asarray(o.prediction.probabilities, dtype=float)
        best = int(np.argmax(probs)) if probs.size else 0
        n = min(N, o.prediction.positions.shape[1])
        blk.pred_position[i, :n] = o.prediction.positions[best, :n]
        blk.pred_angle[i, :n] = o.prediction.angles[best, :n]
        blk.pred_major[i, :n] = o.prediction.major[best, :n]
        blk.pred_minor[i, :n] = o.prediction.minor[best, :n]
        blk.pred_type[i] = o.prediction.type
        if n < N:  # extend with the last step
            blk.pred_position[i, n:] = blk.pred_position[i, n - 1]
            blk.pred_major[i, n:] = blk.pred_major[i, n - 1]
            blk.pred_minor[i, n:] = blk.pred_minor[i, n - 1]
        if K > 1:
            k_o = o.prediction.positions.shape[0]
            for k in range(K):
                src = k if k < k_o else best  # pad by repeating the best mode
                blk.modes_position[i, k, :n] = o.prediction.positions[src, :n]
                blk.modes_angle[i, k, :n] = o.prediction.angles[src, :n]
                blk.modes_major[i, k, :n] = o.prediction.major[src, :n]
                blk.modes_minor[i, k, :n] = o.prediction.minor[src, :n]
                if n < N:
                    blk.modes_position[i, k, n:] = blk.modes_position[i, k, n - 1]
                    blk.modes_angle[i, k, n:] = blk.modes_angle[i, k, n - 1]
                    blk.modes_major[i, k, n:] = blk.modes_major[i, k, n - 1]
                    blk.modes_minor[i, k, n:] = blk.modes_minor[i, k, n - 1]
                blk.modes_prob[i, k] = (
                    probs[k] / probs[:k_o].sum() if k < k_o and probs[:k_o].sum() > 0
                    else (0.0 if k >= k_o else 1.0 / k_o)
                )
    return blk
