"""Obstacle message schemas + (de)serialization.

Equivalent of mpc_planner_msgs (ref mpc_planner_msgs/msg/*.msg:
Gaussian — mean path + major/minor semiaxes; ObstacleGMM — id, pose,
gaussians[], probabilities[]; ObstacleArray). Instead of ROS IDL these
are plain dataclasses with dict/JSON round-trip, feeding
`systems.convert_obstacle_messages` / the data-preparation layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class GaussianMsg:
    """Ref Gaussian.msg: mean path + uncertainty semiaxes per step."""

    mean_x: List[float] = field(default_factory=list)
    mean_y: List[float] = field(default_factory=list)
    major_semiaxis: List[float] = field(default_factory=list)
    minor_semiaxis: List[float] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "mean_x": list(self.mean_x),
            "mean_y": list(self.mean_y),
            "major_semiaxis": list(self.major_semiaxis),
            "minor_semiaxis": list(self.minor_semiaxis),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "GaussianMsg":
        return cls(**{k: list(d.get(k, [])) for k in
                      ("mean_x", "mean_y", "major_semiaxis", "minor_semiaxis")})


@dataclass
class ObstacleGMMMsg:
    """Ref ObstacleGMM.msg: multi-modal Gaussian prediction."""

    id: int = 0
    pose_x: float = 0.0
    pose_y: float = 0.0
    pose_psi: float = 0.0
    radius: float = 0.4
    gaussians: List[GaussianMsg] = field(default_factory=list)
    probabilities: List[float] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "pose": [self.pose_x, self.pose_y, self.pose_psi],
            "radius": self.radius,
            "gaussians": [g.to_dict() for g in self.gaussians],
            "probabilities": list(self.probabilities),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ObstacleGMMMsg":
        pose = d.get("pose", [0.0, 0.0, 0.0])
        return cls(
            id=int(d.get("id", 0)),
            pose_x=pose[0], pose_y=pose[1],
            pose_psi=pose[2] if len(pose) > 2 else 0.0,
            radius=float(d.get("radius", 0.4)),
            gaussians=[GaussianMsg.from_dict(g) for g in d.get("gaussians", [])],
            probabilities=list(d.get("probabilities", [])),
        )

    def to_raw_obstacle(self) -> dict:
        """-> the `systems.convert_obstacle_messages` input schema,
        carrying ALL modes (the reference jackalsimulator converts only
        the first, ros1_jackalsimulator.cpp:302-339; this framework
        advertises GMM SH-MPC, so the full mixture flows through —
        modes ride a leading K axis, short modes are padded by
        repetition at pack time).

        Per-step mode headings are derived from each mean path's finite
        differences so anisotropic uncertainty stays aligned with the
        mode's direction of travel in the multi-modal scenario sampler.
        """
        raw = {"id": self.id, "position": [self.pose_x, self.pose_y],
               "angle": self.pose_psi, "radius": self.radius}
        if not self.gaussians:
            return raw
        K = len(self.gaussians)
        n = max(len(g.mean_x) for g in self.gaussians)

        def _pad(a, n):
            a = np.asarray(a, dtype=float)
            if a.shape[0] >= n:
                return a[:n]
            if a.shape[0] == 0:
                return np.zeros(n)
            return np.concatenate([a, np.repeat(a[-1:], n - a.shape[0], axis=0)])

        positions = np.stack(
            [np.stack([_pad(g.mean_x, n), _pad(g.mean_y, n)], axis=-1)
             for g in self.gaussians]
        )  # [K, n, 2]
        angles = np.zeros((K, n))
        for k in range(K):
            d = np.diff(positions[k], axis=0)
            if n > 1:
                step = np.arctan2(d[:, 1], d[:, 0])
                still = np.hypot(d[:, 0], d[:, 1]) < 1e-9
                step = np.where(still, self.pose_psi, step)
                angles[k, :-1] = step
                angles[k, -1] = step[-1]
            else:
                angles[k, :] = self.pose_psi
        raw["prediction"] = {
            "positions": positions,
            "angles": angles,
            "major": np.stack([_pad(g.major_semiaxis, n) for g in self.gaussians]),
            "minor": np.stack([_pad(g.minor_semiaxis, n) for g in self.gaussians]),
            "probabilities": np.asarray(
                self.probabilities if self.probabilities else [1.0 / K] * K,
                dtype=float,
            ),
        }
        return raw


@dataclass
class ObstacleArrayMsg:
    """Ref ObstacleArray.msg."""

    obstacles: List[ObstacleGMMMsg] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"obstacles": [o.to_dict() for o in self.obstacles]}

    @classmethod
    def from_dict(cls, d: dict) -> "ObstacleArrayMsg":
        return cls(obstacles=[ObstacleGMMMsg.from_dict(o) for o in d.get("obstacles", [])])

    def to_raw_obstacles(self) -> List[dict]:
        return [o.to_raw_obstacle() for o in self.obstacles]
