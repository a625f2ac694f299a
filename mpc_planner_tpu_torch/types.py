"""Host-side data types of one control cycle.

Counterpart of mpc_planner_tpu/types.py (ref mpc_planner_types/
data_types.h and realtime_data.h). Only the types the planner's main
path uses are here; all of them are plain Python/numpy containers.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, Optional

import numpy as np


class PredictionType(enum.IntEnum):
    """Ref data_types.h: DETERMINISTIC / GAUSSIAN / NONGAUSSIAN."""

    NONE = 0
    DETERMINISTIC = 1
    GAUSSIAN = 2
    NONGAUSSIAN = 3


class Trajectory:
    """Host-side output trajectory (ref data_types.h Trajectory)."""

    def __init__(self, dt: float = 0.0, positions: Optional[np.ndarray] = None):
        self.dt = dt
        self.positions = (
            np.zeros((0, 2)) if positions is None else np.asarray(positions, dtype=float)
        )

    def add(self, x: float, y: float) -> None:
        self.positions = np.vstack([self.positions, [x, y]])

    def __len__(self) -> int:
        return len(self.positions)


class PlannerOutput:
    """Ref planner.h PlannerOutput{trajectory, success}."""

    def __init__(self, dt: float = 0.0, N: int = 0):
        self.trajectory = Trajectory(dt)
        self.success = False
        self.N = N


class State:
    """Current robot state addressed by model-map names
    (ref mpc_planner_solver/src/state.cpp:7-44)."""

    def __init__(self, model: Any = None, nx: Optional[int] = None):
        if model is not None:
            self._names = list(model.states)
        else:
            self._names = ["x", "y", "psi", "v", "spline"][: nx or 5]
        self._values = np.zeros(len(self._names))

    @property
    def names(self):
        return list(self._names)

    def get(self, name: str) -> float:
        if name not in self._names:
            return 0.0
        return float(self._values[self._names.index(name)])

    def set(self, name: str, value: float) -> None:
        if name in self._names:
            self._values[self._names.index(name)] = float(value)

    def get_position(self) -> np.ndarray:
        return np.array([self.get("x"), self.get("y")])

    def as_array(self) -> np.ndarray:
        return self._values.copy()

    def from_array(self, arr: np.ndarray) -> "State":
        self._values = np.asarray(arr, dtype=float).copy()
        return self

    def reset(self) -> None:
        self._values[:] = 0.0

    def __repr__(self) -> str:
        return "State(" + ", ".join(f"{n}={v:.3f}" for n, v in zip(self._names, self._values)) + ")"


class RealTimeData:
    """All sensor-side inputs for one cycle (ref realtime_data.h:16-49)."""

    def __init__(self):
        self.robot_area: list = []  # list of (offset, radius)
        self.dynamic_obstacles: list = []  # list of HostObstacle
        self.reference_path: Optional[Dict[str, np.ndarray]] = None
        self.left_bound: Optional[np.ndarray] = None  # [P, 2]
        self.right_bound: Optional[np.ndarray] = None  # [P, 2]
        self.goal: Optional[np.ndarray] = None  # [2]
        self.goal_received: bool = False
        self.planning_start_time: float = 0.0
        self.obstacle_block = None  # ObstacleBlock (struct-of-arrays, padded)
        self.ego_position: np.ndarray = np.zeros(2)

    def reset(self) -> None:
        """Ref realtime_data.h: reset clears everything except robot_area."""
        robot_area = self.robot_area
        self.__init__()
        self.robot_area = robot_area


class ModuleData:
    """Per-cycle shared blackboard between modules
    (ref mpc_planner_types/module_data.h:21-34)."""

    def __init__(self):
        self.static_obstacles: Optional[np.ndarray] = None  # [N, H, 3] rows (a1, a2, b)
        self.path = None  # PathSpline2D
        self.current_path_segment: int = 0
        self.warmstart: Optional[np.ndarray] = None  # [N+1, nvar] ego prediction
        self.warmstart_xy: Optional[np.ndarray] = None  # [N+1, 2]
        self.warmstart_psi: Optional[np.ndarray] = None  # [N+1]
        self.warmstart_spline: Optional[np.ndarray] = None  # [N+1]
        # Set by the planner before the module optimize chain:
        self.pblock = None  # ParameterBlock (main fill)
        self.xinit: Optional[np.ndarray] = None  # [nx]
        self.num_iterations: int = 10
