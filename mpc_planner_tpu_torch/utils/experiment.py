"""Experiment recording: per-iteration metric export + segmentation.

Counterpart of mpc_planner_tpu/utils/experiment.py (ref mpc_planner/src/
experiment_util.cpp:15-115, ros_tools DataSaver): records poses, plans,
obstacles, intrusion/collision feedback and runtimes each control
iteration, segments experiments on task completion, and auto-saves after
`num_experiments`. Same record fields and the same JSON layout as the
reference. Every value is moved to the host before it is recorded (a
tensor becomes numpy, then plain Python), so an export never holds a
device tensor.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import numpy as np
import torch


def _host(value):
    """A module metric as plain Python: tensors and numpy values leave the
    device and become floats, ints, bools or lists; dicts recurse."""
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    if isinstance(value, (np.ndarray, np.generic)):
        return value.tolist()
    return value


class ExperimentUtil:
    def __init__(self, cfg, save_folder: str = "data", save_file: Optional[str] = None,
                 enable: Optional[bool] = None):
        self.cfg = cfg
        self.enable = True if enable is None else enable
        self.save_folder = save_folder
        self.save_file = save_file or f"{cfg.name}_experiment"
        self.num_experiments = 5
        self.iteration_data: List[dict] = []
        self.experiments: List[dict] = []
        self._experiment_start = time.time()
        self.control_iteration = 0

    def set_start_experiment(self) -> None:
        """Ref experiment_util.cpp setStartExperiment."""
        self._experiment_start = time.time()
        self.iteration_data = []
        self.control_iteration = 0

    def update(self, state, planner, data, runtime_s: float = 0.0) -> None:
        """Record one control iteration (ref :30-76)."""
        if not self.enable:
            return
        record = {
            "iteration": self.control_iteration,
            "pose": [float(state.get("x")), float(state.get("y")), float(state.get("psi"))],
            "velocity": float(state.get("v")),
            "runtime": runtime_s,
            "status": int(planner._output.success),
            "intrusion": float(getattr(data, "intrusion", 0.0)),
        }
        if planner._output.success and len(planner._output.trajectory) > 0:
            record["plan"] = np.asarray(planner._output.trajectory.positions).tolist()
        obstacles = []
        if data.obstacle_block is not None:
            blk = data.obstacle_block
            for i in range(blk.position.shape[0]):
                if blk.index[i] >= 0:
                    obstacles.append(
                        {"id": int(blk.index[i]), "pos": _host(blk.position[i]),
                         "radius": float(blk.radius[i])}
                    )
        record["obstacles"] = obstacles
        # Per-module saveData chain (ref controller_module.h:120-125;
        # planner.cpp calls each module's saveData per iteration)
        modules = getattr(planner, "modules", None)
        if modules is not None and hasattr(modules, "save_data_all"):
            module_metrics = _host(modules.save_data_all())
            if module_metrics:
                record["modules"] = module_metrics
        self.iteration_data.append(record)
        self.control_iteration += 1

    def on_task_complete(self, objective_reached: bool) -> None:
        """Close out an experiment segment (ref :78-110)."""
        duration = time.time() - self._experiment_start
        collisions = sum(1 for r in self.iteration_data if r["intrusion"] > 0.0)
        infeasible = sum(1 for r in self.iteration_data if not r["status"])
        self.experiments.append(
            {
                "duration": duration,
                "completed": bool(objective_reached),
                "collisions": collisions,
                "infeasible_iterations": infeasible,
                "iterations": len(self.iteration_data),
                "metrics": self.iteration_data,
            }
        )
        self.set_start_experiment()
        if len(self.experiments) >= self.num_experiments:
            self.export_data()

    def export_data(self, path: Optional[str] = None) -> str:
        """Write all experiments to JSON (ref exportData)."""
        os.makedirs(self.save_folder, exist_ok=True)
        path = path or os.path.join(self.save_folder, f"{self.save_file}.json")
        summary = {
            "num_experiments": len(self.experiments),
            "experiments": [
                {k: v for k, v in e.items() if k != "metrics"} for e in self.experiments
            ],
        }
        with open(path, "w") as f:
            json.dump({"summary": summary, "data": self.experiments}, f)
        return path
