"""Visualization of planner internals.

Counterpart of mpc_planner_tpu/utils/visualization.py (ref
mpc_planner_util/src/data_visualization.cpp + the per-module visualize()
methods): instead of RViz markers, every internal artifact (planned and
warmstart trajectories, per-planner T-MPC candidates colored by homotopy
class, obstacle prediction ellipses, constraint halfspace lines, robot
area discs) is collected as plain geometry dicts that export as JSON for
an external viewer or render to matplotlib. `to_json` gives the same text
as the reference's for the same inputs. Collectors take numpy arrays (the
planner copies device tensors to the host before it hands them over);
matplotlib is imported only by `render_matplotlib`.
"""

from __future__ import annotations

import json
from typing import List

import numpy as np


class Visualizer:
    def __init__(self):
        self.artifacts: List[dict] = []

    def clear(self) -> None:
        self.artifacts = []

    # -- collectors (mirror data_visualization.h:23-65) -------------------
    def add_trajectory(self, positions, name: str = "trajectory", color=None,
                       radius: float = 0.0) -> None:
        self.artifacts.append(
            {"type": "trajectory", "name": name,
             "points": np.asarray(positions, dtype=float).tolist(),
             "color": color, "radius": radius}
        )

    def add_obstacles(self, obstacle_block, name: str = "obstacles") -> None:
        items = []
        for i in range(obstacle_block.position.shape[0]):
            if obstacle_block.index[i] < 0:
                continue
            items.append(
                {"pos": obstacle_block.position[i].tolist(),
                 "radius": float(obstacle_block.radius[i])}
            )
        self.artifacts.append({"type": "obstacles", "name": name, "items": items})

    def add_prediction_ellipses(self, obstacle_block, chi: float = 1.0,
                                name: str = "predictions") -> None:
        items = []
        M = obstacle_block.pred_major.shape[0]
        for i in range(M):
            if obstacle_block.index[i] < 0:
                continue
            items.append(
                {"positions": obstacle_block.pred_position[i].tolist(),
                 "major": (np.sqrt(chi) * obstacle_block.pred_major[i]).tolist(),
                 "minor": (np.sqrt(chi) * obstacle_block.pred_minor[i]).tolist(),
                 "angle": obstacle_block.pred_angle[i].tolist()}
            )
        self.artifacts.append({"type": "prediction_ellipses", "name": name, "items": items})

    def add_halfspaces(self, halfspaces, name: str = "constraints") -> None:
        """halfspaces [K, 3] rows (a1, a2, b): line a.x = b."""
        self.artifacts.append(
            {"type": "halfspaces", "name": name,
             "rows": np.asarray(halfspaces, dtype=float).tolist()}
        )

    def add_robot_area(self, position, psi: float, robot_area,
                       name: str = "robot_area") -> None:
        discs = []
        p = np.asarray(position, dtype=float)
        d = np.array([np.cos(psi), np.sin(psi)])
        for offset, radius in robot_area:
            discs.append({"pos": (p + offset * d).tolist(), "radius": radius})
        self.artifacts.append({"type": "discs", "name": name, "items": discs})

    def add_tmpc_candidates(self, batch_Z, model, selected: int,
                            name: str = "tmpc_planners") -> None:
        """Per-planner trajectories colored by class; selected highlighted
        (ref guidance_constraints.cpp:437-491). batch_Z [B, N+1, nvar]."""
        ix, iy = model.index("x"), model.index("y")
        Z = np.asarray(batch_Z)
        items = [{"points": Z[i][:, [ix, iy]].tolist(), "selected": i == selected, "class": i}
                 for i in range(Z.shape[0])]
        self.artifacts.append({"type": "candidates", "name": name, "items": items})

    # -- sinks -------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(self.artifacts)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def render_matplotlib(self, ax=None):
        """Render to a matplotlib Axes (lazy import; optional dependency)."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(figsize=(10, 6))
        for art in self.artifacts:
            t = art["type"]
            if t == "trajectory":
                pts = np.asarray(art["points"])
                if len(pts):
                    ax.plot(pts[:, 0], pts[:, 1], "-o", ms=2, label=art["name"])
            elif t == "obstacles":
                for item in art["items"]:
                    ax.add_patch(plt.Circle(item["pos"], item["radius"], fill=False, color="r"))
            elif t == "discs":
                for item in art["items"]:
                    ax.add_patch(plt.Circle(item["pos"], item["radius"], fill=False, color="b"))
            elif t == "candidates":
                for item in art["items"]:
                    pts = np.asarray(item["points"])
                    style = "-r" if item["selected"] else "--"
                    ax.plot(pts[:, 0], pts[:, 1], style, lw=2 if item["selected"] else 1)
            elif t == "halfspaces":
                for a1, a2, b in art["rows"]:
                    n = np.hypot(a1, a2)
                    if n < 1e-9 or abs(b) > 1e4:
                        continue
                    p0 = np.array([a1, a2]) * b / (n * n)
                    d = np.array([-a2, a1]) / n
                    seg = np.stack([p0 - 5 * d, p0 + 5 * d])
                    ax.plot(seg[:, 0], seg[:, 1], ":k", lw=0.5)
        ax.set_aspect("equal")
        return ax
