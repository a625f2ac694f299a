"""Host guidance of T-MPC++ (counterpart of mpc_planner_tpu/guidance)."""

from mpc_planner_tpu_torch.guidance.homotopy import GuidancePlanner, GuidanceTrajectory
from mpc_planner_tpu_torch.guidance.prm import VisibilityPRMPlanner


def make_guidance_planner(cfg):
    """Guidance backend factory (t_mpc.guidance_backend)."""
    backend = getattr(cfg.t_mpc, "guidance_backend", "lateral")
    if backend == "prm":
        return VisibilityPRMPlanner(cfg)
    if backend == "lateral":
        return GuidancePlanner(cfg)
    if backend == "sampled":
        raise ValueError(
            "guidance backend 'sampled' (the device sweep, mpc_planner_tpu/guidance/"
            "device_prm.py) is not ported yet: ROADMAP.md item M11")
    raise ValueError(f"Unknown guidance backend '{backend}' (lateral | prm | sampled)")


__all__ = [
    "GuidancePlanner",
    "GuidanceTrajectory",
    "VisibilityPRMPlanner",
    "make_guidance_planner",
]
