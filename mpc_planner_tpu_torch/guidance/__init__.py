"""Host guidance of T-MPC++ (counterpart of mpc_planner_tpu/guidance)."""

from mpc_planner_tpu_torch.guidance.homotopy import GuidancePlanner, GuidanceTrajectory
from mpc_planner_tpu_torch.guidance.prm import VisibilityPRMPlanner


def make_guidance_planner(cfg, device=None):
    """Guidance backend factory (t_mpc.guidance_backend). `device` is where
    the "sampled" sweep runs (None: the card); the host backends ignore it."""
    backend = getattr(cfg.t_mpc, "guidance_backend", "lateral")
    if backend == "prm":
        return VisibilityPRMPlanner(cfg)
    if backend == "lateral":
        return GuidancePlanner(cfg)
    if backend == "sampled":
        from mpc_planner_tpu_torch.guidance.device_prm import DeviceSampledPlanner

        return DeviceSampledPlanner(cfg, device=device)
    raise ValueError(f"Unknown guidance backend '{backend}' (lateral | prm | sampled)")


__all__ = [
    "GuidancePlanner",
    "GuidanceTrajectory",
    "VisibilityPRMPlanner",
    "make_guidance_planner",
]
