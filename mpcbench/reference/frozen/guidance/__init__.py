"""Host guidance of T-MPC++: the "lateral" backend only."""

from mpcbench.reference.frozen.guidance.homotopy import GuidancePlanner, GuidanceTrajectory


def make_guidance_planner(cfg, device=None):
    """The guidance backend of `cfg` ("lateral", the configurations' default)."""
    backend = getattr(cfg.t_mpc, "guidance_backend", "lateral")
    if backend != "lateral":
        raise ValueError(f"the frozen reference has the 'lateral' guidance only, not {backend!r}")
    return GuidancePlanner(cfg)


__all__ = ["GuidancePlanner", "GuidanceTrajectory", "make_guidance_planner"]
