"""Verify drive: closed-loop T-MPC++ with the Visibility-PRM guidance
backend (t_mpc.guidance_backend="prm"), on the card.

The port's counterpart of experiments/verify_prm_drive.py (same scene,
same checks and lines). `--device cpu` runs it on the CPU.

    python -m mpc_planner_tpu_torch.experiments.verify_prm_drive [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from mpc_planner_tpu_torch.experiments.common import check_route, device_parser, resolve_device


def drive(device, max_steps: int = 200):
    """The PRM-guided corridor run: (SimResult, the guidance planner,
    wall seconds)."""
    from mpc_planner_tpu_torch.planner import Planner
    from mpc_planner_tpu_torch.presets import configuration_tmpc
    from mpc_planner_tpu_torch.sim import ClosedLoopSimulator, Pedestrian
    from mpc_planner_tpu_torch.utils.config import default_config

    cfg = default_config(N=20)
    cfg = cfg.replace(t_mpc=cfg.t_mpc.__class__(guidance_backend="prm"))
    model, modules = configuration_tmpc(cfg)
    planner = Planner(model, modules, cfg, device=device)
    check_route(planner.solver, True)

    rng = np.random.default_rng(0)
    peds = [
        Pedestrian(
            position=np.array([rng.uniform(4, 24), rng.uniform(-2.5, 2.5)]),
            velocity=np.array([rng.uniform(-0.6, 0.3), rng.uniform(-0.9, 0.9)]),
            radius=0.4,
            goal=np.array([rng.uniform(0, 28), rng.uniform(-3, 3)]),
        )
        for _ in range(8)
    ]
    xs = np.linspace(0, 25, 14)
    sim = ClosedLoopSimulator(planner, cfg, peds, {"x": xs, "y": np.zeros_like(xs)},
                              social_forces=True, seed=0)
    t0 = time.time()
    result = sim.run(max_steps=max_steps)
    return result, modules.get("GuidanceConstraints").guidance, time.time() - t0


def main(argv=None):
    args = device_parser(__doc__.split("\n\n")[0]).parse_args(argv)
    from mpc_planner_tpu_torch.guidance import VisibilityPRMPlanner

    result, guidance, wall = drive(resolve_device(args.device))
    assert isinstance(guidance, VisibilityPRMPlanner), "PRM backend not active"
    print(f"wall={wall:.1f}s steps={len(result.trajectory)} "
          f"completed={result.completed} duration={result.duration:.1f}s "
          f"collisions={result.collisions} infeasible={result.infeasible_cycles}")
    print(f"final position: {result.trajectory[-1]}")
    assert result.completed, "robot did not reach the corridor end"
    assert result.collisions == 0, "collision in PRM-guided run"
    print("VERIFY-OK")


if __name__ == "__main__":
    main()
