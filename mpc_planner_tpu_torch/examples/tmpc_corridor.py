"""T-MPC++ corridor run among pedestrians: the reference's headline
experiment (mpc_planner_jackalsimulator + pedestrian_simulator Gazebo
setup) in the closed-loop simulator.

The port's counterpart of examples/02_tmpc_corridor.py. T-MPC++ (ref
guidance_constraints.cpp) plans one full MPC problem per homotopy class
around the pedestrians in parallel, here one batched solve, and keeps the
best feasible trajectory each cycle.

    python -m mpc_planner_tpu_torch.examples.tmpc_corridor [--device cpu]
        [--guidance lateral|prm|sampled]
"""

import numpy as np

from mpc_planner_tpu_torch import default_config
from mpc_planner_tpu_torch.examples import parser
from mpc_planner_tpu_torch.planner import Planner
from mpc_planner_tpu_torch.presets import configuration_tmpc
from mpc_planner_tpu_torch.sim import ClosedLoopSimulator, Pedestrian


def main(argv=None):
    ap = parser(__doc__.split("\n\n")[0])
    ap.add_argument("--guidance", default="lateral", help="the guidance backend")
    args = ap.parse_args(argv)
    cfg = default_config(N=10)
    cfg = cfg.replace(t_mpc=cfg.t_mpc.__class__(guidance_backend=args.guidance))

    model, modules = configuration_tmpc(cfg)  # contouring + guidance + ellipsoids
    planner = Planner(model, modules, cfg, device=args.device)

    # Corridor: straight 20 m reference path, 4 oncoming pedestrians.
    xs = np.linspace(0.0, 20.0, 12)
    path = {"x": xs, "y": np.zeros_like(xs)}
    rng = np.random.default_rng(3)
    peds = [
        Pedestrian(position=np.array([4.0 + 3.5 * i, float(rng.uniform(-1.5, 1.5))]),
                   velocity=np.array([-0.9, float(rng.uniform(-0.2, 0.2))]))
        for i in range(4)
    ]

    sim = ClosedLoopSimulator(planner, cfg, peds, path, social_forces=True, robot_aware=True)
    result = sim.run(max_steps=200)

    print(f"completed:         {result.completed}")
    print(f"duration:          {result.duration:.1f} s ({result.steps} cycles)")
    print(f"collisions:        {result.collisions}")
    print(f"max intrusion:     {result.max_intrusion:.3f} m")
    print(f"infeasible cycles: {result.infeasible_cycles}")
    print(f"mean velocity:     {result.mean_velocity:.2f} m/s")
    assert result.completed and result.collisions == 0


if __name__ == "__main__":
    main()
