"""External simulator driving the planner over the process bridge.

The port's counterpart of examples/05_bridge_external_sim.py. The
reference wires its planner to the robot or simulator through ROS topics
at a 20 Hz timer (ros1_jackalsimulator.cpp:58-103,153-201). This example
reproduces that topology with the port's socket bridge:

  [this process]  pedestrian simulator + robot integrator, 20 Hz loop
        | NDJSON over a Unix socket (msgs.py schemas)
  [child process] PlannerBridgeServer(Planner(...)): the "planner node"

Per cycle the simulator publishes the pedestrians as ObstacleGMM messages
(constant-velocity predictions with growing uncertainty, the reference's
obstacleCallback conversion), ticks the planner with the current pose,
applies the returned (v, w) command, and steps the world. The socket round
trip is measured against the reference's 50 ms cycle budget.

    python -m mpc_planner_tpu_torch.examples.bridge_external_sim [--device cpu]
"""

import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from mpc_planner_tpu_torch.examples import parser

N = 10  # horizon of the planner in the child process
DT = 0.2
CYCLES = 80
N_PEDS = 4

SERVER_SCRIPT = f"""
import sys
import torch
torch.set_num_threads(1)
from mpc_planner_tpu_torch import default_config
from mpc_planner_tpu_torch.bridge import PlannerBridgeServer
from mpc_planner_tpu_torch.planner import Planner
from mpc_planner_tpu_torch.presets import configuration_basic

cfg = default_config(N={N}).replace(max_obstacles={N_PEDS})
cfg = cfg.replace(solver=cfg.solver.__class__(iterations=4, qp_iterations=8))
model, modules = configuration_basic(cfg)
planner = Planner(model, modules, cfg, device=sys.argv[2])
server = PlannerBridgeServer(planner, cfg, address=sys.argv[1])
print("READY", flush=True)
server.serve_forever()
"""


def make_obstacle_msgs(peds, horizon, dt):
    """Constant-velocity ObstacleGMM predictions with propagated
    uncertainty (ref data_preparation.cpp:58-79,170-186)."""
    from mpc_planner_tpu_torch.msgs import GaussianMsg, ObstacleGMMMsg

    msgs = []
    for i, (pos, vel) in enumerate(peds):
        steps = np.arange(1, horizon + 1)[:, None] * dt
        mean = pos[None] + steps * vel[None]
        sigma = np.sqrt(np.cumsum(np.full(horizon, (0.3 * dt) ** 2)))
        msgs.append(ObstacleGMMMsg(
            id=i, pose_x=float(pos[0]), pose_y=float(pos[1]), radius=0.35,
            gaussians=[GaussianMsg(mean_x=mean[:, 0].tolist(), mean_y=mean[:, 1].tolist(),
                                   major_semiaxis=sigma.tolist(), minor_semiaxis=sigma.tolist())],
            probabilities=[1.0]))
    return msgs


def main(argv=None):
    args = parser(__doc__.split("\n\n")[0]).parse_args(argv)
    from mpc_planner_tpu_torch.bridge import PlannerBridgeClient

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory(prefix="mpc_bridge_ex_") as tmp:
        addr = os.path.join(tmp, "planner.sock")
        proc = subprocess.Popen([sys.executable, "-u", "-c", SERVER_SCRIPT, addr, args.device],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        try:
            line = proc.stdout.readline().strip()
            while line and line != "READY":
                line = proc.stdout.readline().strip()
            if proc.poll() is not None:
                raise RuntimeError("planner server failed to start")
            run_client(PlannerBridgeClient(addr, timeout=600.0))
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_client(client):
    assert client.ping()
    # Reference path straight down the corridor (pathCallback analog)
    xs = np.linspace(0.0, 12.0, 8)
    client.set_reference_path(xs.tolist(), np.zeros_like(xs).tolist())

    # Crossing pedestrians
    rng = np.random.default_rng(3)
    peds = [(np.array([rng.uniform(2.5, 9.0), rng.uniform(-2.0, 2.0)]),
             np.array([rng.uniform(-0.3, 0.1), rng.uniform(-0.5, 0.5)])) for _ in range(N_PEDS)]

    x, y, psi, v = 0.0, 0.0, 0.0, 0.0
    latencies, infeasible = [], 0
    for _ in range(CYCLES):
        # publish obstacles (async topic analog), then tick
        t0 = time.perf_counter()
        client.send_obstacles(make_obstacle_msgs(peds, N, DT))
        resp = client.tick([x, y, psi], v)
        latencies.append(time.perf_counter() - t0)
        assert resp["type"] == "command", resp
        if not resp["success"]:
            infeasible += 1  # a braking command (v=0 ramp) comes back
        v = resp["v"]
        psi += resp["w"] * DT
        x += v * np.cos(psi) * DT
        y += v * np.sin(psi) * DT
        peds = [(p + DT * u, u) for p, u in peds]
        if resp["objective_reached"]:
            break

    lat = np.asarray(latencies[1:]) * 1e3  # the first cycle builds the solver's kernels
    print(f"cycles={len(latencies)} pos=({x:.2f},{y:.2f}) infeasible={infeasible} "
          f"first cycle {latencies[0] * 1e3:.1f} ms")
    print(f"socket round-trip latency after the first cycle: mean={lat.mean():.1f}ms "
          f"p50={np.percentile(lat, 50):.1f}ms max={lat.max():.1f}ms "
          f"(reference cycle budget: 50 ms @ 20 Hz)")
    client.shutdown()
    assert x > 8.0, "robot did not progress down the corridor"
    print("OK")


if __name__ == "__main__":
    main()
