"""Port vs reference, on the CPU: the planner bridge (bridge.py),
mirroring tests/test_bridge.py.

* `PlannerBridgeServer.handle`: the port's server and the reference's,
  each around its package's goal planner with one obstacle (N=10), answer
  the same message sequence (ping, goal, obstacles, ticks, an unknown
  type, reset, a flipped-robot tick, shutdown) with the same replies:
  types, keys, flags and keep-going equal, the numbers (commands,
  trajectories) within 5e-3, the planner agreement tolerance.
* Over a Unix socket with a client timeout: a port client and a reference
  client each drive the port's server (served from a thread), and a port
  client drives the reference's server: the protocol is the same byte for
  byte. Malformed JSON is answered with an error and the server keeps
  serving.
"""

import json
import threading

import numpy as np
import pytest
import torch

import mpc_planner_tpu.bridge as jax_bridge
import mpc_planner_tpu_torch.bridge as bridge

torch.set_num_threads(1)

N = 10
TIMEOUT = 120.0


def _server(pkg, address):
    """tests/test_bridge.py's server: the goal planner with ellipsoid
    obstacles, in package `pkg`."""
    if pkg == "jax":
        from mpc_planner_tpu import default_config
        from mpc_planner_tpu.models import SecondOrderUnicycleModel
        from mpc_planner_tpu.modules import EllipsoidConstraintModule, GoalModule, ModuleManager, MPCBaseModule
        from mpc_planner_tpu.planner import Planner
        kw, mod = {}, jax_bridge
    else:
        from mpc_planner_tpu_torch import default_config
        from mpc_planner_tpu_torch.models import SecondOrderUnicycleModel
        from mpc_planner_tpu_torch.modules import (EllipsoidConstraintModule, GoalModule, ModuleManager,
                                                   MPCBaseModule)
        from mpc_planner_tpu_torch.planner import Planner
        kw, mod = {"device": "cpu"}, bridge
    cfg = default_config(N=N)
    cfg = cfg.replace(solver=cfg.solver.__class__(iterations=4, qp_iterations=8))
    model = SecondOrderUnicycleModel()
    mgr = ModuleManager()
    base = mgr.add_module(MPCBaseModule(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    mgr.add_module(GoalModule(cfg))
    mgr.add_module(EllipsoidConstraintModule(cfg))
    return mod.PlannerBridgeServer(Planner(model, mgr, cfg, **kw), cfg, address=address)


def _obstacle():
    from mpc_planner_tpu_torch.msgs import GaussianMsg, ObstacleGMMMsg

    return ObstacleGMMMsg(
        id=0, pose_x=2.0, pose_y=1.5, radius=0.4,
        gaussians=[GaussianMsg(mean_x=[2.0] * N, mean_y=[1.5] * N,
                               major_semiaxis=[0.1] * N, minor_semiaxis=[0.1] * N)],
        probabilities=[1.0])


def _messages():
    msgs = [{"type": "ping"}, {"type": "goal", "goal": [4.0, 0.0]},
            {"type": "obstacles", "obstacles": [_obstacle().to_dict()]}]
    pose = [0.0, 0.0, 0.0]
    for k in range(4):  # a fixed pose sequence, so both servers see the same ticks
        msgs.append({"type": "tick", "pose": [0.3 * k, 0.02 * k, 0.01 * k], "velocity": 0.4 * k})
    msgs += [{"type": "no_such_thing"}, {"type": "reset"}, {"type": "goal", "goal": [1.0, 0.0]},
             {"type": "tick", "pose": pose, "velocity": 0.0, "roll": 3.0}, {"type": "shutdown"}]
    return msgs


def _assert_same(reply, ref):
    assert reply.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, float) or (isinstance(v, list) and v and isinstance(v[0], list)):
            np.testing.assert_allclose(np.asarray(reply[k], float), np.asarray(v, float), atol=5e-3)
        else:
            assert reply[k] == v, k


def test_handle_replies_match_reference(tmp_path):
    servers = [_server(pkg, str(tmp_path / f"{pkg}.sock")) for pkg in ("jax", "torch")]
    try:
        for msg in _messages():
            (ref, ref_keep), (reply, keep) = (s.handle(json.loads(json.dumps(msg))) for s in servers)
            assert keep == ref_keep
            _assert_same(reply, ref)
            if msg["type"] == "tick" and "roll" not in msg:
                assert reply["success"] and len(reply["trajectory"]) == N - 1
            if "roll" in msg:
                assert reply["success"] is False and reply["v"] == 0.0
    finally:
        for s in servers:
            s._server.close()


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def _drive(client_mod, address):
    client = client_mod.PlannerBridgeClient(address, timeout=TIMEOUT)
    assert client.ping()
    assert client.set_goal([4.0, 0.0])["type"] == "ok"
    assert client.send_obstacles([_obstacle()])["type"] == "ok"
    x, y, psi, v = 0.0, 0.0, 0.0, 0.0
    for _ in range(3):
        resp = client.tick([x, y, psi], v)
        assert resp["type"] == "command" and resp["success"], resp
        v = resp["v"]
        psi += resp["w"] * 0.2
        x += v * np.cos(psi) * 0.2
        y += v * np.sin(psi) * 0.2
    assert x > 0.05
    assert client.request({"type": "no_such_thing"})["type"] == "error"
    client.sock.sendall(b"{not json\n")  # malformed JSON does not stop the server
    assert json.loads(client.reader.readline())["type"] == "error"
    assert client.ping()
    assert client.shutdown()["type"] == "ok"


@pytest.mark.parametrize("server_pkg,client_pkg", [("torch", "torch"), ("torch", "jax"),
                                                   ("jax", "torch")])
def test_socket_round_trip(server_pkg, client_pkg, tmp_path):
    address = str(tmp_path / "bridge.sock")
    thread = _serve(_server(server_pkg, address))
    _drive(bridge if client_pkg == "torch" else jax_bridge, address)
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive()


def test_default_address_is_the_reference_path():
    assert bridge.default_address() == jax_bridge.default_address()
