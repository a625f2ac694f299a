"""External-process bridge: the planner behind a socket, in place of the
reference's ROS topic layer.

Counterpart of mpc_planner_tpu/bridge.py, with the same protocol byte for
byte, so a client of either package drives a server of the other. The
reference's system packages wire the planner to the robot through ROS
pub/sub (state / goal / reference path / obstacle topics in, command out:
mpc_planner_jackalsimulator/src/ros1_jackalsimulator.cpp:58-103, 185-201).
Here the same surface is a newline-delimited-JSON protocol over a
Unix-domain or TCP socket, speaking the msgs.py schemas (which mirror
mpc_planner_msgs/msg/*.msg), so an external simulator or robot driver in
any language, a thin ROS relay node included, drives the planner from
another process. The server holds a `systems.RobotLoop`; the planner in it
runs on the card unless it was built with another device.

Protocol (one JSON object per line, request -> response):

  {"type": "reference_path", "x": [...], "y": [...], "v": [...]?,
   "left_bound": [[x,y],...]?, "right_bound": ...?}      -> {"type": "ok"}
  {"type": "goal", "goal": [x, y]}                       -> {"type": "ok"}
  {"type": "obstacles", "obstacles": [<ObstacleGMM dict>]} -> {"type": "ok"}
      (stored; consumed by the next tick: the async-callback pattern of
       the reference's obstacleCallback, ros1_jackalsimulator.cpp:298)
  {"type": "tick", "pose": [x, y, psi], "velocity": v,
   "roll": r?, "pitch": p?}
      -> {"type": "command", "v": .., "w": .., "success": bool,
          "objective_reached": bool, "trajectory": [[x, y], ...]}
  {"type": "reset"}                                      -> {"type": "ok"}
  {"type": "ping"}                                       -> {"type": "pong"}
  {"type": "shutdown"}                                   -> {"type": "ok"} + close

Single client, blocking, synchronous: a control loop is a lockstep
request/response cycle (the 20 Hz timer lives with the caller, like the
reference's ros::Timer does in the system node).
"""

from __future__ import annotations

import json
import os
import socket
import stat
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from mpc_planner_tpu_torch.msgs import ObstacleGMMMsg
from mpc_planner_tpu_torch.systems import RobotLoop


def _send(sock: socket.socket, obj: dict) -> None:
    sock.sendall((json.dumps(obj) + "\n").encode())


class _LineReader:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""

    def readline(self) -> Optional[bytes]:
        while b"\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                return None
            self.buf += chunk
        line, self.buf = self.buf.split(b"\n", 1)
        return line


def default_address() -> str:
    """Default socket path: inside a per-user mode-0700 runtime dir, not
    a fixed world-writable /tmp path (any local user could otherwise
    connect and command the planner, and the server would unlink whatever
    sat at the fixed path). The same path as the reference's, so the two
    packages' servers and clients find each other by default."""
    run_dir = os.path.join(
        tempfile.gettempdir(), f"mpc_planner_tpu-{os.getuid()}"
    )
    os.makedirs(run_dir, mode=0o700, exist_ok=True)
    # XDG_RUNTIME_DIR-style ownership check: the path is predictable, so
    # refuse a directory (or symlink) pre-created by another local user
    # with a clear error instead of an opaque chmod PermissionError.
    st = os.lstat(run_dir)
    if not stat.S_ISDIR(st.st_mode):
        raise RuntimeError(
            f"runtime dir {run_dir!r} exists but is not a real directory "
            "(symlink squatting?) — remove it or set an explicit address"
        )
    if st.st_uid != os.getuid():
        raise RuntimeError(
            f"runtime dir {run_dir!r} is owned by uid {st.st_uid}, not "
            f"{os.getuid()} — remove it or set an explicit address"
        )
    os.chmod(run_dir, 0o700)
    return os.path.join(run_dir, "planner.sock")


class PlannerBridgeServer:
    """Serves one RobotLoop over a socket. `serve_forever` blocks: run it
    as the main loop of a planner process (or in a thread)."""

    def __init__(self, planner, cfg, address=None):
        self.loop = RobotLoop(planner, cfg)
        self._pending_obstacles: List[dict] = []
        if address is None:
            address = default_address()
        self.address = address
        if isinstance(address, str):
            if os.path.exists(address):
                # Only clear a stale path if it really is a socket:
                # never unlink an arbitrary file planted at the address.
                if stat.S_ISSOCK(os.lstat(address).st_mode):
                    os.unlink(address)
                else:
                    raise RuntimeError(
                        f"bridge address {address!r} exists and is not a socket"
                    )
            self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._server.bind(address)
            os.chmod(address, 0o600)
        else:  # (host, port) tuple
            self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._server.bind(tuple(address))
        self._server.listen(1)

    @property
    def port(self) -> Optional[int]:
        if self._server.family == socket.AF_INET:
            return self._server.getsockname()[1]
        return None

    def handle(self, msg: dict) -> Tuple[dict, bool]:
        """Process one request; returns (response, keep_going)."""
        t = msg.get("type")
        if t == "ping":
            return {"type": "pong"}, True
        if t == "shutdown":
            return {"type": "ok"}, False
        if t == "reset":
            self.loop.reset()
            self._pending_obstacles = []
            return {"type": "ok"}, True
        if t == "reference_path":
            self.loop.set_reference_path(
                msg["x"], msg["y"], v=msg.get("v"),
                left_bound=msg.get("left_bound"),
                right_bound=msg.get("right_bound"),
            )
            return {"type": "ok"}, True
        if t == "goal":
            self.loop.set_goal(msg["goal"])
            return {"type": "ok"}, True
        if t == "obstacles":
            self._pending_obstacles = [
                ObstacleGMMMsg.from_dict(o).to_raw_obstacle()
                for o in msg.get("obstacles", [])
            ]
            return {"type": "ok"}, True
        if t == "tick":
            v_cmd, w_cmd, success = self.loop.tick(
                msg["pose"], msg["velocity"], self._pending_obstacles,
                roll=msg.get("roll", 0.0), pitch=msg.get("pitch", 0.0),
            )
            traj = self.loop.planner._output.trajectory.positions
            return {
                "type": "command",
                "v": v_cmd,
                "w": w_cmd,
                "success": bool(success),
                "objective_reached": bool(self.loop.objective_reached()),
                "trajectory": np.asarray(traj, float).tolist(),
            }, True
        return {"type": "error", "message": f"unknown type {t!r}"}, True

    def serve_forever(self) -> None:
        try:
            while True:
                conn, _ = self._server.accept()
                reader = _LineReader(conn)
                keep = True
                while keep:
                    line = reader.readline()
                    if line is None:
                        break
                    try:
                        msg = json.loads(line)
                    except json.JSONDecodeError as e:
                        _send(conn, {"type": "error", "message": str(e)})
                        continue
                    try:
                        resp, keep = self.handle(msg)
                    except Exception as e:  # surface planner errors to client
                        resp, keep = {"type": "error", "message": repr(e)}, True
                    _send(conn, resp)
                conn.close()
                if not keep:
                    return
        finally:
            self._server.close()
            if isinstance(self.address, str) and os.path.exists(self.address):
                os.unlink(self.address)


class PlannerBridgeClient:
    """Robot-/simulator-side handle (the reference's topic publishers +
    command subscriber collapsed into one request/response socket).
    `timeout` [s] bounds every send and receive."""

    def __init__(self, address=None, timeout=60.0):
        if address is None:
            address = default_address()
        if isinstance(address, str):
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.settimeout(timeout)
        self.sock.connect(address if isinstance(address, str) else tuple(address))
        self.reader = _LineReader(self.sock)

    def request(self, msg: dict) -> dict:
        _send(self.sock, msg)
        line = self.reader.readline()
        if line is None:
            raise ConnectionError("bridge server closed the connection")
        return json.loads(line)

    def ping(self) -> bool:
        return self.request({"type": "ping"}).get("type") == "pong"

    def set_reference_path(self, x, y, **kw) -> dict:
        return self.request({"type": "reference_path",
                             "x": list(map(float, x)),
                             "y": list(map(float, y)), **kw})

    def set_goal(self, goal) -> dict:
        return self.request({"type": "goal", "goal": list(map(float, goal))})

    def send_obstacles(self, obstacle_msgs) -> dict:
        return self.request({
            "type": "obstacles",
            "obstacles": [o.to_dict() if hasattr(o, "to_dict") else o
                          for o in obstacle_msgs],
        })

    def tick(self, pose, velocity: float, **kw) -> dict:
        return self.request({"type": "tick", "pose": list(map(float, pose)),
                             "velocity": float(velocity), **kw})

    def reset(self) -> dict:
        return self.request({"type": "reset"})

    def shutdown(self) -> dict:
        try:
            return self.request({"type": "shutdown"})
        finally:
            self.sock.close()
