"""Minimal ROS 2 relay between robot topics and the planner bridge.

The port's counterpart of examples/06_ros_relay.py: the same relay, over
the port's bridge client (the protocol is the reference's byte for byte,
so the relay also drives a server of the JAX package).

The reference's system nodes ARE the relay: ros1_jackalsimulator.cpp
subscribes to /input/state, /input/goal, /pedestrian_simulator/
trajectory_predictions and publishes /cmd_vel (:58-103), with the
planner living in-process. In this framework the planner runs as its
own process behind `PlannerBridgeServer` (any middleware can feed it),
so the ROS integration reduces to this ~80-line relay node:

  odom topic  ─┐                                    ┌─> cmd_vel topic
  obstacles  ──┤  rclpy node ── NDJSON/Unix socket ─┤
  path topic ──┘        (PlannerBridgeClient)       └─ planner process

Run the planner process first (any system preset), e.g.:

    python -c "
    from mpc_planner_tpu_torch.bridge import PlannerBridgeServer
    from mpc_planner_tpu_torch.planner import Planner
    from mpc_planner_tpu_torch.presets import configuration_tmpc
    from mpc_planner_tpu_torch.utils.config import default_config
    cfg = default_config(N=20)
    model, modules = configuration_tmpc(cfg)
    PlannerBridgeServer(Planner(model, modules, cfg), cfg).serve_forever()"

(the planner on the card), then launch this node in a ROS 2 environment:

    python -m mpc_planner_tpu_torch.examples.ros_relay [--address /path/planner.sock]

Without rclpy this example prints the wiring and exits 0 (the relay's
client calls are exercised by tests/test_torch_bridge.py).
"""

import sys

try:
    import rclpy
    from rclpy.node import Node
except ImportError:  # no ROS environment: document the wiring, exit clean
    rclpy = None
    Node = object

from mpc_planner_tpu_torch.bridge import PlannerBridgeClient, default_address
from mpc_planner_tpu_torch.examples import parser


class PlannerRelay(Node):
    """Relay node (ref ros1_jackalsimulator.cpp:58-103 topic wiring)."""

    def __init__(self, address: str):
        super().__init__("mpc_planner_relay")
        from geometry_msgs.msg import Twist
        from nav_msgs.msg import Odometry, Path

        self.client = PlannerBridgeClient(address=address)
        self.pose = None  # (x, y, psi)
        self.velocity = 0.0
        self.obstacles = []

        self.cmd_pub = self.create_publisher(Twist, "cmd_vel", 1)
        self.create_subscription(Odometry, "odom", self._on_odom, 1)
        self.create_subscription(Path, "plan", self._on_path, 1)
        # Obstacle predictions arrive as a JSON string on a std_msgs
        # topic (the ObstacleArrayMsg dict schema, msgs.py); swap for a
        # typed message in a real deployment.
        from std_msgs.msg import String

        self.create_subscription(String, "obstacle_predictions",
                                 self._on_obstacles, 1)
        # 20 Hz control timer (ref :153 the controlLoop ros::Timer)
        self.create_timer(0.05, self._control_loop)

    def _on_odom(self, msg) -> None:
        q = msg.pose.pose.orientation
        import math

        psi = math.atan2(2.0 * (q.w * q.z + q.x * q.y),
                         1.0 - 2.0 * (q.y * q.y + q.z * q.z))
        p = msg.pose.pose.position
        self.pose = (p.x, p.y, psi)
        self.velocity = msg.twist.twist.linear.x

    def _on_path(self, msg) -> None:
        xs = [p.pose.position.x for p in msg.poses]
        ys = [p.pose.position.y for p in msg.poses]
        if len(xs) >= 2:
            self.client.set_reference_path(xs, ys)

    def _on_obstacles(self, msg) -> None:
        import json

        from mpc_planner_tpu_torch.msgs import ObstacleArrayMsg

        arr = ObstacleArrayMsg.from_dict(json.loads(msg.data))
        self.obstacles = [o.to_dict() for o in arr.obstacles]

    def _control_loop(self) -> None:
        if self.pose is None:
            return
        self.client.send_obstacles(self.obstacles)
        out = self.client.tick(list(self.pose), self.velocity)
        from geometry_msgs.msg import Twist

        cmd = Twist()
        cmd.linear.x = float(out.get("v", 0.0))
        cmd.angular.z = float(out.get("w", 0.0))
        self.cmd_pub.publish(cmd)


def main(argv=None) -> int:
    ap = parser(__doc__.split("\n\n")[0])
    ap.set_defaults(device=None)  # the planner, and its device, live in the server process
    ap.add_argument("--address", default=None, help="the bridge's socket (default: bridge.default_address())")
    args = ap.parse_args(argv)
    if rclpy is None:
        print(__doc__)
        print("rclpy not available in this environment; relay not started.")
        return 0
    rclpy.init()
    node = PlannerRelay(args.address or default_address())
    try:
        rclpy.spin(node)
    except KeyboardInterrupt:
        pass
    finally:
        node.destroy_node()
        rclpy.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
