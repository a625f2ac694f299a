"""Smoke-run the port's examples (mpc_planner_tpu_torch/examples) as
subprocesses with `--device cpu`, mirroring tests/test_examples.py so they
cannot rot. The two that run a long closed loop on the CPU are marked
slow: the T-MPC++ corridor (~4 min) and the custom system (~1 min)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "example,args,expect",
    [
        ("goal_tracking", (), "goal reached"),
        ("mesh_fanout", ("--ranks", "2"), "2 ranks finished"),
        # Without rclpy installed the relay documents itself and exits 0
        ("ros_relay", (), "relay"),
        pytest.param("tmpc_corridor", (), "completed:", marks=pytest.mark.slow, id="tmpc_corridor"),
        pytest.param("custom_system", (), "no collision", marks=pytest.mark.slow, id="custom_system"),
        ("bridge_external_sim", (), "OK"),
    ],
)
def test_example_runs(example, args, expect):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", f"mpc_planner_tpu_torch.examples.{example}", "--device", "cpu", *args],
        capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert expect in proc.stdout
