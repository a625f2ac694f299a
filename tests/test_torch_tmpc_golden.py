"""The port's T-MPC++ planner against the reference's goldens: one
`Planner.solve_mpc` of configuration_tmpc on corridor_scene(6 pedestrians,
seed 7), the scenes of tests/test_regression.py:52-82, on the torch
backend (CPU), reproduces tests/golden/tmpc_corridor.npz (N=15) and
tmpc_corridor_n30.npz (N=30) within 5e-3 absolute, the reference's own
tolerance (tests/test_regression.py:102). The goldens are only read.
"""

import os

import numpy as np
import pytest
import torch

from mpc_planner_tpu_torch.planner import Planner
from mpc_planner_tpu_torch.presets import configuration_tmpc, corridor_scene
from mpc_planner_tpu_torch.utils.config import default_config

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.mark.parametrize("name, N", [("tmpc_corridor", 15), ("tmpc_corridor_n30", 30)])
def test_tmpc_golden(name, N):
    cfg = default_config(N=N)
    model, modules = configuration_tmpc(cfg)
    planner = Planner(model, modules, cfg, device="cpu")
    state, data = corridor_scene(cfg, n_pedestrians=6, seed=7)
    planner.on_data_received(data, "reference_path")
    out = planner.solve_mpc(state, data)
    assert out.success
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["Z"]
    assert planner._Z.shape == golden.shape
    err = np.abs(planner._Z - golden).max()
    assert err < 5e-3, f"golden mismatch for {name}: max err {err}"
