"""The traffic is the port's corridor, copied, and a function of the seed."""

import numpy as np
import torch

from mpcbench import scene
from mpcbench.drivers import closed_loop, fleet


def test_pedestrians_equal_the_ports_make_peds():
    from mpc_planner_tpu_torch.experiments.corridor_benchmark import make_peds

    for seed in (0, 1, 7, 123456789, 3000000101):
        a, b = scene.make_peds(12, seed), make_peds(12, seed)
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p.position, q.position)
            np.testing.assert_array_equal(p.velocity, q.velocity)
            for wa, wb in zip(p.waypoints, q.waypoints):
                np.testing.assert_array_equal(wa, wb)


def test_social_forces_equal_the_ports_simulator():
    from mpc_planner_tpu_torch.experiments.corridor_benchmark import make_peds
    from mpc_planner_tpu_torch.sim import ClosedLoopSimulator

    ours, theirs = scene.make_peds(12, 5), make_peds(12, 5)
    sim = ClosedLoopSimulator.__new__(ClosedLoopSimulator)
    sim.pedestrians, sim.social_forces, sim.robot_aware = theirs, True, True
    robot = np.array([6.0, 0.2])
    for _ in range(30):
        scene.step_pedestrians(ours, 0.2, robot_position=robot)
        sim._step_pedestrians(0.2, robot_position=robot)
    for p, q in zip(ours, theirs):
        np.testing.assert_allclose(p.position, q.position, rtol=0, atol=1e-12)


def test_robot_integration_equals_the_models_dynamics():
    from mpc_planner_tpu_torch.models import ContouringSecondOrderUnicycleModel

    model = ContouringSecondOrderUnicycleModel()
    x = np.array([1.0, -0.3, 0.2, 1.1, 0.7])
    z = torch.tensor([0.4, -0.2, *x], dtype=torch.float64)
    want = model.discrete_dynamics(z, torch.zeros(1), 0.2).numpy()
    np.testing.assert_allclose(scene.integrate_robot(x, 0.4, -0.2, 0.2), want, atol=1e-12)


def test_episodes_are_a_function_of_the_seed_alone():
    s = 3000000101
    assert [scene.episode_seed(s, e) for e in range(6)] == [scene.episode_seed(s, e)
                                                          for e in range(6)]
    assert scene.episode_seed(s, 0) != scene.episode_seed(s + 1, 0)
    assert len({scene.episode_seed(s, e) for e in range(20)}) == 20


def test_checked_answers_are_drawn_from_the_seed():
    c = {"episodes": 10, "candidates": 48, "tie": 1e-3}
    a = closed_loop.draw_candidates(2**31 + 5, c, 200)
    assert a == closed_loop.draw_candidates(2**31 + 5, c, 200) and a[0] == (0, 0)
    assert len(set(a)) == 48 and all(e < 10 and k < 200 for e, k in a)
    assert max(k for _, k in a) > 100 and max(e for e, _ in a) > 5  # the whole window
    f = {"robots": 16, "max_cycle": 200, "candidates": 8}
    i1, c1 = fleet.draw_samples(2**31 + 5, 1024, f)
    i2, c2 = fleet.draw_samples(2**31 + 5, 1024, f)
    assert list(i1) == list(i2) and c1 == c2 and len(set(c1)) == 8 and len(set(i1)) == 16
    assert max(c1) > 100


def test_fleet_scenes_and_starts_are_a_function_of_the_seed():
    x1, p1 = fleet.snapshot_scene(99, 3, 12)
    x2, p2 = fleet.snapshot_scene(99, 3, 12)
    np.testing.assert_array_equal(x1, x2)
    assert all(np.array_equal(a.position, b.position) for a, b in zip(p1, p2))
    assert x1[0] < 4.0  # short of the crossing zone
    rng1, rng2 = np.random.default_rng(1), np.random.default_rng(1)
    Z0, P, xi = np.zeros((31, 7)), np.ones((31, 5)), np.zeros(5)
    a = fleet.perturbed_batch(rng1, Z0, P, xi, 4, 2, 0.05)
    b = fleet.perturbed_batch(rng2, Z0, P, xi, 4, 2, 0.05)
    np.testing.assert_array_equal(a[0], b[0])
    assert np.all(a[0][:, 0] == 0) and np.all(a[0][:, :, :2] == 0)
