"""The closed-loop generator: one robot driven through consecutive corridor
episodes by `Planner.solve_mpc`, back to back, on sim time.

Traffic parameters (the mix's JSON): `pedestrians` (drawn anew for each
episode from (seed, episode)), `max_steps` (an episode's cap),
`warmup_steps`, `budget_ms` (the 20 Hz robot's cycle budget) and `compare`
(`candidates` cycles drawn from the seed over the first `episodes` episodes,
whose program state is kept: the reference checks the first of them, in the
order of the draw, that the window reached; how many, each cell's limits
file says; `tie`, the selection's).

A cycle's time is the host clock around `solve_mpc`, which ends in the
device-to-host copy of the plan; the benchmark's own pedestrian and robot
steps lie outside it. Each episode starts from a `planner.reset()`.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mpcbench import scene

GOAL = np.array([scene.PATH_X[-1], 0.0])
WARMUP_EPISODE = 2**32 - 1


def draw_candidates(seed: int, compare: dict, max_steps: int) -> List[tuple]:
    """The (episode, step) pairs whose program state the window keeps, drawn
    from the seed, in the order of the draw: episode 0's first cycle (the
    start, from a reset planner) first, then cycles anywhere in the first
    `episodes` episodes."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**63, 7]))
    pairs = [(0, 0)]
    while len(pairs) < int(compare["candidates"]):
        p = (int(rng.integers(0, compare["episodes"])), int(rng.integers(1, max_steps)))
        if p not in pairs:
            pairs.append(p)
    return pairs


class ProgramLoop:
    """The port's planner on the card (or on `device`), and the program state
    that a checked cycle reads."""

    def __init__(self, config: dict, device=None):
        from mpc_planner_tpu_torch import presets
        from mpc_planner_tpu_torch.planner import Planner

        self.cfg, self.model, self.modules = presets.select_system(config["system"],
                                                                   config["variant"])
        self.planner = Planner(self.model, self.modules, self.cfg, device=device)
        self.gmod = self.modules.get("GuidanceConstraints")
        self.contouring = self.modules.get("Contouring")
        check_shapes(config, self.planner.ocp, self.gmod)

    def make_data(self, x: np.ndarray, peds, path: dict):
        return program_data(self.cfg, self.model, self.planner.default_robot_area(), x, peds, path)

    def state_of(self, x: np.ndarray):
        return program_state(self.model, x)

    def snapshot_before(self) -> dict:
        """The program's own state that the next cycle starts from."""
        p = self.planner
        snap = {"Z_prev": p._Z.copy(), "was_feasible": bool(p._output.success)}
        if self.contouring is not None:
            snap["closest_segment"] = int(self.contouring.closest_segment)
        if self.gmod is not None:
            g = self.gmod
            snap["selected_signature"] = (None if g.guidance is None
                                          else g.guidance.selected_signature)
            snap["selected_planner"] = int(g._selected_planner)
            snap["prev_duals"] = (None if g._prev_duals is None
                                  else tuple(t.detach().cpu().numpy() for t in g._prev_duals))
        return snap

    def snapshot_after(self, out, state) -> dict:
        p = self.planner
        rec = {"success": bool(out.success), "P": p._module_data.pblock.data.copy(),
               "spline_s": float(state.get("spline"))}
        if out.success:
            rec["plan"] = p._Z.copy()
        if self.gmod is not None and self.gmod._prev_duals is not None:
            duals = self.gmod._prev_duals
            rec["batch_ok"] = duals[2].detach().cpu().numpy()
            if out.success:
                rec["batch_Z"] = self.gmod._last_batch_Z.detach().cpu().numpy()
                rec["batch_lam"] = torch.cat(duals[:2], dim=-1).detach().cpu().numpy()
                rec["selected"] = int(self.gmod._selected_planner)
        return rec


def program_state(model, x: np.ndarray):
    """The port's State of the state vector x."""
    from mpc_planner_tpu_torch.types import State

    state = State(model)
    state.from_array(np.asarray(x, dtype=float))
    return state


def program_data(cfg, model, robot_area, x: np.ndarray, peds, path: dict):
    """RealTimeData of one cycle: the path, the goal at its end, and the
    pedestrians under constant-velocity predictions, through the port's
    data preparation."""
    from mpc_planner_tpu_torch.data_preparation import (
        HostObstacle,
        ensure_obstacle_size,
        get_constant_velocity_prediction,
        pack_obstacles,
    )
    from mpc_planner_tpu_torch.types import RealTimeData

    data = RealTimeData()
    data.robot_area = robot_area
    data.reference_path = path
    data.goal = GOAL.copy()
    data.goal_received = True
    state = program_state(model, x)
    obstacles = []
    for i, p in enumerate(peds):
        o = HostObstacle(index=i, position=p.position.copy(), angle=0.0, radius=p.radius)
        o.prediction = get_constant_velocity_prediction(p.position, p.velocity, cfg.dt, cfg.N,
                                                        cfg.probabilistic.enable)
        obstacles.append(o)
    obstacles = ensure_obstacle_size(obstacles, state, cfg.max_obstacles, cfg.N, cfg.dt,
                                     cfg.probabilistic.enable)
    data.dynamic_obstacles = obstacles
    data.obstacle_block = pack_obstacles(obstacles, cfg.N)
    data.ego_position = state.get_position()
    return data


def check_shapes(config: dict, ocp, gmod) -> None:
    """Refuse a program whose OCP is not the configuration file's."""
    got = {"N": ocp.N, "nvar": ocp.nvar, "nh": ocp.nh, "npar": ocp.npar,
           "iterations": ocp.cfg.solver.iterations,
           "batch": 1 if gmod is None else gmod.n_planners}
    want = {k: config[k] for k in got}
    if got != want:
        raise RuntimeError(f"the program builds {got}, the configuration file states {want}")


class Outcomes:
    """Planning outcomes of the configuration, reported and never counted as
    failures."""

    def __init__(self):
        self.non_success_exits = 0
        self.escalated_cycles = 0
        self.budget_misses = 0
        self.collisions = 0
        self.completed_episodes = 0
        self.unfinished_episodes = 0
        self.episodes = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(vars(self))


def run(program: ProgramLoop, traffic: dict, seed: int, seconds: float, launches=None,
        on_window=None, after_window=None, checked_cycles: int = 1) -> dict:
    """Set-up's warm-up episode, then the measured window of `seconds`.

    `launches()` reads the K3 launch counter; `on_window` is a context
    manager factory entered around the window (the device trace);
    `after_window()` runs once the window has closed. Returns the window's
    cycle records, the checked cycles' snapshots and the outcomes."""
    import contextlib

    cfg = program.cfg
    dt = cfg.dt
    path = {"x": scene.PATH_X.copy(), "y": np.zeros_like(scene.PATH_X)}
    candidates = draw_candidates(seed, traffic["compare"], traffic["max_steps"])
    samples = set(candidates)
    launches = launches or (lambda: 0)
    budget_s = traffic["budget_ms"] / 1e3

    def episode(e: int, steps: int, record: Optional[list], outcomes: Optional[Outcomes],
                snapshots: Optional[dict], deadline: float):
        """One episode; returns False if the window closed inside it."""
        # The warm-up (e = -1) plays a scene of its own, outside the sequence.
        peds = scene.make_peds(traffic["pedestrians"],
                               scene.episode_seed(seed, WARMUP_EPISODE if e < 0 else e))
        program.planner.reset()
        x = np.zeros(5)
        data = program.make_data(x, peds, path)
        program.planner.on_data_received(data, "reference_path")
        state = program.state_of(x)
        for k in range(steps):
            data = program.make_data(state.as_array(), peds, path)
            snap = None
            if snapshots is not None and (e, k) in samples:
                snap = {"episode": e, "step": k, "x": state.as_array().copy(),
                        "peds": {"pos": np.array([p.position for p in peds]),
                                 "vel": np.array([p.velocity for p in peds]),
                                 "radius": np.array([p.radius for p in peds])},
                        **program.snapshot_before()}
            n0 = launches()
            raised = None
            t0 = time.perf_counter()
            try:
                out = program.planner.solve_mpc(state, data)
            except Exception as exc:  # a failed operation: recorded, the loop goes on
                out, raised = None, f"{type(exc).__name__}: {exc}"
            t1 = time.perf_counter()
            n_launch = launches() - n0
            success = out is not None and out.success
            finite = (not success) or bool(np.all(np.isfinite(program.planner._Z)))
            if record is not None:
                record.append((t1 - t0, n_launch, success, finite, raised, t0))
            if outcomes is not None:
                outcomes.non_success_exits += int(out is not None and not out.success)
                outcomes.escalated_cycles += int(n_launch > 1)
                outcomes.budget_misses += int(t1 - t0 > budget_s)
            if snap is not None:
                snap["raised"] = raised
                if out is not None:
                    snap.update(program.snapshot_after(out, state))
                snapshots[(e, k)] = snap
            if success and finite:
                a, w = program.planner.get_solution(0, "a"), program.planner.get_solution(0, "w")
            else:
                a, w = scene.braking_input(state.get("v"), dt, cfg.deceleration_at_infeasible), 0.0
            x = scene.integrate_robot(state.as_array(), a, w, dt)
            state = program.state_of(x)
            scene.step_pedestrians(peds, dt, robot_position=x[:2])
            if outcomes is not None:
                outcomes.collisions += scene.intrusions(x[:2], peds, cfg.robot_radius)
            if np.linalg.norm(x[:2] - GOAL) < 1.0:
                if outcomes is not None:
                    outcomes.completed_episodes += 1
                return True
            if time.perf_counter() >= deadline:
                return False
        if outcomes is not None:
            outcomes.unfinished_episodes += 1
        return True

    # Set-up: one short episode of a scene outside the run's sequence.
    episode(-1, traffic["warmup_steps"], None, None, None, math.inf)

    record: List[tuple] = []
    outcomes = Outcomes()
    snapshots: Dict[tuple, dict] = {}
    ctx = on_window() if on_window is not None else contextlib.nullcontext()
    with ctx:
        t_start = time.perf_counter()
        deadline = t_start + seconds
        e = 0
        while True:
            outcomes.episodes += 1
            whole = episode(e, traffic["max_steps"], record, outcomes, snapshots, deadline)
            e += 1
            if not whole or time.perf_counter() >= deadline:
                break
        t_end = time.perf_counter()
    if after_window is not None:
        after_window()
    checked = sorted([p for p in candidates if p in snapshots][:int(checked_cycles)])
    return {"cycles": record, "window_s": t_end - t_start, "t_start": t_start, "t_end": t_end,
            "outcomes": outcomes.as_dict(), "snapshots": [snapshots[k] for k in checked]}


Program = ProgramLoop


def reference_numbers(out: dict, config: dict, traffic: dict, seed: int, against=(),
                      readings=None, workers=None):
    """The checked cycles that did not raise, against the frozen reference
    (at the configuration's `reference_precision`), each cycle with the
    reference's probe: a judge.Checked. With `against`, also the reference
    at each of those precisions (the control: "tf32") put in the program's
    place: {"program": Checked, precision: Checked}. A `readings` list
    receives each cycle's readings, with the plans' gaps alone beside."""
    from mpcbench import judge
    from mpcbench.reference import pool
    from mpcbench.reference.check import corridor_task, probe_snapshot

    tie, main = traffic["compare"]["tie"], config["reference_precision"]
    snaps = [s for s in out["snapshots"] if s.get("raised") is None and "P" in s]
    tasks = []
    for s in snaps:
        tasks += [(corridor_task, (config, main, s)),
                  (corridor_task, (config, main, probe_snapshot(s, seed)))]
        tasks += [(corridor_task, (config, p, s)) for p in against]
    recs = pool.run(tasks, workers)
    width = 2 + len(against)
    result = {who: judge.Checked() for who in ("program", *against)}
    for n, s in enumerate(snaps):
        ref, probe, *others = recs[n * width:(n + 1) * width]
        sens = judge.corridor_sensitivities(ref, probe)
        row = {"episode": s["episode"], "step": s["step"], "sens": sens,
               "plan_sens": judge.corridor_sensitivities(ref, probe, duals=False)}
        for who, rec in [("program", s), *zip(against, others)]:
            result[who].params.append(judge.param_gap(rec["P"], ref["P"]))
            gaps, selection = judge.corridor_solves(rec, ref, tie)
            result[who].add_cycle(gaps, sens, selection)
            plain = {k: v for k, v in rec.items() if k != "batch_lam"}
            row.update({f"{who}_gaps": gaps, f"{who}_selection": selection,
                        f"{who}_plan_gaps": judge.corridor_solves(plain, ref, tie)[0]})
        if readings is not None:
            readings.append(row)
    return result if against else result["program"]


def failed_operations(out: dict) -> int:
    """Cycles that raised or returned a non-finite plan."""
    return sum(int(c[4] is not None or not c[3]) for c in out["cycles"])


def attempted(out: dict) -> int:
    return len(out["cycles"])


def end_to_end(out: dict) -> dict:
    from mpcbench import stats

    times = [c[0] for c in out["cycles"]]
    return {"cycle_ms_mean": stats.mean_ms(out["window_s"], len(times)),
            "cycle_ms_p95": stats.p95_ms(times)}


def outcomes(out: dict) -> dict:
    return dict(out["outcomes"], checked_cycles=len(out["snapshots"]))
