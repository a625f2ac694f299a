"""The reference's side of the comparison: the frozen plain route, worked
from the benchmark's own inputs, on the host's CPU cores after the window
(each checked cycle or block of robots a task of `pool.run`).

For a checked corridor cycle the reference builds the cycle's data from
the pedestrians' raw positions and velocities, starts from the program's
own state before the cycle (the plan it keeps, whether the last cycle
succeeded, the path segment, the selected homotopy class and the carried
duals: the step-by-step part), and runs the whole cycle: warm start,
module updates, the parameter block, the guidance, the batched SQP-RTI
with its escalation, and the T-MPC++ selection. For the fleet it builds
each sampled robot's OCP instance from its scene and solves the sampled
robots from the same starts as the program.

`precision` is "f32" (the configurations' stated float32, TF32 off) or
"tf32", the control: the float32 reference with the parameter block and
every QP's data and step rounded to TF32 (a 10-bit mantissa), the
precision one step below the stated one.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from mpcbench.reference.frozen import presets
from mpcbench.reference.frozen.data_preparation import (
    HostObstacle,
    define_robot_area,
    ensure_obstacle_size,
    get_constant_velocity_prediction,
    pack_obstacles,
)
from mpcbench.reference.frozen.guidance import make_guidance_planner
from mpcbench.reference.frozen.parameters import ParameterBlock
from mpcbench.reference.frozen.planner import Planner
from mpcbench.reference.frozen.solver.ocp import OCP
from mpcbench.reference.frozen.solver.sqp import EXIT_SUCCESS, SQPSolver
from mpcbench.reference.frozen.solver.warmstart import initialize_with_state
from mpcbench.reference.frozen.types import ModuleData, RealTimeData, State

PATH_X = np.linspace(0.0, 25.0, 14)
GOAL = np.array([PATH_X[-1], 0.0])


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round to TF32 (float32 with a 10-bit mantissa), to nearest."""
    if not torch.is_floating_point(t):
        return t
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(t.dtype)


PRECISIONS = {"f32": (torch.float32, None), "tf32": (torch.float32, tf32)}


def _precision(precision: str):
    """(dtype, rounding) of a precision's name."""
    try:
        return PRECISIONS[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}") from None


def _data(cfg, x, peds: dict) -> RealTimeData:
    data = RealTimeData()
    data.robot_area = define_robot_area(cfg.robot.length, cfg.robot.width, cfg.n_discs)
    data.reference_path = {"x": PATH_X.copy(), "y": np.zeros_like(PATH_X)}
    data.goal = GOAL.copy()
    data.goal_received = True
    state = State(nx=5)
    state.from_array(np.asarray(x, float))
    obstacles = []
    for i, (p, v, r) in enumerate(zip(peds["pos"], peds["vel"], peds["radius"])):
        o = HostObstacle(index=i, position=np.asarray(p, float).copy(), angle=0.0, radius=float(r))
        o.prediction = get_constant_velocity_prediction(np.asarray(p, float), np.asarray(v, float),
                                                        cfg.dt, cfg.N, cfg.probabilistic.enable)
        obstacles.append(o)
    obstacles = ensure_obstacle_size(obstacles, state, cfg.max_obstacles, cfg.N, cfg.dt,
                                     cfg.probabilistic.enable)
    data.dynamic_obstacles = obstacles
    data.obstacle_block = pack_obstacles(obstacles, cfg.N)
    data.ego_position = state.get_position()
    return data


PROBE_SCALE = 1e-6  # relative: a few float32 roundings of every input


def jitter(a, rng, scale: float = PROBE_SCALE):
    """`a` with every entry moved by a relative N(0, scale) from `rng`."""
    a = np.asarray(a, float)
    return a * (1.0 + scale * rng.standard_normal(a.shape))


def probe_snapshot(snap: dict, seed: int) -> dict:
    """The sensitivity probe of a checked cycle: the same cycle with every
    number it starts from (the robot's state, the pedestrians, the kept plan
    and the carried duals) moved by a few float32 roundings. Where the
    reference's answer moves under this by more than a solve in another
    rounding may, the cycle cannot decide between two such solves."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**63, snap["episode"],
                                                        snap["step"], 17]))
    out = dict(snap)
    out["x"] = jitter(snap["x"], rng)
    out["Z_prev"] = jitter(snap["Z_prev"], rng)
    out["peds"] = {"pos": jitter(snap["peds"]["pos"], rng), "vel": jitter(snap["peds"]["vel"], rng),
                   "radius": snap["peds"]["radius"]}
    if snap.get("prev_duals") is not None:
        ll, lu, ok = snap["prev_duals"]
        out["prev_duals"] = (jitter(ll, rng), jitter(lu, rng), ok)
    return out


class CorridorReference:
    """The frozen planner of one configuration."""

    def __init__(self, config: dict, precision: str = "f32"):
        self.cfg, self.model, self.modules = presets.build(config["system"], config["variant"])
        dtype, rounding = _precision(precision)
        self.planner = Planner(self.model, self.modules, self.cfg, device="cpu", dtype=dtype)
        self.planner.solver.rounding = rounding
        if rounding is not None:
            self.planner.param_rounding = lambda P: rounding(torch.as_tensor(P)).numpy()
        self.precision = precision
        self.gmod = self.modules.get("GuidanceConstraints")
        self.contouring = self.modules.get("Contouring")

    def cycle(self, snap: dict) -> dict:
        """The reference's cycle from a snapshot's inputs and program state."""
        p = self.planner
        dtype = p.solver.dtype
        p.reset()
        data = _data(self.cfg, snap["x"], snap["peds"])
        p.on_data_received(data, "reference_path")
        p._Z = np.asarray(snap["Z_prev"], float).copy()
        p._output.success = bool(snap["was_feasible"])
        if self.contouring is not None:
            self.contouring.closest_segment = int(snap["closest_segment"])
        if self.gmod is not None:
            g = self.gmod
            if snap["selected_signature"] is not None:
                g.guidance = make_guidance_planner(self.cfg)
                g.guidance.selected_signature = snap["selected_signature"]
            g._selected_planner = int(snap["selected_planner"])
            if snap["prev_duals"] is not None:
                ll, lu, ok = snap["prev_duals"]
                g._prev_duals = (torch.as_tensor(ll, dtype=dtype), torch.as_tensor(lu, dtype=dtype),
                                 torch.as_tensor(ok, dtype=torch.bool))
        state = State(self.model)
        state.from_array(np.asarray(snap["x"], float))
        p.solver.last_branches = None
        if self.gmod is not None:
            self.gmod._last_branches = None
        out = p.solve_mpc(state, data)
        rec = {"success": bool(out.success), "P": p._module_data.pblock.data.copy(),
               "spline_s": float(state.get("spline"))}
        if out.success:
            rec["plan"] = p._Z.copy()
        if self.gmod is not None:
            g = self.gmod
            rec["branches"] = g._last_branches
            if g._prev_duals is not None:
                rec["batch_ok"] = g._prev_duals[2].detach().cpu().numpy()
            if out.success:
                rec["batch_Z"] = g._last_batch_Z.detach().cpu().double().numpy()
                rec["batch_lam"] = torch.cat(g._prev_duals[:2], dim=-1).detach().double().numpy()
                rec["selected"] = int(g._selected_planner)
                rec["weighted_cost"] = g._last_weighted_cost
        else:
            rec["branches"] = p.solver.last_branches
        return rec


def fleet_instances(config: dict, scenes: List[tuple]):
    """The reference's (P [S, N+1, npar], xinit) of scenes given as (x, peds)
    pairs, from the frozen modules."""
    cfg, model, modules = presets.build(config["system"], config["variant"])
    ocp = OCP(model, modules, cfg)
    Ps, xs = [], []
    for x, peds in scenes:
        data = _data(cfg, x, peds)
        state = State(model)
        state.from_array(np.asarray(x, float))
        modules.reset_all()
        modules.on_data_received(data, "reference_path")
        Z0 = initialize_with_state(model, cfg.N, state)
        md = ModuleData()
        md.warmstart = Z0
        md.warmstart_xy = Z0[:, [model.index("x"), model.index("y")]]
        md.warmstart_psi = Z0[:, model.index("psi")]
        md.warmstart_spline = Z0[:, model.index("spline")]
        modules.update_all(state, data, md)
        pblock = ParameterBlock(ocp.params, cfg.N + 1)
        modules.set_parameters_all(data, md, pblock)
        pblock.data[cfg.N] = pblock.data[cfg.N - 1]
        Ps.append(pblock.data.copy())
        xs.append(np.array([state.get(n) for n in model.states]))
    return np.stack(Ps), np.stack(xs), (cfg, model, modules, ocp)


def fleet_solve(built, Z, P, xinit, warm=None, precision: str = "f32",
                probe_seed=None) -> Dict[str, np.ndarray]:
    """The frozen solve_batch of sampled robots: plans, exit codes and final
    duals (lam_l and lam_u side by side). With
    `probe_seed`, the sensitivity probe: every input moved by a few float32
    roundings first."""
    if probe_seed is not None:
        rng = np.random.default_rng(np.random.SeedSequence([int(probe_seed) % 2**63, 19]))
        Z, P, xinit = jitter(Z, rng), jitter(P, rng), jitter(xinit, rng)
        if warm is not None:
            warm = (jitter(warm[0], rng), jitter(warm[1], rng), warm[2])
    cfg, model, modules, ocp = built
    dtype, rounding = _precision(precision)
    solver = SQPSolver(ocp, device="cpu", dtype=dtype)
    solver.rounding = rounding
    f64 = dict(dtype=dtype, device=solver.device)
    w = None
    if warm is not None:
        w = tuple(torch.as_tensor(a, **f64) for a in warm[:2]) + (
            torch.as_tensor(warm[2], dtype=torch.bool, device=solver.device),)
    P = torch.as_tensor(P, **f64)
    if solver.rounding is not None:
        P = solver.rounding(P)
    res = solver.solve_batch(torch.as_tensor(Z, **f64), P,
                             torch.as_tensor(xinit, **f64), warm_duals=w)
    codes = res.exit_code.cpu().numpy()
    return {"Z": res.Z.cpu().double().numpy(), "codes": codes, "ok": codes == EXIT_SUCCESS,
            "P": P.cpu().double().numpy(),
            "lam": torch.cat([res.lam_l, res.lam_u], dim=-1).double().numpy(),
            "branches": solver.last_branches}


# The workers' tasks: each worker builds a configuration's reference once.
_BUILT: dict = {}


def corridor_task(config: dict, precision: str, snap: dict) -> dict:
    """The reference's record of one checked corridor cycle."""
    key = ("corridor", config["name"], precision)
    if key not in _BUILT:
        _BUILT[key] = CorridorReference(config, precision)
    return _BUILT[key].cycle(snap)


def fleet_task(config: dict, precision: str, Z, P, xinit, warm=None, probe_seed=None) -> dict:
    """The reference's solve of a block of sampled robots."""
    key = ("fleet", config["name"])
    if key not in _BUILT:
        cfg, model, modules = presets.build(config["system"], config["variant"])
        _BUILT[key] = (cfg, model, modules, OCP(model, modules, cfg))
    return fleet_solve(_BUILT[key], Z, P, xinit, warm=warm, precision=precision,
                       probe_seed=probe_seed)
