"""The fleet generator: `robots` robots re-planned every control tick,
straight into `SQPSolver.solve_batch`, the host guidance bypassed.

Traffic parameters (the mix's JSON): `snapshots` distinct corridor scenes
of `pedestrians` pedestrians, each with `starts_per_snapshot` warm starts
whose states at stages 1..N are moved by N(0, `perturbation`) (the port's
experiments/common.py::perturbed_batch, copied); `warmup_cycles` chained
cycles in set-up, so the window starts from converged plans; `compare`
(`robots` robots drawn from the seed, and `candidates` window cycles drawn
from the seed below `max_cycle`: the reference checks the first of them, in
the order of the draw, that the window reached, in blocks of `block`
robots).

A cycle warm-starts from the last one's plans and duals (the reference
bench.py's method) and ends by pulling every plan and exit code to the
host, as a fleet server must before it sends commands; its time is the
host clock from dispatch to the plans on the host.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from mpcbench import scene


def snapshot_scene(seed: int, i: int, n_peds: int):
    """Scene i of a run: the robot's state (x, y, psi, v, spline) at the
    corridor's entrance, short of the pedestrians' crossing zone (x >= 4 m),
    moving or not, and its pedestrians, all drawn from (seed, i)."""
    rng = np.random.default_rng(scene.episode_seed(seed, 10_000 + i))
    x = np.array([rng.uniform(0.0, 2.5), rng.uniform(-0.5, 0.5), rng.uniform(-0.2, 0.2),
                  rng.uniform(0.0, 1.5), 0.0])
    peds = scene.make_peds(n_peds, scene.episode_seed(seed, 20_000 + i))
    return x, peds


def draw_samples(seed: int, robots: int, compare: dict):
    """(robot indices, candidate window cycles in the order of the draw) the
    reference checks, drawn from the seed; the set-up's cold solve of those
    robots (the start) is checked besides."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**63, 11]))
    idx = np.sort(rng.choice(robots, size=int(compare["robots"]), replace=False))
    cycles = [int(c) for c in rng.choice(np.arange(int(compare["max_cycle"])),
                                         size=int(compare["candidates"]), replace=False)]
    return idx, cycles


def scene_parameters(cfg, model, modules, ocp, x, peds, make_data):
    """One host pass of the modules around the state-held warm start: (Z0
    [N+1, nvar], P [N+1, npar], xinit [nx]) of one scene (the port's
    experiments/common.py::build_solver, with its own types)."""
    md_cls, pb_cls, init_state = make_data["ModuleData"], make_data["ParameterBlock"], \
        make_data["initialize_with_state"]
    state, data = make_data["state_and_data"](x, peds)
    modules.reset_all()
    modules.on_data_received(data, "reference_path")
    Z0 = init_state(model, cfg.N, state)
    md = md_cls()
    md.warmstart = Z0
    md.warmstart_xy = Z0[:, [model.index("x"), model.index("y")]]
    md.warmstart_psi = Z0[:, model.index("psi")]
    md.warmstart_spline = Z0[:, model.index("spline")]
    modules.update_all(state, data, md)
    pblock = pb_cls(ocp.params, cfg.N + 1)
    modules.set_parameters_all(data, md, pblock)
    pblock.data[cfg.N] = pblock.data[cfg.N - 1]
    xinit = np.array([state.get(n) for n in model.states])
    return Z0, pblock.data, xinit


class ProgramFleet:
    """The port's SQPSolver on the card (or `device`) with the fleet's
    batch."""

    def __init__(self, config: dict, device=None):
        from mpc_planner_tpu_torch import presets
        from mpc_planner_tpu_torch.solver.ocp import OCP
        from mpc_planner_tpu_torch.solver.sqp import SQPSolver

        from mpcbench.drivers.closed_loop import check_shapes

        self.cfg, self.model, self.modules = presets.select_system(config["system"],
                                                                   config["variant"])
        self.ocp = OCP(self.model, self.modules, self.cfg)
        self.solver = SQPSolver(self.ocp, device=device)
        check_shapes(config, self.ocp, self.modules.get("GuidanceConstraints"))
        self.device = self.solver.device

    def types(self):
        from mpc_planner_tpu_torch.data_preparation import define_robot_area
        from mpc_planner_tpu_torch.parameters import ParameterBlock
        from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
        from mpc_planner_tpu_torch.types import ModuleData

        from mpcbench.drivers.closed_loop import program_data, program_state

        c = self.cfg
        area = define_robot_area(c.robot.length, c.robot.width, c.n_discs)

        def state_and_data(x, peds):
            return (program_state(self.model, x),
                    program_data(c, self.model, area, x, peds, _path()))

        return {"ModuleData": ModuleData, "ParameterBlock": ParameterBlock,
                "initialize_with_state": initialize_with_state, "state_and_data": state_and_data}


def _path():
    return {"x": scene.PATH_X.copy(), "y": np.zeros_like(scene.PATH_X)}


def perturbed_batch(rng, Z0, P, xinit, copies: int, nu: int, sigma: float):
    """`copies` copies of one OCP instance, the states of stages 1..N of each
    warm start moved by N(0, sigma) from `rng`, as float32 numpy."""
    Zb = np.tile(Z0[None], (copies, 1, 1)).astype(np.float32)
    Zb[:, 1:, nu:] += rng.normal(0, sigma, Zb[:, 1:, nu:].shape).astype(np.float32)
    return Zb, np.tile(P[None], (copies, 1, 1)).astype(np.float32), \
        np.tile(xinit[None], (copies, 1)).astype(np.float32)


def build_batch(program: ProgramFleet, traffic: dict, seed: int):
    """The fleet's inputs from the seed: (Z0, P, xinit) numpy [robots, ...]
    and each robot's scene index."""
    n, c = int(traffic["snapshots"]), int(traffic["starts_per_snapshot"])
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**63, 13]))
    types = program.types()
    Zs, Ps, xs = [], [], []
    for i in range(n):
        x, peds = snapshot_scene(seed, i, traffic["pedestrians"])
        Z0, P, xinit = scene_parameters(program.cfg, program.model, program.modules, program.ocp,
                                        x, peds, types)
        Zb, Pb, xb = perturbed_batch(rng, Z0, P, xinit, c, program.model.nu,
                                     traffic["perturbation"])
        Zs.append(Zb), Ps.append(Pb), xs.append(xb)
    return np.concatenate(Zs), np.concatenate(Ps), np.concatenate(xs), np.repeat(np.arange(n), c)


def run(program: ProgramFleet, traffic: dict, seed: int, seconds: float, launches=None,
        on_window=None, after_window=None, checked_cycles: int = 2) -> dict:
    import contextlib

    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS

    solver = program.solver
    dev = program.device
    Z0, P, xinit, scene_of = build_batch(program, traffic, seed)
    robots = Z0.shape[0]
    idx, candidates = draw_samples(seed, robots, traffic["compare"])
    f32 = dict(dtype=torch.float32, device=dev)
    Zd, Pd, xd = (torch.as_tensor(a, **f32) for a in (Z0, P, xinit))
    launches = launches or (lambda: 0)

    def cycle(Z, warm):
        res = solver.solve_batch(Z, Pd, xd, warm_duals=warm)
        Zh = res.Z.cpu().numpy()
        codes = res.exit_code.cpu().numpy()
        return res, Zh, codes

    # Set-up: the cold solve (the start that the reference checks), then
    # warm cycles to converged plans.
    sel = torch.as_tensor(idx, device=dev)

    def duals_of(res):
        return torch.cat([res.lam_l[sel], res.lam_u[sel]], dim=-1).cpu().numpy()

    res, Zh, codes = cycle(Zd, None)
    start = {"Z0": Z0[idx], "xinit": xinit[idx], "P": P[idx], "scene": scene_of[idx],
             "Z": Zh[idx], "codes": codes[idx], "lam": duals_of(res)}
    carry = (res.Z, (res.lam_l, res.lam_u, res.exit_code == EXIT_SUCCESS))
    for _ in range(int(traffic["warmup_cycles"])):
        res, Zh, codes = cycle(*carry)
        carry = (res.Z, (res.lam_l, res.lam_u, res.exit_code == EXIT_SUCCESS))

    record: List[tuple] = []
    checks = {}
    ctx = on_window() if on_window is not None else contextlib.nullcontext()
    with ctx:
        t_start = time.perf_counter()
        deadline = t_start + seconds
        k = 0
        while True:
            snap = None
            if k in candidates:
                Zc, (wl, wu, ok) = carry
                snap = {"cycle": k, "Z_in": Zc[sel].cpu().numpy(), "lam_l": wl[sel].cpu().numpy(),
                        "lam_u": wu[sel].cpu().numpy(), "ok": ok[sel].cpu().numpy()}
            n0 = launches()
            raised = None
            t0 = time.perf_counter()
            try:
                res, Zh, codes = cycle(*carry)
            except Exception as exc:  # a failed cycle: every robot's solve failed
                raised = f"{type(exc).__name__}: {exc}"
            t1 = time.perf_counter()
            if raised is None:
                finite = np.isfinite(Zh).all(axis=(1, 2))
                record.append((t1 - t0, launches() - n0, int((codes != EXIT_SUCCESS).sum()),
                               int((~finite).sum()), None, t0))
                if snap is not None:
                    snap.update({"Z": Zh[idx], "codes": codes[idx], "lam": duals_of(res)})
                    checks[k] = snap
                carry = (res.Z, (res.lam_l, res.lam_u, res.exit_code == EXIT_SUCCESS))
            else:
                record.append((t1 - t0, launches() - n0, robots, 0, raised, t0))
            k += 1
            if time.perf_counter() >= deadline:
                break
        t_end = time.perf_counter()
    if after_window is not None:
        after_window()
    checked = sorted([k for k in candidates if k in checks][:int(checked_cycles)])
    return {"cycles": record, "window_s": t_end - t_start, "robots": robots,
            "sampled_robots": idx, "start": start, "checks": [checks[k] for k in checked],
            "scene_of": scene_of, "t_start": t_start, "t_end": t_end}


Program = ProgramFleet


def _raw(peds) -> dict:
    return {"pos": np.array([p.position for p in peds]), "vel": np.array([p.velocity for p in peds]),
            "radius": np.array([p.radius for p in peds])}


def reference_numbers(out: dict, config: dict, traffic: dict, seed: int, against=(),
                      readings=None, workers=None):
    """The checked robot solves against the frozen reference (at the
    configuration's `reference_precision`), which builds the parameter
    blocks from the robots' scenes: the set-up's cold solve of the sampled
    robots (from the benchmark's starts) and their checked window cycles
    (from the program's carried plans and duals), each block of robots with
    the reference's probe: a judge.Checked. With `against`, also the
    reference at each of those precisions (the control: "tf32") put in the
    program's place: {"program": Checked, precision: Checked}. A `readings`
    list receives each block's readings, with the plans' gaps alone beside."""
    from mpcbench import judge
    from mpcbench.reference import pool
    from mpcbench.reference.check import fleet_instances, fleet_task

    main = config["reference_precision"]
    start = out["start"]
    scenes = [snapshot_scene(seed, int(s), traffic["pedestrians"]) for s in start["scene"]]
    P_ref, x_ref, _ = fleet_instances(config, [(x, _raw(p)) for x, p in scenes])
    solves = [(start["Z0"], None, start)] + [
        (c["Z_in"], (c["lam_l"], c["lam_u"], c["ok"]), c) for c in out["checks"]]
    size = int(traffic["compare"]["block"])
    blocks = [(k, slice(b, b + size)) for k in range(len(solves))
              for b in range(0, len(P_ref), size)]
    tasks = []
    for k, sl in blocks:
        Z_in, warm, _ = solves[k]
        w = None if warm is None else tuple(a[sl] for a in warm)
        args = (Z_in[sl], P_ref[sl], x_ref[sl], w)
        tasks += [(fleet_task, (config, main, *args)),
                  (fleet_task, (config, main, *args, seed * 31 + 7 * k + sl.start))]
        tasks += [(fleet_task, (config, p, *args)) for p in against]
    recs = pool.run(tasks, workers)
    width = 2 + len(against)
    result = {who: judge.Checked() for who in ("program", *against)}
    for n, (k, sl) in enumerate(blocks):
        ref, probe, *others = recs[n * width:(n + 1) * width]
        prog = solves[k][2]
        sens = judge.fleet_sensitivities(ref, probe)
        row = {"solve": k, "robots": [sl.start, sl.stop], "sens": sens,
               "plan_sens": judge.fleet_sensitivities(ref, probe, duals=False)}
        answers = [("program", prog["Z"][sl], prog["codes"][sl], prog["lam"][sl],
                    prog["P"][sl] if k == 0 else None)]
        answers += [(p, o["Z"], o["codes"], o["lam"], o["P"] if k == 0 else None)
                    for p, o in zip(against, others)]
        for who, Z, codes, lam, P in answers:
            if P is not None:
                result[who].params.extend(judge.param_gap(P[b], P_ref[sl][b])
                                          for b in range(len(P)))
            gaps = judge.fleet_solves(Z, codes, ref, lam)
            result[who].add_cycle(gaps, sens)
            row.update({f"{who}_gaps": gaps, f"{who}_plan_gaps": judge.fleet_solves(Z, codes, ref)})
        if readings is not None:
            readings.append(row)
    return result if against else result["program"]


def failed_operations(out: dict) -> int:
    """Robot solves of cycles that raised, or with a non-finite plan."""
    return sum(c[3] + (out["robots"] if c[4] is not None else 0) for c in out["cycles"])


def attempted(out: dict) -> int:
    return out["robots"] * len(out["cycles"])


def end_to_end(out: dict) -> dict:
    from mpcbench import stats

    times = [c[0] for c in out["cycles"]]
    done = sum(out["robots"] for c in out["cycles"] if c[4] is None)
    return {"solves_per_s": stats.rate(done, out["window_s"]), "fleet_cycle_ms_p95": stats.p95_ms(times)}


def outcomes(out: dict) -> dict:
    cycles = out["cycles"]
    return {"non_success_exits": sum(c[2] for c in cycles if c[4] is None),
            "escalated_cycles": sum(int(c[1] > 1) for c in cycles),
            "cycles": len(cycles), "robots": out["robots"],
            "checked_solves": len(out["start"]["Z"]) * (1 + len(out["checks"]))}
