"""What the experiments share: the device flag, the route each solver
resolved, the perturbed batch of one OCP instance, and clocks that end in
a device sync.

Every experiment runs on the card unless it is given `--device cpu`; without
CUDA and without that flag it raises (`default_device`). On the card a
experiment asserts the route each solver resolved, so a kernel that fails to
build or launch fails the experiment instead of giving way to the plain route.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch

from mpc_planner_tpu_torch import default_device

# Routes of a batched solve, as (solver.qp_backend, solver.rti_fused): K3 for
# the whole RTI loop, K1 per RTI iteration, or plain torch.
ROUTES = {"fused": ("cuda", "on"), "unfused": ("cuda", "off"), "plain": ("torch", "off")}


def device_parser(description: str) -> argparse.ArgumentParser:
    """An experiment's command line with `--device` (default the card, cuda)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def resolve_device(name) -> torch.device:
    """The device of a `--device` value: "cuda" (or None) is the card, and an
    error without CUDA; anything else as torch reads it."""
    return default_device(None if name == "cuda" else name)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device):
    """(fn(), seconds on the host clock between two device syncs)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def card_text(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def check_route(solver, fused: bool, backend: str = "cuda") -> None:
    """On the card: raise unless `solver` resolved to the route asked for:
    the kernels (backend "cuda"), K3 for the whole loop (`fused`) or K1 per
    iteration, or the plain QP (backend "torch"). A no-op elsewhere."""
    if solver.device.type != "cuda":
        return
    if solver.qp_backend != backend:
        raise RuntimeError(f"the solver's QP backend is {solver.qp_backend!r} on the card, "
                           f"not {backend!r}")
    if solver.rti_fused != fused:
        raise RuntimeError(f"the solver's fused route is {solver.rti_fused}, expected {fused}: "
                           f"{solver.rti_fused_reason}")


def with_solver(cfg, **fields):
    return cfg.replace(solver=dataclasses.replace(cfg.solver, **fields))


def route_solver(model, modules, cfg, route: str, device):
    """An SQPSolver of the OCP (model, modules) on one of ROUTES. On the
    card the route is asserted. On the CPU the kernels' wrappers take their
    plain versions (solve_rti_cuda takes ops/rti.py::solve_rti_torch for CPU
    tensors), so "fused" runs K3's plain version and the two others the
    plain QP."""
    from mpc_planner_tpu_torch.solver.ocp import OCP
    from mpc_planner_tpu_torch.solver.sqp import SQPSolver

    backend, fused = ROUTES[route]
    device = torch.device(device)
    c = with_solver(cfg, qp_backend=backend if device.type == "cuda" else "torch", rti_fused=fused)
    solver = SQPSolver(OCP(model, modules, c), device=device)
    if device.type == "cuda":
        check_route(solver, fused == "on", backend)
    elif fused == "on":
        solver.rti_fused = True
    return solver


def build_solver(cfg, model, modules, state, data, device):
    """One host pass of the modules around the state-held warm start and the
    parameter block with its terminal row, then the solver on `device`: the
    reference's experiments/ladder_bench.py::build_solver. Returns (solver,
    Z0 [N+1, nvar], P [N+1, npar], xinit [nx]), the arrays as numpy."""
    from mpc_planner_tpu_torch.parameters import ParameterBlock
    from mpc_planner_tpu_torch.solver.ocp import OCP
    from mpc_planner_tpu_torch.solver.sqp import SQPSolver
    from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
    from mpc_planner_tpu_torch.types import ModuleData

    ocp = OCP(model, modules, cfg)
    solver = SQPSolver(ocp, device=device)
    md = ModuleData()
    if data.reference_path is not None:
        modules.on_data_received(data, "reference_path")
    modules.on_data_received(data, "dynamic obstacles")
    Z0 = initialize_with_state(model, cfg.N, state)
    md.warmstart = Z0
    md.warmstart_xy = Z0[:, [model.index("x"), model.index("y")]]
    md.warmstart_psi = Z0[:, model.index("psi")]
    if "spline" in model.states:
        md.warmstart_spline = Z0[:, model.index("spline")]
    modules.update_all(state, data, md)
    pblock = ParameterBlock(ocp.params, cfg.N + 1)
    modules.set_parameters_all(data, md, pblock)
    pblock.data[cfg.N] = pblock.data[cfg.N - 1]
    xinit = np.array([state.get(n) for n in model.states])
    return solver, Z0, pblock.data, xinit


def perturbed_batch(rng, Z0, P, xinit, B: int, nu: int, device):
    """B copies of one OCP instance on `device`, the states of stages 1..N
    of each warm start moved by N(0, 0.05) from `rng` (the reference's
    experiments draw the same numbers in the same order)."""
    Zb = np.tile(Z0[None], (B, 1, 1)).astype(np.float32)
    Zb[:, 1:, nu:] += rng.normal(0, 0.05, Zb[:, 1:, nu:].shape).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(Zb, **f32), torch.as_tensor(np.tile(P[None], (B, 1, 1)), **f32),
            torch.as_tensor(np.tile(xinit[None], (B, 1)), **f32))


def warm_chain(solver, warm0, Pb, xb, rti: int, cycles: int):
    """`cycles` chained control cycles of `solver.batch_impl`, each from the
    last one's Z and converged duals; warm0 = (Z, lam_l, lam_u, ok). Returns
    the last cycle's carry and its SolveResult."""
    carry, res = warm0, None
    for _ in range(cycles):
        res = solver.batch_impl(carry[0], Pb, xb, rti, warm0=carry[1:])
        carry = warm_carry(res)
    return carry, res


def timed_chains(solver, warm0, Pb, xb, rti: int, cycles: int, reps: int, device):
    """The reference's steady-state measurement (bench.py, ladder_bench.py):
    one untimed chain of `cycles` warm cycles from warm0 (the reference's
    compiling call), then `reps` timed chains from the same warm0. Returns
    (seconds per cycle of each timed chain as an array, the last chain's
    warm_chain result)."""
    out = warm_chain(solver, warm0, Pb, xb, rti, cycles)
    times = []
    for _ in range(reps):
        out, seconds = timed(lambda: warm_chain(solver, warm0, Pb, xb, rti, cycles), device)
        times.append(seconds / cycles)
    return np.asarray(times), out


def warm_carry(res):
    """(Z, lam_l, lam_u, ok) of a SolveResult: the next cycle's start."""
    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS

    return res.Z, res.lam_l, res.lam_u, res.exit_code == EXIT_SUCCESS
