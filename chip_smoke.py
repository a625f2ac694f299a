#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mpc_planner_tpu_torch) on one
NVIDIA GPU: builds the hand-written Hopper kernels from the checkout,
holds each against its plain torch version, drives the planner's main
path, and prints one JSON result line.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is printed as a
result then):
  1. refuse to run without CUDA; print the card (nvidia-smi) and torch;
  2. build the kernels (torch.utils.cpp_extension.load, sm_90a), the three
     libraries in parallel: K1 + K2, K3 for system_jackal("goal") (from
     the stage code generated for that OCP), K4;
  3. K2 MIRROR kernel vs plain on seeded symmetric [B*(N+1), n, n]
     stacks, n = 5 and 7 (max |d| / max |H| < 1e-5);
  4. K1 QP kernel vs plain on QPs of system_jackal("goal") at B=1024,
     N=30, nh=12, linearized around perturbed corridor warm starts: cold
     + Mehrotra, then warm duals + fixed sigma (relative error on dz and
     lam_l < 5e-3);
  5. Planner.solve_mpc closed loop, 20 cycles on corridor_scene(12
     pedestrians), state advanced by the port's dynamics and the
     pedestrians by their constant velocities; every cycle
     must succeed and the robot must approach the goal; cycle 1 matches
     the same cycle on qp_backend="torch" within 5e-3. The kernels'
     launch counts are taken over this run;
  6. SQPSolver.solve_batch at B=1024, 10 RTI iterations: one cold solve,
     then 8 chained warm cycles, for "cuda" and for "torch";
  7. K3's linearization alone (linearize_cuda) vs the unfused
     SQPSolver._linearize on phase 4's iterates (terminal u-block masked,
     bounds on active rows): max |d| / max |ref| < 1e-4 for each of H, g,
     A, B, c, Dh, lb, ub;
  8. K3 vs its plain version (solve_rti_torch) at B=1024, N=30, 10 RTI
     iterations, from phase 4's perturbed converged plans (a control
     loop's warm start), cold duals and then warm duals: relative error on
     Z < 5e-3, exit codes differing in <= 1% of the batch. (From phase 4's
     raw noisy starts a few elements end at another local solution on
     every pair of routes, K1 against plain included: PERF.md.)
  9. Planner.solve_mpc closed loop with solver.rti_fused="on", as phase 5:
     every cycle succeeds, the robot approaches the goal, cycle 1 matches
     phase 5's torch backend within 5e-3; over this run K3 launches and K1
     does not. K3's launch count is taken here;
 10. SQPSolver.solve_batch through the fused route at B=1024: one cold
     solve and 8 chained warm cycles;
 11. K4, the Riccati probe: each thread mapping vs its plain version
     (< 1e-3) and timed at 1024 and 131,072 elements.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N = 30
BATCH = 1024
RTI_ITERATIONS = 10
WARM_CYCLES = 8
PLANNER_CYCLES = 20
SEED = 0


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


def walk_pedestrians(state, data, cfg):
    """Advance the corridor scene by one control period: each pedestrian
    takes one step along its constant-velocity prediction and is
    predicted again from there, as a tracker would report it next cycle.
    Without this the predictions stay anchored at t=0 while the robot
    drives on into them."""
    from mpc_planner_tpu_torch.data_preparation import (
        get_constant_velocity_prediction,
        pack_obstacles,
    )

    for o in data.dynamic_obstacles:
        if o.index < 0 or o.prediction is None:
            continue  # padding dummies stay where they are
        path = o.prediction.positions[0]
        velocity = (path[1] - path[0]) / cfg.dt
        o.position = path[1].copy()
        o.prediction = get_constant_velocity_prediction(
            o.position, velocity, cfg.dt, cfg.N, cfg.probabilistic.enable)
    data.obstacle_block = pack_obstacles(data.dynamic_obstacles, cfg.N)
    data.ego_position = state.get_position()


def cuda_ms(torch, fn, reps):
    """Mean device time of fn() over `reps` back-to-back calls (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fused_phases(dev, card, stage_code, Z0, P, x0, Zp, plain_solver, make_planner, closed_loop,
                 Z_torch_first):
    """Phases 7-10: the fused route (K3). Returns K3's record for the
    kernels line and its launch count over phase 9's planner loop."""
    import torch

    from mpc_planner_tpu_torch.ops import cuda_qp
    from mpc_planner_tpu_torch.ops.cuda_rti import linearize_cuda, solve_rti_cuda
    from mpc_planner_tpu_torch.ops.rti import solve_rti_torch
    from mpc_planner_tpu_torch.solver.ocp import OCP
    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS, SQPSolver

    ocp = stage_code.ocp
    nu, nvar = ocp.nu, ocp.nvar
    cfg = ocp.cfg.replace(solver=ocp.cfg.solver.__class__(rti_fused="on"))
    solver = SQPSolver(OCP(ocp.model, ocp.modules, cfg), device=dev)
    check(solver.rti_fused, "rti_fused='on' did not take the fused route on the GPU")
    templates = dict(lb_template=solver._lb_template, ub_template=solver._ub_template)

    # -- 7. K3's linearization vs the unfused one ---------------------------------
    ref = plain_solver._linearize(Zp, P)
    out = linearize_cuda(Zp, P, stage_code, lm=solver.lm, mirror_x_only=solver._mirror_x_only,
                         **templates)
    torch.cuda.synchronize()
    keep = torch.ones_like(ref.H)
    keep[:, N, :nu, :] = 0  # the terminal u-block: lm*I unfused, 0 in K3; the QP never reads it
    keep[:, N, :, :nu] = 0
    pairs = dict(H=(out.H * keep, ref.H * keep), g=(out.g, ref.g), A=(out.A, ref.A),
                 B=(out.B, ref.B), c=(out.c, ref.c), Dh=(out.D[:, :, nvar:], ref.D[:, :, nvar:]),
                 lb=(out.lb * ref.mask_l, ref.lb * ref.mask_l),
                 ub=(out.ub * ref.mask_u, ref.ub * ref.mask_u))
    errs = {k: rel_err(a, b) for k, (a, b) in pairs.items()}
    print("phase 7: linearize_cuda vs SQPSolver._linearize, B=%d: max|d|/max|ref| " % BATCH
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    check(max(errs.values()) < 1e-4, f"K3 linearization disagrees with the unfused one: {errs}")
    sys.stdout.flush()

    # -- 8. K3 vs plain, cold then warm ------------------------------------------
    Zc = Zp.clone()
    Zc[:, 0, nu:] = x0
    wi = solver.warm_qp_iters
    kw = dict(num_iterations=RTI_ITERATIONS, warm_iters=wi, mu0=solver.mu0,
              sigma_fixed=solver.warm_sigma, lm=solver.lm, mirror_x_only=solver._mirror_x_only,
              **templates)
    cold = dict(kw, it0=solver.qp_iterations)
    max_abs = 0.0

    def compare(label, start, args):
        nonlocal max_abs
        ref_res = solve_rti_torch(start, P, ocp, **args)
        res = solve_rti_cuda(start, P, stage_code, **args)
        torch.cuda.synchronize()
        e_z = rel_err(res.Z, ref_res.Z)
        codes, codes_ref = solver._exit_codes(res.Z, P)[0], solver._exit_codes(ref_res.Z, P)[0]
        n_diff = int((codes != codes_ref).sum())
        max_abs = max(max_abs, float((res.Z - ref_res.Z).abs().max()))
        per = (res.Z - ref_res.Z).abs().amax(dim=(1, 2)) / ref_res.Z.abs().max()
        print(f"phase 8: K3 vs solve_rti_torch, {label}, B={BATCH}, {RTI_ITERATIONS} RTI: rel err Z "
              f"{e_z:.3e} (median element {float(per.median()):.2e}, {int((per > 5e-3).sum())} "
              f"elements > 5e-3), lam_l {rel_err(res.lam_l, ref_res.lam_l):.3e}; exit codes differ in "
              f"{n_diff}/{BATCH} ({int((codes == EXIT_SUCCESS).sum())} vs "
              f"{int((codes_ref == EXIT_SUCCESS).sum())} successes)")
        check(e_z < 5e-3, f"K3 disagrees with plain ({label}): {e_z}")
        check(n_diff <= BATCH // 100, f"K3 exit codes differ from plain in {n_diff} elements ({label})")
        return ref_res

    first = compare("cold", Zc, cold)
    # the next cycle: from the plain cold solve, with its duals
    compare("warm", first.Z, dict(kw, it0=wi, warm_duals=(first.lam_l, first.lam_u, first.mu < 1e-2)))
    ms = cuda_ms(torch, lambda: solve_rti_cuda(Zc, P, stage_code, **cold), 3)
    plain_ms = cuda_ms(torch, lambda: solve_rti_torch(Zc, P, ocp, **cold), 1)
    ms_b1 = cuda_ms(torch, lambda: solve_rti_cuda(Zc[:1], P[:1], stage_code, **cold), 5)
    print(f"phase 8: K3 cold solve, {RTI_ITERATIONS} RTI: B={BATCH} kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; B=1 kernel {ms_b1:.3f} ms [{card}]")
    sys.stdout.flush()

    # -- 9. planner closed loop on the fused route ----------------------------------
    planner, (state, data) = make_planner("auto", rti_fused="on")
    check(planner.solver.rti_fused, "the planner's solver did not take the fused route")
    cuda_qp.reset_launch_counts()
    Z_first, times, d0, d1 = closed_loop(planner, state, data)
    launches = dict(cuda_qp.launch_counts)
    diff = float(np.abs(Z_torch_first - Z_first).max())
    print(f"phase 9: {PLANNER_CYCLES}/{PLANNER_CYCLES} fused planner cycles succeeded; distance to "
          f"goal {d0:.3f} -> {d1:.3f} m; cycle time median {np.median(times[1:]) * 1e3:.2f} ms, "
          f"max {np.max(times[1:]) * 1e3:.2f} ms [{card}] (first {times[0] * 1e3:.1f} ms); cycle 1 Z "
          f"vs phase 5's torch backend: max |d| = {diff:.3e}; kernel launches {launches}")
    check(d1 < d0 - 0.5, "fused route: robot did not approach the goal")
    check(diff < 5e-3, "fused route: cycle 1 differs from the torch backend")
    check(launches["rti"] > 0 and launches["qp"] == 0 and launches["mirror"] == 0,
          f"fused route: expected K3 launches and no K1/K2 launches, got {launches}")
    sys.stdout.flush()

    # -- 10. batch on the fused route ------------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve_batch(Z0, P, x0, num_iterations=RTI_ITERATIONS)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    cold_ok = int((res.exit_code == EXIT_SUCCESS).sum())
    cycle_s = []
    for _ in range(WARM_CYCLES):
        t0 = time.perf_counter()
        res = solver.solve_batch(res.Z, P, x0, num_iterations=RTI_ITERATIONS,
                                 warm_duals=(res.lam_l, res.lam_u, res.exit_code == EXIT_SUCCESS))
        torch.cuda.synchronize()
        cycle_s.append(time.perf_counter() - t0)
    feasible = int((res.exit_code == EXIT_SUCCESS).sum())
    check(bool(torch.isfinite(res.Z).all()), "fused route: non-finite batch solution")
    print(f"phase 10: fused: B={BATCH} cold solve {cold_s * 1e3:.1f} ms ({cold_ok}/{BATCH} feasible); "
          f"{WARM_CYCLES} warm cycles mean {np.mean(cycle_s) * 1e3:.1f} ms, last cycle "
          f"{feasible}/{BATCH} feasible [{card}]")
    check(feasible > 0, "fused route: no feasible batch element")
    sys.stdout.flush()
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms), launches["rti"]


def probe_phase(card, dev):
    """Phase 11: K4, every mapping held against plain and timed. Returns
    the record of the "single" mapping at 1024 elements (K1's mapping at
    K1's batch) and the launch count of the probe's run."""
    from mpc_planner_tpu_torch.experiments import riccati_probe
    from mpc_planner_tpu_torch.ops import cuda_qp

    cuda_qp.reset_launch_counts()
    rows = riccati_probe.run(dev)
    launches = cuda_qp.launch_counts["riccati_probe"]
    for r in rows:
        print(f"phase 11: riccati probe E={r['elements']} {r['mapping']}: max|d| "
              f"{r['max_abs_err']:.2e}, {r['ms'] * 1e3:.1f} us/launch, {r['ns_per_step']:.1f} "
              f"ns/stage-step/chain ({r['ns_per_step_element']:.4f} ns per element); plain "
              f"{r['plain_ms']:.2f} ms [{card}]")
    check(launches > 0, "the probe launched no kernel")
    first = next(r for r in rows if r["mapping"] == "single" and r["elements"] == 1024)
    sys.stdout.flush()
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows), ms=first["ms"],
                plain_ms=first["plain_ms"]), launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a GPU",
              file=sys.stderr)
        return 2

    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.experiments import riccati_probe
    from mpc_planner_tpu_torch.ops import cuda_qp, cuda_rti
    from mpc_planner_tpu_torch.ops.stage_codegen import StageCode
    from mpc_planner_tpu_torch.ops.jacobi_eigh import mirror_unpacked
    from mpc_planner_tpu_torch.parameters import ParameterBlock
    from mpc_planner_tpu_torch.planner import Planner
    from mpc_planner_tpu_torch.solver.ocp import OCP
    from mpc_planner_tpu_torch.solver.qp import solve_qp
    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS, SQPSolver
    from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
    from mpc_planner_tpu_torch.types import ModuleData

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device -----------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: device {kind!r}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(card)
    sys.stdout.flush()

    # -- 2. build (the three libraries in parallel) -----------------------------
    t0 = time.perf_counter()
    cfg, model, modules = presets.system_jackal("goal", N=N)
    stage_code = StageCode(OCP(model, modules, cfg))
    stage_code.generate()
    codegen_s = time.perf_counter() - t0

    def timed(fn, *args):
        t = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t

    with ThreadPoolExecutor(3) as pool:
        builds = {name: pool.submit(timed, fn, *args) for name, fn, args in (
            ("qp+mirror", cuda_qp.load_kernels, ()), ("rti", cuda_rti.load_rti, (stage_code,)),
            ("riccati_probe", riccati_probe.load_probe, ()))}
        build_s = {name: f.result() for name, f in builds.items()}
    print(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s (stage code "
          f"generated in {codegen_s:.1f} s; builds in parallel: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in build_s.items()) + ")")
    sys.stdout.flush()

    gen = torch.Generator(device=dev).manual_seed(SEED)
    record = {}

    # -- 3. K2 MIRROR vs plain -------------------------------------------------
    lm = 1e-6
    for n in (5, 7):
        H = torch.randn(BATCH * (N + 1), n, n, device=dev, generator=gen)
        H = 0.5 * (H + H.mT)
        out_k = cuda_qp.mirror_cuda(H, lm)
        out_p = mirror_unpacked(H, lm)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max() / H.abs().max())
        print(f"phase 3: mirror n={n} [{H.shape[0]}, {n}, {n}] max|d|/max|H| = {err:.3e}")
        check(err < 1e-5, f"MIRROR kernel disagrees with plain (n={n}): {err}")
        if n == 5:  # the main path's x-only MIRROR shape
            ms = cuda_ms(torch, lambda: cuda_qp.mirror_cuda(H, lm), 20)
            plain_ms = cuda_ms(torch, lambda: mirror_unpacked(H, lm), 3)
            record["mirror"] = dict(max_abs_err=float((out_k - out_p).abs().max()), ms=ms,
                                    plain_ms=plain_ms)
            print(f"phase 3: mirror [{H.shape[0]}, 5, 5]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    sys.stdout.flush()

    # -- 4. K1 QP vs plain -----------------------------------------------------
    cfg = cfg.replace(solver=cfg.solver.__class__(qp_backend="torch"))
    ocp = OCP(model, modules, cfg)
    plain_solver = SQPSolver(ocp, device=dev)
    state, data = presets.corridor_scene(cfg, n_pedestrians=12, seed=SEED)
    pblock = ParameterBlock(ocp.params, N + 1)
    modules.set_parameters_all(data, ModuleData(), pblock)
    pblock.data[N] = pblock.data[N - 1]
    nu, nx = model.nu, model.nx
    P = torch.as_tensor(pblock.data, dtype=torch.float32, device=dev).expand(BATCH, -1, -1)
    x0 = torch.as_tensor(state.as_array(), dtype=torch.float32, device=dev).expand(BATCH, -1)
    Z0 = torch.as_tensor(initialize_with_state(model, N, state), dtype=torch.float32,
                         device=dev).expand(BATCH, -1, -1).clone()
    Z0[:, 1:, nu:] += 0.05 * torch.randn(Z0[:, 1:, nu:].shape, device=dev, generator=gen)
    # Warm starts: a converged plan (plain path) perturbed, as a control
    # loop's previous-cycle solution would be.
    Zs = plain_solver.batch_impl(Z0, P, x0, RTI_ITERATIONS).Z
    Zp = Zs + 0.01 * torch.randn(Zs.shape, device=dev, generator=gen)
    qp = plain_solver._linearize(Zp, P)
    qp_iters = cfg.solver.qp_iterations
    ref = solve_qp(qp, nu, nx, iterations=qp_iters, mehrotra=True)
    out = cuda_qp.solve_qp_cuda(qp, nu, nx, iterations=qp_iters, mehrotra=True)
    torch.cuda.synchronize()
    e_dz, e_ll = rel_err(out.dz, ref.dz), rel_err(out.lam_l, ref.lam_l)
    print(f"phase 4: QP cold+Mehrotra B={BATCH} nh={ocp.nh}: rel err dz {e_dz:.3e}, lam_l {e_ll:.3e}")
    check(e_dz < 5e-3 and e_ll < 5e-3, "QP kernel disagrees with plain (cold)")
    qp_abs = float((out.dz - ref.dz).abs().max())
    ok = ref.mu < 1e-2
    qp1 = plain_solver._linearize(Zp + ref.dz, P)
    warm = (ref.lam_l, ref.lam_u, ok)
    wi = plain_solver.warm_qp_iters
    ref2 = solve_qp(qp1, nu, nx, iterations=wi, warm_duals=warm, mehrotra=False)
    out2 = cuda_qp.solve_qp_cuda(qp1, nu, nx, iterations=wi, warm_duals=warm, mehrotra=False)
    torch.cuda.synchronize()
    e_dz2, e_ll2 = rel_err(out2.dz, ref2.dz), rel_err(out2.lam_l, ref2.lam_l)
    print(f"phase 4: QP warm duals ({int(ok.sum())}/{BATCH} ok)+fixed sigma: "
          f"rel err dz {e_dz2:.3e}, lam_l {e_ll2:.3e}")
    check(e_dz2 < 5e-3 and e_ll2 < 5e-3, "QP kernel disagrees with plain (warm)")
    ms = cuda_ms(torch, lambda: cuda_qp.solve_qp_cuda(qp, nu, nx, iterations=qp_iters), 5)
    plain_ms = cuda_ms(torch, lambda: solve_qp(qp, nu, nx, iterations=qp_iters), 2)
    record["qp"] = dict(max_abs_err=max(qp_abs, float((out2.dz - ref2.dz).abs().max())),
                        ms=ms, plain_ms=plain_ms)
    print(f"phase 4: QP cold solve B={BATCH}, {qp_iters} IP iterations: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    sys.stdout.flush()

    # -- 5. planner closed loop (the main path) ----------------------------------
    def make_planner(backend, rti_fused="auto"):
        c, m, mods = presets.system_jackal("goal", N=N)
        c = c.replace(solver=c.solver.__class__(qp_backend=backend, rti_fused=rti_fused))
        return Planner(m, mods, c, device=dev), presets.corridor_scene(c, n_pedestrians=12, seed=SEED)

    def closed_loop(planner, state, data):
        """PLANNER_CYCLES cycles of the main path: Z of cycle 1, the cycle
        times, the start and end positions; every cycle must succeed."""
        start = state.get_position().copy()
        Z_first, times = None, []
        for cycle in range(PLANNER_CYCLES):
            t0 = time.perf_counter()
            out_p = planner.solve_mpc(state, data)
            times.append(time.perf_counter() - t0)
            check(out_p.success, f"planner cycle {cycle} failed")
            if Z_first is None:
                Z_first = planner._Z.copy()
            z = np.concatenate([[planner.get_solution(0, "a"), planner.get_solution(0, "w")],
                                state.as_array()])
            x_next = model.discrete_dynamics(torch.as_tensor(z, dtype=torch.float32, device=dev),
                                             None, cfg.dt)
            state.from_array(x_next.cpu().numpy())
            walk_pedestrians(state, data, cfg)
        goal = np.asarray(data.goal)
        d0, d1 = np.linalg.norm(goal - start), np.linalg.norm(goal - state.get_position())
        return Z_first, times, d0, d1

    planner, (state, data) = make_planner("auto")
    check(planner.solver.qp_backend == "cuda", "auto backend did not pick cuda on the GPU")
    check(not planner.solver.rti_fused, "rti_fused='auto' did not resolve off")
    cuda_qp.reset_launch_counts()
    Z_first, times, d0, d1 = closed_loop(planner, state, data)
    launches = dict(cuda_qp.launch_counts)
    print(f"phase 5: {PLANNER_CYCLES}/{PLANNER_CYCLES} planner cycles succeeded; distance to goal "
          f"{d0:.3f} -> {d1:.3f} m; cycle time median {np.median(times[1:]) * 1e3:.2f} ms, "
          f"max {np.max(times[1:]) * 1e3:.2f} ms [{card}] "
          f"(first {times[0] * 1e3:.1f} ms); kernel launches {launches}")
    check(d1 < d0 - 0.5, "robot did not approach the goal")
    for name in ("qp", "mirror"):
        check(launches[name] > 0, f"main path never launched the {name} kernel")

    planner_t, (state_t, data_t) = make_planner("torch")
    t0 = time.perf_counter()
    check(planner_t.solve_mpc(state_t, data_t).success, "torch-backend planner cycle 1 failed")
    torch_cycle_s = time.perf_counter() - t0
    Z_torch_first = planner_t._Z.copy()
    diff = float(np.abs(Z_torch_first - Z_first).max())
    print(f"phase 5: cycle 1 Z, cuda vs torch backend: max |d| = {diff:.3e}; torch-backend "
          f"cycle 1 {torch_cycle_s * 1e3:.1f} ms [{card}]")
    check(diff < 5e-3, "cycle 1 differs between the cuda and torch backends")
    sys.stdout.flush()

    # -- 6. batch: cold + chained warm cycles ------------------------------------
    for backend in ("cuda", "torch"):
        c = cfg.replace(solver=cfg.solver.__class__(qp_backend=backend))
        solver = SQPSolver(OCP(model, modules, c), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve_batch(Z0, P, x0, num_iterations=RTI_ITERATIONS)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        cold_ok = int((res.exit_code == EXIT_SUCCESS).sum())
        cycle_s = []
        for _ in range(WARM_CYCLES):
            t0 = time.perf_counter()
            res = solver.solve_batch(res.Z, P, x0, num_iterations=RTI_ITERATIONS,
                                     warm_duals=(res.lam_l, res.lam_u, res.exit_code == EXIT_SUCCESS))
            torch.cuda.synchronize()
            cycle_s.append(time.perf_counter() - t0)
        feasible = int((res.exit_code == EXIT_SUCCESS).sum())
        check(bool(torch.isfinite(res.Z).all()), f"{backend}: non-finite batch solution")
        print(f"phase 6: {backend}: B={BATCH} cold solve {cold_s * 1e3:.1f} ms ({cold_ok}/{BATCH} "
              f"feasible); {WARM_CYCLES} warm cycles mean {np.mean(cycle_s) * 1e3:.1f} ms, "
              f"last cycle {feasible}/{BATCH} feasible [{card}]")
        check(feasible > 0, f"{backend}: no feasible batch element")
    sys.stdout.flush()

    record["rti"], rti_launches = fused_phases(
        dev, card, stage_code, Z0, P, x0, Zp, plain_solver, make_planner, closed_loop,
        Z_torch_first)
    record["riccati_probe"], probe_launches = probe_phase(card, dev)

    kernels = [
        dict(name="qp", route="cuda", source="mpc_planner_tpu_torch/ops/csrc/qp_kernel.cu",
             replaces="mpc_planner_tpu/ops/pallas_qp.py:621", launches=launches["qp"],
             **record["qp"]),
        dict(name="mirror", route="cuda", source="mpc_planner_tpu_torch/ops/csrc/mirror_kernel.cu",
             replaces="mpc_planner_tpu/ops/pallas_qp.py:81", launches=launches["mirror"],
             **record["mirror"]),
        dict(name="rti", route="cuda", source="mpc_planner_tpu_torch/ops/csrc/rti_kernel.cuh",
             replaces="mpc_planner_tpu/ops/pallas_rti.py:205", launches=rti_launches,
             **record["rti"]),
        dict(name="riccati_probe", route="cuda",
             source="mpc_planner_tpu_torch/ops/csrc/riccati_probe.cu",
             replaces="experiments/riccati_ilp_probe.py:278", launches=probe_launches,
             **record["riccati_probe"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
