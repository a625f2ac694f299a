#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mpc_planner_tpu_torch) on one
NVIDIA GPU: builds the hand-written Hopper kernels from the checkout,
holds each against its plain torch version, drives the planner's paths
(goal tracking, and the T-MPC++ flagship), and prints one JSON result
line.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is printed as a
result then):
  1. refuse to run without CUDA; print the card (nvidia-smi) and torch;
  2. build the kernels (torch.utils.cpp_extension.load, sm_90a), every
     library in parallel: K1 + K2, K3 for system_jackal("goal") and for
     the flagship OCP (from the stage code generated for each OCP), K4;
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
     (< 1e-3) and timed at 5, 1024 and 131,072 elements;
 12. the flagship's build: K3 for configuration_tmpc at N=20 and N=30
     (build times; whether they share one build), the native geometry
     library, and the OCP's nh, nrows and npar;
 13. K1 and K2 at the flagship shape: QPs linearized from the flagship
     batch (B=1024, N=20, nh=24) around perturbed converged plans, cold +
     Mehrotra and warm duals + fixed sigma (relative error on dz, lam_l
     and lam_u < 5e-3), K2 on those QPs' stage Hessians (< 1e-5); timed;
 14. K3 at the flagship shape: its linearization vs SQPSolver._linearize
     (< 1e-4), and solve_rti_cuda vs solve_rti_torch from converged plans,
     cold and warm (as phase 8: Z < 5e-3, exit codes differ in <= 1%);
     timed;
 15. the flagship planner (system_jackalsimulator("tmpc"): N=30, B=5
     planners) closed loop on corridor_scene(12 pedestrians), 20 cycles
     on the unfused route (K1 + K2) and on the fused route (K3): every
     cycle succeeds, the launch counts show K1/K2 only on the unfused
     route and K3 only on the fused one, cycle 1's Z matches the torch
     backend on the card within 5e-3; prints the cycle times, the
     selected planner per cycle, the least pedestrian distance, the
     profiler's host scopes and (unchecked) the max |Z - golden| of the
     tests/golden/tmpc_corridor*.npz scenes;
 16. the flagship batch (bench.py's workload: configuration_tmpc, N=20,
     corridor_scene(8 pedestrians), B=1024 warm starts perturbed by 0.05,
     10 RTI): one cold solve and 8 chained warm cycles carrying Z and the
     duals on K1 + K2 and on K3, a cold solve and 2 warm cycles on plain
     torch; mean warm cycle, solves/s and feasible count.
Every kernel time is printed beside its bound: the least time the card
could take for the same work (ops/cuda_qp.py::bound_ms over the operation
and byte counts of qp_work, mirror_work, rti_work and probe_work), and the
share of it the kernel reaches. No single PyTorch call computes what K1,
K2, K3 or K4 compute, so none has a library time (null in the record).
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
FLAGSHIP_N = 20  # the batch workload's horizon (bench.py)
PLAIN_WARM_CYCLES = 2
ROBOT_BATCH = 5  # the flagship planner's batch: 4 homotopy classes + the free planner


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


def kernel_record(max_abs_err, ms, plain_ms, work):
    """One kernel's numbers for the JSON record; `work` = (flops, bytes) of
    the timed call."""
    from mpc_planner_tpu_torch.ops.cuda_qp import bound_ms

    bound, bound_by = bound_ms(*work)
    return dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=None)


def bound_text(ms, work):
    """'bound 0.0123 ms by operations (0.45% of it reached)' for a kernel time."""
    from mpc_planner_tpu_torch.ops.cuda_qp import bound_ms

    bound, bound_by = bound_ms(*work)
    return f"bound {bound:.3g} ms by {bound_by} ({100 * bound / ms:.3g}% of it reached)"


def batch_work(work, batch):
    return work[0] * batch, work[1] * batch


def check_qp(phase, card, plain, Zp, P, fields=("dz", "lam_l", "lam_u")):
    """K1 vs its plain version (solve_qp) on the QPs that `plain` (a
    torch-backend SQPSolver) linearizes at the plans Zp: cold + Mehrotra,
    then the next RTI iteration's QPs with warm duals + a fixed sigma;
    relative error on `fields` < 5e-3. Both timed. Returns K1's record."""
    import torch

    from mpc_planner_tpu_torch.ops import cuda_qp
    from mpc_planner_tpu_torch.solver.qp import solve_qp

    ocp = plain.ocp
    nu, nx, B, n = ocp.nu, ocp.nx, Zp.shape[0], Zp.shape[1] - 1
    qp = plain._linearize(Zp, P)
    qp_iters, wi = plain.qp_iterations, plain.warm_qp_iters
    ref = solve_qp(qp, nu, nx, iterations=qp_iters, mehrotra=True)
    out = cuda_qp.solve_qp_cuda(qp, nu, nx, iterations=qp_iters, mehrotra=True)
    torch.cuda.synchronize()
    errs = {f: rel_err(getattr(out, f), getattr(ref, f)) for f in fields}
    print(f"phase {phase}: QP cold+Mehrotra B={B} N={n} nh={ocp.nh}: rel err "
          + ", ".join(f"{f} {e:.3e}" for f, e in errs.items()))
    check(max(errs.values()) < 5e-3, f"QP kernel disagrees with plain (cold, B={B}, N={n}): {errs}")
    ok = ref.mu < 1e-2
    qp1 = plain._linearize(Zp + ref.dz, P)
    warm = (ref.lam_l, ref.lam_u, ok)
    ref2 = solve_qp(qp1, nu, nx, iterations=wi, warm_duals=warm, mehrotra=False)
    out2 = cuda_qp.solve_qp_cuda(qp1, nu, nx, iterations=wi, warm_duals=warm, mehrotra=False)
    torch.cuda.synchronize()
    errs = {f: rel_err(getattr(out2, f), getattr(ref2, f)) for f in fields}
    print(f"phase {phase}: QP warm duals ({int(ok.sum())}/{B} ok)+fixed sigma: rel err "
          + ", ".join(f"{f} {e:.3e}" for f, e in errs.items()))
    check(max(errs.values()) < 5e-3, f"QP kernel disagrees with plain (warm, B={B}, N={n}): {errs}")
    work = batch_work(cuda_qp.qp_work(n, nu, nx, ocp.nh, qp_iters), B)
    ms = cuda_ms(torch, lambda: cuda_qp.solve_qp_cuda(qp, nu, nx, iterations=qp_iters), 20)
    plain_ms = cuda_ms(torch, lambda: solve_qp(qp, nu, nx, iterations=qp_iters), 2)
    print(f"phase {phase}: QP cold solve B={B}, N={n}, nh={ocp.nh}, {qp_iters} IP iterations: "
          f"kernel {ms:.3f} ms, {bound_text(ms, work)}, plain {plain_ms:.3f} ms [{card}]")
    if B <= ROBOT_BATCH:  # a lone warp per SM: what the predictor's extra solve and passes cost
        t = cuda_ms(torch, lambda: cuda_qp.solve_qp_cuda(qp, nu, nx, iterations=qp_iters,
                                                         mehrotra=False), 20)
        print(f"phase {phase}: QP cold solve B={B}, fixed sigma instead of Mehrotra (one linear "
              f"solve and 7 row passes an iteration instead of two and 12): kernel {t:.3f} ms [{card}]")
    # Where the launcher changes path: the largest batch whose QPs it stages in
    # shared memory, and one element more (read from global memory).
    ext = cuda_qp.load_kernels()
    resident = ext.qp_resident_blocks(ext.qp_shared_bytes(n, nu, nx, ocp.nh, True))
    if resident < B:
        for b in (resident, resident + 1):
            part = qp._replace(**{f: getattr(qp, f)[:b] for f in qp._fields})
            t = cuda_ms(torch, lambda: cuda_qp.solve_qp_cuda(part, nu, nx, iterations=qp_iters), 20)
            where = "staged in shared memory" if b == resident else "read from global memory"
            print(f"phase {phase}: QP cold solve B={b} ({where}): kernel {t:.3f} ms [{card}]")
    sys.stdout.flush()
    max_abs = max(float((out.dz - ref.dz).abs().max()), float((out2.dz - ref2.dz).abs().max()))
    return kernel_record(max_abs, ms, plain_ms, work)


def check_linearization(phase, solver, stage_code, plain_solver, Zp, P):
    """K3's linearization alone (linearize_cuda) vs the unfused
    SQPSolver._linearize at the iterates Zp: max |d| / max |ref| < 1e-4."""
    import torch

    from mpc_planner_tpu_torch.ops.cuda_rti import linearize_cuda

    nu, nvar = stage_code.ocp.nu, stage_code.ocp.nvar
    ref = plain_solver._linearize(Zp, P)
    out = linearize_cuda(Zp, P, stage_code, lm=solver.lm, mirror_x_only=solver._mirror_x_only,
                         lb_template=solver._lb_template, ub_template=solver._ub_template)
    torch.cuda.synchronize()
    keep = torch.ones_like(ref.H)
    keep[:, -1, :nu, :] = 0  # the terminal u-block: lm*I unfused, 0 in K3; the QP never reads it
    keep[:, -1, :, :nu] = 0
    pairs = dict(H=(out.H * keep, ref.H * keep), g=(out.g, ref.g), A=(out.A, ref.A),
                 B=(out.B, ref.B), c=(out.c, ref.c), Dh=(out.D[:, :, nvar:], ref.D[:, :, nvar:]),
                 lb=(out.lb * ref.mask_l, ref.lb * ref.mask_l),
                 ub=(out.ub * ref.mask_u, ref.ub * ref.mask_u))
    errs = {k: rel_err(a, b) for k, (a, b) in pairs.items()}
    print(f"phase {phase}: linearize_cuda vs SQPSolver._linearize, B={Zp.shape[0]}, "
          f"N={Zp.shape[1] - 1}: max|d|/max|ref| " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    check(max(errs.values()) < 1e-4, f"K3 linearization disagrees with the unfused one: {errs}")
    sys.stdout.flush()


def check_rti(phase, card, solver, stage_code, Zp, P, x0, with_b1=True):
    """K3 vs its plain version (solve_rti_torch) from the plans Zp, cold
    and then warm (from the plain cold solve with its duals): relative
    error on Z < 5e-3, exit codes differing in <= 1% of the batch; both
    timed at B and (with_b1) the kernel at B=1. Returns K3's record."""
    import torch

    from mpc_planner_tpu_torch.ops import cuda_qp
    from mpc_planner_tpu_torch.ops.cuda_rti import load_rti, rti_work, solve_rti_cuda
    from mpc_planner_tpu_torch.ops.rti import solve_rti_torch
    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS

    ocp = stage_code.ocp
    B = Zp.shape[0]
    Zc = Zp.clone()
    Zc[:, 0, ocp.nu:] = x0
    wi = solver.warm_qp_iters
    kw = dict(num_iterations=RTI_ITERATIONS, warm_iters=wi, mu0=solver.mu0,
              sigma_fixed=solver.warm_sigma, lm=solver.lm, mirror_x_only=solver._mirror_x_only,
              lb_template=solver._lb_template, ub_template=solver._ub_template)
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
        print(f"phase {phase}: K3 vs solve_rti_torch, {label}, B={B}, N={Zp.shape[1] - 1}, "
              f"{RTI_ITERATIONS} RTI: rel err Z {e_z:.3e} (median element {float(per.median()):.2e}, "
              f"{int((per > 5e-3).sum())} elements > 5e-3), lam_l {rel_err(res.lam_l, ref_res.lam_l):.3e}; "
              f"exit codes differ in {n_diff}/{B} ({int((codes == EXIT_SUCCESS).sum())} vs "
              f"{int((codes_ref == EXIT_SUCCESS).sum())} successes)")
        check(e_z < 5e-3, f"K3 disagrees with plain ({label}): {e_z}")
        check(n_diff <= B // 100, f"K3 exit codes differ from plain in {n_diff} elements ({label})")
        return ref_res

    first = compare("cold", Zc, cold)
    compare("warm", first.Z, dict(kw, it0=wi, warm_duals=(first.lam_l, first.lam_u, first.mu < 1e-2)))
    work = rti_work(stage_code, Zp.shape[1] - 1, RTI_ITERATIONS, solver.qp_iterations, wi,
                    mirror_x_only=solver._mirror_x_only)
    ms = cuda_ms(torch, lambda: solve_rti_cuda(Zc, P, stage_code, **cold), 5)
    plain_ms = cuda_ms(torch, lambda: solve_rti_torch(Zc, P, ocp, **cold), 1)
    print(f"phase {phase}: K3 cold solve, {RTI_ITERATIONS} RTI, N={Zp.shape[1] - 1}: B={B} kernel "
          f"{ms:.3f} ms, {bound_text(ms, batch_work(work, B))}, plain {plain_ms:.3f} ms [{card}]")
    if B > 1 and with_b1:
        ms_b1 = cuda_ms(torch, lambda: solve_rti_cuda(Zc[:1], P[:1], stage_code, **cold), 10)
        print(f"phase {phase}: K3 cold solve, {RTI_ITERATIONS} RTI: B=1 kernel {ms_b1:.3f} ms, "
              f"{bound_text(ms_b1, work)} [{card}]")
        # Where the launcher changes path (as for K1, phase 13)
        lib = load_rti(stage_code)
        resident = cuda_qp.load_kernels().qp_resident_blocks(
            lib.mpc_rti_shared_bytes(Zp.shape[1] - 1, 1))
        if resident < B:
            for b in (resident, resident + 1):
                t = cuda_ms(torch, lambda: solve_rti_cuda(Zc[:b], P[:b], stage_code, **cold), 5)
                where = "QP staged in shared memory" if b == resident else "QP in global scratch"
                print(f"phase {phase}: K3 cold solve B={b} ({where}): kernel {t:.3f} ms [{card}]")
    sys.stdout.flush()
    return kernel_record(max_abs, ms, plain_ms, batch_work(work, B))


def fused_phases(dev, card, stage_code, Z0, P, x0, Zp, plain_solver, make_planner, closed_loop,
                 Z_torch_first):
    """Phases 7-10: the fused route (K3). Returns K3's record for the
    kernels line and its launch count over phase 9's planner loop."""
    import torch

    from mpc_planner_tpu_torch.ops import cuda_qp
    from mpc_planner_tpu_torch.solver.ocp import OCP
    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS, SQPSolver

    ocp = stage_code.ocp
    cfg = ocp.cfg.replace(solver=ocp.cfg.solver.__class__(rti_fused="on"))
    solver = SQPSolver(OCP(ocp.model, ocp.modules, cfg), device=dev)
    check(solver.rti_fused, "rti_fused='on' did not take the fused route on the GPU")

    # -- 7. K3's linearization vs the unfused one ---------------------------------
    check_linearization(7, solver, stage_code, plain_solver, Zp, P)
    # -- 8. K3 vs plain, cold then warm ------------------------------------------
    rti_record = check_rti(8, card, solver, stage_code, Zp, P, x0)

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
    return rti_record, launches["rti"]


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
              f"ns/stage-step/chain ({r['ns_per_step_element']:.4f} ns per element), bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} "
              f"({100 * r['bound_ms'] / r['ms']:.2f}% of it reached); plain {r['plain_ms']:.2f} ms "
              f"[{card}]")
    check(launches > 0, "the probe launched no kernel")
    first = next(r for r in rows if r["mapping"] == "single" and r["elements"] == 1024)
    sys.stdout.flush()
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows), ms=first["ms"],
                plain_ms=first["plain_ms"], bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                library_ms=None), launches


def flagship_phases(dev, card, codes, build_s):
    """Phases 12-16: the T-MPC++ flagship. `codes` are the stage codes of
    configuration_tmpc built in phase 2 (by horizon). Returns the kernels
    line's records of K1, K2 and K3 at the flagship shape, with the launch
    counts of phase 15's planner runs."""
    import os

    import torch

    from mpc_planner_tpu_torch import native, presets
    from mpc_planner_tpu_torch.ops import cuda_qp
    from mpc_planner_tpu_torch.ops.jacobi_eigh import mirror_unpacked
    from mpc_planner_tpu_torch.ops.rti import stage_derivatives
    from mpc_planner_tpu_torch.planner import Planner
    from mpc_planner_tpu_torch.solver.ocp import OCP
    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS, SQPSolver
    from mpc_planner_tpu_torch.utils.config import default_config

    def solver_cfg(n, **solver):
        c = default_config(N=n)
        return c.replace(solver=c.solver.__class__(**solver))

    # -- 12. the flagship's build ---------------------------------------------------
    shared = codes[FLAGSHIP_N].source("cuda") == codes[N].source("cuda")
    ocp = codes[FLAGSHIP_N].ocp
    nrows = ocp.nvar + ocp.nh
    print(f"phase 12: flagship K3 (configuration_tmpc): N={FLAGSHIP_N} generated and built in "
          f"{build_s[f'rti_flagship_N{FLAGSHIP_N}']:.1f} s, N={N} in {build_s[f'rti_flagship_N{N}']:.1f} s "
          f"({'one build: the generated code does not depend on N' if shared else 'two builds'}); "
          f"nh={ocp.nh}, nrows={nrows}, npar={ocp.npar}; native geometry library loaded: "
          f"{native.available()}")
    check((ocp.nh, nrows) == (24, 31), f"flagship OCP has nh={ocp.nh}, nrows={nrows}")
    sys.stdout.flush()

    # The batch workload (bench.py:71-81): one OCP instance, B perturbed warm
    # starts; converged plans of it, perturbed, as a control loop's warm starts.
    model, ocp_t, Z0, P0, xinit = presets.flagship_problem(solver_cfg(FLAGSHIP_N, qp_backend="torch"))
    nu, nx = model.nu, model.nx
    plain = SQPSolver(ocp_t, device=dev)
    rng = np.random.default_rng(SEED)
    Zb = np.tile(Z0[None], (BATCH, 1, 1)).astype(np.float32)
    Zb[:, 1:, nu:] += rng.normal(0, 0.05, Zb[:, 1:, nu:].shape).astype(np.float32)
    Zb = torch.as_tensor(Zb, device=dev)
    P = torch.as_tensor(P0, dtype=torch.float32, device=dev).expand(BATCH, -1, -1)
    x0 = torch.as_tensor(xinit, dtype=torch.float32, device=dev).expand(BATCH, -1)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Zs = plain.batch_impl(Zb, P, x0, RTI_ITERATIONS).Z
    Zp = Zs + 0.01 * torch.randn(Zs.shape, device=dev, generator=gen)
    Zp[:, 0, nu:] = x0

    # -- 13. K1 and K2 at the flagship shape -------------------------------------------
    qp_record = check_qp(13, card, plain, Zp, P)
    # K2 on the same iterates' running-cost Hessians, x-block (the x-only form)
    Hx = stage_derivatives(ocp_t, Zp, P).H_run[:, :, nu:, nu:].reshape(-1, nx, nx).contiguous()
    lm = plain.lm
    out_k, out_p = cuda_qp.mirror_cuda(Hx, lm), mirror_unpacked(Hx, lm)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max() / Hx.abs().max())
    ms = cuda_ms(torch, lambda: cuda_qp.mirror_cuda(Hx, lm), 20)
    plain_ms = cuda_ms(torch, lambda: mirror_unpacked(Hx, lm), 3)
    work = batch_work(cuda_qp.mirror_work(nx), Hx.shape[0])
    mirror_record = kernel_record(float((out_k - out_p).abs().max()), ms, plain_ms, work)
    print(f"phase 13: mirror on the flagship's stage Hessians {list(Hx.shape)}: max|d|/max|H| = "
          f"{err:.3e}; kernel {ms:.4f} ms, {bound_text(ms, work)}, plain {plain_ms:.4f} ms [{card}]")
    check(err < 1e-5, f"MIRROR kernel disagrees with plain on the flagship's Hessians: {err}")
    sys.stdout.flush()

    # The robot's own batch: B=5 planners at N=30 (what phase 15's cycles launch).
    model_r, ocp_r, Z0_r, P0_r, xinit_r = presets.flagship_problem(solver_cfg(N, qp_backend="torch"))
    plain_r = SQPSolver(ocp_r, device=dev)
    Zr = np.tile(Z0_r[None], (ROBOT_BATCH, 1, 1)).astype(np.float32)
    Zr[:, 1:, nu:] += rng.normal(0, 0.05, Zr[:, 1:, nu:].shape).astype(np.float32)
    P_r = torch.as_tensor(P0_r, dtype=torch.float32, device=dev).expand(ROBOT_BATCH, -1, -1)
    x0_r = torch.as_tensor(xinit_r, dtype=torch.float32, device=dev).expand(ROBOT_BATCH, -1)
    Zr = plain_r.batch_impl(torch.as_tensor(Zr, device=dev), P_r, x0_r, RTI_ITERATIONS).Z
    Zr = Zr + 0.01 * torch.randn(Zr.shape, device=dev, generator=gen)
    Zr[:, 0, nu:] = x0_r
    qp_robot_record = check_qp(13, card, plain_r, Zr, P_r)

    # -- 14. K3 at the flagship shape -------------------------------------------------
    fused = SQPSolver(OCP(model, ocp_t.modules, solver_cfg(FLAGSHIP_N, rti_fused="on")), device=dev)
    check(fused.rti_fused, "the flagship solver did not take the fused route")
    check_linearization(14, fused, fused._stage_code, plain, Zp, P)
    rti_record = check_rti(14, card, fused, fused._stage_code, Zp, P, x0)
    fused_r = SQPSolver(OCP(model_r, ocp_r.modules, solver_cfg(N, rti_fused="on")), device=dev)
    check(fused_r.rti_fused, "the flagship solver at the robot's horizon did not take the fused route")
    check_linearization(14, fused_r, fused_r._stage_code, plain_r, Zr, P_r)
    rti_robot_record = check_rti(14, card, fused_r, fused_r._stage_code, Zr, P_r, x0_r, with_b1=False)

    # -- 15. the flagship planner, closed loop, on both routes ---------------------------------
    goldens = {n: np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                       "golden", name))["Z"]
               for n, name in ((15, "tmpc_corridor.npz"), (30, "tmpc_corridor_n30.npz"))}

    def make_planner(route, cfg=None, scene=(12, SEED)):
        solver = dict(unfused={}, fused=dict(rti_fused="on"), torch=dict(qp_backend="torch"))[route]
        if cfg is None:
            cfg, m, mods = presets.system_jackalsimulator("tmpc")
        else:
            m, mods = presets.configuration_tmpc(cfg)
        cfg = cfg.replace(solver=cfg.solver.__class__(**solver))
        planner = Planner(m, mods, cfg, device=dev)
        state, data = presets.corridor_scene(cfg, n_pedestrians=scene[0], seed=scene[1])
        planner.on_data_received(data, "reference_path")
        return planner, state, data

    def closed_loop(planner, state, data):
        cfg, m = planner.cfg, planner.model
        module = planner.modules.get("GuidanceConstraints")
        x_start = state.get("x")
        Z_first, times, selected, d_min = None, [], [], np.inf
        for cycle in range(PLANNER_CYCLES):
            t0 = time.perf_counter()
            out_p = planner.solve_mpc(state, data)
            times.append(time.perf_counter() - t0)
            check(out_p.success, f"flagship planner cycle {cycle} failed")
            if Z_first is None:
                Z_first = planner._Z.copy()
            selected.append(module._selected_planner)
            z = np.concatenate([[planner.get_solution(0, "a"), planner.get_solution(0, "w")],
                                state.as_array()])
            x_next = m.discrete_dynamics(torch.as_tensor(z, dtype=torch.float32, device=dev), None,
                                         cfg.dt)
            state.from_array(x_next.cpu().numpy())
            walk_pedestrians(state, data, cfg)
            blk = data.obstacle_block
            real = blk.index >= 0
            d_min = min(d_min, float(np.linalg.norm(blk.position[real] - state.get_position(),
                                                    axis=1).min()))
        return Z_first, times, selected, d_min, state.get("x") - x_start

    planner_t, state_t, data_t = make_planner("torch")
    t0 = time.perf_counter()
    check(planner_t.solve_mpc(state_t, data_t).success, "flagship torch-backend cycle 1 failed")
    torch_cycle_s = time.perf_counter() - t0
    Z_torch_first = planner_t._Z.copy()
    print(f"phase 15: flagship torch backend on the card: cycle 1 {torch_cycle_s * 1e3:.1f} ms [{card}]")
    launches = {}
    scopes = ("planning", "update", "guidance_update", "set_parameters", "optimization",
              "tmpc_host_assemble", "tmpc_dispatch_solve_pull", "tmpc_escalation")
    for route, kernels, absent in (("unfused", ("qp", "mirror"), ("rti",)),
                                   ("fused", ("rti",), ("qp", "mirror"))):
        planner, state, data = make_planner(route)
        check(planner.solver.qp_backend == "cuda" and planner.solver.rti_fused == (route == "fused"),
              f"flagship {route} route: backend {planner.solver.qp_backend}, fused "
              f"{planner.solver.rti_fused}")
        cuda_qp.reset_launch_counts()
        Z_first, times, selected, d_min, progress = closed_loop(planner, state, data)
        launches[route] = dict(cuda_qp.launch_counts)
        diff = float(np.abs(Z_torch_first - Z_first).max())
        print(f"phase 15: flagship {route}: {PLANNER_CYCLES}/{PLANNER_CYCLES} cycles succeeded, "
              f"{progress:.2f} m of progress; cycle time median {np.median(times[1:]) * 1e3:.2f} ms, "
              f"max {np.max(times[1:]) * 1e3:.2f} ms [{card}] (first {times[0] * 1e3:.1f} ms); "
              f"selected planner per cycle {selected}; least pedestrian distance {d_min:.3f} m; "
              f"cycle 1 Z vs the torch backend: max |d| = {diff:.3e}; kernel launches "
              f"{launches[route]}")
        stats = planner.profiler.stats
        print(f"phase 15: flagship {route}: launches per cycle over {PLANNER_CYCLES} cycles: "
              + ", ".join(f"K{i} {launches[route][k] / PLANNER_CYCLES:.2f}"
                          for i, k in ((1, "qp"), (2, "mirror"), (3, "rti"))))
        print(f"phase 15: flagship {route} host scopes, median ms over {PLANNER_CYCLES} cycles: "
              + ", ".join(f"{k} {stats[k].median * 1e3:.2f} (n={stats[k].count})"
                          for k in scopes if k in stats))
        check(diff < 5e-3, f"flagship {route}: cycle 1 differs from the torch backend")
        check(progress > 1.0, f"flagship {route}: the robot made no progress")
        for name in kernels:
            check(launches[route][name] > 0, f"flagship {route}: the {name} kernel never launched")
        for name in absent:
            check(launches[route][name] == 0, f"flagship {route}: the {name} kernel launched")
        golden_err = []
        for n, Zg in goldens.items():
            pg, sg, dg = make_planner(route, default_config(N=n), scene=(6, 7))
            check(pg.solve_mpc(sg, dg).success, f"golden scene N={n} failed on the {route} route")
            golden_err.append(f"N={n} {float(np.abs(pg._Z - Zg).max()):.3e}")
        print(f"phase 15: flagship {route}: max |Z - golden| (not checked): " + ", ".join(golden_err))
        sys.stdout.flush()

    # -- 16. the flagship batch (bench.py's workload) ------------------------------------------
    unfused = SQPSolver(OCP(model, ocp_t.modules, default_config(N=FLAGSHIP_N)), device=dev)
    for label, solver, cycles in (("K1+K2", unfused, WARM_CYCLES), ("K3", fused, WARM_CYCLES),
                                  ("plain torch", plain, PLAIN_WARM_CYCLES)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve_batch(Zb, P, x0, num_iterations=RTI_ITERATIONS)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        cold_ok = int((res.exit_code == EXIT_SUCCESS).sum())
        cycle_s = []
        for _ in range(cycles):
            t0 = time.perf_counter()
            res = solver.batch_impl(res.Z, P, x0, RTI_ITERATIONS,
                                    warm0=(res.lam_l, res.lam_u, res.exit_code == EXIT_SUCCESS))
            torch.cuda.synchronize()
            cycle_s.append(time.perf_counter() - t0)
        feasible = int((res.exit_code == EXIT_SUCCESS).sum())
        check(bool(torch.isfinite(res.Z).all()), f"flagship batch {label}: non-finite solution")
        check(feasible > 0, f"flagship batch {label}: no feasible element")
        mean_s = float(np.mean(cycle_s))
        print(f"phase 16: flagship batch on {label}: B={BATCH}, N={FLAGSHIP_N}, cold solve "
              f"{cold_s * 1e3:.1f} ms ({cold_ok}/{BATCH} feasible); {cycles} warm cycles mean "
              f"{mean_s * 1e3:.1f} ms = {BATCH / mean_s:.0f} solves/s, last cycle {feasible}/{BATCH} "
              f"feasible [{card}]")
        sys.stdout.flush()

    return dict(qp=dict(launches=launches["unfused"]["qp"], **qp_record),
                mirror=dict(launches=launches["unfused"]["mirror"], **mirror_record),
                rti=dict(launches=launches["fused"]["rti"], **rti_record),
                qp_robot=dict(launches=launches["unfused"]["qp"], **qp_robot_record),
                rti_robot=dict(launches=launches["fused"]["rti"], **rti_robot_record))


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
    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS, SQPSolver
    from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
    from mpc_planner_tpu_torch.types import ModuleData
    from mpc_planner_tpu_torch.utils.config import default_config

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

    # -- 2. build (every library in parallel) ------------------------------------
    t0 = time.perf_counter()
    cfg, model, modules = presets.system_jackal("goal", N=N)
    stage_code = StageCode(OCP(model, modules, cfg))
    flagship_codes = {}
    for n in (FLAGSHIP_N, N):
        c = default_config(N=n)
        flagship_codes[n] = StageCode(OCP(*presets.configuration_tmpc(c), c))

    def timed(fn, *args):
        t = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t

    # K3 libraries generate their stage code (make_fx) in the pool too; one
    # OCP's second build waits for the first when their code is the same.
    jobs = [("qp+mirror", cuda_qp.load_kernels, ()), ("rti", cuda_rti.load_rti, (stage_code,)),
            ("riccati_probe", riccati_probe.load_probe, ())]
    jobs += [(f"rti_flagship_N{n}", cuda_rti.load_rti, (code,)) for n, code in flagship_codes.items()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        builds = {name: pool.submit(timed, fn, *args) for name, fn, args in jobs}
        build_s = {name: f.result() for name, f in builds.items()}
    print(f"phase 2: kernels generated, built and loaded in {time.perf_counter() - t0:.1f} s "
          "(in parallel: " + ", ".join(f"{k} {v:.1f} s" for k, v in build_s.items()) + ")")
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
            work = batch_work(cuda_qp.mirror_work(n), H.shape[0])
            record["mirror"] = kernel_record(float((out_k - out_p).abs().max()), ms, plain_ms, work)
            print(f"phase 3: mirror [{H.shape[0]}, 5, 5]: kernel {ms:.4f} ms, {bound_text(ms, work)}, "
                  f"plain {plain_ms:.4f} ms [{card}]")
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
    record["qp"] = check_qp(4, card, plain_solver, Zp, P, fields=("dz", "lam_l"))

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
    flagship = flagship_phases(dev, card, flagship_codes, build_s)

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
        dict(name="qp_flagship", route="cuda", source="mpc_planner_tpu_torch/ops/csrc/qp_kernel.cu",
             replaces="mpc_planner_tpu/ops/pallas_qp.py:621", **flagship["qp"]),
        dict(name="mirror_flagship", route="cuda",
             source="mpc_planner_tpu_torch/ops/csrc/mirror_kernel.cu",
             replaces="mpc_planner_tpu/ops/pallas_qp.py:81", **flagship["mirror"]),
        dict(name="rti_flagship", route="cuda", source="mpc_planner_tpu_torch/ops/csrc/rti_kernel.cuh",
             replaces="mpc_planner_tpu/ops/pallas_rti.py:205", **flagship["rti"]),
        dict(name="qp_flagship_robot_batch", route="cuda",
             source="mpc_planner_tpu_torch/ops/csrc/qp_kernel.cu",
             replaces="mpc_planner_tpu/ops/pallas_qp.py:621", **flagship["qp_robot"]),
        dict(name="rti_flagship_robot_batch", route="cuda",
             source="mpc_planner_tpu_torch/ops/csrc/rti_kernel.cuh",
             replaces="mpc_planner_tpu/ops/pallas_rti.py:205", **flagship["rti_robot"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
