#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mpc_planner_tpu_torch) on one
NVIDIA GPU: builds the hand-written Hopper kernels from the checkout,
holds each against its plain torch version, drives the planner's paths
(goal tracking, the T-MPC++ flagship, the real Jackal's Gaussian T-MPC,
one cycle of the bicycle, the point mass and rosnavigation's slack T-MPC,
SH-MPC through the closed-loop simulator, the flagship with sampled
guidance, the parallel-in-horizon QP, the batch split over a NCCL process
group, the bridge and the experiments of mpc_planner_tpu_torch/experiments),
and prints one JSON result line.

    python3 chip_smoke.py

Entry points run on the card by default, and `rti_fused="auto"` (the
default) takes the fused route K3 wherever it can be built: the script
asserts the resolved route of every planner and solver it builds, so a
silent downgrade fails it; the unfused route (K1, which runs the MIRROR in
its prologue) is driven by asking for `rti_fused="off"`.

Phases (any failure raises and exits non-zero; nothing is printed as a
result then):
  1. refuse to run without CUDA; print the card (nvidia-smi) and torch;
  2. build the kernels (torch.utils.cpp_extension.load, sm_90a), every
     library in parallel: K1 + K2, K4, and K3 (from the stage code
     generated for each OCP) for system_jackal("goal"), the flagship OCP,
     system_jackal("tmpc") (Gaussian), the bicycle, dingo's point mass,
     rosnavigation's T-MPC, the three SH-MPC OCPs, and configuration_basic
     and configuration_safe_horizon at N=20 (phase 26's corridor rows); the
     build times are printed;
  3. K2 MIRROR kernel vs plain on seeded symmetric [B*(N+1), n, n]
     stacks, n = 5 and 7 (max |d| / max |H| < 1e-5);
  4. K1 QP kernel vs plain on QPs of system_jackal("goal") at B=1024,
     N=30, nh=12, linearized around perturbed corridor warm starts: cold
     + Mehrotra, then warm duals + fixed sigma (relative error on dz and
     lam_l < 5e-3), each on RAW Hessians with the MIRROR inside the kernel
     (against mirror_nvar + solve_qp) and on Hessians regularized
     beforehand; timed: K1 with the MIRROR inside, the two-step sequence it
     replaces (K2, then K1), K1 alone, plain;
  5. Planner.solve_mpc closed loop on the unfused route (rti_fused="off"),
     6 cycles on corridor_scene(12 pedestrians), state advanced by the
     port's dynamics and the pedestrians by their constant velocities;
     every cycle must succeed and the robot must approach the goal; cycle
     1 matches the same cycle on qp_backend="torch" within 5e-3. K1
     launches, K2 and K3 do not (K1's launch count is taken here);
  6. SQPSolver.solve_batch at B=1024, 10 RTI iterations: one cold solve,
     then chained warm cycles, 3 for "cuda" (unfused) and 1 for "torch";
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
  9. Planner.solve_mpc closed loop on the default route (rti_fused="auto"
     must have resolved on), 20 cycles as phase 5: every cycle succeeds,
     the robot approaches the goal, cycle 1 matches phase 5's torch backend
     within 5e-3; over this run K3 launches and K1 does not. K3's launch
     count is taken here;
 10. SQPSolver.solve_batch through the fused route at B=1024: one cold
     solve and 8 chained warm cycles;
 11. K4, the Riccati probe: each thread mapping vs its plain version
     (< 1e-3) and timed at 5, 1024 and 131,072 elements;
 12. the flagship's build: K3 for configuration_tmpc at N=20 and N=30
     (build times; whether they share one build), the native geometry
     library, and the OCP's nh, nrows and npar;
 13. K1 and K2 at the flagship shape: QPs linearized from the flagship
     batch (B=1024, N=20, nh=24) and from the robot's batch (B=5, N=30)
     around perturbed converged plans, as phase 4 (relative error on dz,
     lam_l and lam_u < 5e-3), K2 on those QPs' stage Hessians (< 1e-5);
     timed;
 14. K3 at the flagship shape: its linearization vs SQPSolver._linearize
     (< 1e-4), and solve_rti_cuda vs solve_rti_torch from converged plans,
     cold and warm (as phase 8: Z < 5e-3, exit codes differ in <= 1%);
     timed;
 15. the flagship planner (system_jackalsimulator("tmpc"): N=30, B=5
     planners) closed loop on corridor_scene(12 pedestrians): 6 cycles on
     the unfused route (rti_fused="off": K1 only) and 20 on the default,
     fused route (K3 only): every cycle succeeds, the launch counts show
     the right kernels, cycle 1's Z matches the torch backend on the card
     within 5e-3; prints the cycle times, the selected planner per cycle,
     the least pedestrian distance, the profiler's host scopes and
     (unchecked) the max |Z - golden| of the tests/golden/tmpc_corridor*.npz
     scenes;
 16. the flagship batch (bench.py's workload: configuration_tmpc, N=20,
     corridor_scene(8 pedestrians), B=1024 warm starts perturbed by 0.05,
     10 RTI): one cold solve and chained warm cycles carrying Z and the
     duals: 3 on K1 (host-bound), 8 on K3, 1 on plain torch; mean warm
     cycle, solves/s and feasible count;
 17. cell E, the real Jackal: system_jackal("tmpc") (T-MPC++ with the
     Gaussian chance-constraint submodule, N=30, B=5 planners, 12
     pedestrians with Gaussian predictions): K1 (MIRROR inside) and K3
     against their plain versions at B=5 (as phases 13, 14), then 20 cycles
     through Planner.solve_mpc with no device and no route given (the card,
     the fused route) and 6 with rti_fused="off": every cycle succeeds,
     the launch counts show the right kernels, cycle 1 matches the torch
     backend on the card within 5e-3;
 18. K1 (MIRROR inside) and K3 against their plain versions at B=1024 on the
     (nu, nx) no run had touched: the bicycle (configuration_bicycle: nu=3,
     nx=6, N=30) and dingo's point mass (system_dingo("lmpcc"): nu=2, nx=4,
     N=30); one planner cycle of each through solve_mpc on each route;
 19. the same for system_rosnavigation("tmpc") (slack model nu=3, nx=5,
     guidance + ellipsoid + decomp rows: nh=36, N=20) with a synthetic
     two-wall costmap made from the seed;
 20. cell F, SH-MPC: system_jackalsimulator("safe_horizon") (slack input,
     nu=3, nx=5, nh=24, N=30, 4 scenario solvers x 657 samples sized from
     the risk, 12 pedestrians with Gaussian predictions). Cycle 1's device
     step on the default route against the same step on qp_backend="torch"
     on the card (one CUDA generator, the same draws): P bit-equal, support
     counts and pruning flags equal, certificates within 1e-5, the winner's
     Z within 5e-3; cycle 2 from identical inputs, where the scenario rows
     bind: P bit-equal, the rest printed beside K3's plain version (not
     checked); K1 (MIRROR inside) and K3 against their plain versions at
     B=4 on cycle 1's P (as phases 13, 14; exit codes equal); a third cycle
     under torch.profiler; ClosedLoopSimulator with the scene's pedestrians,
     20 steps with no device and no route given and 2 with
     rti_fused="off": no collision, forward progress, K3 only / K1 only,
     the cycle times, the share of cycles with a valid certificate and the
     median certificate; then two cycles at 1024 scenario solvers (778
     samples each): each device step's time, the solve's share, feasible
     count, peak device memory, and a third cycle under torch.profiler;
 21. the same agreement for system_jackalsimulator("safe_horizon_hard")
     (nu=2) and system_rosnavigation("safe_horizon") (decomp rows after the
     scenario rows: nh=36, N=20, phase 19's costmap), and one planner cycle
     of each on each route;
 22. cell C with sampled guidance: system_jackalsimulator("tmpc") with
     guidance_backend="sampled" (512 candidate paths a cycle, the sweep on
     the card) through ClosedLoopSimulator on corridor_scene(12)'s
     pedestrians, 20 steps on the default route and 2 with rti_fused="off":
     every step succeeds, no collision, >= 2 guidance classes on cycle 1, K3
     only / K1 only; the sweep (draw + score) timed at S=512 and S=8192 with
     its peak memory, and held against the same function on the CPU from the
     same draws (positions and cost < 1e-5 relative, side and feasible
     equal);
 23. solve_qp(horizon_parallel=True) against the sequential sweeps on cell
     D's QPs (B=1024, N=20) and cell C's (B=5, N=30) from phases 13-16 (dz <
     1e-4, duals < 5e-3 relative), each timed once beside K1 on the same QPs;
     one cycle of cell C on qp_backend="torch" with horizon_parallel against
     phase 15's cycle 1 (5e-3);
 24. parallel.distributed_solve_step on NCCL with world size 1 (cuda:0)
     over cell D's batch through K3, a cold and a warm-chained cycle
     (winner shifted, duals carried, consistency 0.9 on the winner): winner,
     found and Z bit-equal to solve_batch + argmin_objective; the step's
     time beside its solve's; the process group destroyed after;
 25. cell E's planner behind PlannerBridgeServer (a thread, a Unix socket in
     a temporary directory): 20 cycles of obstacles + tick from a client,
     every command successful and equal to the same planner driven
     directly by a RobotLoop on the same messages and RTI budget; the
     round trip's median beside solve_mpc's; the run recorded by
     ExperimentUtil and exported, one Planner.visualize JSON saved
     (matplotlib never imported);
 26. the experiments' functions (mpc_planner_tpu_torch/experiments)
     at a cut size, each with the launch counts read around it:
     corridor_benchmark.run_row for T-MPC++ and MPC (ellipsoid) at 4 and 12
     pedestrians and SH-MPC at 12, seed 0 each (K3 only; every row must
     complete, the T-MPC++ and MPC rows with 0 collisions; SH-MPC's
     configuration collides in this scene on both packages, so its
     collisions are printed, not gated), and 40 steps of T-MPC++ at
     samples_per_class=250 (B = 1001 parallel guesses); guidance_ab at 2 scenes; batch_sweep at B=128
     and 1024, n30_latency at B=1024 and 5 (warm iterations 6 and 4), both
     K3 only at 2 cycles x 2 repetitions; fused_rti_check at B=1024 (K3
     against K1 and the plain route: Z < 5e-3 relative, exit codes within
     1%), each route timed.
Every kernel time is printed beside its bound: the least time the card
could take for the same work (ops/cuda_qp.py::bound_ms over the operation
and byte counts of qp_work, mirror_work, rti_work and probe_work), and the
share of it the kernel reaches. No single PyTorch call computes what K1,
K2, K3 or K4 compute, so none has a library time (null in the record). K2
is on no planner route (K1 and K3 run the MIRROR themselves): its
launch count in the record is the 0 that the unfused planner runs of phases
5 and 15 read, and those phases fail on any other count.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
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
HOST_BOUND_WARM_CYCLES = 3  # of the unfused batches (phases 6, 16): seconds a cycle
PLANNER_CYCLES = 20
UNFUSED_CYCLES = 6  # of the unfused planner loops (phases 5, 15, 17): ~2-4 s a cycle on the host
SEED = 0
FLAGSHIP_N = 20  # the batch workload's horizon (bench.py)
PLAIN_WARM_CYCLES = 1
ROBOT_BATCH = 5  # the flagship planner's batch: 4 homotopy classes + the free planner
SHMPC_UNFUSED_STEPS = 2  # of cell F's unfused closed loop (phase 20): ~3-8 s a step on the host
SAMPLED_SAMPLES = 512  # candidate paths of the sampled guidance sweep (phase 22)
SAMPLED_UNFUSED_STEPS = 2  # of phase 22's unfused closed loop: ~2-4 s a step on the host
DISTRIBUTED_REPS = 10  # timed warm steps, and solves alone, of phase 24: ~35 ms each
# Phase 26's corridor rows: (label, configuration in presets, pedestrians, whether a
# collision fails the phase), seed 0 each. SH-MPC's configuration collides in this scene
# on both packages (PERF.md): its row must complete, its collisions are printed.
CORRIDOR_ROWS = (("T-MPC++", "configuration_tmpc", 4, True),
                 ("T-MPC++", "configuration_tmpc", 12, True),
                 ("MPC (ellipsoid)", "configuration_basic", 4, True),
                 ("MPC (ellipsoid)", "configuration_basic", 12, True),
                 ("SH-MPC (slack)", "configuration_safe_horizon", 12, False))
CORRIDOR_MAX_STEPS = 200  # the experiment's default; a completed run stops at the goal (~100 steps)
CORRIDOR_SAMPLES_PER_CLASS = 250  # 4 classes x 250 + the free planner: B = 1001 guesses
CORRIDOR_WIDE_STEPS = 40  # of the B = 1001 row: ~0.3 s a cycle, host guidance
SWEEP_BATCHES = (128, BATCH)  # phase 26's batch_sweep: one resident wave and the flagship batch
N30_BATCHES = (BATCH, ROBOT_BATCH)  # phase 26's n30_latency


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


def scene_pedestrians(cfg, scene):
    """The simulator's pedestrians for a corridor scene: its pedestrians at
    their constant velocities."""
    from mpc_planner_tpu_torch.sim import Pedestrian

    return [Pedestrian(position=o.position.copy(),
                       velocity=(o.prediction.positions[0][1] - o.prediction.positions[0][0]) / cfg.dt,
                       radius=o.radius) for o in scene.dynamic_obstacles if o.index >= 0]


def free_port():
    """A free TCP port on localhost (for a process group's rendezvous)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


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


def event_ms(torch, fn):
    """(fn(), its device time in ms by CUDA events): one call, no warm-up;
    for the plain versions, which take seconds and are no yardstick."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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
    """K1 vs its plain version on the QPs that `plain` (a torch-backend
    SQPSolver) linearizes at the plans Zp: cold + Mehrotra, then the next
    RTI iteration's QPs with warm duals + a fixed sigma; relative error on
    `fields` < 5e-3 (dz against the larger of the two steps: a relinearized
    step may be ~0 itself). Twice: K1 on RAW Hessians with the MIRROR inside
    (what the unfused route launches) against mirror_nvar + solve_qp, and K1
    on Hessians regularized beforehand against solve_qp. Timed: K1 with the
    MIRROR inside, the two-step sequence it replaces (K2 on the stack, then
    K1), K1 alone and plain. Returns K1's record (with the MIRROR inside)."""
    import torch

    from mpc_planner_tpu_torch.ops import cuda_qp
    from mpc_planner_tpu_torch.ops.jacobi_eigh import mirror_nvar
    from mpc_planner_tpu_torch.solver.qp import solve_qp

    ocp = plain.ocp
    nu, nx, nvar, B, n = ocp.nu, ocp.nx, ocp.nvar, Zp.shape[0], Zp.shape[1] - 1
    qp_iters, wi = plain.qp_iterations, plain.warm_qp_iters
    lm, x_only = plain.lm, plain._mirror_x_only
    inside = dict(mirror_lm=lm, mirror_x_only=x_only)
    max_abs = 0.0

    def agree(label, out, ref, scale):
        nonlocal max_abs
        errs = {f: rel_err(getattr(out, f), getattr(ref, f)) for f in fields if f != "dz"}
        d = float((out.dz - ref.dz).abs().max())
        errs["dz"] = d / max(float(ref.dz.abs().max()), scale, 1e-12)
        max_abs = max(max_abs, d)
        print(f"phase {phase}: QP {label} B={B} N={n} nu={nu} nx={nx} nh={ocp.nh}: rel err "
              + ", ".join(f"{f} {e:.3e}" for f, e in errs.items()))
        check(all(bool(torch.isfinite(getattr(out, f)).all()) for f in fields),
              f"QP kernel gave non-finite values ({label}, B={B}, N={n})")
        check(max(errs.values()) < 5e-3, f"QP kernel disagrees with plain ({label}, B={B}, N={n}): {errs}")

    qp_raw = plain._linearize(Zp, P, raw_hessian=True)
    qp = cuda_qp._mirrored(qp_raw, nu, lm, x_only)  # = plain._linearize(Zp, P)
    solve_qp(qp, nu, nx, iterations=1)  # warm-up of the plain path
    ref, plain_ms = event_ms(torch, lambda: solve_qp(cuda_qp._mirrored(qp_raw, nu, lm, x_only), nu, nx,
                                                     iterations=qp_iters, mehrotra=True))
    step = float(ref.dz.abs().max())
    out = cuda_qp.solve_qp_cuda(qp_raw, nu, nx, iterations=qp_iters, mehrotra=True, **inside)
    agree("MIRROR inside, cold+Mehrotra", out, ref, step)
    agree("cold+Mehrotra", cuda_qp.solve_qp_cuda(qp, nu, nx, iterations=qp_iters, mehrotra=True),
          ref, step)
    ok = ref.mu < 1e-2
    qp1_raw = plain._linearize(Zp + ref.dz, P, raw_hessian=True)
    qp1 = cuda_qp._mirrored(qp1_raw, nu, lm, x_only)
    warm = (ref.lam_l, ref.lam_u, ok)
    ref2 = solve_qp(qp1, nu, nx, iterations=wi, warm_duals=warm, mehrotra=False)
    label = f"warm duals ({int(ok.sum())}/{B} ok)+fixed sigma"
    agree("MIRROR inside, " + label,
          cuda_qp.solve_qp_cuda(qp1_raw, nu, nx, iterations=wi, warm_duals=warm, mehrotra=False,
                                **inside), ref2, step)
    agree(label, cuda_qp.solve_qp_cuda(qp1, nu, nx, iterations=wi, warm_duals=warm, mehrotra=False),
          ref2, step)
    torch.cuda.synchronize()

    def two_step():  # what the unfused route launched before: K2 on the stack, then K1
        H = mirror_nvar(qp_raw.H.reshape(-1, nvar, nvar), lm, nu, x_only, cuda_qp.mirror_cuda)
        return cuda_qp.solve_qp_cuda(qp_raw._replace(H=H.reshape(qp_raw.H.shape)), nu, nx,
                                     iterations=qp_iters)

    work = batch_work(cuda_qp.qp_work(n, nu, nx, ocp.nh, qp_iters, mirror=True,
                                      mirror_x_only=x_only), B)
    ms = cuda_ms(torch, lambda: cuda_qp.solve_qp_cuda(qp_raw, nu, nx, iterations=qp_iters, **inside), 20)
    two_ms = cuda_ms(torch, two_step, 20)
    alone_ms = cuda_ms(torch, lambda: cuda_qp.solve_qp_cuda(qp, nu, nx, iterations=qp_iters), 20)
    print(f"phase {phase}: QP cold solve B={B}, N={n}, nu={nu}, nx={nx}, nh={ocp.nh}, {qp_iters} IP "
          f"iterations: kernel with the MIRROR inside ({'x-only' if x_only else 'full'}) {ms:.3f} ms, "
          f"{bound_text(ms, work)}; K2 then K1 (two launches and the slices between) {two_ms:.3f} ms; "
          f"K1 alone on regularized Hessians {alone_ms:.3f} ms; plain (MIRROR + QP) {plain_ms:.3f} ms "
          f"[{card}]")
    if B <= ROBOT_BATCH:  # a lone warp per SM: what the predictor's extra solve and passes cost
        t = cuda_ms(torch, lambda: cuda_qp.solve_qp_cuda(qp_raw, nu, nx, iterations=qp_iters,
                                                         mehrotra=False, **inside), 20)
        print(f"phase {phase}: QP cold solve B={B}, fixed sigma instead of Mehrotra (one linear "
              f"solve and 7 row passes an iteration instead of two and 12): kernel {t:.3f} ms [{card}]")
    # Where the launcher changes path: the largest batch whose QPs it stages in
    # shared memory, and one element more (read from global memory).
    ext = cuda_qp.load_kernels()
    resident = ext.qp_resident_blocks(ext.qp_shared_bytes(n, nu, nx, ocp.nh, True, True))
    if resident < B:
        for b in (resident, resident + 1):
            part = qp_raw._replace(**{f: getattr(qp_raw, f)[:b] for f in qp_raw._fields})
            t = cuda_ms(torch, lambda: cuda_qp.solve_qp_cuda(part, nu, nx, iterations=qp_iters,
                                                             **inside), 20)
            where = "staged in shared memory" if b == resident else "read from global memory"
            print(f"phase {phase}: QP cold solve B={b} ({where}): kernel {t:.3f} ms [{card}]")
    sys.stdout.flush()
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

    plain_times = {}

    def compare(label, start, args):
        nonlocal max_abs
        ref_res, plain_times[label] = event_ms(torch, lambda: solve_rti_torch(start, P, ocp, **args))
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
    plain_ms = plain_times["cold"]
    print(f"phase {phase}: K3 cold solve, {RTI_ITERATIONS} RTI, N={Zp.shape[1] - 1}: B={B} kernel "
          f"{ms:.3f} ms, {bound_text(ms, batch_work(work, B))}, plain {plain_ms:.3f} ms (one call, the "
          f"first of its shape) [{card}]")
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


def contouring_closed_loop(dev, planner, state, data, cycles, label):
    """`cycles` cycles of a contouring planner on the corridor scene: the
    state advanced by the port's dynamics (inputs beyond a and w, a slack,
    at 0), the pedestrians walked. Every cycle must succeed. Returns Z of
    cycle 1, the cycle times, the selected planner per cycle (None without
    a guidance module), the least pedestrian distance and the progress."""
    import torch

    cfg, m = planner.cfg, planner.model
    module = planner.modules.get("GuidanceConstraints")
    x_start = state.get("x")
    Z_first, times, selected, d_min = None, [], [], np.inf
    for cycle in range(cycles):
        t0 = time.perf_counter()
        out_p = planner.solve_mpc(state, data)
        times.append(time.perf_counter() - t0)
        check(out_p.success, f"{label} planner cycle {cycle} failed")
        if Z_first is None:
            Z_first = planner._Z.copy()
        selected.append(None if module is None else module._selected_planner)
        u = [planner.get_solution(0, name) for name in m.inputs]
        x = [state.get(name) for name in m.states]
        x_next = m.discrete_dynamics(torch.as_tensor(np.array(u + x), dtype=torch.float32, device=dev),
                                     None, cfg.dt)
        for name, value in zip(m.states, x_next.cpu().numpy()):
            state.set(name, value)
        walk_pedestrians(state, data, cfg)
        blk = data.obstacle_block
        real = blk.index >= 0
        d_min = min(d_min, float(np.linalg.norm(blk.position[real] - state.get_position(),
                                                axis=1).min()))
    return Z_first, times, selected, d_min, state.get("x") - x_start


def fused_phases(dev, card, stage_code, Z0, P, x0, Zp, plain_solver, make_planner, closed_loop,
                 Z_torch_first):
    """Phases 7-10: the fused route (K3). Returns K3's record for the
    kernels line and its launch count over phase 9's planner loop."""
    import torch

    from mpc_planner_tpu_torch.ops import cuda_qp
    from mpc_planner_tpu_torch.solver.ocp import OCP
    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS, SQPSolver

    ocp = stage_code.ocp
    solver = SQPSolver(OCP(ocp.model, ocp.modules, ocp.cfg), device=dev)
    check(solver.rti_fused, f"rti_fused='auto' did not resolve on: {solver.rti_fused_reason}")

    # -- 7. K3's linearization vs the unfused one ---------------------------------
    check_linearization(7, solver, stage_code, plain_solver, Zp, P)
    # -- 8. K3 vs plain, cold then warm ------------------------------------------
    rti_record = check_rti(8, card, solver, stage_code, Zp, P, x0)

    # -- 9. planner closed loop on the fused route ----------------------------------
    planner, (state, data) = make_planner("auto")  # rti_fused="auto": the default route
    check(planner.solver.rti_fused,
          f"rti_fused='auto' did not resolve on: {planner.solver.rti_fused_reason}")
    cuda_qp.reset_launch_counts()
    Z_first, times, d0, d1 = closed_loop(planner, state, data, PLANNER_CYCLES)
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
    fused = SQPSolver(OCP(model, ocp_t.modules, solver_cfg(FLAGSHIP_N)), device=dev)
    check(fused.rti_fused, f"the flagship solver did not take the fused route: {fused.rti_fused_reason}")
    check_linearization(14, fused, fused._stage_code, plain, Zp, P)
    rti_record = check_rti(14, card, fused, fused._stage_code, Zp, P, x0)
    fused_r = SQPSolver(OCP(model_r, ocp_r.modules, solver_cfg(N)), device=dev)
    check(fused_r.rti_fused, "the flagship solver at the robot's horizon did not take the fused route")
    check_linearization(14, fused_r, fused_r._stage_code, plain_r, Zr, P_r)
    rti_robot_record = check_rti(14, card, fused_r, fused_r._stage_code, Zr, P_r, x0_r, with_b1=False)

    # -- 15. the flagship planner, closed loop, on both routes ---------------------------------
    goldens = {n: np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                       "golden", name))["Z"]
               for n, name in ((15, "tmpc_corridor.npz"), (30, "tmpc_corridor_n30.npz"))}

    def make_planner(route, cfg=None, scene=(12, SEED)):
        solver = dict(unfused=dict(rti_fused="off"), fused={}, torch=dict(qp_backend="torch"))[route]
        if cfg is None:
            cfg, m, mods = presets.system_jackalsimulator("tmpc")
        else:
            m, mods = presets.configuration_tmpc(cfg)
        cfg = cfg.replace(solver=cfg.solver.__class__(**solver))
        planner = Planner(m, mods, cfg, device=dev)
        state, data = presets.corridor_scene(cfg, n_pedestrians=scene[0], seed=scene[1])
        planner.on_data_received(data, "reference_path")
        return planner, state, data

    planner_t, state_t, data_t = make_planner("torch")
    t0 = time.perf_counter()
    check(planner_t.solve_mpc(state_t, data_t).success, "flagship torch-backend cycle 1 failed")
    torch_cycle_s = time.perf_counter() - t0
    Z_torch_first = planner_t._Z.copy()
    print(f"phase 15: flagship torch backend on the card: cycle 1 {torch_cycle_s * 1e3:.1f} ms [{card}]")
    launches = {}
    scopes = ("planning", "update", "guidance_update", "set_parameters", "optimization",
              "tmpc_host_assemble", "tmpc_dispatch_solve_pull", "tmpc_escalation")
    # rti_fused="auto" (the default) must resolve on; "off" asks for the unfused
    # route, K1 with the MIRROR inside, at a cut depth (it is host-bound)
    for route, kernels, absent, cycles in (("unfused", ("qp",), ("mirror", "rti"), UNFUSED_CYCLES),
                                           ("fused", ("rti",), ("qp", "mirror"), PLANNER_CYCLES)):
        planner, state, data = make_planner(route)
        check(planner.solver.qp_backend == "cuda" and planner.solver.rti_fused == (route == "fused"),
              f"flagship {route} route: backend {planner.solver.qp_backend}, fused "
              f"{planner.solver.rti_fused} ({planner.solver.rti_fused_reason})")
        cuda_qp.reset_launch_counts()
        Z_first, times, selected, d_min, progress = contouring_closed_loop(
            dev, planner, state, data, cycles, f"flagship {route}")
        launches[route] = dict(cuda_qp.launch_counts)
        diff = float(np.abs(Z_torch_first - Z_first).max())
        print(f"phase 15: flagship {route}: {cycles}/{cycles} cycles succeeded, "
              f"{progress:.2f} m of progress; cycle time median {np.median(times[1:]) * 1e3:.2f} ms, "
              f"max {np.max(times[1:]) * 1e3:.2f} ms [{card}] (first {times[0] * 1e3:.1f} ms); "
              f"selected planner per cycle {selected}; least pedestrian distance {d_min:.3f} m; "
              f"cycle 1 Z vs the torch backend: max |d| = {diff:.3e}; kernel launches "
              f"{launches[route]}")
        stats = planner.profiler.stats
        print(f"phase 15: flagship {route}: launches per cycle over {cycles} cycles: "
              + ", ".join(f"K{i} {launches[route][k] / cycles:.2f}"
                          for i, k in ((1, "qp"), (2, "mirror"), (3, "rti"))))
        print(f"phase 15: flagship {route} host scopes, median ms over {cycles} cycles: "
              + ", ".join(f"{k} {stats[k].median * 1e3:.2f} (n={stats[k].count})"
                          for k in scopes if k in stats))
        check(diff < 5e-3, f"flagship {route}: cycle 1 differs from the torch backend")
        check(progress > 0.5, f"flagship {route}: the robot made no progress")
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
    unfused = SQPSolver(OCP(model, ocp_t.modules, solver_cfg(FLAGSHIP_N, rti_fused="off")), device=dev)
    for label, solver, cycles in (("K1", unfused, HOST_BOUND_WARM_CYCLES), ("K3", fused, WARM_CYCLES),
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

    records = dict(qp=dict(launches=launches["unfused"]["qp"], **qp_record),
                   mirror=dict(launches=launches["unfused"]["mirror"], **mirror_record),  # 0: checked above
                   rti=dict(launches=launches["fused"]["rti"], **rti_record),
                   qp_robot=dict(launches=launches["unfused"]["qp"], **qp_robot_record),
                   rti_robot=dict(launches=launches["fused"]["rti"], **rti_robot_record))
    # what phases 23 and 24 take: the QP data of cells D and C, cell D's batch,
    # cycle 1 of cell C on the torch backend
    inputs = dict(qps={f"cell D (B={BATCH}, N={FLAGSHIP_N})": (plain, Zp, P),
                       f"cell C (B={ROBOT_BATCH}, N={N})": (plain_r, Zr, P_r)},
                  batch=(Zb, P, x0), torch_cycle_Z=Z_torch_first)
    return records, inputs


def family_presets():
    """name -> a function that builds (cfg, model, modules) afresh: the OCP
    families of phases 17-19 at their systems' horizons."""
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.utils.config import default_config

    def bicycle():
        cfg = default_config(N=N)
        return (cfg, *presets.configuration_bicycle(cfg))

    return {"jackal_tmpc": lambda: presets.system_jackal("tmpc"),  # N=30, nh=24 (Gaussian)
            "bicycle": bicycle,  # nu=3, nx=6, N=30
            "dingo_pointmass": lambda: presets.system_dingo("lmpcc"),  # nu=2, nx=4, N=30
            "rosnavigation_tmpc": lambda: presets.system_rosnavigation("tmpc")}  # nu=3, nx=5, N=20


def remaining_phases(dev, card, codes, build_s):
    """Phases 17-19: the OCP families of the remaining modules and models.
    `codes`: name -> the stage code built in phase 2. Returns the kernels
    line's entries of K1 and K3 at the new shapes, name -> (K1's, K3's)."""
    import torch

    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.ops import cuda_qp
    from mpc_planner_tpu_torch.planner import Planner
    from mpc_planner_tpu_torch.solver.ocp import OCP
    from mpc_planner_tpu_torch.solver.sqp import SQPSolver

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    makers = family_presets()
    entries = {}

    def with_solver(cfg, **solver):
        return cfg.replace(solver=dataclasses.replace(cfg.solver, **solver))

    def agreement(phase, name, batch, n_pedestrians, costmap):
        """K1 (MIRROR inside) and K3 against their plain versions at this
        family's shape, around perturbed converged plans of `batch` copies of
        one instance on the corridor scene."""
        cfg, model, modules = makers[name]()
        code, nu = codes[name], model.nu
        ocp_t, Z0, P0, xinit = presets.preset_problem(
            with_solver(cfg, qp_backend="torch", iterations=RTI_ITERATIONS), model, modules,
            n_pedestrians=n_pedestrians, seed=SEED, costmap=costmap)
        plain = SQPSolver(ocp_t, device=dev)
        Zb = np.tile(Z0[None], (batch, 1, 1)).astype(np.float32)
        Zb[:, 1:, nu:] += rng.normal(0, 0.05, Zb[:, 1:, nu:].shape).astype(np.float32)
        P = torch.as_tensor(P0, dtype=torch.float32, device=dev).expand(batch, -1, -1)
        x0 = torch.as_tensor(xinit, dtype=torch.float32, device=dev).expand(batch, -1)
        Zs = plain.batch_impl(torch.as_tensor(Zb, device=dev), P, x0, RTI_ITERATIONS).Z
        Zp = Zs + 0.01 * torch.randn(Zs.shape, device=dev, generator=gen)
        Zp[:, 0, nu:] = x0
        print(f"phase {phase}: {name}: nu={nu}, nx={model.nx}, nh={ocp_t.nh}, nrows="
              f"{ocp_t.nvar + ocp_t.nh}, npar={ocp_t.npar}, N={cfg.N}, B={batch}; MIRROR "
              f"{'x-only' if plain._mirror_x_only else 'full'}; K3 generated and built in "
              f"{build_s['rti_' + name]:.1f} s")
        qp_record = check_qp(phase, card, plain, Zp, P)
        fused = SQPSolver(OCP(model, modules, with_solver(cfg, iterations=RTI_ITERATIONS)), device=dev)
        check(fused.rti_fused and fused.qp_backend == "cuda",
              f"{name}: rti_fused='auto' did not resolve on: {fused.rti_fused_reason}")
        check_linearization(phase, fused, code, plain, Zp, P)
        rti_record = check_rti(phase, card, fused, code, Zp, P, x0, with_b1=False)
        return qp_record, rti_record

    # -- 17. cell E, the real Jackal: T-MPC++ with Gaussian chance constraints -----------
    qp_e, rti_e = agreement(17, "jackal_tmpc", ROBOT_BATCH, 12, False)

    def jackal(device=None, **solver):
        cfg, model, modules = makers["jackal_tmpc"]()
        cfg = with_solver(cfg, **solver)
        # no device given: the port's default, the card
        planner = Planner(model, modules, cfg) if device is None else Planner(model, modules, cfg,
                                                                             device=device)
        state, data = presets.corridor_scene(cfg, n_pedestrians=12, seed=SEED)
        planner.on_data_received(data, "reference_path")
        return planner, state, data

    planner_t, state_t, data_t = jackal(dev, qp_backend="torch")
    check(planner_t.solve_mpc(state_t, data_t).success, "cell E: torch-backend cycle 1 failed")
    Z_torch_first = planner_t._Z.copy()
    launches = {}
    for route, solver, kernels, absent, cycles in (
            ("default", {}, ("rti",), ("qp", "mirror"), PLANNER_CYCLES),
            ("unfused", dict(rti_fused="off"), ("qp",), ("mirror", "rti"), UNFUSED_CYCLES)):
        planner, state, data = jackal(**solver)
        s = planner.solver
        check(s.device.type == "cuda" and s.qp_backend == "cuda",
              f"cell E {route}: device {s.device}, backend {s.qp_backend}")
        check(s.rti_fused == (route == "default"),
              f"cell E {route}: fused {s.rti_fused} ({s.rti_fused_reason})")
        cuda_qp.reset_launch_counts()
        Z_first, times, selected, d_min, progress = contouring_closed_loop(
            dev, planner, state, data, cycles, f"cell E {route}")
        launches[route] = dict(cuda_qp.launch_counts)
        diff = float(np.abs(Z_torch_first - Z_first).max())
        print(f"phase 17: cell E (system_jackal('tmpc'), Gaussian submodule, N={planner.N}, B="
              f"{ROBOT_BATCH}) {route} route: {cycles}/{cycles} cycles succeeded, "
              f"{progress:.2f} m of progress; cycle time median {np.median(times[1:]) * 1e3:.2f} ms, "
              f"max {np.max(times[1:]) * 1e3:.2f} ms [{card}] (first {times[0] * 1e3:.1f} ms); "
              f"selected planner per cycle {selected}; least pedestrian distance {d_min:.3f} m; "
              f"cycle 1 Z vs the torch backend: max |d| = {diff:.3e}; kernel launches "
              f"{launches[route]}; per cycle: "
              + ", ".join(f"K{i} {launches[route][k] / cycles:.2f}"
                          for i, k in ((1, "qp"), (2, "mirror"), (3, "rti"))))
        check(diff < 5e-3, f"cell E {route}: cycle 1 differs from the torch backend")
        check(progress > (1.0 if route == "default" else 0.5), f"cell E {route}: the robot made no progress")
        check(bool(np.isfinite(planner._Z).all()), f"cell E {route}: non-finite plan")
        for k in kernels:
            check(launches[route][k] > 0, f"cell E {route}: the {k} kernel never launched")
        for k in absent:
            check(launches[route][k] == 0, f"cell E {route}: the {k} kernel launched")
        sys.stdout.flush()
    entries["jackal_tmpc_robot_batch"] = (dict(launches=launches["unfused"]["qp"], **qp_e),
                                          dict(launches=launches["default"]["rti"], **rti_e))

    # -- 18, 19. the shapes no run had touched, at B=1024, and one planner cycle each -------
    for phase, name, costmap in ((18, "bicycle", False), (18, "dingo_pointmass", False),
                                 (19, "rosnavigation_tmpc", True)):
        qp_record, rti_record = agreement(phase, name, BATCH, 8, costmap)
        counts = {}
        for route, solver in (("default", {}), ("unfused", dict(rti_fused="off"))):
            cfg, model, modules = makers[name]()
            c = with_solver(cfg, **solver)
            planner = Planner(model, modules, c)  # no device given: the card
            state, data = presets.corridor_scene(c, n_pedestrians=8, seed=SEED)
            if costmap:
                data.costmap, data.costmap_meta = presets.two_wall_costmap(SEED)
            state.set("v", 1.0)
            planner.on_data_received(data, "reference_path")
            check(planner.solver.rti_fused == (route == "default"),
                  f"{name} {route}: fused {planner.solver.rti_fused} "
                  f"({planner.solver.rti_fused_reason})")
            cuda_qp.reset_launch_counts()
            t0 = time.perf_counter()
            out = planner.solve_mpc(state, data)
            cycle_s = time.perf_counter() - t0
            counts[route] = dict(cuda_qp.launch_counts)
            check(out.success, f"{name} {route}: the planner cycle failed")
            check(bool(np.isfinite(planner._Z).all()), f"{name} {route}: non-finite plan")
            print(f"phase {phase}: {name} {route} route: one planner cycle through solve_mpc "
                  f"succeeded in {cycle_s * 1e3:.1f} ms (the first of its kind) [{card}]; kernel "
                  f"launches {counts[route]}")
        check(counts["default"]["rti"] > 0 and counts["default"]["qp"] == 0,
              f"{name}: the default route launched {counts['default']}")
        check(counts["unfused"]["qp"] > 0 and counts["unfused"]["mirror"] == 0
              and counts["unfused"]["rti"] == 0, f"{name}: the unfused route launched {counts['unfused']}")
        entries[name] = (dict(launches=counts["unfused"]["qp"], **qp_record),
                         dict(launches=counts["default"]["rti"], **rti_record))
        sys.stdout.flush()
    return entries


def scenario_presets():
    """name -> a function that builds (cfg, model, modules) afresh, with
    keyword overrides of the SH-MPC section: the SH-MPC OCPs of phases 20-21
    at their systems' horizons, the draw sized from the risk."""
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.utils.config import ScenarioConfig

    def make(system, variant):
        return lambda **scenario: presets.select_system(
            system, variant, scenario_constraints=ScenarioConfig(**scenario))

    return {"shmpc": make("jackalsimulator", "safe_horizon"),  # nu=3, nx=5, nh=24, N=30
            "shmpc_hard": make("jackalsimulator", "safe_horizon_hard"),  # nu=2, nx=5
            "rosnavigation_shmpc": make("rosnavigation", "safe_horizon")}  # nh=36, N=20


@contextlib.contextmanager
def recorded_steps(planner):
    """Keep every SH-MPC device step that `planner` runs meanwhile: a list
    of dicts with the solve's inputs (P, Z0, xinit, n_iter) and solutions
    (Z of every solver), the packed result as
    numpy, the step's wall time with the card synchronized before and after
    (step_ms), and the batched solve's time by CUDA events (solve_ms)."""
    import torch

    module, solver = planner.modules.get("ScenarioConstraints"), planner.solver
    solve, fused_step = solver.batch_impl, module._fused_step
    steps = []

    def timed_solve(Z0, P, xinit, n_iter, *args, **kwargs):
        res, steps[-1]["solve_ms"] = event_ms(torch, lambda: solve(Z0, P, xinit, n_iter, *args, **kwargs))
        steps[-1].update(P=P, Z0=Z0, xinit=xinit, n_iter=n_iter, Z=res.Z)
        return res

    def timed_step(*args, **kwargs):
        steps.append({})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fused_step(*args, **kwargs)
        torch.cuda.synchronize()
        steps[-1].update(step_ms=(time.perf_counter() - t0) * 1e3, packed=out[0].cpu().numpy())
        return out

    solver.batch_impl, module._fused_step = timed_solve, timed_step
    try:
        yield steps
    finally:
        del solver.batch_impl, module._fused_step


def device_breakdown(phase, label, card, fn):
    """One call of fn() under torch.profiler: its wall time (the card
    synchronized after it), the device time summed over its kernels, the
    idle share 1 - device / wall, and the five kernels with the most device
    time. Where the profiler sees no kernel, the device time is printed as
    not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms <= 0:
        print(f"phase {phase}: {label} under torch.profiler: wall {wall_ms:.1f} ms; device time not "
              f"measured (the profiler saw no kernel) [{card}]")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    print(f"phase {phase}: {label} under torch.profiler: wall {wall_ms:.1f} ms, device busy "
          f"{device_ms:.2f} ms in {sum(e.count for e in kernels)} kernel launches, idle share "
          f"{1 - device_ms / wall_ms:.3f}; most device time: "
          + "; ".join(f"{e.key[:70]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}" for e in top)
          + f" [{card}]")
    sys.stdout.flush()


def scenario_phases(dev, card, codes, build_s):
    """Phases 20-21: SH-MPC. `codes`: name -> the stage code built in phase
    2. Returns the kernels line's entries of K1 and K3 at the SH-MPC shapes,
    name -> (K1's, K3's)."""
    import torch

    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.ops import cuda_qp
    from mpc_planner_tpu_torch.planner import Planner
    from mpc_planner_tpu_torch.sim import ClosedLoopSimulator

    makers = scenario_presets()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    entries = {}

    def planner_of(name, device=dev, costmap=False, **solver):
        cfg, model, modules = makers[name]()
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, **solver))
        # device None: the port's default, the card
        planner = Planner(model, modules, cfg) if device is None else Planner(model, modules, cfg,
                                                                             device=device)
        state, data = presets.corridor_scene(cfg, n_pedestrians=12, seed=SEED)
        if costmap:
            data.costmap, data.costmap_meta = presets.two_wall_costmap(SEED)
        planner.on_data_received(data, "reference_path")
        return planner, state, data

    def agreement(phase, name, costmap):
        """Two cycles of `name` on the default route and on the torch backend
        (on the card), each from identical inputs; both draw with one CUDA
        generator. Cycle 1, from the scene's start: bit-equal P, equal
        support counts and pruning flags, certificates within 1e-5, the
        winner's Z within 5e-3. Cycle 2, from cycle 1's plan on the default
        route (its stage-1 state, cold duals), where the scenario rows bind:
        bit-equal P; the accounting and the solutions are printed beside the
        same step solved by K3's plain version, unchecked (10 fixed-step RTI
        iterations from a plan that is not converged end where rounding
        takes them: PERF.md). Then K1 (MIRROR inside) and K3 against their
        plain versions at the scenario batch, around perturbed converged
        plans of cycle 1's P. Returns (K1's record, K3's record, the default
        route's launch counts over its two cycles, its planner, state and
        data)."""
        from mpc_planner_tpu_torch.ops.rti import solve_rti_torch

        runs = {route: planner_of(name, costmap=costmap, **solver)
                for route, solver in (("default", {}), ("torch", dict(qp_backend="torch")))}
        for route, (planner, _, _) in runs.items():
            check(planner.solver.rti_fused == (route == "default"),
                  f"{name} {route}: fused {planner.solver.rti_fused} ({planner.solver.rti_fused_reason})")
        lead, follower = runs["default"][0], runs["torch"][0]
        module = lead.modules.get("ScenarioConstraints")
        B, ocp = module.cfg.scenario_constraints.parallel_solvers, lead.ocp
        counts = dict.fromkeys(cuda_qp.launch_counts, 0)
        first = {}
        for cycle in (1, 2):
            if cycle == 2:  # identical inputs: cycle 1's plan on the default route, cold duals
                follower._Z, follower._output = lead._Z.copy(), lead._output
                for planner in (lead, follower):
                    planner.modules.get("ScenarioConstraints")._prev_duals = None
                    planner.modules.get("Contouring").closest_segment = \
                        lead.modules.get("Contouring").closest_segment
                x1 = lead._Z[1, ocp.nu:].copy()
                for _, state, _ in runs.values():
                    state.from_array(x1)
            steps, success = {}, {}
            for route, (planner, state, data) in runs.items():
                cuda_qp.reset_launch_counts()
                with recorded_steps(planner) as steps[route]:
                    t0 = time.perf_counter()
                    success[route] = planner.solve_mpc(state, data).success
                    cycle_s = time.perf_counter() - t0
                if route == "default":
                    counts = {k: counts[k] + v for k, v in cuda_qp.launch_counts.items()}
                print(f"phase {phase}: {name} {route}: cycle {cycle} in {cycle_s * 1e3:.1f} ms (the card "
                      f"synchronized around each device step), device steps "
                      + ", ".join(f"{s['step_ms']:.2f} ms (batched solve {s['solve_ms']:.2f})"
                                  for s in steps[route]) + f"; success {success[route]} [{card}]")
            ut, uk = (module._unpack(steps[r][0]["packed"], B) for r in ("torch", "default"))
            p_equal = torch.equal(steps["torch"][0]["P"], steps["default"][0]["P"])
            cert_d = float(np.abs(ut[7] - uk[7]).max())
            z_d = float(np.abs(ut[0] - uk[0]).max())
            print(f"phase {phase}: {name} (nu={ocp.nu}, nx={ocp.nx}, nh={ocp.nh}, npar={ocp.npar}, "
                  f"N={ocp.N}, {B} solvers x {module.n_samples} samples) cycle {cycle}: device step on "
                  f"K3 vs the torch backend: P bit-equal {p_equal}; support {uk[6].tolist()} vs "
                  f"{ut[6].tolist()}; pruning exact {uk[8].tolist()} vs {ut[8].tolist()}; certificate "
                  f"{uk[7].round(4).tolist()}, max |d| {cert_d:.2e}; exit codes {uk[3].tolist()} vs "
                  f"{ut[3].tolist()}; winner {uk[1]} vs {ut[1]}, its Z max |d| {z_d:.2e}")
            check(p_equal, f"{name} cycle {cycle}: the device steps' parameter blocks differ")
            if cycle == 1:
                check(success["default"] and success["torch"], f"{name} cycle 1: planner success {success}")
                check(np.array_equal(ut[6], uk[6]) and np.array_equal(ut[8], uk[8]),
                      f"{name} cycle 1: support counts or pruning flags differ")
                check(cert_d < 1e-5 and z_d < 5e-3, f"{name} cycle 1: certificate or the winner's Z differ")
                first = steps["torch"][0]
            else:  # the same step solved by K3's plain version
                s, fused = steps["default"][0], lead.solver
                Zc = s["Z0"].clone()
                Zc[:, 0, ocp.nu:] = s["xinit"]
                plain_Z = solve_rti_torch(
                    Zc, s["P"], ocp, num_iterations=s["n_iter"], it0=fused.qp_iterations,
                    warm_iters=fused.warm_qp_iters, mu0=fused.mu0, sigma_fixed=fused.warm_sigma,
                    lm=fused.lm, mirror_x_only=fused._mirror_x_only, lb_template=fused._lb_template,
                    ub_template=fused._ub_template).Z
                per = {label: (Z - plain_Z).abs().amax(dim=(1, 2)).tolist()
                       for label, Z in (("K3", s["Z"]), ("torch backend", steps["torch"][0]["Z"]))}
                print(f"phase {phase}: {name} cycle 2 (not checked): max |Z - Z of K3's plain version| "
                      f"per solver: " + "; ".join(f"{k} {[f'{v:.2e}' for v in vs]}" for k, vs in per.items()))
        print(f"phase {phase}: {name}: K3 generated and built in {build_s['rti_' + name]:.1f} s")

        plain, fused = follower.solver, lead.solver
        P, Z0, x0 = (first[k] for k in ("P", "Z0", "xinit"))
        Zs = plain.batch_impl(Z0, P, x0, RTI_ITERATIONS).Z
        Zp = Zs + 0.01 * torch.randn(Zs.shape, device=dev, generator=gen)
        Zp[:, 0, ocp.nu:] = x0
        qp_record = check_qp(phase, card, plain, Zp, P)
        check_linearization(phase, fused, codes[name], plain, Zp, P)
        rti_record = check_rti(phase, card, fused, codes[name], Zp, P, x0, with_b1=False)
        return (qp_record, rti_record, counts) + runs["default"]

    # -- 20. cell F: SH-MPC on the slack model --------------------------------------------
    qp_f, rti_f, _, planner, state, data = agreement(20, "shmpc", False)
    device_breakdown(20, "cell F, a third cycle of that default-route planner", card,
                     lambda: planner.solve_mpc(state, data))
    cfg, _, _ = makers["shmpc"]()
    _, scene = presets.corridor_scene(cfg, n_pedestrians=12, seed=SEED)

    launches = {}
    for route, solver, steps, kernels, absent in (
            ("default", {}, PLANNER_CYCLES, ("rti",), ("qp", "mirror")),
            ("unfused", dict(rti_fused="off"), SHMPC_UNFUSED_STEPS, ("qp",), ("mirror", "rti"))):
        c, model, modules = makers["shmpc"]()
        c = c.replace(solver=dataclasses.replace(c.solver, **solver))
        planner = Planner(model, modules, c)  # no device given: the card
        s = planner.solver
        check(s.device.type == "cuda" and s.qp_backend == "cuda" and s.rti_fused == (route == "default"),
              f"cell F {route}: device {s.device}, backend {s.qp_backend}, fused {s.rti_fused} "
              f"({s.rti_fused_reason})")
        sim = ClosedLoopSimulator(planner, c, scene_pedestrians(cfg, scene), scene.reference_path)
        cuda_qp.reset_launch_counts()
        res = sim.run(max_steps=steps)
        launches[route] = dict(cuda_qp.launch_counts)
        records = res.module_records
        certs = [r["scenario_risk_certificate"] for r in records]
        valid = [r["scenario_cert_valid"] for r in records]
        times = np.asarray(res.cycle_times[1:]) * 1e3
        stats = planner.profiler.stats
        print(f"phase 20: cell F (system_jackalsimulator('safe_horizon'), N={c.N}, "
              f"{c.scenario_constraints.parallel_solvers} solvers x {records[0]['scenario_n_samples']} "
              f"samples, 12 pedestrians) {route} route through ClosedLoopSimulator: {res.steps} steps, "
              f"{res.collisions} collisions, {res.infeasible_cycles} infeasible cycles, "
              f"{res.trajectory[-1][0]:.2f} m of progress; cycle time median {np.median(times):.2f} ms, "
              f"max {np.max(times):.2f} ms [{card}] (first {res.cycle_times[0] * 1e3:.1f} ms); valid "
              f"certificate in {sum(valid)}/{len(valid)} cycles, median certificate "
              f"{np.median(certs):.4f}, per cycle {[round(e, 4) for e in certs]}; selected solver "
              f"{[r['scenario_selected_solver'] for r in records]}; kernel launches {launches[route]}; per "
              f"cycle: " + ", ".join(f"K{i} {launches[route][k] / res.steps:.2f}"
                                     for i, k in ((1, "qp"), (2, "mirror"), (3, "rti"))))
        print(f"phase 20: cell F {route} host scopes, median ms over {res.steps} cycles: "
              + ", ".join(f"{k} {stats[k].median * 1e3:.2f} (n={stats[k].count})"
                          for k in ("planning", "update", "set_parameters", "optimization",
                                    "scenario_host_assemble", "scenario_dispatch_solve_pull",
                                    "scenario_escalation") if k in stats))
        check(res.steps == steps and res.collisions == 0, f"cell F {route}: {res.collisions} collisions")
        check(res.trajectory[-1][0] > (1.0 if route == "default" else 0.0),
              f"cell F {route}: the robot made no progress")
        for k in kernels:
            check(launches[route][k] > 0, f"cell F {route}: the {k} kernel never launched")
        for k in absent:
            check(launches[route][k] == 0, f"cell F {route}: the {k} kernel launched")
        sys.stdout.flush()
    entries["shmpc"] = (dict(launches=launches["unfused"]["qp"], **qp_f),
                        dict(launches=launches["default"]["rti"], **rti_f))

    # One device step at BATCH scenario solvers (the draw sized for them)
    c, model, modules = makers["shmpc"](parallel_solvers=BATCH)
    planner = Planner(model, modules, c)
    state, data = presets.corridor_scene(c, n_pedestrians=12, seed=SEED)
    planner.on_data_received(data, "reference_path")
    module = planner.modules.get("ScenarioConstraints")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recorded_steps(planner) as steps:
        for cycle in range(2):  # cold, then warm (carried duals)
            check(planner.solve_mpc(state, data).success, f"{BATCH} scenario solvers: cycle {cycle} failed")
    peak = torch.cuda.max_memory_allocated()
    device_breakdown(20, f"{BATCH} scenario solvers, a third cycle", card,
                     lambda: planner.solve_mpc(state, data))
    for i, s in enumerate(steps):
        u = module._unpack(s["packed"], BATCH)
        print(f"phase 20: {BATCH} scenario solvers x {module.n_samples} samples, N={c.N}, device step "
              f"{i + 1}/{len(steps)}: {s['step_ms']:.1f} ms, of which the batched solve (K3) "
              f"{s['solve_ms']:.1f} ms ({100 * s['solve_ms'] / s['step_ms']:.1f}%); {int((u[3] == 1).sum())}/"
              f"{BATCH} feasible, winner {u[1]}, certificate {u[7][u[1]]:.4f} [{card}]")
        check(u[2] and bool(np.isfinite(u[0]).all()), f"{BATCH} scenario solvers: no feasible solver")
    print(f"phase 20: {BATCH} scenario solvers: peak device memory {peak / 2**30:.2f} GiB over "
          f"{len(steps)} device steps (draws [{BATCH}, {module.n_samples}, {c.max_obstacles}, {c.N - 1}, 2] "
          f"f32 = {BATCH * module.n_samples * c.max_obstacles * (c.N - 1) * 2 * 4 / 2**30:.2f} GiB) [{card}]")
    del planner, state, data, module, steps
    sys.stdout.flush()

    # -- 21. the other SH-MPC OCPs: one planner cycle on each route -----------------------------
    for name, costmap in (("shmpc_hard", False), ("rosnavigation_shmpc", True)):
        qp_record, rti_record, default_counts = agreement(21, name, costmap)[:3]
        planner, state, data = planner_of(name, device=None, costmap=costmap, rti_fused="off")
        check(planner.solver.qp_backend == "cuda" and not planner.solver.rti_fused,
              f"{name} unfused: fused {planner.solver.rti_fused}")
        cuda_qp.reset_launch_counts()
        t0 = time.perf_counter()
        out = planner.solve_mpc(state, data)
        cycle_s = time.perf_counter() - t0
        unfused_counts = dict(cuda_qp.launch_counts)
        check(out.success and bool(np.isfinite(planner._Z).all()), f"{name} unfused: the cycle failed")
        print(f"phase 21: {name} unfused route: one planner cycle through solve_mpc succeeded in "
              f"{cycle_s * 1e3:.1f} ms (the first of its kind) [{card}]; kernel launches {unfused_counts}")
        check(default_counts["rti"] > 0 and default_counts["qp"] == 0,
              f"{name}: the default route launched {default_counts}")
        check(unfused_counts["qp"] > 0 and unfused_counts["mirror"] == 0 and unfused_counts["rti"] == 0,
              f"{name}: the unfused route launched {unfused_counts}")
        entries[name] = (dict(launches=unfused_counts["qp"], **qp_record),
                         dict(launches=default_counts["rti"], **rti_record))
        sys.stdout.flush()
    return entries


def sampled_guidance_phase(dev, card):
    """Phase 22: cell C with the sampled guidance backend
    (guidance_backend="sampled", S=SAMPLED_SAMPLES candidates a cycle) through
    ClosedLoopSimulator, the device sweep held against its plain version on
    the CPU, and the sweep timed at S=512 and S=8192."""
    import torch

    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.guidance import device_prm
    from mpc_planner_tpu_torch.ops import cuda_qp
    from mpc_planner_tpu_torch.planner import Planner
    from mpc_planner_tpu_torch.sim import ClosedLoopSimulator
    from mpc_planner_tpu_torch.utils.config import default_config

    base = default_config()
    t_mpc = dataclasses.replace(base.t_mpc, guidance_backend="sampled", sampled_n_samples=SAMPLED_SAMPLES)
    captured = {}
    score = device_prm.score

    def recording(*args):  # the first sweep's inputs, kept for the checks below
        captured.setdefault("args", args)
        return score(*args)

    for route, solver, steps, kernels, absent in (
            ("default", {}, PLANNER_CYCLES, ("rti",), ("qp", "mirror")),
            ("unfused", dict(rti_fused="off"), SAMPLED_UNFUSED_STEPS, ("qp",), ("mirror", "rti"))):
        cfg, model, modules = presets.system_jackalsimulator(
            "tmpc", t_mpc=t_mpc, solver=dataclasses.replace(base.solver, **solver))
        planner = Planner(model, modules, cfg)  # no device given: the card
        s = planner.solver
        check(s.device.type == "cuda" and s.qp_backend == "cuda" and s.rti_fused == (route == "default"),
              f"cell C sampled {route}: device {s.device}, backend {s.qp_backend}, fused {s.rti_fused}")
        module = planner.modules.get("GuidanceConstraints")
        classes, update = [], module.update

        def counted(state, data, md, update=update, module=module, classes=classes):
            update(state, data, md)
            classes.append(len({(t.obstacle_ids, t.signature) for t in module._trajectories
                                if not t.braking}))

        module.update = counted
        _, scene = presets.corridor_scene(cfg, n_pedestrians=12, seed=SEED)
        sim = ClosedLoopSimulator(planner, cfg, scene_pedestrians(cfg, scene), scene.reference_path)
        device_prm.score = recording
        cuda_qp.reset_launch_counts()
        try:
            res = sim.run(max_steps=steps)
        finally:
            device_prm.score = score
        launches = dict(cuda_qp.launch_counts)
        check(isinstance(module.guidance, device_prm.DeviceSampledPlanner)
              and module.guidance.device.type == "cuda", "cell C sampled: the sweep is not on the card")
        times = np.asarray(res.cycle_times[1:]) * 1e3
        print(f"phase 22: cell C (system_jackalsimulator('tmpc'), N={cfg.N}, B={ROBOT_BATCH}) with "
              f"sampled guidance (S={SAMPLED_SAMPLES}) {route} route through ClosedLoopSimulator: "
              f"{res.steps} steps, {res.collisions} collisions, {res.infeasible_cycles} infeasible cycles, "
              f"{res.trajectory[-1][0]:.2f} m of progress; cycle time median {np.median(times):.2f} ms, "
              f"max {np.max(times):.2f} ms [{card}] (first {res.cycle_times[0] * 1e3:.1f} ms); guidance "
              f"classes per cycle {classes}; selected planner "
              f"{[r['guidance_selected_planner'] for r in res.module_records]}; kernel launches "
              f"{launches}; per cycle: " + ", ".join(f"K{i} {launches[k] / res.steps:.2f}"
                                                    for i, k in ((1, "qp"), (2, "mirror"), (3, "rti"))))
        check(res.steps == steps and res.infeasible_cycles == 0 and res.collisions == 0,
              f"cell C sampled {route}: {res.infeasible_cycles} infeasible cycles, "
              f"{res.collisions} collisions in {res.steps} steps")
        check(classes[0] >= 2, f"cell C sampled {route}: {classes[0]} guidance class(es) on cycle 1")
        check(res.trajectory[-1][0] > (1.0 if route == "default" else 0.0),
              f"cell C sampled {route}: the robot made no progress")
        for k in kernels:
            check(launches[k] > 0, f"cell C sampled {route}: the {k} kernel never launched")
        for k in absent:
            check(launches[k] == 0, f"cell C sampled {route}: the {k} kernel launched")
        sys.stdout.flush()

    # The sweep alone (draw + score, what the card runs per cycle) on cycle 1's
    # scene, and against the same function on the CPU from the same draws
    basis, start, goals, pred, clear, _, _, _, track, s_prof, weight = captured["args"]
    w_lat = float(np.float32(max(cfg.road.width / 2.0 - cfg.robot_radius, 0.5) + 1.0))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for S in (SAMPLED_SAMPLES, 8192):
        draws = device_prm.draw(gen, S, goals.shape[0], w_lat)
        scene_args = (basis, start, goals, pred, clear)

        def sweep():
            return device_prm.score(*scene_args, *device_prm.draw(gen, S, goals.shape[0], w_lat),
                                    track, s_prof, weight)

        ms = cuda_ms(torch, sweep, 20)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = device_prm.score(*scene_args, *draws, track, s_prof, weight)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        ref = device_prm.score(*(a.cpu() for a in scene_args + draws + (track, s_prof, weight)))
        errs = {name: rel_err(o.cpu(), r) for name, o, r in (("positions", out[0], ref[0]),
                                                             ("cost", out[2], ref[2]))}
        same = {name: bool(torch.equal(o.cpu(), r)) for name, o, r in (("side", out[1], ref[1]),
                                                                       ("feasible", out[3], ref[3]))}
        M = pred.shape[0]
        print(f"phase 22: sweep S={S}, M={M}, N={pred.shape[1] - 1}: draw + score {ms:.3f} ms on the card, "
              f"peak memory above the inputs {peak / 2**20:.1f} MiB (the [S, M, N+1, 2] distances "
              f"{S * M * pred.shape[1] * 2 * 4 / 2**20:.1f} MiB) [{card}]; vs the CPU on the same draws: "
              f"rel err positions {errs['positions']:.2e}, cost {errs['cost']:.2e}; side equal "
              f"{same['side']}, feasible equal {same['feasible']} ({int(ref[3].sum())}/{S} feasible)")
        check(max(errs.values()) < 1e-5 and all(same.values()),
              f"the sweep on the card disagrees with the CPU at S={S}: {errs}, {same}")
    sys.stdout.flush()


def horizon_parallel_phase(dev, card, inputs):
    """Phase 23: solve_qp(horizon_parallel=True) against the sequential
    sweeps on the card, on cells D's and C's QPs (phases 13-16), both timed
    once beside K1 on the same QPs; then one planner cycle of cell C on the
    torch backend with horizon_parallel=True."""
    import torch

    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.ops import cuda_qp
    from mpc_planner_tpu_torch.planner import Planner
    from mpc_planner_tpu_torch.solver.qp import solve_qp

    for i, (label, (plain, Zp, P)) in enumerate(inputs["qps"].items()):
        nu, nx, iters = plain.ocp.nu, plain.ocp.nx, plain.qp_iterations
        qp = plain._linearize(Zp, P)  # MIRROR-regularized, as the torch backend solves it
        if i == 0:  # load the scans' kernels (inverse, triangular solves) once
            solve_qp(qp, nu, nx, iterations=1, horizon_parallel=True)
        seq, seq_ms = event_ms(torch, lambda: solve_qp(qp, nu, nx, iterations=iters, mu0=plain.mu0))
        par, par_ms = event_ms(torch, lambda: solve_qp(qp, nu, nx, iterations=iters, mu0=plain.mu0,
                                                       horizon_parallel=True))
        k1_ms = cuda_ms(torch, lambda: cuda_qp.solve_qp_cuda(qp, nu, nx, iterations=iters,
                                                             mu0=plain.mu0), 20)
        errs = {"dz": rel_err(par.dz, seq.dz), "lam_l": rel_err(par.lam_l, seq.lam_l),
                "lam_u": rel_err(par.lam_u, seq.lam_u)}
        print(f"phase 23: {label}, {iters} IP iterations: horizon_parallel vs sequential sweeps rel err "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; plain torch scans {par_ms:.1f} ms, sequential {seq_ms:.1f} ms (scan/sequential "
              f"{par_ms / seq_ms:.2f}), K1 on the same QPs {k1_ms:.3f} ms [{card}]")
        check(errs["dz"] <= 1e-4 and max(errs["lam_l"], errs["lam_u"]) <= 5e-3,
              f"horizon_parallel disagrees with the sequential sweeps on {label}: {errs}")
    cfg, model, modules = presets.system_jackalsimulator("tmpc")
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, qp_backend="torch", horizon_parallel=True))
    planner = Planner(model, modules, cfg)
    state, data = presets.corridor_scene(cfg, n_pedestrians=12, seed=SEED)
    planner.on_data_received(data, "reference_path")
    check(planner.solver.horizon_parallel and planner.solver.qp_backend == "torch",
          "cell C horizon_parallel: the key did not reach the solver")
    t0 = time.perf_counter()
    check(planner.solve_mpc(state, data).success, "cell C horizon_parallel: cycle 1 failed")
    cycle_s = time.perf_counter() - t0
    diff = float(np.abs(planner._Z - inputs["torch_cycle_Z"]).max())
    print(f"phase 23: cell C cycle 1 on the torch backend with horizon_parallel: {cycle_s * 1e3:.1f} ms "
          f"[{card}]; Z vs the sequential sweeps' cycle 1 (phase 15) max |d| = {diff:.3e}")
    check(diff < 5e-3, "cell C horizon_parallel: cycle 1 differs from the sequential sweeps'")
    sys.stdout.flush()


def distributed_phase(dev, card, batch):
    """Phase 24: parallel.distributed_solve_step on NCCL with world size 1
    over cell D's batch through K3, a cold and a warm-chained cycle, held
    bit for bit against solve_batch + argmin_objective on the same inputs
    (qp_retry_cold off, so that solve_batch is the same one batch_impl);
    the step's time beside the solve's."""
    import torch
    import torch.distributed as dist

    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.ops import cuda_qp
    from mpc_planner_tpu_torch.parallel import (
        argmin_objective,
        batch_mesh,
        distributed_solve_step,
        initialize_distributed,
    )
    from mpc_planner_tpu_torch.solver.ocp import OCP
    from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS, SQPSolver
    from mpc_planner_tpu_torch.utils.config import default_config

    Zb, P, x0 = batch
    B = Zb.shape[0]
    initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0, device=dev)
    try:
        check(dist.get_backend() == "nccl", f"the process group runs {dist.get_backend()}, not NCCL")
        mesh = batch_mesh(dev)
        c = default_config(N=FLAGSHIP_N)
        c = c.replace(solver=dataclasses.replace(c.solver, qp_retry_cold=False))
        solver = SQPSolver(OCP(*presets.configuration_tmpc(c), c), device=dev)
        check(solver.rti_fused, f"phase 24: the solver is not on K3 ({solver.rti_fused_reason})")
        ones = torch.ones(B, device=dev)
        cold = distributed_solve_step(solver, mesh, RTI_ITERATIONS)
        warm = distributed_solve_step(solver, mesh, RTI_ITERATIONS, warm=True)
        cuda_qp.reset_launch_counts()
        Zw, idx, found, res = cold(Zb, P, x0, ones)
        ref = solver.solve_batch(Zb, P, x0, num_iterations=RTI_ITERATIONS)
        r_idx, r_found = argmin_objective(ref.pobj, ref.exit_code == EXIT_SUCCESS)
        Zs = torch.cat([Zw[1:], Zw[-1:]]).expand(B, -1, -1).contiguous()
        consistency = torch.where(torch.arange(B, device=dev) == idx, 0.9, 1.0)
        duals = (res.lam_l, res.lam_u, res.exit_code == EXIT_SUCCESS)
        Zw2, idx2, found2, res2 = warm(Zs, P, x0, consistency, *duals)
        ref2 = solver.solve_batch(Zs, P, x0, num_iterations=RTI_ITERATIONS,
                                  warm_duals=(ref.lam_l, ref.lam_u, ref.exit_code == EXIT_SUCCESS))
        r_idx2, r_found2 = argmin_objective(ref2.pobj, ref2.exit_code == EXIT_SUCCESS, 0.9, r_idx)
        launches = dict(cuda_qp.launch_counts)
        same = [int(i) == int(j) and bool(f) == bool(g) and torch.equal(z, r.Z[j]) and torch.equal(q.Z, r.Z)
                for i, f, z, q, j, g, r in ((idx, found, Zw, res, r_idx, r_found, ref),
                                            (idx2, found2, Zw2, res2, r_idx2, r_found2, ref2))]
        step_ms, solve_ms = [], []
        for _ in range(DISTRIBUTED_REPS):  # in turns: the difference is a fraction of a ms
            for times, fn in ((step_ms, lambda: warm(Zs, P, x0, consistency, *duals)),
                              (solve_ms, lambda: solver.batch_impl(Zs, P, x0, RTI_ITERATIONS, warm0=duals))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        print(f"phase 24: distributed_solve_step on {dist.get_backend()} (world size {mesh.world_size}, "
              f"{mesh.device}) over cell D's batch (B={B}, N={FLAGSHIP_N}, K3): cold winner {int(idx)} "
              f"(found {bool(found)}, {int((res.exit_code == EXIT_SUCCESS).sum())}/{B} feasible), warm "
              f"winner {int(idx2)} (found {bool(found2)}); equal bit for bit to solve_batch + "
              f"argmin_objective: {same}; kernel launches {launches}; warm step median "
              f"{np.median(step_ms):.2f} ms, its solve alone {np.median(solve_ms):.2f} ms, the "
              f"collectives' overhead {np.median(step_ms) - np.median(solve_ms):.2f} ms [{card}]")
        check(all(same) and bool(found) and bool(found2),
              f"phase 24: the distributed step differs from solve_batch + argmin_objective: {same}")
        check(launches["rti"] > 0 and launches["qp"] == 0, f"phase 24: kernel launches {launches}")
    finally:
        dist.destroy_process_group()
    sys.stdout.flush()


def bridge_phase(card):
    """Phase 25: cell E's planner on the card behind PlannerBridgeServer (a
    thread, a Unix socket in a temporary directory): 20 cycles of obstacles +
    tick from a client, against the same planner driven directly by a
    RobotLoop on the same messages, with the same RTI budget per cycle (the
    budget depends on the clock, so the direct loop takes the count the
    served planner took); the run recorded by ExperimentUtil and exported;
    one Planner.visualize JSON saved."""
    import os
    import tempfile
    import threading

    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.bridge import PlannerBridgeClient, PlannerBridgeServer
    from mpc_planner_tpu_torch.msgs import GaussianMsg, ObstacleGMMMsg
    from mpc_planner_tpu_torch.planner import Planner
    from mpc_planner_tpu_torch.systems import RobotLoop
    from mpc_planner_tpu_torch.utils.experiment import ExperimentUtil

    planners = []
    for _ in range(2):
        cfg, model, modules = presets.system_jackal("tmpc")
        planners.append(Planner(model, modules, cfg))  # no device given: the card
    served, direct = planners
    check(served.solver.device.type == "cuda" and served.solver.rti_fused,
          "phase 25: the served planner is not on K3")
    budgets, solve_s = [], []
    budget, solve = served._iterations_for_budget, served.solve_mpc

    def recorded_budget(data):
        budgets.append(budget(data))
        return budgets[-1]

    def timed_solve(state, data):
        t0 = time.perf_counter()
        out = solve(state, data)
        solve_s.append(time.perf_counter() - t0)
        return out

    served._iterations_for_budget, served.solve_mpc = recorded_budget, timed_solve
    direct._iterations_for_budget = lambda data: budgets[-1]
    _, scene = presets.corridor_scene(cfg, n_pedestrians=12, seed=SEED)
    peds = [(p.position.copy(), p.velocity.copy()) for p in scene_pedestrians(cfg, scene)]
    path = scene.reference_path
    loop = RobotLoop(direct, cfg)
    loop.set_reference_path(path["x"], path["y"])
    with tempfile.TemporaryDirectory() as tmp:
        exp = ExperimentUtil(cfg, save_folder=tmp)
        server = PlannerBridgeServer(served, cfg, address=os.path.join(tmp, "planner.sock"))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        client = PlannerBridgeClient(server.address, timeout=120.0)
        check(client.ping(), "phase 25: no pong")
        check(client.set_reference_path(path["x"], path["y"])["type"] == "ok", "phase 25: path refused")
        x, y, psi, v = 0.0, 0.0, 0.0, 0.0
        tick_s, diffs = [], []
        for _ in range(PLANNER_CYCLES):
            sigma = np.sqrt(np.cumsum(np.full(cfg.N, (0.3 * cfg.dt) ** 2)))
            msgs = []
            for i, (p, u) in enumerate(peds):
                mean = p[None] + np.arange(1, cfg.N + 1)[:, None] * cfg.dt * u[None]
                msgs.append(ObstacleGMMMsg(
                    id=i, pose_x=float(p[0]), pose_y=float(p[1]), radius=cfg.obstacle_radius,
                    gaussians=[GaussianMsg(mean_x=mean[:, 0].tolist(), mean_y=mean[:, 1].tolist(),
                                           major_semiaxis=sigma.tolist(), minor_semiaxis=sigma.tolist())],
                    probabilities=[1.0]))
            t0 = time.perf_counter()
            client.send_obstacles(msgs)
            resp = client.tick([x, y, psi], v)
            tick_s.append(time.perf_counter() - t0)
            raw = [ObstacleGMMMsg.from_dict(m.to_dict()).to_raw_obstacle() for m in msgs]
            cmd = loop.tick([x, y, psi], v, raw)
            exp.update(loop.state, direct, loop.data, runtime_s=tick_s[-1])
            check(resp["type"] == "command" and resp["success"], f"phase 25: tick failed: {resp}")
            diffs.append(max(abs(resp["v"] - cmd[0]), abs(resp["w"] - cmd[1]),
                             float(np.abs(np.asarray(resp["trajectory"])
                                          - direct._output.trajectory.positions).max())))
            check(cmd[2] and diffs[-1] == 0.0,
                  f"phase 25: the served command {resp['v'], resp['w']} differs from the direct {cmd}")
            v = resp["v"]
            psi += resp["w"] * cfg.dt
            x += v * np.cos(psi) * cfg.dt
            y += v * np.sin(psi) * cfg.dt
            peds = [(p + cfg.dt * u, u) for p, u in peds]
        check(client.shutdown()["type"] == "ok", "phase 25: shutdown refused")
        thread.join(timeout=60)
        check(not thread.is_alive(), "phase 25: the server did not stop")
        exp.on_task_complete(objective_reached=False)
        exported = exp.export_data()
        viz_path = os.path.join(tmp, "visualize.json")
        viz = direct.visualize(loop.state, loop.data)
        viz.save(viz_path)
        kinds = sorted({a["type"] for a in viz.artifacts})
        sizes = os.path.getsize(exported), os.path.getsize(viz_path)
    check("candidates" in kinds and "obstacles" in kinds, f"phase 25: visualize gave {kinds}")
    check("matplotlib" not in sys.modules, "phase 25: matplotlib was imported")
    tick_ms, solve_ms = np.median(tick_s[1:]) * 1e3, np.median(solve_s[1:]) * 1e3
    print(f"phase 25: cell E (system_jackal('tmpc')) behind PlannerBridgeServer: {PLANNER_CYCLES}/"
          f"{PLANNER_CYCLES} commands succeeded, equal to the directly driven planner's (max |d| "
          f"{max(diffs):.1e}; RTI budget per cycle {budgets}); {x:.2f} m of progress; obstacles + tick "
          f"round trip median {tick_ms:.2f} ms, solve_mpc median {solve_ms:.2f} ms, the bridge's "
          f"overhead {tick_ms - solve_ms:.2f} ms [{card}]; ExperimentUtil export {sizes[0]} bytes, "
          f"Planner.visualize JSON {sizes[1]} bytes ({', '.join(kinds)})")
    sys.stdout.flush()


def experiment_phases(dev, card):
    """Phase 26: the experiments' functions on the card at a cut size
    (the full experiments run on their own): corridor_benchmark.run_row for
    T-MPC++ and MPC (ellipsoid) at 4 and 12 pedestrians and SH-MPC at 12,
    seed 0 each, every row completed, the T-MPC++ and MPC rows without a
    collision (CORRIDOR_ROWS); one T-MPC++ row at
    ~1,000 parallel guesses (samples_per_class); guidance_ab at 2 scenes;
    batch_sweep, n30_latency and fused_rti_check at fewer repetitions. The
    launch counts of each are read around it."""
    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.experiments import (
        batch_sweep,
        fused_rti_check,
        guidance_ab,
        n30_latency,
    )
    from mpc_planner_tpu_torch.experiments import corridor_benchmark as cb
    from mpc_planner_tpu_torch.ops import cuda_qp

    def counted(label, fn, kernels, absent=()):
        """fn() with the launch counts set to 0 before and read after: each of
        `kernels` launched, none of `absent`."""
        cuda_qp.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
        launches = dict(cuda_qp.launch_counts)
        check(all(launches[k] > 0 for k in kernels) and not any(launches[k] for k in absent),
              f"phase 26: {label} launched {launches}")
        print(f"phase 26: {label}: {seconds:.1f} s, kernel launches {launches}")
        sys.stdout.flush()
        return out

    t_phase = time.perf_counter()
    rows = {}

    def corridor():
        for label, make, peds, no_collision in CORRIDOR_ROWS:
            row = cb.run_row(getattr(presets, make), cb.build_config(), peds, 1, CORRIDOR_MAX_STEPS,
                             dev, label=label)
            rows[label, peds] = row
            check(row["completed"] == 1 and (row["collisions"] == 0 or not no_collision),
                  f"phase 26: corridor row {label} at {peds} pedestrians: {row}")

    counted("corridor rows (seed 0 each, completed; T-MPC++ and MPC without a collision)",
            corridor, ("rti",), ("qp", "mirror"))
    for (label, peds), row in rows.items():
        print(f"phase 26: corridor {label}, {peds} pedestrians: duration {row['duration_mean']} s, "
              f"cycle mean {row['cycle_ms_mean']} ms, p99 {row['cycle_ms_p99']} ms, B={row['B']}, "
              f"infeasible {row['infeasible']}, certificate {row['scenario_certificate']} [{card}]")
    cfg = cb.build_config(samples_per_class=CORRIDOR_SAMPLES_PER_CLASS)
    wide = counted(f"corridor T-MPC++ at samples_per_class={CORRIDOR_SAMPLES_PER_CLASS}",
                   lambda: cb.run_row(presets.configuration_tmpc, cfg, 12, 1, CORRIDOR_WIDE_STEPS,
                                      dev, label="T-MPC++"), ("rti",), ("qp", "mirror"))
    check(wide["B"] >= 1000 and wide["cycle_ms_mean"] is not None,
          f"phase 26: the wide T-MPC++ row: {wide}")
    print(f"phase 26: corridor T-MPC++ at B={wide['B']} parallel guesses, 12 pedestrians, "
          f"{CORRIDOR_WIDE_STEPS} steps: {wide['collisions']} collisions, cycle mean "
          f"{wide['cycle_ms_mean']} ms, p99 {wide['cycle_ms_p99']} ms [{card}]")

    ab = guidance_ab.run(2, 12, dev)
    check([r["backend"] for r in ab] == list(guidance_ab.BACKENDS)
          and all(r["classes_per_scene"] >= 1 for r in ab), f"phase 26: guidance_ab rows {ab}")

    sweep, _ = counted(f"batch_sweep at B={SWEEP_BATCHES} (2 cycles x 2 repetitions)",
                       lambda: batch_sweep.sweep(SWEEP_BATCHES, cycles=2, reps=2, device=dev),
                       ("rti",), ("qp", "mirror"))
    check(all(np.isfinite(r[1]) and r[3] > 0 for r in sweep), f"phase 26: batch_sweep {sweep}")
    latency = counted(f"n30_latency at B={N30_BATCHES}, warm iterations 6 and 4 (2 cycles x 2)",
                      lambda: n30_latency.latency_rows(N30_BATCHES, (6, 4), cycles=2, reps=2,
                                                       device=dev), ("rti",), ("qp", "mirror"))
    check(all(r["feasible_steady"] > 0 for r in latency), f"phase 26: n30_latency {latency}")
    agree, times = counted(f"fused_rti_check at B={BATCH}",
                           lambda: fused_rti_check.check(BATCH, device=dev, reps=(3, 1, 1),
                                                         latency=False), ("rti", "qp"), ("mirror",))
    check(all(r["ok"] for r in agree), f"phase 26: fused_rti_check {agree}")
    print(f"phase 26: the experiments ran in {time.perf_counter() - t_phase:.1f} s; fused_rti_check "
          f"B={BATCH}: " + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items()) + f" [{card}]")
    sys.stdout.flush()


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
    c = default_config(N=FLAGSHIP_N)  # phase 26's corridor rows (T-MPC++ shares flagship N=20's)
    corridor_codes = {name: StageCode(OCP(*getattr(presets, name)(c), c))
                      for name in ("configuration_basic", "configuration_safe_horizon")}

    def timed(fn, *args):
        t = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t

    # K3 libraries generate their stage code (make_fx) in the pool too; one
    # OCP's second build waits for the first when their code is the same.
    jobs = [("qp+mirror", cuda_qp.load_kernels, ()), ("rti", cuda_rti.load_rti, (stage_code,)),
            ("riccati_probe", riccati_probe.load_probe, ())]
    jobs += [(f"rti_flagship_N{n}", cuda_rti.load_rti, (code,)) for n, code in flagship_codes.items()]
    jobs += [(f"rti_corridor_{name[len('configuration_'):]}", cuda_rti.load_rti, (code,))
             for name, code in corridor_codes.items()]
    family_codes = {}
    for name, build in family_presets().items():
        c, m, mods = build()
        family_codes[name] = StageCode(OCP(m, mods, c))
    scenario_codes = {}
    for name, build in scenario_presets().items():
        c, m, mods = build()
        scenario_codes[name] = StageCode(OCP(m, mods, c))
    jobs += [(f"rti_{name}", cuda_rti.load_rti, (code,))
             for name, code in {**family_codes, **scenario_codes}.items()]
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

    def closed_loop(planner, state, data, cycles):
        """`cycles` cycles of the main path: Z of cycle 1, the cycle times,
        the start and end positions; every cycle must succeed."""
        start = state.get_position().copy()
        Z_first, times = None, []
        for cycle in range(cycles):
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

    planner, (state, data) = make_planner("auto", rti_fused="off")
    check(planner.solver.qp_backend == "cuda", "auto backend did not pick cuda on the GPU")
    check(not planner.solver.rti_fused, "rti_fused='off' took the fused route")
    cuda_qp.reset_launch_counts()
    Z_first, times, d0, d1 = closed_loop(planner, state, data, UNFUSED_CYCLES)
    launches = dict(cuda_qp.launch_counts)
    print(f"phase 5: {UNFUSED_CYCLES}/{UNFUSED_CYCLES} unfused planner cycles succeeded; distance to goal "
          f"{d0:.3f} -> {d1:.3f} m; cycle time median {np.median(times[1:]) * 1e3:.2f} ms, "
          f"max {np.max(times[1:]) * 1e3:.2f} ms [{card}] "
          f"(first {times[0] * 1e3:.1f} ms); kernel launches {launches}")
    check(d1 < d0 - 0.25, "robot did not approach the goal")
    check(launches["qp"] > 0, "the unfused route never launched the qp kernel")
    check(launches["mirror"] == 0 and launches["rti"] == 0,
          f"the unfused route launched more than K1 (MIRROR runs inside it): {launches}")

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
    for backend, warm_cycles in (("cuda", HOST_BOUND_WARM_CYCLES), ("torch", PLAIN_WARM_CYCLES)):
        c = cfg.replace(solver=cfg.solver.__class__(qp_backend=backend, rti_fused="off"))
        solver = SQPSolver(OCP(model, modules, c), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve_batch(Z0, P, x0, num_iterations=RTI_ITERATIONS)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        cold_ok = int((res.exit_code == EXIT_SUCCESS).sum())
        cycle_s = []
        for _ in range(warm_cycles):
            t0 = time.perf_counter()
            res = solver.solve_batch(res.Z, P, x0, num_iterations=RTI_ITERATIONS,
                                     warm_duals=(res.lam_l, res.lam_u, res.exit_code == EXIT_SUCCESS))
            torch.cuda.synchronize()
            cycle_s.append(time.perf_counter() - t0)
        feasible = int((res.exit_code == EXIT_SUCCESS).sum())
        check(bool(torch.isfinite(res.Z).all()), f"{backend}: non-finite batch solution")
        print(f"phase 6: {backend}: B={BATCH} cold solve {cold_s * 1e3:.1f} ms ({cold_ok}/{BATCH} "
              f"feasible); {warm_cycles} warm cycles mean {np.mean(cycle_s) * 1e3:.1f} ms, "
              f"last cycle {feasible}/{BATCH} feasible [{card}]")
        check(feasible > 0, f"{backend}: no feasible batch element")
    sys.stdout.flush()

    record["rti"], rti_launches = fused_phases(
        dev, card, stage_code, Z0, P, x0, Zp, plain_solver, make_planner, closed_loop,
        Z_torch_first)
    record["riccati_probe"], probe_launches = probe_phase(card, dev)
    flagship, flagship_inputs = flagship_phases(dev, card, flagship_codes, build_s)
    families = remaining_phases(dev, card, family_codes, build_s)
    families.update(scenario_phases(dev, card, scenario_codes, build_s))
    sampled_guidance_phase(dev, card)
    horizon_parallel_phase(dev, card, flagship_inputs)
    distributed_phase(dev, card, flagship_inputs["batch"])
    bridge_phase(card)
    experiment_phases(dev, card)

    kernels = [
        dict(name="qp", route="cuda", source="mpc_planner_tpu_torch/ops/csrc/qp_kernel.cu",
             replaces="mpc_planner_tpu/ops/pallas_qp.py:621", launches=launches["qp"],
             **record["qp"]),
        dict(name="mirror", route="cuda", source="mpc_planner_tpu_torch/ops/csrc/mirror_kernel.cu",
             replaces="mpc_planner_tpu/ops/pallas_qp.py:81", launches=launches["mirror"],
             **record["mirror"]),  # 0: K2 is on no planner route (phase 5 checks it)
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
    for name, (qp_entry, rti_entry) in families.items():
        kernels.append(dict(name=f"qp_{name}", route="cuda",
                            source="mpc_planner_tpu_torch/ops/csrc/qp_kernel.cu",
                            replaces="mpc_planner_tpu/ops/pallas_qp.py:621", **qp_entry))
        kernels.append(dict(name=f"rti_{name}", route="cuda",
                            source="mpc_planner_tpu_torch/ops/csrc/rti_kernel.cuh",
                            replaces="mpc_planner_tpu/ops/pallas_rti.py:205", **rti_entry))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
