#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mpc_planner_tpu_torch) on one
NVIDIA GPU: builds the hand-written Hopper kernels from the checkout,
holds each against its plain torch version, drives the planner's main
path, and prints one JSON result line.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is printed as a
result then):
  1. refuse to run without CUDA; print the card (nvidia-smi) and torch;
  2. build the kernels (torch.utils.cpp_extension.load, sm_90a);
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
     then 8 chained warm cycles, for "cuda" and for "torch".
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a GPU",
              file=sys.stderr)
        return 2

    from mpc_planner_tpu_torch import presets
    from mpc_planner_tpu_torch.ops import cuda_qp
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

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_qp.load_kernels()
    print(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s")
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
    cfg, model, modules = presets.system_jackal("goal", N=N)
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
    def make_planner(backend):
        c, m, mods = presets.system_jackal("goal", N=N)
        c = c.replace(solver=c.solver.__class__(qp_backend=backend))
        return Planner(m, mods, c, device=dev), presets.corridor_scene(c, n_pedestrians=12, seed=SEED)

    planner, (state, data) = make_planner("auto")
    check(planner.solver.qp_backend == "cuda", "auto backend did not pick cuda on the GPU")
    start = state.get_position().copy()
    cuda_qp.reset_launch_counts()
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
    launches = dict(cuda_qp.launch_counts)
    goal = np.asarray(data.goal)
    d0, d1 = np.linalg.norm(goal - start), np.linalg.norm(goal - state.get_position())
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
    diff = float(np.abs(planner_t._Z - Z_first).max())
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

    kernels = [
        dict(name="qp", route="cuda", source="mpc_planner_tpu_torch/ops/csrc/qp_kernel.cu",
             replaces="mpc_planner_tpu/ops/pallas_qp.py:621", launches=launches["qp"],
             **record["qp"]),
        dict(name="mirror", route="cuda", source="mpc_planner_tpu_torch/ops/csrc/mirror_kernel.cu",
             replaces="mpc_planner_tpu/ops/pallas_qp.py:81", launches=launches["mirror"],
             **record["mirror"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
