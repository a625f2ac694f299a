"""K4: a probe of the backward Riccati factorization on Hopper.

Counterpart of experiments/riccati_ilp_probe.py (its main :278, the
factorization `_factor_chain` :72-94). That probe timed TPU lane layouts of
the recursion at the heart of the QP kernel K1; this one times Hopper
thread mappings of the same recursion (ops/csrc/riccati_probe.cu):

  single       one thread per element (K1's first mapping);
  interleaved  two elements per thread, their recursions interleaved;
  lanes        eight lanes per element, products across lanes by shuffles;
  warp         one warp per element, the recursion redundantly on every
               lane, stage data read from global memory;
  staged       the same on the element's stage data staged into shared
               memory by asynchronous copies (K1's own pattern,
               ip_solve.cuh's factorization);
  team         staged, with each step shared over the warp's lanes
               (ops/csrc/riccati_step.cuh: one matrix entry a lane).

Each is held against the plain batched torch `factor_chain_torch` within
the TPU probe's own bound (1e-3, riccati_ilp_probe.py:363-370), on its
synthetic data (:255-262, seeded with numpy): nu=2, nx=5, 8 sweeps, the
horizon N a parameter as the TPU probe's argv[1] (:55). Timings are per
launch, with CUDA events, printed beside the bound (`probe_work`) and as
ns per stage-step per chain (the TPU probe's unit, :273-274: launch time /
(sweeps * N)), at N=20 for 5, 1024 and 131,072 elements and at N=30 (the
single robot's horizon) for 5. Last, the step's dependent-chain floor:
CHAIN_OPS dependent float32 operations and one division, at their
latencies measured on the card (clock64) and the SM clock nvidia-smi reads.

    python -m mpc_planner_tpu_torch.experiments.riccati_probe [N]

With N, that horizon at the three sizes. The "team" body also builds with
the host compiler (`factor_chain_host`, ops/csrc/riccati_host.cpp) for the
CPU tests.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np
import torch

from mpc_planner_tpu_torch.ops.cuda_qp import (
    BUILD_DIR, CSRC, bound_ms, launch_counts, load_c_library, riccati_step_flops,
)

N_STAGES = 20
NU, NX = 2, 5
SWEEPS = 8
MAPPINGS = ("single", "interleaved", "lanes", "warp", "staged", "team")
SIZES = (5, 1024, 131_072)  # the robot's batch, the batch workload's, a full card
# (N, elements): the sizes at N=20, and the single robot's horizon on cells C and E
CASES = tuple((N_STAGES, E) for E in SIZES) + ((30, 5),)
TOLERANCE = 1e-3  # riccati_ilp_probe.py:369
# The longest dependency path of one step, besides its division
# (ops/csrc/riccati_step.cuh): P B 5, R-hat 7, the determinant 2, the
# inverse 1, K 2, S'K 2, the new P 1 + 2.
CHAIN_OPS = 22

# Launches of each mapping through factor_chain_cuda since the last reset
# (beside cuda_qp.launch_counts["riccati_probe"], their sum).
mapping_launches = dict.fromkeys(MAPPINGS, 0)

_lib = None
_lib_lock = threading.Lock()


def make_data(rng: np.random.Generator, elements: int, n_stages: int = N_STAGES):
    """The TPU probe's synthetic stage data, element axis last:
    H [N+1, 7, 7, E] (symmetric, +3 I), A [N, 5, 5, E] (+0.9 I),
    B [N, 5, 2, E], float32."""
    nvar = NU + NX
    M = rng.normal(0, 0.3, (n_stages + 1, nvar, nvar, elements)).astype(np.float32)
    H = M + np.swapaxes(M, 1, 2) + 3.0 * np.eye(nvar, dtype=np.float32)[:, :, None]
    A = rng.normal(0, 0.2, (n_stages, NX, NX, elements)).astype(np.float32)
    A += 0.9 * np.eye(NX, dtype=np.float32)[:, :, None]
    B = rng.normal(0, 0.3, (n_stages, NX, NU, elements)).astype(np.float32)
    return H, A, B


def factor_chain_torch(H, A, B, sweeps: int = SWEEPS):
    """Plain version: the backward factorization of every element at once.
    H [E, N+1, 7, 7], A [E, N, 5, 5], B [E, N, 5, 2] -> P [E, 5, 5]."""
    n_stages = A.shape[1]
    P = H[:, n_stages, NU:, NU:]
    eye = 1e-7 * torch.eye(NU, dtype=H.dtype, device=H.device)
    for _ in range(sweeps):
        for k in reversed(range(n_stages)):
            Hk, Ak, Bk = H[:, k], A[:, k], B[:, k]
            PA, PB = P @ Ak, P @ Bk
            R = Hk[:, :NU, :NU] + Bk.mT @ PB + eye
            S = Hk[:, :NU, NU:] + Bk.mT @ PA
            inv_det = 1.0 / (R[:, 0, 0] * R[:, 1, 1] - R[:, 0, 1] * R[:, 0, 1])
            Rinv = torch.stack([torch.stack([R[:, 1, 1], -R[:, 0, 1]], -1),
                                torch.stack([-R[:, 0, 1], R[:, 0, 0]], -1)], -2)
            K = -(Rinv * inv_det[:, None, None]) @ S
            Pn = Hk[:, NU:, NU:] + Ak.mT @ PA + S.mT @ K
            P = 0.5 * (Pn + Pn.mT)
    return P


def probe_work(elements: int, n_stages: int = N_STAGES, sweeps: int = SWEEPS):
    """(flops, bytes) of one launch: sweeps * N factorization steps per
    element; H, A and B read once, P written once."""
    nvar = NU + NX
    floats = (n_stages + 1) * nvar * nvar + n_stages * NX * (NX + NU) + NX * NX
    return elements * sweeps * n_stages * riccati_step_flops(NU, NX), 4 * elements * floats


def load_probe(verbose: bool = False) -> ctypes.CDLL:
    """Build (first call in a process) and load the probe's kernels."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = load_c_library("mpc_riccati_probe", [os.path.join(CSRC, "riccati_probe.cu")],
                                 os.path.join(BUILD_DIR, "riccati_probe"), verbose)
            lib.riccati_probe_launch.restype = ctypes.c_int
            lib.riccati_probe_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            lib.riccati_probe_latency.restype = ctypes.c_int
            lib.riccati_probe_latency.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
            _lib = lib
    return _lib


def _check_arrays(H, A, B, device_type: str):
    E, n_stages = H.shape[-1], A.shape[0]
    shapes = {"H": (n_stages + 1, NU + NX, NU + NX, E), "A": (n_stages, NX, NX, E),
              "B": (n_stages, NX, NU, E)}
    for name, t in (("H", H), ("A", A), ("B", B)):
        if t.device.type != device_type or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {device_type.upper()} tensor")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
    return E, n_stages


def factor_chain_cuda(H, A, B, mapping: str, sweeps: int = SWEEPS):
    """One launch of the probe kernel with the given mapping, on the
    element-innermost arrays H [N+1, 7, 7, E], A [N, 5, 5, E],
    B [N, 5, 2, E] (float32, contiguous) -> P [5, 5, E]. CPU tensors take
    the plain version; CUDA tensors the kernel, which raises on a refused
    launch (also a refused shared-memory size), with no fallback."""
    if mapping not in MAPPINGS:
        raise ValueError(f"mapping must be one of {MAPPINGS}, got {mapping!r}")
    if H.device.type == "cpu":
        _check_arrays(H, A, B, "cpu")
        return factor_chain_torch(*(x.movedim(-1, 0) for x in (H, A, B)), sweeps).movedim(0, -1)
    E, n_stages = _check_arrays(H, A, B, "cuda")
    lib = load_probe()
    P = torch.empty(NX, NX, E, device=H.device)
    with torch.cuda.device(H.device):
        err = lib.riccati_probe_launch(MAPPINGS.index(mapping), H.data_ptr(), A.data_ptr(),
                                       B.data_ptr(), P.data_ptr(), E, n_stages, sweeps,
                                       torch.cuda.current_stream(H.device).cuda_stream)
    if err:
        raise RuntimeError(f"riccati probe launch failed ({mapping}): cudaError {err}")
    launch_counts["riccati_probe"] += 1
    mapping_launches[mapping] += 1
    return P


def factor_chain_host(H, A, B, build_dir: str, sweeps: int = SWEEPS):
    """The "team" mapping's body (ops/csrc/riccati_step.cuh) built with the
    host compiler into `build_dir` (ops/csrc/riccati_host.cpp: a team of
    one lane) and run on CPU tensors, with factor_chain_cuda's arrays. For
    the CPU tests: the port's CPU path is the plain version, not this."""
    E, n_stages = _check_arrays(H, A, B, "cpu")
    fn = load_c_library("mpc_riccati_host", [os.path.join(CSRC, "riccati_host.cpp")],
                        build_dir).riccati_team_host
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    P = torch.empty(NX, NX, E)
    fn(H.data_ptr(), A.data_ptr(), B.data_ptr(), P.data_ptr(), E, n_stages, sweeps)
    return P


def _event_ms(fn, reps: int) -> float:
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


def run(device="cuda", cases=CASES, reps: int = 20, seed: int = 0):
    """Every mapping at every (N, elements) case: max |P - plain| (checked
    against the bound) and times. Returns a list of dicts, one per (case,
    mapping)."""
    rows = []
    for n_stages, E in cases:
        bound, bound_by = bound_ms(*probe_work(E, n_stages))
        H, A, B = (torch.as_tensor(x, device=device)
                   for x in make_data(np.random.default_rng(seed), E, n_stages))
        plain_args = [x.movedim(-1, 0).contiguous() for x in (H, A, B)]
        ref = factor_chain_torch(*plain_args).movedim(0, -1)
        plain_ms = _event_ms(lambda: factor_chain_torch(*plain_args), max(reps // 10, 1))
        for mapping in MAPPINGS:
            P = factor_chain_cuda(H, A, B, mapping)
            torch.cuda.synchronize()
            err = float((P - ref).abs().max())
            if not err < TOLERANCE:
                raise RuntimeError(f"riccati probe {mapping} at N={n_stages}, E={E}: "
                                   f"max |P - plain| = {err}")
            ms = _event_ms(lambda: factor_chain_cuda(H, A, B, mapping), reps)
            steps = SWEEPS * n_stages
            rows.append(dict(n_stages=n_stages, elements=E, mapping=mapping, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                             share=bound / ms, ns_per_step=ms * 1e6 / steps,
                             ns_per_step_element=ms * 1e6 / (steps * E)))
    return rows


def chain_latency(n: int = 4096):
    """Cycles of one dependent float32 FMA, one dependent division, one
    lane exchange through shared memory (store, __syncwarp, the next lane's
    load) and one shuffle, on the card (clock64 over n of each, one warp)."""
    cycles = (ctypes.c_longlong * 4)()
    err = load_probe().riccati_probe_latency(n, cycles)
    if err:
        raise RuntimeError(f"riccati probe latency kernel failed: cudaError {err}")
    return tuple(c / n for c in cycles)


def _nvidia_smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("riccati_probe: needs a CUDA device")
    cases = tuple((int(argv[0]), E) for E in SIZES) if argv else CASES
    card = _nvidia_smi("name,power.limit")
    print(card)
    print(f"device {torch.cuda.get_device_name(0)}; nu={NU} nx={NX} sweeps={SWEEPS}")
    for r in run(cases=cases):
        print(f"N={r['n_stages']} E={r['elements']:>7} {r['mapping']:12s} "
              f"max|d|={r['max_abs_err']:.2e} {r['ms'] * 1e3:10.2f} us/launch "
              f"({r['ns_per_step']:9.1f} ns/stage-step/chain, {r['ns_per_step_element']:.4f} "
              f"per element); bound {r['bound_ms'] * 1e3:.3f} us by {r['bound_by']} "
              f"({100 * r['share']:.2f}%); plain {r['plain_ms']:.2f} ms; library call: none")
    fma, div, exchange, shuffle = chain_latency()
    clocks = _nvidia_smi("clocks.sm,clocks.max.sm")
    max_mhz = float(clocks.split(",")[1].split()[0])
    floor_cycles = CHAIN_OPS * fma + div
    print(f"latencies (cycles): FMA {fma:.2f}, division {div:.2f}, shared-memory exchange "
          f"{exchange:.2f}, shuffle {shuffle:.2f}")
    print(f"dependent-chain floor of a step: {CHAIN_OPS} x {fma:.2f} + {div:.2f} = "
          f"{floor_cycles:.1f} cycles = {floor_cycles * 1e3 / max_mhz:.1f} ns at {max_mhz:.0f} MHz; "
          f"with the team step's three exchanges {floor_cycles + 3 * exchange:.1f} cycles = "
          f"{(floor_cycles + 3 * exchange) * 1e3 / max_mhz:.1f} ns (clocks.sm, clocks.max.sm: "
          f"{clocks}) [{card}]")


if __name__ == "__main__":
    main()
