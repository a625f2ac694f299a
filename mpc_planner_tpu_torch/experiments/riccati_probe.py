"""K4: a probe of the backward Riccati factorization on Hopper.

Counterpart of experiments/riccati_ilp_probe.py (its main :278, the
factorization `_factor_chain` :72-94). That probe timed TPU lane layouts of
the recursion at the heart of the QP kernel K1; this one times Hopper
thread mappings of the same recursion (ops/csrc/riccati_probe.cu):

  single       one thread per element (K1's mapping);
  interleaved  two elements per thread, their recursions interleaved;
  lanes        eight lanes per element, products across lanes by shuffles.

Each is held against the plain batched torch `factor_chain_torch` within
the TPU probe's own bound (1e-3, riccati_ilp_probe.py:363-370), on its
synthetic data (:255-262, seeded with numpy): N=20, nu=2, nx=5, 8 sweeps.
Timings are per launch, with CUDA events, printed as ns per stage-step per
chain (the TPU probe's unit, :273-274: launch time / (sweeps * N)) at 1024
and 131,072 elements.

    python -m mpc_planner_tpu_torch.experiments.riccati_probe
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from mpc_planner_tpu_torch.ops.cuda_qp import BUILD_DIR, CSRC, launch_counts, load_c_library

N_STAGES = 20
NU, NX = 2, 5
SWEEPS = 8
MAPPINGS = ("single", "interleaved", "lanes")
SIZES = (1024, 131_072)
TOLERANCE = 1e-3  # riccati_ilp_probe.py:369

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
            _lib = lib
    return _lib


def factor_chain_cuda(H, A, B, mapping: str, sweeps: int = SWEEPS):
    """One launch of the probe kernel with the given mapping, on the
    element-innermost arrays H [N+1, 7, 7, E], A [N, 5, 5, E],
    B [N, 5, 2, E] (CUDA, float32, contiguous) -> P [5, 5, E]."""
    E, n_stages = H.shape[-1], A.shape[0]
    shapes = {"H": (n_stages + 1, NU + NX, NU + NX, E), "A": (n_stages, NX, NX, E),
              "B": (n_stages, NX, NU, E)}
    for name, t in (("H", H), ("A", A), ("B", B)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
    lib = load_probe()
    P = torch.empty(NX, NX, E, device=H.device)
    with torch.cuda.device(H.device):
        err = lib.riccati_probe_launch(MAPPINGS.index(mapping), H.data_ptr(), A.data_ptr(),
                                       B.data_ptr(), P.data_ptr(), E, n_stages, sweeps,
                                       torch.cuda.current_stream(H.device).cuda_stream)
    if err:
        raise RuntimeError(f"riccati probe launch failed ({mapping}): cudaError {err}")
    launch_counts["riccati_probe"] += 1
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


def run(device="cuda", sizes=SIZES, reps: int = 20, seed: int = 0):
    """Every mapping at every size: max |P - plain| (checked against the
    bound) and times. Returns a list of dicts, one per (size, mapping)."""
    rows = []
    for E in sizes:
        H, A, B = (torch.as_tensor(x, device=device) for x in make_data(np.random.default_rng(seed), E))
        plain_args = [x.movedim(-1, 0).contiguous() for x in (H, A, B)]
        ref = factor_chain_torch(*plain_args).movedim(0, -1)
        plain_ms = _event_ms(lambda: factor_chain_torch(*plain_args), max(reps // 10, 1))
        for mapping in MAPPINGS:
            P = factor_chain_cuda(H, A, B, mapping)
            torch.cuda.synchronize()
            err = float((P - ref).abs().max())
            if not err < TOLERANCE:
                raise RuntimeError(f"riccati probe {mapping} at E={E}: max |P - plain| = {err}")
            ms = _event_ms(lambda: factor_chain_cuda(H, A, B, mapping), reps)
            rows.append(dict(elements=E, mapping=mapping, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             ns_per_step=ms * 1e6 / (SWEEPS * N_STAGES),
                             ns_per_step_element=ms * 1e6 / (SWEEPS * N_STAGES * E)))
    return rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit("riccati_probe: needs a CUDA device")
    print(f"device {torch.cuda.get_device_name(0)}; N={N_STAGES} nu={NU} nx={NX} sweeps={SWEEPS}")
    for r in run():
        print(f"E={r['elements']:>7} {r['mapping']:12s} max|d|={r['max_abs_err']:.2e} "
              f"{r['ms'] * 1e3:10.1f} us/launch ({r['ns_per_step']:9.1f} ns/stage-step/chain, "
              f"{r['ns_per_step_element']:.4f} ns/stage-step/element); plain {r['plain_ms']:.2f} ms")


if __name__ == "__main__":
    main()
