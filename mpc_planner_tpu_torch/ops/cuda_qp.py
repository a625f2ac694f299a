"""Wrappers of the hand-written Hopper kernels K1 (QP) and K2 (MIRROR).

K1 `solve_qp_cuda` replaces mpc_planner_tpu/ops/pallas_qp.py::
solve_qp_pallas (-> _qp_kernel -> _ip_solve); K2 `mirror_cuda` replaces
pallas_qp.py::_mirror_lanes and ops/jacobi_eigh.py::mirror_unpacked.
Sources: ops/csrc/{qp_kernel.cu, mirror_kernel.cu}, bound by
ops/csrc/binding.cpp. K1 runs one warp per batch element on element-major
arrays (ops/csrc/ip_solve.cuh has the design). They are compiled for sm_90a with
torch.utils.cpp_extension.load at first use, into the package's `_build/`
directory; nothing is compiled or imported when this module is imported.

Each wrapper takes its kernel's plain torch version (solver/qp.py::
solve_qp, ops/jacobi_eigh.py::mirror_unpacked) only for tensors that lie
on the CPU. For a CUDA tensor it launches the kernel or raises: a failed
build or launch is an error, never a silent fallback.

Beside the wrappers: the operation and byte counts of each kernel's work
(`qp_work`, `mirror_work`) and `bound_ms`, the least time the card could
take for them, which chip_smoke.py prints beside every measured time; and
`solve_qp_host`, K1's body built with the host compiler for the CPU tests.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from mpc_planner_tpu_torch.ops.jacobi_eigh import mirror_unpacked
from mpc_planner_tpu_torch.solver.qp import QPData, QPSolution, solve_qp

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
# nvcc flags of every kernel build: sm_90a (wgmma and setmaxnreg exist only
# there), and ptxas' register and spill report, printed by a build run with
# verbose=True.
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-Xptxas=-v"]

# Kernel launches made through the wrappers since the last reset (read by
# chip_smoke.py to show the main path went through the kernels): K1 "qp",
# K2 "mirror", K3 "rti" (and its linearization alone, "rti_linearize",
# ops/cuda_rti.py), K4 "riccati_probe" (experiments/riccati_probe.py).
launch_counts = {"qp": 0, "mirror": 0, "rti": 0, "rti_linearize": 0, "riccati_probe": 0}

# (nu, nx) pairs and matrix sizes the kernels are instantiated for
# (qp_kernel.cu::launch_qp, mirror_kernel.cu::launch_mirror).
QP_SHAPES = {(2, 4), (2, 5), (3, 5), (3, 6)}
MIRROR_SIZES = range(2, 10)

_ext = None
_ext_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def load_kernels(verbose: bool = False):
    """Build (first call in a process) and load the kernel extension."""
    global _ext
    with _ext_lock:
        if _ext is None:
            from torch.utils.cpp_extension import load

            os.makedirs(BUILD_DIR, exist_ok=True)
            _ext = load(
                name="mpc_planner_tpu_torch_kernels",
                sources=[os.path.join(CSRC, f)
                         for f in ("binding.cpp", "qp_kernel.cu", "mirror_kernel.cu")],
                build_directory=BUILD_DIR,
                extra_cuda_cflags=CUDA_FLAGS,
                verbose=verbose,
            )
    return _ext


def load_c_library(name: str, sources, directory: str, verbose: bool = False) -> ctypes.CDLL:
    """Build sources with plain C entry points (no PyTorch headers, so
    nvcc takes seconds) by torch.utils.cpp_extension.load into `directory`
    and load the shared library with ctypes. A host-only source builds with
    the host compiler, at -O1: it serves the CPU tests."""
    from torch.utils.cpp_extension import load

    os.makedirs(directory, exist_ok=True)
    path = load(name=name, sources=list(sources), build_directory=directory,
                extra_include_paths=[CSRC], extra_cflags=["-O1"], extra_cuda_cflags=CUDA_FLAGS,
                is_python_module=False, verbose=verbose)
    return ctypes.CDLL(path)


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def mirror_cuda(H: torch.Tensor, lm: float, sweeps: int = 6) -> torch.Tensor:
    """MIRROR (eigenvalues -> max(|w|, lm)) of a stack H [M, n, n], n <= 9.

    One kernel launch for the whole stack (one thread per matrix)."""
    if H.device.type == "cpu":
        return mirror_unpacked(H, lm, sweeps)
    if H.device.type != "cuda":
        raise ValueError(f"mirror_cuda takes CUDA (or CPU) tensors, got {H.device}")
    if H.dim() != 3 or H.shape[1] != H.shape[2] or H.shape[1] not in MIRROR_SIZES:
        raise ValueError(f"mirror_cuda takes [M, n, n] with 2 <= n <= 9, got {tuple(H.shape)}")
    _check(H, "H", H.shape, H.device)
    if not H.is_contiguous():
        raise ValueError("H must be contiguous")
    ext = load_kernels()
    out = torch.empty_like(H)
    ext.mirror(H, out, float(lm), int(sweeps))
    launch_counts["mirror"] += 1
    return out


def _qp_arguments(qp: QPData, nu: int, nx: int, warm_duals):
    """What K1 takes, from the solve_qp_pallas contract: the row masks
    folded into +-1e15 bound sentinels, only the nh general rows of D, warm
    duals or three dummies; every array element-major and contiguous (the
    layout the callers hold: no transpose). Also the output arrays."""
    B, Np1, nrows, nvar = qp.D.shape
    N = Np1 - 1
    nh = nrows - nvar
    if (nu, nx) not in QP_SHAPES or nu + nx != nvar or nh < 0:
        raise ValueError(
            f"solve_qp_cuda: (nu={nu}, nx={nx}, nvar={nvar}) not supported; kernel "
            f"instantiations: {sorted(QP_SHAPES)}")
    dev = qp.H.device
    for name, t, shape in (
        ("H", qp.H, (B, Np1, nvar, nvar)), ("g", qp.g, (B, Np1, nvar)),
        ("A", qp.A, (B, N, nx, nx)), ("B", qp.B, (B, N, nx, nu)), ("c", qp.c, (B, N, nx)),
        ("lb", qp.lb, (B, Np1, nrows)), ("ub", qp.ub, (B, Np1, nrows)),
        ("mask_l", qp.mask_l, (B, Np1, nrows)), ("mask_u", qp.mask_u, (B, Np1, nrows)),
    ):
        _check(t, name, shape, dev)

    lb = torch.where(qp.mask_l > 0, qp.lb, -1e15)
    ub = torch.where(qp.mask_u > 0, qp.ub, 1e15)
    Dh = qp.D[:, :, nvar:, :] if nh else qp.D.new_zeros(B, Np1, 1, nvar)
    inputs = [x.contiguous() for x in (qp.H, qp.g, qp.A, qp.B, qp.c, Dh, lb, ub)]
    if warm_duals is not None:
        wl, wu, ok = warm_duals
        _check(wl, "lam_l", (B, Np1, nrows), dev)
        _check(wu, "lam_u", (B, Np1, nrows), dev)
        if tuple(ok.shape) != (B,):
            raise ValueError(f"ok has shape {tuple(ok.shape)}, expected ({B},)")
        inputs += [wl.contiguous(), wu.contiguous(), ok.to(torch.float32).contiguous()]
    else:
        dummy = qp.H.new_zeros(1)
        inputs += [dummy, dummy, dummy]
    outputs = [torch.empty(shape, device=dev)
               for shape in ((B, Np1, nvar), (B, Np1, nrows), (B, Np1, nrows), (B,))]
    return inputs, outputs, N, nh


def solve_qp_cuda(
    qp: QPData,
    nu: int,
    nx: int,
    iterations: int,
    mu0: float = 1e1,
    reg: float = 1e-7,
    tau: float = 0.995,
    warm_duals=None,
    mehrotra: bool = True,
    sigma_fixed: float = 0.1,
) -> QPSolution:
    """Batched QP solve with the solve_qp_pallas contract: QPData with a
    leading batch axis. One launch, one warp per batch element."""
    if qp.H.device.type == "cpu":
        return solve_qp(qp, nu, nx, iterations=iterations, mu0=mu0, reg=reg, tau=tau,
                        warm_duals=warm_duals, mehrotra=mehrotra, sigma_fixed=sigma_fixed)
    if qp.H.device.type != "cuda":
        raise ValueError(f"solve_qp_cuda takes CUDA (or CPU) tensors, got {qp.H.device}")
    inputs, outputs, N, nh = _qp_arguments(qp, nu, nx, warm_duals)
    load_kernels().qp(inputs, outputs, N, nu, nx, nh, int(iterations), float(mu0), float(reg),
                      float(tau), warm_duals is not None, bool(mehrotra), float(sigma_fixed))
    launch_counts["qp"] += 1
    return QPSolution(*outputs)


class _QPLaunch(ctypes.Structure):
    """ops/csrc/qp_launch.h::QPLaunch."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("H", "g", "A", "Bm", "c", "Dh", "lb", "ub", "wl", "wu",
                                                "wok", "dz", "lam_l", "lam_u", "mu")]
                + [(n, ctypes.c_int) for n in ("B", "N", "nu", "nx", "nh", "iterations")]
                + [(n, ctypes.c_float) for n in ("mu0", "reg", "tau", "sigma_fixed")]
                + [(n, ctypes.c_int) for n in ("use_warm", "mehrotra")])


def solve_qp_host(qp: QPData, nu: int, nx: int, iterations: int, build_dir: str, mu0: float = 1e1,
                  reg: float = 1e-7, tau: float = 0.995, warm_duals=None, mehrotra: bool = True,
                  sigma_fixed: float = 0.1) -> QPSolution:
    """K1's body (ops/csrc/ip_solve.cuh) built with the host compiler into
    `build_dir` (ops/csrc/qp_host.cpp: a team of one lane) and run on CPU
    tensors, with solve_qp_cuda's contract. For the CPU tests: the port's
    CPU path is the plain solve_qp, not this."""
    if qp.H.device.type != "cpu":
        raise ValueError(f"solve_qp_host takes CPU tensors, got {qp.H.device}")
    inputs, outputs, N, nh = _qp_arguments(qp, nu, nx, warm_duals)
    fn = load_c_library("mpc_qp_host", [os.path.join(CSRC, "qp_host.cpp")], build_dir).mpc_qp_solve_host
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.POINTER(_QPLaunch)]
    args = _QPLaunch(*(t.data_ptr() for t in (*inputs, *outputs)), qp.D.shape[0], N, nu, nx, nh,
                     int(iterations), float(mu0), float(reg), float(tau), float(sigma_fixed),
                     int(warm_duals is not None), int(bool(mehrotra)))
    if fn(ctypes.byref(args)):
        raise RuntimeError(f"qp host build has no instantiation for (nu={nu}, nx={nx})")
    return QPSolution(*outputs)


# -- the least time the card could take ---------------------------------------
# NVIDIA's data sheet for the H100 SXM: float32 outside the tensor cores,
# and the HBM3 rate.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(flops: float, nbytes: float):
    """(milliseconds, "operations" or "bytes"): the larger of the work's
    operations over the card's peak float32 rate and its bytes (each input
    read once, each output written once) over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


_INVERSE_FLOPS = {1: 1, 2: 9, 3: 36}  # ip_solve.cuh::sym_inv


def riccati_step_flops(nu: int, nx: int) -> int:
    """One backward step of the Riccati factorization (ip_solve.cuh): P A
    and P B, R-hat and S-hat, the closed-form inverse, K, the new P and its
    symmetrization. A multiply-add counts 2."""
    nv = nu + nx
    return (2 * nx * nx * nv  # PA, PB
            + nu * nu * (2 * nx + 2) + nu * nx * (2 * nx + 1)  # R-hat (+ reg), S-hat
            + _INVERSE_FLOPS[nu] + nu * nx * 2 * nu  # inverse, K
            + nx * nx * (2 * nx + 2 * nu + 2) + 2 * nx * nx)  # P_new, 0.5 (P + P')


def qp_work(N: int, nu: int, nx: int, nh: int, iterations: int, mehrotra: bool = True,
            warm: bool = False):
    """(flops, bytes) of ONE element's solve in K1, counted from
    ip_solve.cuh pass by pass (adds, multiplies and divisions count 1 each,
    comparisons and selects 0; the fixed-count loop does all of it whatever
    the data). Bytes: every input read once, every output written once."""
    nv = nu + nx
    nr = nv + nh
    rows, nz, ns = (N + 1) * nr, (N + 1) * nv, nv * (nv + 1) // 2
    direction = 18  # rho (6), ds (4), dlam (8) of one row
    linear_solve = (19 * rows  # gradient weight of every row
                    + nz * (1 + 2 * nh)  # g-bar
                    + N * (2 * nx * nx + 2 * nu * nx + 2 * nu * nu + nx * (2 * nx + 2 * nu))  # backward
                    + N * (nu * (2 * nx + 1) + nx * (2 * nx + 2 * nu + 1))  # rollout
                    + (N + 1) * nh * 2 * nv)  # D dz
    if mehrotra:
        targets = (4 + (direction + 8) + (direction + 14) + (direction + 10)) * rows
    else:
        targets = 6 * rows
    per_iteration = (6 * rows  # complementarity
                     + 5 * rows  # barrier weights
                     + (N + 1) * (3 * nh * ns + nv)  # H-bar
                     + N * nx * (2 * nx + 2 * nu + 2) + nz * 2 * nv  # residual, gradient
                     + N * riccati_step_flops(nu, nx)
                     + targets + (2 if mehrotra else 1) * linear_solve
                     + (direction + 12) * rows  # step lengths
                     + 2 * nz + (direction + 10) * rows)  # update
    flops = 7 * rows + iterations * per_iteration + 6 * rows  # init, loop, final mu
    floats = ((N + 1) * (nv * nv + nv + nh * nv + 2 * nr) + N * (nx * nx + nx * nu + nx)  # QP
              + (2 * rows + 1 if warm else 0)  # warm duals, ok
              + nz + 2 * rows + 1)  # dz, duals, mu
    return flops, 4 * floats


def mirror_work(n: int, sweeps: int = 6):
    """(flops, bytes) of K2 on ONE n x n matrix (mirror.cuh): per rotation
    the angle (12) and three passes of n entries at 6 each; then
    V max(|w|, lm) V' at 3 n per entry. In and out: n*n floats each."""
    rotations = sweeps * n * (n - 1) // 2
    return n * (n - 1) + rotations * (12 + 18 * n) + 3 * n ** 3, 4 * 2 * n * n
