"""Wrappers of the hand-written Hopper kernels K1 (QP) and K2 (MIRROR).

K1 `solve_qp_cuda` replaces mpc_planner_tpu/ops/pallas_qp.py::
solve_qp_pallas (-> _qp_kernel -> _ip_solve); K2 `mirror_cuda` replaces
pallas_qp.py::_mirror_lanes and ops/jacobi_eigh.py::mirror_unpacked.
Sources: ops/csrc/{qp_kernel.cu, mirror_kernel.cu}, bound by
ops/csrc/binding.cpp. They are compiled for sm_90a with
torch.utils.cpp_extension.load at first use, into the package's `_build/`
directory; nothing is compiled or imported when this module is imported.

Each wrapper takes its kernel's plain torch version (solver/qp.py::
solve_qp, ops/jacobi_eigh.py::mirror_unpacked) only for tensors that lie
on the CPU. For a CUDA tensor it launches the kernel or raises: a failed
build or launch is an error, never a silent fallback.
"""

from __future__ import annotations

import os
import threading

import torch

from mpc_planner_tpu_torch.ops.jacobi_eigh import mirror_unpacked
from mpc_planner_tpu_torch.solver.qp import QPData, QPSolution, solve_qp

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")

# Kernel launches made through the wrappers since the last reset
# (read by chip_smoke.py to show the main path went through the kernels).
launch_counts = {"qp": 0, "mirror": 0}

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
                sources=[os.path.join(_CSRC, f)
                         for f in ("binding.cpp", "qp_kernel.cu", "mirror_kernel.cu")],
                build_directory=BUILD_DIR,
                extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
                verbose=verbose,
            )
    return _ext


def _check(t: torch.Tensor, name: str, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def mirror_cuda(H: torch.Tensor, lm: float, sweeps: int = 6) -> torch.Tensor:
    """MIRROR (eigenvalues -> max(|w|, lm)) of a stack H [M, n, n], n <= 9.

    One kernel launch for the whole stack (one thread per matrix)."""
    if H.device.type == "cpu":
        return mirror_unpacked(H, lm, sweeps)
    if H.dim() != 3 or H.shape[1] != H.shape[2] or H.shape[1] not in MIRROR_SIZES:
        raise ValueError(f"mirror_cuda takes [M, n, n] with 2 <= n <= 9, got {tuple(H.shape)}")
    _check(H, "H", H.shape)
    if not H.is_contiguous():
        raise ValueError("H must be contiguous")
    ext = load_kernels()
    out = torch.empty_like(H)
    ext.mirror(H, out, float(lm), int(sweeps))
    launch_counts["mirror"] += 1
    return out


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [..., B] contiguous (batch innermost)."""
    return x.movedim(0, -1).contiguous()


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
    leading batch axis; the row masks are folded into +-1e15 bound
    sentinels and only the nh general rows of D go to the kernel."""
    if qp.H.device.type == "cpu":
        return solve_qp(qp, nu, nx, iterations=iterations, mu0=mu0, reg=reg, tau=tau,
                        warm_duals=warm_duals, mehrotra=mehrotra, sigma_fixed=sigma_fixed)
    B, Np1, nrows, nvar = qp.D.shape
    N = Np1 - 1
    nh = nrows - nvar
    if (nu, nx) not in QP_SHAPES or nu + nx != nvar or nh < 0:
        raise ValueError(
            f"solve_qp_cuda: (nu={nu}, nx={nx}, nvar={nvar}) not supported; kernel "
            f"instantiations: {sorted(QP_SHAPES)}")
    for name, t, shape in (
        ("H", qp.H, (B, Np1, nvar, nvar)), ("g", qp.g, (B, Np1, nvar)),
        ("A", qp.A, (B, N, nx, nx)), ("B", qp.B, (B, N, nx, nu)), ("c", qp.c, (B, N, nx)),
        ("lb", qp.lb, (B, Np1, nrows)), ("ub", qp.ub, (B, Np1, nrows)),
        ("mask_l", qp.mask_l, (B, Np1, nrows)), ("mask_u", qp.mask_u, (B, Np1, nrows)),
    ):
        _check(t, name, shape)

    lb = torch.where(qp.mask_l > 0, qp.lb, -1e15)
    ub = torch.where(qp.mask_u > 0, qp.ub, 1e15)
    Dh = qp.D[:, :, nvar:, :] if nh else qp.D.new_zeros(B, Np1, 1, nvar)
    inputs = [_lanes(x) for x in (qp.H, qp.g, qp.A, qp.B, qp.c, Dh, lb, ub)]
    if warm_duals is not None:
        wl, wu, ok = warm_duals
        _check(wl, "lam_l", (B, Np1, nrows))
        _check(wu, "lam_u", (B, Np1, nrows))
        if tuple(ok.shape) != (B,):
            raise ValueError(f"ok has shape {tuple(ok.shape)}, expected ({B},)")
        inputs += [_lanes(wl), _lanes(wu), ok.to(torch.float32).contiguous()]
    else:
        dummy = qp.H.new_zeros(1)
        inputs += [dummy, dummy, dummy]

    ext = load_kernels()
    dev = qp.H.device
    dz = torch.empty(Np1, nvar, B, device=dev)
    lam_l = torch.empty(Np1, nrows, B, device=dev)
    lam_u = torch.empty(Np1, nrows, B, device=dev)
    mu = torch.empty(B, device=dev)
    scratch = torch.empty(ext.qp_scratch_floats(N, nu, nx, nh) * B, device=dev)
    ext.qp(inputs, [dz, lam_l, lam_u, mu], scratch, N, nu, nx, nh, int(iterations),
           float(mu0), float(reg), float(tau), warm_duals is not None, bool(mehrotra),
           float(sigma_fixed))
    launch_counts["qp"] += 1
    return QPSolution(dz=dz.movedim(-1, 0), lam_l=lam_l.movedim(-1, 0),
                      lam_u=lam_u.movedim(-1, 0), mu=mu)
