"""Wrapper of the hand-written Hopper kernel K3: the whole SQP-RTI solve in
one launch.

`solve_rti_cuda` replaces mpc_planner_tpu/ops/pallas_rti.py::
solve_rti_pallas (-> _rti_kernel) with the same contract; `linearize_cuda`
runs the kernel's linearization alone for one iterate (a debug entry,
held against the unfused SQPSolver._linearize). The kernel is
ops/csrc/rti_kernel.cuh instantiated with the stage code generated for
the OCP (ops/stage_codegen.py), built for sm_90a at first use into the
package's `_build/` and loaded with ctypes; nothing is compiled when this
module is imported.

Both wrappers take the plain torch version (ops/rti.py) only for tensors
that lie on the CPU. For a CUDA tensor they launch the kernel or raise: a
failed code generation, build or launch is an error, never a fallback.
"""

from __future__ import annotations

import ctypes

import torch

from mpc_planner_tpu_torch.ops.cuda_qp import batch_innermost, launch_counts
from mpc_planner_tpu_torch.ops.rti import RTIResult, linearize_torch, solve_rti_torch
from mpc_planner_tpu_torch.ops.stage_codegen import StageCode, load_library
from mpc_planner_tpu_torch.solver.qp import QPData

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mpc_rti_dims": (_I, [ctypes.POINTER(_I)]),
    "mpc_rti_scratch_floats": (ctypes.c_longlong, [_I]),
    "mpc_rti_solve": (_I, [_P] * 12 + [_I] * 8 + [_F] * 5 + [_P]),
    "mpc_rti_linearize": (_I, [_P] * 12 + [_I] * 3 + [_F, _P]),
}


def load_rti(code: StageCode, verbose: bool = False) -> ctypes.CDLL:
    """Generate, build (first call per OCP and process) and load K3 for the
    OCP of `code`; checks that the library was built for its dimensions."""
    lib = load_library(code, "cuda", verbose=verbose)
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    dims = (ctypes.c_int * 4)()
    lib.mpc_rti_dims(dims)
    ocp = code.ocp
    if tuple(dims) != (ocp.nu, ocp.nx, ocp.nh, ocp.npar):
        raise RuntimeError(f"rti library dims {tuple(dims)} != OCP {(ocp.nu, ocp.nx, ocp.nh, ocp.npar)}")
    return lib


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _prepare(Z, P, code: StageCode, lb_template, ub_template):
    """Checks shared by both wrappers; the library and contiguous
    templates."""
    ocp = code.ocp
    if ocp.nu > 3:
        raise ValueError(f"the rti kernel inverts R-hat in closed form, nu <= 3; got nu={ocp.nu}")
    B, Np1 = Z.shape[:2]
    nrows = ocp.nvar + ocp.nh
    dev = Z.device
    _check(Z, "Z", (B, Np1, ocp.nvar), dev)
    _check(P, "P", (B, Np1, ocp.npar), dev)
    _check(lb_template, "lb_template", (Np1, nrows), dev)
    _check(ub_template, "ub_template", (Np1, nrows), dev)
    return load_rti(code), lb_template.contiguous(), ub_template.contiguous()


def solve_rti_cuda(
    Z0,  # [B, N+1, nvar] warm start (x0 rows already pinned to xinit)
    P,  # [B, N+1, npar]
    code: StageCode,
    *,
    lb_template,  # [N+1, nrows] bound values, -1e15 where inactive
    ub_template,  # [N+1, nrows], +1e15 where inactive
    num_iterations: int,
    it0: int,
    warm_iters: int,
    mu0: float = 1e1,
    reg: float = 1e-7,
    tau: float = 0.995,
    warm_duals=None,  # (lam_l [B, N+1, nrows], lam_u, ok [B])
    mehrotra: bool = True,
    sigma_fixed: float = 0.1,
    lm: float = 1e-4,
    mirror_x_only: bool = False,
) -> RTIResult:
    """Whole SQP-RTI solve of the batch in one kernel launch."""
    kw = dict(lb_template=lb_template, ub_template=ub_template, num_iterations=num_iterations,
              it0=it0, warm_iters=warm_iters, mu0=mu0, reg=reg, tau=tau, warm_duals=warm_duals,
              mehrotra=mehrotra, sigma_fixed=sigma_fixed, lm=lm, mirror_x_only=mirror_x_only)
    if Z0.device.type == "cpu":
        return solve_rti_torch(Z0, P, code.ocp, **kw)
    if num_iterations < 1:
        raise ValueError(f"num_iterations must be >= 1, got {num_iterations}")
    lib, lbT, ubT = _prepare(Z0, P, code, lb_template, ub_template)
    B, Np1, nvar = Z0.shape
    N, nrows, dev = Np1 - 1, lbT.shape[1], Z0.device
    if warm_duals is not None:
        wl, wu, ok = warm_duals
        _check(wl, "lam_l", (B, Np1, nrows), dev)
        _check(wu, "lam_u", (B, Np1, nrows), dev)
        if tuple(ok.shape) != (B,):
            raise ValueError(f"ok has shape {tuple(ok.shape)}, expected ({B},)")
        warm = [batch_innermost(wl), batch_innermost(wu), ok.to(torch.float32).contiguous()]
    else:
        warm = [Z0.new_zeros(1)] * 3
    Z0l, Pl = batch_innermost(Z0), batch_innermost(P)
    Z = torch.empty(Np1, nvar, B, device=dev)
    lam_l = torch.empty(Np1, nrows, B, device=dev)
    lam_u = torch.empty(Np1, nrows, B, device=dev)
    mu = torch.empty(B, device=dev)
    scratch = torch.empty(lib.mpc_rti_scratch_floats(N) * B, device=dev)
    with torch.cuda.device(dev):
        err = lib.mpc_rti_solve(
            *(t.data_ptr() for t in (Z0l, Pl, lbT, ubT, *warm, Z, lam_l, lam_u, mu, scratch)),
            B, N, int(num_iterations), int(it0), int(warm_iters), int(warm_duals is not None),
            int(bool(mehrotra)), int(bool(mirror_x_only)), float(mu0), float(reg), float(tau),
            float(sigma_fixed), float(lm), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rti kernel launch failed: cudaError {err}")
    launch_counts["rti"] += 1
    return RTIResult(Z=Z.movedim(-1, 0), lam_l=lam_l.movedim(-1, 0),
                     lam_u=lam_u.movedim(-1, 0), mu=mu)


def linearize_cuda(Z, P, code: StageCode, *, lb_template, ub_template, lm: float,
                   mirror_x_only: bool) -> QPData:
    """The kernel's linearization alone at the iterate Z [B, N+1, nvar], as
    QPData (D with the identity box rows, masks from the sentinels)."""
    if Z.device.type == "cpu":
        return linearize_torch(code.ocp, Z, P, lb_template, ub_template, lm, mirror_x_only)
    lib, lbT, ubT = _prepare(Z, P, code, lb_template, ub_template)
    ocp = code.ocp
    B, Np1, nvar = Z.shape
    N, nu, nx, nh, dev = Np1 - 1, ocp.nu, ocp.nx, ocp.nh, Z.device
    nrows = nvar + nh
    out = dict(H=(Np1, nvar, nvar), g=(Np1, nvar), A=(N, nx, nx), B=(N, nx, nu), c=(N, nx),
               Dh=(Np1, max(nh, 1), nvar), lb=(Np1, nrows), ub=(Np1, nrows))
    out = {k: torch.empty(s + (B,), device=dev) for k, s in out.items()}
    Zl, Pl = batch_innermost(Z), batch_innermost(P)
    with torch.cuda.device(dev):
        err = lib.mpc_rti_linearize(
            *(t.data_ptr() for t in (Zl, Pl, lbT, ubT, *out.values())),
            B, N, int(bool(mirror_x_only)), float(lm), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rti linearize kernel launch failed: cudaError {err}")
    launch_counts["rti_linearize"] += 1
    q = {k: v.movedim(-1, 0) for k, v in out.items()}
    D = torch.eye(nvar, device=dev).expand(B, Np1, nvar, nvar)
    if nh:
        D = torch.cat([D, q["Dh"]], dim=2)
    return QPData(H=q["H"], g=q["g"], A=q["A"], B=q["B"], c=q["c"], D=D.contiguous(),
                  lb=q["lb"], ub=q["ub"], mask_l=(q["lb"] > -1e14).float(),
                  mask_u=(q["ub"] < 1e14).float())
