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

from mpc_planner_tpu_torch.ops.cuda_qp import _check, launch_counts, mirror_work, qp_work
from mpc_planner_tpu_torch.ops.rti import RTIResult, linearize_torch, solve_rti_torch
from mpc_planner_tpu_torch.ops.stage_codegen import StageCode, load_library
from mpc_planner_tpu_torch.solver.qp import QPData

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SOLVE_ARGS = [_P] * 11 + [_I] * 8 + [_F] * 5  # without the scratch and the stream
_LINEARIZE_ARGS = [_P] * 12 + [_I] * 3 + [_F]  # without the stream
_SIGNATURES = {
    "mpc_rti_dims": (_I, [ctypes.POINTER(_I)]),
    "mpc_rti_scratch_floats": (ctypes.c_longlong, [_I]),
    "mpc_rti_shared_bytes": (ctypes.c_longlong, [_I, _I]),
    "mpc_rti_resident_blocks": (ctypes.c_longlong, [ctypes.c_longlong]),
    "mpc_rti_solve": (_I, _SOLVE_ARGS[:11] + [_P] + _SOLVE_ARGS[11:] + [_P]),
    "mpc_rti_linearize": (_I, _LINEARIZE_ARGS + [_P]),
}
_HOST_SIGNATURES = {
    "mpc_rti_solve_host": (None, _SOLVE_ARGS + [_I]),
    "mpc_rti_linearize_host": (None, _LINEARIZE_ARGS),
}


def _typed(lib: ctypes.CDLL, signatures) -> ctypes.CDLL:
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def load_rti(code: StageCode, verbose: bool = False) -> ctypes.CDLL:
    """Generate, build (first call per OCP and process) and load K3 for the
    OCP of `code`; checks that the library was built for its dimensions."""
    lib = _typed(load_library(code, "cuda", verbose=verbose), _SIGNATURES)
    dims = (ctypes.c_int * 4)()
    lib.mpc_rti_dims(dims)
    ocp = code.ocp
    if tuple(dims) != (ocp.nu, ocp.nx, ocp.nh, ocp.npar):
        raise RuntimeError(f"rti library dims {tuple(dims)} != OCP {(ocp.nu, ocp.nx, ocp.nh, ocp.npar)}")
    return lib


def _solve_arguments(Z0, P, code: StageCode, lb_template, ub_template, warm_duals):
    """Checks, and the kernel's arrays in its argument order, all
    element-major and contiguous (the layout the callers hold: no
    transpose): Z0, P, the templates, warm duals (or three dummies), then
    the outputs Z, lam_l, lam_u, mu."""
    ocp = code.ocp
    if ocp.nu > 3:
        raise ValueError(f"the rti kernel inverts R-hat in closed form, nu <= 3; got nu={ocp.nu}")
    B, Np1 = Z0.shape[:2]
    nrows, dev = ocp.nvar + ocp.nh, Z0.device
    _check(Z0, "Z", (B, Np1, ocp.nvar), dev)
    _check(P, "P", (B, Np1, ocp.npar), dev)
    _check(lb_template, "lb_template", (Np1, nrows), dev)
    _check(ub_template, "ub_template", (Np1, nrows), dev)
    if warm_duals is not None:
        wl, wu, ok = warm_duals
        _check(wl, "lam_l", (B, Np1, nrows), dev)
        _check(wu, "lam_u", (B, Np1, nrows), dev)
        if tuple(ok.shape) != (B,):
            raise ValueError(f"ok has shape {tuple(ok.shape)}, expected ({B},)")
        warm = [wl.contiguous(), wu.contiguous(), ok.to(torch.float32).contiguous()]
    else:
        warm = [Z0.new_zeros(1)] * 3
    inputs = [Z0.contiguous(), P.contiguous(), lb_template.contiguous(), ub_template.contiguous()]
    outputs = [torch.empty(shape, device=dev)
               for shape in ((B, Np1, ocp.nvar), (B, Np1, nrows), (B, Np1, nrows), (B,))]
    return inputs + warm, outputs


def _linearize_arguments(Z, P, code: StageCode, lb_template, ub_template):
    """As _solve_arguments, for the linearization alone: the inputs, and
    the QP's arrays by name (Dh: the general rows only)."""
    inputs, _ = _solve_arguments(Z, P, code, lb_template, ub_template, None)
    ocp = code.ocp
    B, Np1, nvar = Z.shape
    N, nu, nx, nh = Np1 - 1, ocp.nu, ocp.nx, ocp.nh
    out = dict(H=(Np1, nvar, nvar), g=(Np1, nvar), A=(N, nx, nx), B=(N, nx, nu), c=(N, nx),
               Dh=(Np1, max(nh, 1), nvar), lb=(Np1, nvar + nh), ub=(Np1, nvar + nh))
    return inputs[:4], {k: torch.empty((B,) + s, device=Z.device) for k, s in out.items()}


def _qp_data(q, nvar: int, nh: int) -> QPData:
    """QPData of the kernel's arrays (D with the identity box rows, masks
    from the sentinels)."""
    B, Np1 = q["g"].shape[:2]
    D = torch.eye(nvar, device=q["g"].device).expand(B, Np1, nvar, nvar)
    if nh:
        D = torch.cat([D, q["Dh"]], dim=2)
    return QPData(H=q["H"], g=q["g"], A=q["A"], B=q["B"], c=q["c"], D=D.contiguous(),
                  lb=q["lb"], ub=q["ub"], mask_l=(q["lb"] > -1e14).float(),
                  mask_u=(q["ub"] < 1e14).float())


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
    """Whole SQP-RTI solve of the batch in one kernel launch, one warp per
    batch element."""
    kw = dict(lb_template=lb_template, ub_template=ub_template, num_iterations=num_iterations,
              it0=it0, warm_iters=warm_iters, mu0=mu0, reg=reg, tau=tau, warm_duals=warm_duals,
              mehrotra=mehrotra, sigma_fixed=sigma_fixed, lm=lm, mirror_x_only=mirror_x_only)
    if Z0.device.type == "cpu":
        return solve_rti_torch(Z0, P, code.ocp, **kw)
    if Z0.device.type != "cuda":
        raise ValueError(f"solve_rti_cuda takes CUDA (or CPU) tensors, got {Z0.device}")
    if num_iterations < 1:
        raise ValueError(f"num_iterations must be >= 1, got {num_iterations}")
    inputs, outputs = _solve_arguments(Z0, P, code, lb_template, ub_template, warm_duals)
    lib = load_rti(code)
    B, N, dev = Z0.shape[0], Z0.shape[1] - 1, Z0.device
    scratch = torch.empty(lib.mpc_rti_scratch_floats(N) * B, device=dev)
    with torch.cuda.device(dev):
        err = lib.mpc_rti_solve(
            *(t.data_ptr() for t in (*inputs, *outputs, scratch)),
            *_solve_scalars(B, N, kw), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rti kernel launch failed: cudaError {err}")
    launch_counts["rti"] += 1
    return RTIResult(*outputs)


def rti_residency(code: StageCode, B: int, N: int):
    """(staged, resident blocks, waves) of a launch of K3 over B elements at
    horizon N on the current device: the launcher stages an element's QP in
    shared memory only where the whole batch is resident even so
    (mpc_rti_solve), and a batch past the resident blocks runs in waves."""
    lib = load_rti(code)
    resident = lib.mpc_rti_resident_blocks(lib.mpc_rti_shared_bytes(N, 1))
    staged = B <= resident
    if not staged:
        resident = lib.mpc_rti_resident_blocks(lib.mpc_rti_shared_bytes(N, 0))
    return staged, resident, -(-B // resident) if resident else None


def _solve_scalars(B: int, N: int, kw):
    return (B, N, int(kw["num_iterations"]), int(kw["it0"]), int(kw["warm_iters"]),
            int(kw["warm_duals"] is not None), int(bool(kw["mehrotra"])),
            int(bool(kw["mirror_x_only"])), float(kw["mu0"]), float(kw["reg"]), float(kw["tau"]),
            float(kw["sigma_fixed"]), float(kw["lm"]))


def linearize_cuda(Z, P, code: StageCode, *, lb_template, ub_template, lm: float,
                   mirror_x_only: bool) -> QPData:
    """The kernel's linearization alone at the iterate Z [B, N+1, nvar], as
    QPData (D with the identity box rows, masks from the sentinels)."""
    if Z.device.type == "cpu":
        return linearize_torch(code.ocp, Z, P, lb_template, ub_template, lm, mirror_x_only)
    if Z.device.type != "cuda":
        raise ValueError(f"linearize_cuda takes CUDA (or CPU) tensors, got {Z.device}")
    inputs, out = _linearize_arguments(Z, P, code, lb_template, ub_template)
    lib = load_rti(code)
    dev = Z.device
    with torch.cuda.device(dev):
        err = lib.mpc_rti_linearize(
            *(t.data_ptr() for t in (*inputs, *out.values())), Z.shape[0], Z.shape[1] - 1,
            int(bool(mirror_x_only)), float(lm), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rti linearize kernel launch failed: cudaError {err}")
    launch_counts["rti_linearize"] += 1
    return _qp_data(out, code.ocp.nvar, code.ocp.nh)


class HostRTI:
    """K3's body (ops/csrc/rti_kernel.cuh with the OCP's generated stage
    code) built with the host compiler into `build_dir` (a team of one
    lane) and run on CPU tensors, with the contracts of solve_rti_cuda and
    linearize_cuda. For the CPU tests: the port's CPU path is the plain
    solve_rti_torch, not this."""

    def __init__(self, code: StageCode, build_dir: str):
        self.code = code
        self.lib = _typed(load_library(code, "cpu", build_dir), _HOST_SIGNATURES)

    def solve(self, Z0, P, *, lb_template, ub_template, warm_duals=None, staged: bool = False,
              **kw) -> RTIResult:
        """`staged`: the linearized QP and the duals in the shared-memory
        block (the launcher's choice for a small batch) instead of scratch."""
        kw = dict(dict(mu0=1e1, reg=1e-7, tau=0.995, mehrotra=True, sigma_fixed=0.1, lm=1e-4,
                       mirror_x_only=False), warm_duals=warm_duals, **kw)
        if Z0.device.type != "cpu":
            raise ValueError(f"HostRTI takes CPU tensors, got {Z0.device}")
        inputs, outputs = _solve_arguments(Z0, P, self.code, lb_template, ub_template, warm_duals)
        self.lib.mpc_rti_solve_host(*(t.data_ptr() for t in (*inputs, *outputs)),
                                    *_solve_scalars(Z0.shape[0], Z0.shape[1] - 1, kw), int(staged))
        return RTIResult(*outputs)

    def linearize(self, Z, P, *, lb_template, ub_template, lm: float, mirror_x_only: bool) -> QPData:
        if Z.device.type != "cpu":
            raise ValueError(f"HostRTI takes CPU tensors, got {Z.device}")
        inputs, out = _linearize_arguments(Z, P, self.code, lb_template, ub_template)
        self.lib.mpc_rti_linearize_host(*(t.data_ptr() for t in (*inputs, *out.values())),
                                        Z.shape[0], Z.shape[1] - 1, int(bool(mirror_x_only)),
                                        float(lm))
        return _qp_data(out, self.code.ocp.nvar, self.code.ocp.nh)


def rti_work(code: StageCode, N: int, num_iterations: int, it0: int, warm_iters: int,
             mehrotra: bool = True, warm: bool = False, mirror_x_only: bool = False):
    """(flops, bytes) of ONE element's solve in K3: per RTI iteration the
    generated stage code on its dual numbers (StageCode.flops), a MIRROR
    per stage and the QP of K1 (qp_work); the fixed-count loops do all of
    it whatever the data. Bytes: Z0, P, the templates (read by every
    element), warm duals in; Z, the duals and mu out."""
    ocp = code.ocp
    nu, nx, nvar, nh = ocp.nu, ocp.nx, ocp.nvar, ocp.nh
    rows, nz = (N + 1) * (nvar + nh), (N + 1) * nvar
    stage = code.flops()
    mirror = mirror_work(nx if mirror_x_only else nvar)[0]
    linearize = (N * (stage["running_cost"] + stage["dynamics"] + stage["constraints"] + mirror
                      + 2 * (nvar + nh) + nx)  # bounds and the defect c
                 + stage["terminal_cost"] + mirror_work(nx)[0] + 2 * (nvar + nh))
    flops = (num_iterations * (linearize + nz)
             + qp_work(N, nu, nx, nh, it0, mehrotra)[0]
             + (num_iterations - 1) * qp_work(N, nu, nx, nh, warm_iters, mehrotra)[0])
    floats = (nz + (N + 1) * ocp.npar + 2 * rows + (2 * rows + 1 if warm else 0)
              + nz + 2 * rows + 1)
    return flops, 4 * floats
