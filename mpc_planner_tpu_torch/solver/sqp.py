"""SQP-RTI solver: linearize -> MIRROR -> IP-Riccati QP -> full step,
iterated, over a batch of OCP instances.

Counterpart of mpc_planner_tpu/solver/sqp.py (the reference's acados
SQP_RTI solver plus its iteration wrapper, acados_solver_interface.cpp:
86-204: EXACT Hessian with MIRROR regularization and FIXED_STEP
globalization, generate_acados_solver.py:155-162).

  * Linearization is `torch.func` (vmap of jacfwd / grad / hessian) of
    the module expressions, over all B*N stages at once.
  * MIRROR and the QP run on the configured backend: "cuda" launches the
    hand-written Hopper kernels (ops/cuda_qp.py), "torch" runs their
    plain versions (solver/qp.py, ops/jacobi_eigh.py).
    On the cuda backend the unfused loop hands K1 the RAW Hessians and
    K1 runs the MIRROR itself (no standalone MIRROR launch).
  * The fused route on the cuda backend runs the whole RTI loop
    (linearization with generated derivative code, MIRROR, every QP) in
    one launch of the fused kernel (ops/cuda_rti.py). `solver.rti_fused`:
    "on" asks for it, "auto" takes it wherever it can be built
    (`SQPSolver.rti_fused_reason` says why not), "off" keeps the unfused
    loop.
  * One batched RTI loop serves every caller: `solve` is a batch of one.
    The per-cycle stall escalation reads exit codes on the host, a
    deliberate host sync, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import hessian, vmap

from mpc_planner_tpu_torch import default_device
from mpc_planner_tpu_torch.ops.cuda_qp import QP_SHAPES, mirror_cuda, solve_qp_cuda
from mpc_planner_tpu_torch.ops.cuda_rti import solve_rti_cuda
from mpc_planner_tpu_torch.ops.jacobi_eigh import mirror_nvar, mirror_unpacked
from mpc_planner_tpu_torch.ops.rti import stage_derivatives
from mpc_planner_tpu_torch.ops.stage_codegen import StageCode
from mpc_planner_tpu_torch.solver.ocp import OCP
from mpc_planner_tpu_torch.solver.qp import QPData, solve_qp

# Exit codes follow the reference's Forces-style convention
# (acados_solver_interface.cpp:198-203 remaps acados codes to these).
EXIT_SUCCESS = 1
EXIT_FAILURE = -1
EXIT_NOT_OPTIMIZED_YET = -999  # ref controller_module.h:13


def explain_exit_flag(code: int) -> str:
    """Human-readable exit explanation (ref acados_solver_interface.cpp:
    391-424 explainExitFlag)."""
    return {
        EXIT_SUCCESS: "Success",
        0: "Maximum number of iterations reached",
        EXIT_FAILURE: "Solver failed (QP infeasible, NaN, or residual above tolerance)",
        EXIT_NOT_OPTIMIZED_YET: "Not optimized yet",
    }.get(int(code), f"Unknown exit code {code}")


class SolveResult(NamedTuple):
    Z: torch.Tensor  # [B, N+1, nvar] solution trajectory (u, x per stage)
    exit_code: torch.Tensor  # [B] int32: 1 success / 0 max-iter (SQP) / -1 failure
    pobj: torch.Tensor  # [B] nonlinear objective at the solution
    res_eq: torch.Tensor  # [B] max dynamics defect
    qp_mu: torch.Tensor  # [B] final interior-point complementarity
    iters: torch.Tensor  # [B] SQP iterations applied per element
    lam_l: torch.Tensor  # [B, N+1, nrows] final QP duals: the next
    lam_u: torch.Tensor  # cycle's warm_duals (HPIPM warm_start=2)


def resolve_qp_backend(backend: str, device: torch.device, nu: int, nx: int) -> str:
    """The QP backend for a solver on `device`. "auto" picks "cuda" on a
    CUDA device when K1 is instantiated for (nu, nx) (ops/cuda_qp.py::
    QP_SHAPES; the reference's own gate is nu <= 3 and nvar <= 9,
    mpc_planner_tpu/solver/sqp.py:176-179), else "torch"."""
    if backend == "auto":
        return "cuda" if device.type == "cuda" and (nu, nx) in QP_SHAPES else "torch"
    if backend not in ("cuda", "torch"):
        raise ValueError(f"qp_backend must be 'auto', 'cuda' or 'torch', got {backend!r}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"qp_backend='cuda' needs a CUDA device, got {device}")
    return backend


class SQPSolver:
    """SQP-RTI solver for one OCP specification on one device: the card
    (`device=None`: cuda:0, an error without CUDA) unless the caller asks
    for another, as the CPU tests do with `device="cpu"`."""

    def __init__(self, ocp: OCP, device=None, iterations: Optional[int] = None,
                 qp_iterations: Optional[int] = None):
        # Full-precision f32 products: TF32 breaks Riccati positive
        # definiteness (the reference forces "highest" for the same
        # reason, mpc_planner_tpu/solver/sqp.py:421-425).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.ocp = ocp
        self.device = default_device(device)
        cfg = ocp.cfg
        s = cfg.solver
        self.iterations = s.iterations if iterations is None else iterations
        self.qp_iterations = s.qp_iterations if qp_iterations is None else qp_iterations
        self.warm_qp_iters = s.qp_warm_iterations if s.qp_warm_iterations > 0 else 4
        self.qp_mu_stall = float(s.qp_mu_stall)
        self.lm = s.levenberg_marquardt
        self.tol_eq = s.tol_eq_residual
        self.mu0 = s.qp_mu0
        self.solver_type = s.solver_type
        self.tol_stat = s.tol_stationarity
        self.warm_corrector_only = bool(s.qp_warm_corrector_only)
        self.warm_sigma = float(s.qp_warm_sigma)
        self.qp_retry_cold = bool(s.qp_retry_cold)
        # The parallel-in-horizon scans: plain torch path only (the key's note)
        self.horizon_parallel = bool(s.horizon_parallel)

        N, nu, nx, nvar, nh = ocp.N, ocp.nu, ocp.nx, ocp.nvar, ocp.nh
        self.nrows = nu + nx + nh

        self.qp_backend = resolve_qp_backend(s.qp_backend, self.device, nu, nx)

        # Fused route: the whole RTI loop in one launch of K3, where the
        # reference's conditions hold (mpc_planner_tpu/solver/sqp.py:187-194:
        # SQP mode needs the per-iteration convergence freeze, and
        # corrector-only warm QPs a Mehrotra flag for the first QP that
        # differs from the later ones: both stay unfused) and the stage-code
        # generator covers the OCP. "on" raises here for an OCP it does not
        # cover; "auto" then resolves off, and `rti_fused_reason` names the
        # op and the stage function. (The reference's "auto" resolves off
        # always, because its TPU compiler cannot build the fused program,
        # sqp.py:195-207; nvcc builds this one in about a minute.)
        if s.rti_fused not in ("auto", "on", "off"):
            raise ValueError(f"rti_fused must be 'auto', 'on' or 'off', got {s.rti_fused!r}")
        self._stage_code = StageCode(ocp)
        self.rti_fused, self.rti_fused_reason = self._resolve_fused(s.rti_fused)

        # Static row templates: box rows are the identity over z; masks
        # switch off u-box + h rows at the terminal node, x-box rows at
        # stage 0 and infinite bounds everywhere.
        f32 = dict(dtype=torch.float32, device=self.device)
        D_box = np.zeros((nu + nx, nvar))
        D_box[:nu, :nu] = np.eye(nu)
        D_box[nu:, nu:] = np.eye(nx)
        self._D_box = torch.as_tensor(D_box, **f32)
        lbz, ubz = np.asarray(ocp.lb_z, float), np.asarray(ocp.ub_z, float)
        self._lbz = torch.as_tensor(np.where(np.isfinite(lbz), lbz, -1e15), **f32)
        self._ubz = torch.as_tensor(np.where(np.isfinite(ubz), ubz, 1e15), **f32)
        lf, uf = np.isfinite(lbz), np.isfinite(ubz)
        if nh:
            lh, uh = np.asarray(ocp.lh, float), np.asarray(ocp.uh, float)
            self._lh = torch.as_tensor(np.where(np.isfinite(lh), lh, -1e15), **f32)
            self._uh = torch.as_tensor(np.where(np.isfinite(uh), uh, 1e15), **f32)
            lf = np.concatenate([lf, np.isfinite(lh)])
            uf = np.concatenate([uf, np.isfinite(uh)])
        stage = np.arange(N + 1)[:, None]
        active = np.concatenate(
            [np.repeat(stage < N, nu, 1), np.repeat(stage > 0, nx, 1), np.repeat(stage < N, nh, 1)],
            axis=1)
        self._mask_l = torch.as_tensor((active & lf[None]).astype(float), **f32)
        self._mask_u = torch.as_tensor((active & uf[None]).astype(float), **f32)
        # The same rows as bound templates [N+1, nrows] for the fused route:
        # +-1e15 sentinels where a row is inactive (the kernel derives its
        # masks from a compare).
        lb_row = torch.cat([self._lbz, self._lh]) if nh else self._lbz
        ub_row = torch.cat([self._ubz, self._uh]) if nh else self._ubz
        self._lb_template = torch.where(self._mask_l > 0, lb_row, -1e15)
        self._ub_template = torch.where(self._mask_u > 0, ub_row, 1e15)

        # MIRROR structure: when the running cost's u-block is diagonal and
        # decoupled from x, mirror(blkdiag(D, Hxx)) =
        # blkdiag(max(|D|, lm), mirror(Hxx)) — an nx x nx eigenproblem.
        structure = s.mirror_structure
        if structure == "auto":
            self._mirror_x_only = self._probe_u_separable()
        else:
            self._mirror_x_only = structure == "x_only"

    def _resolve_fused(self, setting: str):
        """(whether the fused route runs, why not)."""
        if setting == "off":
            return False, "solver.rti_fused is 'off'"
        for ok, why in ((self.qp_backend == "cuda", f"the QP backend is {self.qp_backend!r}"),
                        (self.solver_type == "SQP_RTI", f"solver_type is {self.solver_type!r}"),
                        (not self.warm_corrector_only, "qp_warm_corrector_only is set")):
            if not ok:
                return False, why
        try:
            self._stage_code.generate()
        except ValueError as e:  # an op the generator does not cover
            if setting == "on":
                raise
            return False, str(e)
        return True, ""

    def _probe_u_separable(self, n_probes: int = 4) -> bool:
        """True iff the running-cost Hessian's u-block is diagonal and its
        u-x cross block is zero at random probe points (the reference's
        probe: same seed, same draws, on the CPU)."""
        ocp = self.ocp
        nu, nvar = ocp.nu, ocp.nvar
        rng = np.random.default_rng(0)
        hess = hessian(ocp.running_cost)
        for _ in range(n_probes):
            z = torch.as_tensor(rng.normal(0.0, 1.0, nvar), dtype=torch.float32)
            p = torch.as_tensor(rng.normal(0.0, 1.0, ocp.npar), dtype=torch.float32)
            H = hess(z, p).numpy()
            if not np.all(np.isfinite(H)):
                return False
            if np.max(np.abs(H[:nu, nu:])) > 1e-12:
                return False
            if np.max(np.abs(H[:nu, :nu] - np.diag(np.diag(H[:nu, :nu])))) > 1e-12:
                return False
        return True

    def _mirror(self, H, lm):
        """MIRROR of a [M, n, n] stack on the configured backend."""
        if self.qp_backend == "cuda":
            return mirror_cuda(H, lm)
        return mirror_unpacked(H, lm)

    def _mirror_nvar(self, H):
        """MIRROR a [M, nvar, nvar] stage-Hessian stack, exploiting the
        u-separable block structure when detected."""
        return mirror_nvar(H, self.lm, self.ocp.nu, self._mirror_x_only, self._mirror)

    # -- linearization ----------------------------------------------------
    def _linearize(self, Z, P, raw_hessian: bool = False):
        """QPData of the batch Z [B, N+1, nvar], P [B, N+1, npar], with the
        stage Hessians MIRROR-regularized (the terminal row's zero u-block
        mirrors to lm*I, which the QP's terminal stage never reads), or
        (`raw_hessian`) left exact for a QP kernel that regularizes them
        itself."""
        ocp = self.ocp
        N, nu, nx, nvar, nh = ocp.N, ocp.nu, ocp.nx, ocp.nvar, ocp.nh
        Bb = Z.shape[0]
        d = stage_derivatives(ocp, Z, P)
        A = d.Jf[..., nu:]
        Bm = d.Jf[..., :nu]
        c = d.f - Z[:, 1:, nu:]

        H_last = Z.new_zeros(Bb, 1, nvar, nvar)
        H_last[:, 0, nu:, nu:] = d.H_term[:, nu:, nu:]
        g_last = Z.new_zeros(Bb, 1, nvar)
        g_last[:, 0, nu:] = d.g_term[:, nu:]
        H = torch.cat([d.H_run, H_last], dim=1)
        if not raw_hessian:
            H = self._mirror_nvar(H.reshape(Bb * (N + 1), nvar, nvar)).reshape(Bb, N + 1, nvar, nvar)
        g = torch.cat([d.g_run, g_last], dim=1)

        # Rows per stage: [u-box, x-box, h]; bounds shifted to the iterate.
        D = self._D_box.expand(Bb, N + 1, nu + nx, nvar)
        lb = self._lbz - Z
        ub = self._ubz - Z
        if nh:
            Jh = torch.cat([d.Jh, Z.new_zeros(Bb, 1, nh, nvar)], dim=1)
            h_pad = torch.cat([d.h, Z.new_zeros(Bb, 1, nh)], dim=1)
            D = torch.cat([D, Jh], dim=2)
            lb = torch.cat([lb, self._lh - h_pad], dim=2)
            ub = torch.cat([ub, self._uh - h_pad], dim=2)
        else:
            D = D.contiguous()
        shape = (Bb, N + 1, self.nrows)
        return QPData(H=H, g=g, A=A, B=Bm, c=c, D=D, lb=lb, ub=ub,
                      mask_l=self._mask_l.expand(shape), mask_u=self._mask_u.expand(shape))

    def _linearize_and_solve(self, Z, P, **kw):
        """One RTI iteration's QP at the iterate Z: linearize, MIRROR,
        solve. On the cuda backend K1 takes the raw Hessians and runs the
        MIRROR in its prologue; on torch `_mirror_nvar` runs first."""
        ocp = self.ocp
        common = dict(mu0=self.mu0, sigma_fixed=self.warm_sigma, **kw)
        if self.qp_backend == "cuda":
            return solve_qp_cuda(self._linearize(Z, P, raw_hessian=True), ocp.nu, ocp.nx,
                                 mirror_lm=self.lm, mirror_x_only=self._mirror_x_only, **common)
        return solve_qp(self._linearize(Z, P), ocp.nu, ocp.nx,
                        horizon_parallel=self.horizon_parallel, **common)

    # -- batched SQP-RTI loop ---------------------------------------------
    def batch_impl(self, Z0, P, xinit, num_iterations: int, warm0=None,
                   escalated: bool = False) -> SolveResult:
        """One batched solve, no escalation. Z0 [B, N+1, nvar],
        P [B, N+1, npar], xinit [B, nx] tensors on the solver's device;
        `warm0` = (lam_l, lam_u, ok [B]) duals from the previous control
        cycle. `escalated` runs every QP at the full cold budget."""
        if self.rti_fused:
            return self._solve_batch_fused(Z0, P, xinit, num_iterations, warm0, escalated)
        ocp = self.ocp
        nu = ocp.nu
        sqp_mode = self.solver_type == "SQP"
        wi = self.qp_iterations if escalated else self.warm_qp_iters
        warm_mehrotra = not self.warm_corrector_only

        Z = Z0.clone()
        Z[:, 0, nu:] = xinit  # pin x_0 = xinit (ref setXinit + lbx0/ubx0)

        # First QP: cold at the full count, unless duals come from the
        # previous control cycle; later RTI iterations warm-start from the
        # previous QP's duals and run the short warm count.
        sol = self._linearize_and_solve(
            Z, P, iterations=self.qp_iterations if warm0 is None else wi,
            warm_duals=warm0, mehrotra=(warm0 is None) or warm_mehrotra)
        Z = Z + sol.dz  # FIXED_STEP globalization
        done = sol.dz.abs().amax(dim=(1, 2)) < self.tol_stat
        iters = torch.ones(Z.shape[0], dtype=torch.int32, device=Z.device)
        for _ in range(num_iterations - 1):
            sol = self._linearize_and_solve(
                Z, P, iterations=wi,
                warm_duals=(sol.lam_l, sol.lam_u, sol.mu < 1e-2), mehrotra=warm_mehrotra)
            if sqp_mode:
                Z = torch.where(done[:, None, None], Z, Z + sol.dz)
                iters = iters + (~done).to(torch.int32)
                done = done | (sol.dz.abs().amax(dim=(1, 2)) < self.tol_stat)
            else:
                Z = Z + sol.dz
                iters = iters + 1

        code, pobj, res_eq = self._exit_codes(Z, P, done if sqp_mode else None)
        return SolveResult(Z=Z, exit_code=code, pobj=pobj, res_eq=res_eq,
                           qp_mu=sol.mu, iters=iters, lam_l=sol.lam_l, lam_u=sol.lam_u)

    def _exit_codes(self, Z, P, done=None):
        """(exit code, pobj, res_eq) of final iterates Z; `done` (SQP mode)
        marks the elements that converged."""
        ocp = self.ocp
        res_eq = vmap(ocp.eq_residual)(Z, P)
        pobj = vmap(ocp.total_cost)(Z, P)
        finite = torch.isfinite(res_eq) & torch.isfinite(pobj) & torch.isfinite(Z).all(dim=(1, 2))
        ok = finite & (res_eq <= self.tol_eq)
        if done is None:
            code = torch.where(ok, EXIT_SUCCESS, EXIT_FAILURE)
        else:
            code = torch.where(ok & done, EXIT_SUCCESS, torch.where(ok, 0, EXIT_FAILURE))
        return code.to(torch.int32), pobj, res_eq

    def _solve_batch_fused(self, Z0, P, xinit, num_iterations: int, warm0=None,
                           escalated: bool = False) -> SolveResult:
        """The fused route of `batch_impl`: the whole RTI loop in one launch
        of K3 (ops/cuda_rti.py; on CPU tensors its plain version), with the
        unfused loop's warm-start ladder (mpc_planner_tpu/solver/sqp.py:
        624-670)."""
        nu = self.ocp.nu
        Z0 = Z0.clone()
        Z0[:, 0, nu:] = xinit
        wi = self.qp_iterations if escalated else self.warm_qp_iters
        res = solve_rti_cuda(
            Z0, P, self._stage_code, lb_template=self._lb_template, ub_template=self._ub_template,
            num_iterations=num_iterations, it0=self.qp_iterations if warm0 is None else wi,
            warm_iters=wi, mu0=self.mu0, warm_duals=warm0, mehrotra=True,
            sigma_fixed=self.warm_sigma, lm=self.lm, mirror_x_only=self._mirror_x_only)
        code, pobj, res_eq = self._exit_codes(res.Z, P)
        iters = torch.full((Z0.shape[0],), num_iterations, dtype=torch.int32, device=Z0.device)
        return SolveResult(Z=res.Z, exit_code=code, pobj=pobj, res_eq=res_eq, qp_mu=res.mu,
                           iters=iters, lam_l=res.lam_l, lam_u=res.lam_u)

    # -- public API --------------------------------------------------------
    def bound_limited_vars(self, Z, tol: float = 1e-2):
        """Variables within `tol` of a box bound in a solution Z [N+1, nvar]
        (numpy or a tensor): the acados wrapper's printIfBoundLimited
        (acados_solver_interface.cpp:426-446). A list of (stage, name,
        "lower" | "upper"); stage-0 states are skipped (pinned to xinit, as
        the reference skips 'x' at k == 0)."""
        ocp = self.ocp
        Z = Z.detach().cpu().numpy() if isinstance(Z, torch.Tensor) else np.asarray(Z)
        lb = np.asarray(ocp.lb_z, dtype=float)
        ub = np.asarray(ocp.ub_z, dtype=float)
        names = list(ocp.model.inputs) + list(ocp.model.states)
        hits = []
        for k in range(Z.shape[0]):
            for j, name in enumerate(names):
                if k == 0 and j >= ocp.nu:
                    continue
                if np.isfinite(lb[j]) and abs(Z[k, j] - lb[j]) < tol:
                    hits.append((k, name, "lower"))
                if np.isfinite(ub[j]) and abs(Z[k, j] - ub[j]) < tol:
                    hits.append((k, name, "upper"))
        return hits

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def solve(self, Z0, P, xinit, num_iterations: Optional[int] = None,
              warm_duals=None) -> SolveResult:
        """Single solve, as a batch of one. Z0 [N+1, nvar] warmstart,
        P [N+1, npar], xinit [nx]; `warm_duals` = (lam_l [N+1, nrows],
        lam_u, ok scalar) from the previous cycle's SolveResult."""
        res = self.solve_batch(
            self._tensor(Z0)[None], self._tensor(P)[None], self._tensor(xinit)[None],
            num_iterations=num_iterations,
            warm_duals=None if warm_duals is None else tuple(
                torch.as_tensor(w, device=self.device).reshape((1,) + tuple(np.shape(w)))
                for w in warm_duals),
        )
        return SolveResult(*(f[0] for f in res))

    def solve_batch(self, Z0, P, xinit, num_iterations: Optional[int] = None,
                    warm_duals=None) -> SolveResult:
        """Batched solve over a leading axis. `warm_duals` = (lam_l
        [B, N+1, nrows], lam_u, ok [B]) carried from the previous cycle.

        Elements that FAIL, or end res_eq-feasible with the barrier mu
        still above `qp_mu_stall`, are re-solved at the full IP budget in
        the same cycle (`solver.qp_retry_cold`); with warm duals only the
        elements whose duals were applied are escalated. Reading the exit
        codes is a host sync."""
        n = self.iterations if num_iterations is None else max(int(num_iterations), 1)
        args = (self._tensor(Z0), self._tensor(P), self._tensor(xinit))
        if warm_duals is None:
            res = self.batch_impl(*args, n)
            applied = None
        else:
            wl, wu, ok = warm_duals
            ok = self._tensor(ok, torch.bool)
            res = self.batch_impl(*args, n, warm0=(self._tensor(wl), self._tensor(wu), ok))
            applied = ok.cpu().numpy()
        if not self.qp_retry_cold:
            return res
        if self.warm_qp_iters >= self.qp_iterations and applied is None:
            return res  # the escalated program would be identical
        codes = res.exit_code.cpu().numpy()
        failed = codes == EXIT_FAILURE
        stalled = (codes == EXIT_SUCCESS) & (res.qp_mu.cpu().numpy() > self.qp_mu_stall)
        if applied is not None:
            failed &= applied
            stalled &= applied
        if not (failed | stalled).any():
            return res
        cold = self.batch_impl(*args, n, escalated=True)
        # Adopt the escalated result where it is strictly better than a
        # failed one, or where a stalled element's full-budget solve also
        # succeeded.
        m = (self._tensor(failed, torch.bool) & (cold.exit_code > res.exit_code)) | (
            self._tensor(stalled, torch.bool) & (cold.exit_code == EXIT_SUCCESS))

        def pick(w, c):
            return torch.where(m.reshape((-1,) + (1,) * (w.dim() - 1)), c, w)

        return SolveResult(*(pick(w, c) for w, c in zip(res, cold)))
