"""Frozen copy of the port's solver/sqp.py, plain route only, in a chosen
precision (float64 by default).

SQP-RTI solver: linearize -> MIRROR -> IP-Riccati QP -> full step,
iterated, over a batch of OCP instances.

Counterpart of mpc_planner_tpu/solver/sqp.py (the reference's acados
SQP_RTI solver plus its iteration wrapper, acados_solver_interface.cpp:
86-204: EXACT Hessian with MIRROR regularization and FIXED_STEP
globalization, generate_acados_solver.py:155-162).

  * Linearization is `torch.func` (vmap of jacfwd / grad / hessian) of
    the module expressions, over all B*N stages at once.
  * MIRROR and the QP are the plain versions of the port's kernels
    (ops/jacobi_eigh.py, solver/qp.py), one RTI iteration at a time.
  * One batched RTI loop serves every caller: `solve` is a batch of one.
    The per-cycle stall escalation reads exit codes on the host, a
    deliberate host sync, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import hessian, vmap

from mpcbench.reference.frozen.ops.jacobi_eigh import mirror_nvar
from mpcbench.reference.frozen.ops.rti import stage_derivatives
from mpcbench.reference.frozen.solver.ocp import OCP
from mpcbench.reference.frozen.solver.qp import QPData, solve_qp

# Exit codes follow the reference's Forces-style convention
# (acados_solver_interface.cpp:198-203 remaps acados codes to these).
EXIT_SUCCESS = 1
EXIT_FAILURE = -1
EXIT_NOT_OPTIMIZED_YET = -999  # ref controller_module.h:13


class SolveResult(NamedTuple):
    Z: torch.Tensor  # [B, N+1, nvar] solution trajectory (u, x per stage)
    exit_code: torch.Tensor  # [B] int32: 1 success / 0 max-iter (SQP) / -1 failure
    pobj: torch.Tensor  # [B] nonlinear objective at the solution
    res_eq: torch.Tensor  # [B] max dynamics defect
    qp_mu: torch.Tensor  # [B] final interior-point complementarity
    iters: torch.Tensor  # [B] SQP iterations applied per element
    lam_l: torch.Tensor  # [B, N+1, nrows] final QP duals: the next
    lam_u: torch.Tensor  # cycle's warm_duals (HPIPM warm_start=2)


def branches(warm, cold, adopt, near) -> dict:
    """Both outcomes of an escalation decision, for the benchmark's judge:
    the warm solve's and the escalated one's plans, successes, costs and
    final duals (lam_l and lam_u side by side; None where it did not run),
    which elements adopted the escalated one, and which lay near a
    threshold. (Not in the port: the benchmark's.)"""
    def host(res):
        if res is None:
            return None, None, None, None
        return (res.Z.detach().cpu().double().numpy(),
                res.exit_code.detach().cpu().numpy() == EXIT_SUCCESS,
                res.pobj.detach().cpu().double().numpy(),
                torch.cat([res.lam_l, res.lam_u], dim=-1).detach().cpu().double().numpy())
    out = {"adopt": np.asarray(adopt, bool), "near": np.asarray(near, bool)}
    for name, res in (("warm", warm), ("cold", cold)):
        out[f"{name}_Z"], out[f"{name}_ok"], out[f"{name}_pobj"], out[f"{name}_lam"] = host(res)
    return out


class SQPSolver:
    """SQP-RTI solver for one OCP specification on one device: the card
    (`device=None`: cuda:0, an error without CUDA) unless the caller asks
    for another, as the CPU tests do with `device="cpu"`."""

    def __init__(self, ocp: OCP, device="cpu", iterations: Optional[int] = None,
                 qp_iterations: Optional[int] = None, dtype=torch.float64):
        self.ocp = ocp
        self.device = torch.device(device)
        self.dtype = dtype
        self.rounding = None
        cfg = ocp.cfg
        s = cfg.solver
        self.iterations = s.iterations if iterations is None else iterations
        self.qp_iterations = s.qp_iterations if qp_iterations is None else qp_iterations
        self.warm_qp_iters = s.qp_warm_iterations if s.qp_warm_iterations > 0 else 4
        self.qp_mu_stall = float(s.qp_mu_stall)
        self.lm = s.levenberg_marquardt
        self.tol_eq = s.tol_eq_residual
        self.mu0 = s.qp_mu0
        self.qp_retry_cold = bool(s.qp_retry_cold)

        N, nu, nx, nvar, nh = ocp.N, ocp.nu, ocp.nx, ocp.nvar, ocp.nh
        self.nrows = nu + nx + nh

        # Static row templates: box rows are the identity over z; masks
        # switch off u-box + h rows at the terminal node, x-box rows at
        # stage 0 and infinite bounds everywhere.
        f32 = dict(dtype=self.dtype, device=self.device)
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

        # MIRROR structure: when the running cost's u-block is diagonal and
        # decoupled from x, mirror(blkdiag(D, Hxx)) =
        # blkdiag(max(|D|, lm), mirror(Hxx)) — an nx x nx eigenproblem.
        structure = s.mirror_structure
        if structure == "auto":
            self._mirror_x_only = self._probe_u_separable()
        else:
            self._mirror_x_only = structure == "x_only"

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

    def _mirror_nvar(self, H):
        """MIRROR a [M, nvar, nvar] stage-Hessian stack, exploiting the
        u-separable block structure when detected."""
        return mirror_nvar(H, self.lm, self.ocp.nu, self._mirror_x_only)

    # -- linearization ----------------------------------------------------
    def _linearize(self, Z, P):
        """QPData of the batch Z [B, N+1, nvar], P [B, N+1, npar], with the
        stage Hessians MIRROR-regularized (the terminal row's zero u-block
        mirrors to lm*I, which the QP's terminal stage never reads)."""
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
        solve. With `self.rounding` (a function on tensors) the QP's data
        and its step are rounded by it: the benchmark's lower-precision
        control."""
        ocp = self.ocp
        common = dict(mu0=self.mu0, **kw)
        qp = self._linearize(Z, P)
        if self.rounding is not None:
            qp = type(qp)(*(self.rounding(t) for t in qp))
        sol = solve_qp(qp, ocp.nu, ocp.nx, **common)
        if self.rounding is not None:
            sol = sol._replace(dz=self.rounding(sol.dz))
        return sol

    # -- batched SQP-RTI loop ---------------------------------------------
    def batch_impl(self, Z0, P, xinit, num_iterations: int, warm0=None,
                   escalated: bool = False) -> SolveResult:
        """One batched solve, no escalation. Z0 [B, N+1, nvar],
        P [B, N+1, npar], xinit [B, nx] tensors on the solver's device;
        `warm0` = (lam_l, lam_u, ok [B]) duals from the previous control
        cycle. `escalated` runs every QP at the full cold budget."""
        ocp = self.ocp
        nu = ocp.nu
        wi = self.qp_iterations if escalated else self.warm_qp_iters

        Z = Z0.clone()
        Z[:, 0, nu:] = xinit  # pin x_0 = xinit (ref setXinit + lbx0/ubx0)

        # First QP: cold at the full count, unless duals come from the
        # previous control cycle; later RTI iterations warm-start from the
        # previous QP's duals and run the short warm count.
        sol = self._linearize_and_solve(
            Z, P, iterations=self.qp_iterations if warm0 is None else wi, warm_duals=warm0)
        Z = Z + sol.dz  # FIXED_STEP globalization
        for _ in range(num_iterations - 1):
            sol = self._linearize_and_solve(
                Z, P, iterations=wi, warm_duals=(sol.lam_l, sol.lam_u, sol.mu < 1e-2))
            Z = Z + sol.dz
        iters = torch.full((Z.shape[0],), num_iterations, dtype=torch.int32, device=Z.device)
        code, pobj, res_eq = self._exit_codes(Z, P)
        return SolveResult(Z=Z, exit_code=code, pobj=pobj, res_eq=res_eq,
                           qp_mu=sol.mu, iters=iters, lam_l=sol.lam_l, lam_u=sol.lam_u)

    def _exit_codes(self, Z, P):
        """(exit code, pobj, res_eq) of final iterates Z."""
        ocp = self.ocp
        res_eq = vmap(ocp.eq_residual)(Z, P)
        pobj = vmap(ocp.total_cost)(Z, P)
        finite = torch.isfinite(res_eq) & torch.isfinite(pobj) & torch.isfinite(Z).all(dim=(1, 2))
        ok = finite & (res_eq <= self.tol_eq)
        code = torch.where(ok, EXIT_SUCCESS, EXIT_FAILURE)
        return code.to(torch.int32), pobj, res_eq

    # -- public API --------------------------------------------------------
    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype or self.dtype, device=self.device)

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
        self.last_branches = None
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
        near = self.near_thresholds(res, applied)
        if not (failed | stalled).any() and not near.any():
            self.last_branches = branches(res, None, np.zeros_like(near), near)
            return res
        cold = self.batch_impl(*args, n, escalated=True)
        # Adopt the escalated result where it is strictly better than a
        # failed one, or where a stalled element's full-budget solve also
        # succeeded.
        m = (self._tensor(failed, torch.bool) & (cold.exit_code > res.exit_code)) | (
            self._tensor(stalled, torch.bool) & (cold.exit_code == EXIT_SUCCESS))
        near |= self.near_thresholds(cold, applied, mu=False)
        self.last_branches = branches(res, cold, m.cpu().numpy(), near)

        def pick(w, c):
            return torch.where(m.reshape((-1,) + (1,) * (w.dim() - 1)), c, w)

        return SolveResult(*(pick(w, c) for w, c in zip(res, cold)))

    def near_thresholds(self, res, applied=None, mu: bool = True, factor: float = 10.0):
        """Elements whose escalation or exit decision lies within `factor` of
        its threshold (the final barrier mu against qp_mu_stall, the dynamics
        defect against tol_eq_residual): where a solve in another rounding
        may take the other branch. (Not in the port: the benchmark's.)"""
        r = res.res_eq.detach().cpu().double().numpy()
        near = (r > self.tol_eq / factor) & (r < self.tol_eq * factor)
        if mu:
            q = res.qp_mu.detach().cpu().double().numpy()
            near |= (q > self.qp_mu_stall / factor) & (q < self.qp_mu_stall * factor)
        if applied is not None:
            near &= applied
        return near
