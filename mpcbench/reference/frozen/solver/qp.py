"""Stagewise interior-point QP solved with Riccati sweeps, batched.

Counterpart of mpc_planner_tpu/solver/qp.py::solve_qp (the reference's
acados + HPIPM QP step, SURVEY.md §2.4). This is the plain torch version
of the hand-written CUDA QP kernel (ops/cuda_qp.py).

Same method as the reference: a fixed-count Mehrotra predictor-corrector
primal-dual IPM over the stagewise QP, whose Newton
systems are solved by a backward Riccati factorization (Cholesky of
R-hat, computed once per IP iteration) and two substitution sweeps.
Primal and dual step sizes are separate. The batch is a leading axis
written out (the reference vmaps an unbatched function); every freeze
decision is per element.

Per stage k = 0..N-1 the QP is
    min  1/2 dz_k' H_k dz_k + g_k' dz_k  (+ terminal x-term at N)
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + r_k
         lb_k <= D_k dz_k <= ub_k          (box rows + h-constraint rows)
with dx_0 = 0 (x_0 pinned to xinit). Infinite bounds are masked rows.
The terminal inputs are pinned to zero by the forward rollout, as in the
reference (a known reference defect kept for agreement).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QPData(NamedTuple):
    """Linearized stagewise QP, batched over the leading axis."""

    H: torch.Tensor  # [B, N+1, nvar, nvar]; terminal: x-block only
    g: torch.Tensor  # [B, N+1, nvar]
    A: torch.Tensor  # [B, N, nx, nx]
    B: torch.Tensor  # [B, N, nx, nu]
    c: torch.Tensor  # [B, N, nx] dynamics defects f(z_k) - x_{k+1}
    D: torch.Tensor  # [B, N+1, nrows, nvar]
    lb: torch.Tensor  # [B, N+1, nrows] shifted lower bounds (on D dz)
    ub: torch.Tensor  # [B, N+1, nrows]
    mask_l: torch.Tensor  # [B, N+1, nrows] 1.0 where lower side active
    mask_u: torch.Tensor  # [B, N+1, nrows]


class QPSolution(NamedTuple):
    dz: torch.Tensor  # [B, N+1, nvar]
    lam_l: torch.Tensor  # [B, N+1, nrows] final duals (warm-start the next QP)
    lam_u: torch.Tensor
    mu: torch.Tensor  # [B] final complementarity


_S_MIN = 1e-7
_W_MAX = 1e7
_MU_FREEZE = 1e-9  # stop updating once converged (f32 overflow guard)


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _cholesky(R):
    """Cholesky factor with NaN (not an exception) where R is not
    positive definite, like jnp.linalg.cholesky: the IP loop's freeze
    guard then keeps that element's old iterate."""
    L, info = torch.linalg.cholesky_ex(R)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def _riccati_factor(H_bar, A, Bm, nu: int, reg: float):
    """Backward Riccati factorization -> per-stage (L, K, S_hat, P_next)
    with L = chol(R_hat), reused by the predictor and corrector solves."""
    N = A.shape[1]
    P = H_bar[:, N, nu:, nu:]
    eye = reg * torch.eye(nu, dtype=H_bar.dtype, device=H_bar.device)
    Ls, Ks, Ss, Ps = [None] * N, [None] * N, [None] * N, [None] * N
    for k in reversed(range(N)):
        Hk, Ak, Bk = H_bar[:, k], A[:, k], Bm[:, k]
        PA = P @ Ak
        PB = P @ Bk
        R_hat = Hk[:, :nu, :nu] + Bk.mT @ PB + eye
        S_hat = Hk[:, :nu, nu:] + Bk.mT @ PA
        L = _cholesky(R_hat)
        K = -torch.cholesky_solve(S_hat, L)
        Ls[k], Ks[k], Ss[k], Ps[k] = L, K, S_hat, P
        P = Hk[:, nu:, nu:] + Ak.mT @ PA + S_hat.mT @ K
        P = 0.5 * (P + P.mT)
    return Ls, Ks, Ss, Ps


def _riccati_linear(factors, g_bar, r_eq, A, Bm, nu: int, nx: int):
    """Linear solve for one gradient with a stored factorization."""
    Ls, Ks, Ss, Ps = factors
    N = A.shape[1]
    p = g_bar[:, N, nu:]
    kffs = [None] * N
    for k in reversed(range(N)):
        pc = p + _mv(Ps[k], r_eq[:, k])
        r_hat = g_bar[:, k, :nu] + _mv(Bm[:, k].mT, pc)
        q_hat = g_bar[:, k, nu:] + _mv(A[:, k].mT, pc)
        kff = -torch.cholesky_solve(r_hat.unsqueeze(-1), Ls[k]).squeeze(-1)
        kffs[k] = kff
        p = q_hat + _mv(Ss[k].mT, kff)

    dx = g_bar.new_zeros(g_bar.shape[0], nx)
    dz = []
    for k in range(N):
        du = _mv(Ks[k], dx) + kffs[k]
        dz.append(torch.cat([du, dx], dim=-1))
        dx = _mv(A[:, k], dx) + _mv(Bm[:, k], du) + r_eq[:, k]
    dz.append(torch.cat([dx.new_zeros(dx.shape[0], nu), dx], dim=-1))
    return torch.stack(dz, dim=1)


def _ftb(v, dv, mask, t):
    """Fraction-to-boundary step bound per element: max alpha s.t.
    v + alpha*dv >= (1-t) v over the active rows."""
    ratio = torch.where((dv < 0) & (mask > 0), -t * v / (dv - 1e-30), 1.0)
    return ratio.amin(dim=(1, 2)).clamp(0.0, 1.0)


def solve_qp(
    data: QPData,
    nu: int,
    nx: int,
    iterations: int = 12,
    mu0: float = 1e1,
    reg: float = 1e-7,
    tau: float = 0.995,
    warm_duals=None,
) -> QPSolution:
    """Fixed-count IP solve of a batch of QPs.

    `warm_duals` = (lam_l, lam_u, ok [B] bool): multipliers from the
    previous QP (HPIPM warm_start=2), used where `ok` (the previous QP
    converged); other elements start cold.
    """
    mask_l, mask_u = data.mask_l, data.mask_u
    red = (1, 2)
    n_active = torch.clamp(mask_l.sum(red) + mask_u.sum(red), min=1.0)  # [B]

    def col(x):  # [B] -> [B, 1, 1]
        return x[:, None, None]

    zeta = data.g.new_zeros(data.g.shape)
    s_l = torch.where(mask_l > 0, torch.clamp(-data.lb, min=1e-2), 1.0)
    s_u = torch.where(mask_u > 0, torch.clamp(data.ub, min=1e-2), 1.0)
    lam_l_cold = torch.where(mask_l > 0, mu0 / s_l, 0.0)
    lam_u_cold = torch.where(mask_u > 0, mu0 / s_u, 0.0)
    if warm_duals is None:
        lam_l, lam_u = lam_l_cold, lam_u_cold
    else:
        wl, wu, ok = warm_duals
        ok = col(ok.bool())
        lam_l = torch.where(mask_l > 0, torch.where(ok, wl.clamp(1e-8, _W_MAX), lam_l_cold), 0.0)
        lam_u = torch.where(mask_u > 0, torch.where(ok, wu.clamp(1e-8, _W_MAX), lam_u_cold), 0.0)

    D = data.D
    for _ in range(iterations):
        mu = ((s_l * lam_l * mask_l).sum(red) + (s_u * lam_u * mask_u).sum(red)) / n_active
        converged = mu < _MU_FREEZE

        e = torch.einsum("bkrv,bkv->bkr", D, zeta)
        rho_l = (e - data.lb - s_l) * mask_l
        rho_u = (data.ub - e - s_u) * mask_u

        w = torch.clamp(mask_l * lam_l / s_l + mask_u * lam_u / s_u, 0.0, _W_MAX)
        H_bar = data.H + torch.einsum("bkrv,bkr,bkrw->bkvw", D, w, D)
        factors = _riccati_factor(H_bar, data.A, data.B, nu, reg)

        def solve_linear(g_bar, r):
            return _riccati_linear(factors, g_bar, r, data.A, data.B, nu, nx)

        r_eq = (
            torch.einsum("bkxy,bky->bkx", data.A, zeta[:, :-1, nu:])
            + torch.einsum("bkxu,bku->bkx", data.B, zeta[:, :-1, :nu])
            + data.c
            - zeta[:, 1:, nu:]
        )
        g_stat = data.g + torch.einsum("bkvw,bkw->bkv", data.H, zeta)

        def directions(rc_l, rc_u):
            coef = (
                -mask_l * lam_l
                + mask_u * lam_u
                - mask_l * (rc_l - lam_l * rho_l) / s_l
                + mask_u * (rc_u - lam_u * rho_u) / s_u
            )
            g_bar = g_stat + torch.einsum("bkrv,bkr->bkv", D, coef)
            dz = solve_linear(g_bar, r_eq)
            Ddz = torch.einsum("bkrv,bkv->bkr", D, dz)
            ds_l = (Ddz + rho_l) * mask_l
            ds_u = (rho_u - Ddz) * mask_u
            dlam_l = ((rc_l - lam_l * ds_l) / s_l) * mask_l
            dlam_u = ((rc_u - lam_u * ds_u) / s_u) * mask_u
            return dz, ds_l, ds_u, dlam_l, dlam_u

        # Predictor (affine, mu target = 0)
        _, ds_l_a, ds_u_a, dl_l_a, dl_u_a = directions(
            (-s_l * lam_l) * mask_l, (-s_u * lam_u) * mask_u)
        a_p_aff = col(torch.minimum(_ftb(s_l, ds_l_a, mask_l, 1.0),
                                    _ftb(s_u, ds_u_a, mask_u, 1.0)))
        a_d_aff = col(torch.minimum(_ftb(lam_l, dl_l_a, mask_l, 1.0),
                                    _ftb(lam_u, dl_u_a, mask_u, 1.0)))
        mu_aff = (
            ((s_l + a_p_aff * ds_l_a) * (lam_l + a_d_aff * dl_l_a) * mask_l).sum(red)
            + ((s_u + a_p_aff * ds_u_a) * (lam_u + a_d_aff * dl_u_a) * mask_u).sum(red)
        ) / n_active
        smu = col(torch.clamp((mu_aff / (mu + 1e-30)) ** 3, 0.0, 1.0) * mu)
        # Corrector (centering + second-order correction)
        rc_l = (smu - s_l * lam_l - ds_l_a * dl_l_a) * mask_l
        rc_u = (smu - s_u * lam_u - ds_u_a * dl_u_a) * mask_u
        dz, ds_l, ds_u, dlam_l, dlam_u = directions(rc_l, rc_u)

        a_p = col(torch.minimum(_ftb(s_l, ds_l, mask_l, tau), _ftb(s_u, ds_u, mask_u, tau)))
        a_d = col(torch.minimum(_ftb(lam_l, dlam_l, mask_l, tau), _ftb(lam_u, dlam_u, mask_u, tau)))

        # Freeze converged, diverged or non-finite elements by selecting
        # their OLD iterate (0 * NaN = NaN: a zero step would not do).
        bad = converged | (mu > 1e6) | ~torch.isfinite(mu)
        finite_step = (
            torch.isfinite(dz).all(dim=red)
            & torch.isfinite(dlam_l).all(dim=red)
            & torch.isfinite(dlam_u).all(dim=red)
        )
        frozen = col(bad | ~finite_step)

        zeta = torch.where(frozen, zeta, zeta + a_p * dz)
        s_l = torch.where(mask_l > 0, torch.where(frozen, s_l, torch.clamp(s_l + a_p * ds_l, min=_S_MIN)), 1.0)
        s_u = torch.where(mask_u > 0, torch.where(frozen, s_u, torch.clamp(s_u + a_p * ds_u, min=_S_MIN)), 1.0)
        lam_l = torch.where(
            mask_l > 0, torch.where(frozen, lam_l, torch.clamp(lam_l + a_d * dlam_l, 0.0, _W_MAX)), 0.0)
        lam_u = torch.where(
            mask_u > 0, torch.where(frozen, lam_u, torch.clamp(lam_u + a_d * dlam_u, 0.0, _W_MAX)), 0.0)

    mu_final = ((s_l * lam_l * mask_l).sum(red) + (s_u * lam_u * mask_u).sum(red)) / n_active
    return QPSolution(dz=zeta, lam_l=lam_l, lam_u=lam_u, mu=mu_final)
