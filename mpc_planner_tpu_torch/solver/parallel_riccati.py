"""Parallel-in-horizon Riccati: the stagewise LQR solved by scans over the
stages, batched.

Counterpart of mpc_planner_tpu/solver/parallel_riccati.py. The sequential
Riccati sweeps of `solver/qp.py` walk the horizon one stage at a time,
O(N) dependent steps per IP iteration. This module solves the same
equality-constrained LQR subproblem with inclusive scans over the stage
axis: O(log N) dependent rounds of nx x nx work. `solve_qp(...,
horizon_parallel=True)` swaps it in for `_riccati_factor` /
`_riccati_linear` without touching the IP logic; it acts on the plain torch
path only (`qp_backend="torch"`), as the reference's flag acts on its XLA
path only: the kernels K1 and K3 keep their sequential recursion.

Method (temporal parallelization of LQT, after Sarkka & Garcia-Fernandez,
IEEE TAC 2021): each stage k contributes a conditional value-function
element e_k = (A, b, C, eta, J) representing

    V_{k->j}(x_k) = min over controls of [cost on [k, j)] + V_j(x_j),
    x_j = A x_k + b (C carries the control channel),
    V(x) = 1/2 x' J x - eta' x,

and two elements covering [i, j) and [j, l) combine associatively into one
covering [i, l) (`_combine`, earlier interval first). An inclusive reverse
scan yields every cost-to-go (J_k, eta_k) in ceil(log2(N+1)) rounds. Stage
cross-terms (u'Sx) and linear costs are removed up front by completing the
square, and the forward rollout is a second scan (of affine maps).

torch has no stable associative scan, so `_scan` is written here: the
Hillis-Steele form, in which round d combines every element with the one
d stages later (or earlier) in one batched call. JAX's associative_scan
combines in another tree order, so the two agree to rounding, not bit for
bit. Every array carries the batch as its leading axis and the stages as
axis 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpc_planner_tpu_torch.solver.qp import _cholesky, _mv


class Prep(NamedTuple):
    """Gradient-independent pieces (reused by predictor + corrector)."""

    L_R: torch.Tensor  # [B, N, nu, nu] chol(R + reg I)
    Ks: torch.Tensor  # [B, N, nu, nx] R^{-1} S
    A_t: torch.Tensor  # [B, N, nx, nx] A - B R^{-1} S
    Q_t: torch.Tensor  # [B, N, nx, nx] Q - S' R^{-1} S
    C: torch.Tensor  # [B, N, nx, nx] B R^{-1} B'
    J_term: torch.Tensor  # [B, nx, nx]


def _sym(M):
    return 0.5 * (M + M.mT)


def _chol_solve(L, rhs):
    """cho_solve for [.., n, n] lower factors against [.., n, m]."""
    y = torch.linalg.solve_triangular(L, rhs, upper=False, left=True)
    return torch.linalg.solve_triangular(L.mT, y, upper=True, left=True)


def prepare(H_bar, A, B, nu: int, nx: int, reg: float) -> Prep:
    """Complete the square in u: the gradient-independent per-stage transform.

    Stage cost 1/2 u'Ru + u'Sx + 1/2 x'Qx with u = u_t - R^{-1}(Sx + r)
    becomes 1/2 u_t'R u_t + 1/2 x'(Q - S'R^{-1}S)x (+ linear terms handled
    per gradient in `solve`), with dynamics matrix A - B R^{-1} S."""
    N = A.shape[1]
    eye = reg * torch.eye(nu, dtype=H_bar.dtype, device=H_bar.device)
    R = H_bar[:, :N, :nu, :nu] + eye
    S = H_bar[:, :N, :nu, nu:]
    Q = H_bar[:, :N, nu:, nu:]
    L_R = _cholesky(R)
    Ks = _chol_solve(L_R, S)
    C = _sym(B @ _chol_solve(L_R, B.mT))
    return Prep(L_R=L_R, Ks=Ks, A_t=A - B @ Ks, Q_t=_sym(Q - S.mT @ Ks), C=C,
                J_term=H_bar[:, N, nu:, nu:])


def _combine(earlier, later):
    """Associative combination of value-function elements: `earlier`
    covers the interval before `later`'s. Operands carry any leading dims."""
    Ai, bi, Ci, etai, Ji = earlier
    Aj, bj, Cj, etaj, Jj = later
    eye = torch.eye(Ai.shape[-1], dtype=Ai.dtype, device=Ai.device)
    # Z = (I + Ci Jj)^{-1};  (I + Jj Ci)^{-1} = Z' for symmetric Ci, Jj.
    # inv_ex: a singular element gives inf/NaN as in JAX (the IP loop's
    # freeze guard then keeps that element's old iterate), not an exception.
    Z = torch.linalg.inv_ex(eye + Ci @ Jj).inverse
    Zt = Z.mT
    AjZ = Aj @ Z
    AiT = Ai.mT
    return (AjZ @ Ai,
            _mv(AjZ, bi + _mv(Ci, etaj)) + bj,
            _sym(AjZ @ Ci @ Aj.mT + Cj),
            _mv(AiT, _mv(Zt, etaj - _mv(Jj, bi))) + etai,
            _sym(AiT @ Zt @ Jj @ Ai + Ji))


def _compose(earlier, later):
    """Affine maps x -> F x + v, `earlier` applied first."""
    F1, v1 = earlier
    F2, v2 = later
    return F2 @ F1, _mv(F2, v1) + v2


def _scan(combine, elems, reverse: bool):
    """Inclusive scan over axis 1 of a tuple of [B, L, ...] tensors: entry
    k is combine(e_0, ..., e_k) (forward) or combine(e_k, ..., e_L-1)
    (reverse), `combine` taking the earlier interval first. Hillis-Steele:
    in the round of offset d, entry k takes in the entry d stages away."""
    L = elems[0].shape[1]
    d = 1
    while d < L:
        # pairs (k, k+d): the earlier entry first, for every k at once
        new = combine(tuple(e[:, :L - d] for e in elems), tuple(e[:, d:] for e in elems))
        if reverse:  # entry k (covers [k, k+d)) takes in entry k+d
            elems = tuple(torch.cat([n, e[:, L - d:]], dim=1) for n, e in zip(new, elems))
        else:  # entry k+d (covers (k, k+d]) takes in entry k
            elems = tuple(torch.cat([e[:, :d], n], dim=1) for n, e in zip(new, elems))
        d *= 2
    return elems


def solve(prep: Prep, g_bar, r_eq, B, nu: int, nx: int):
    """Solve the LQR for one gradient; returns dz [B, N+1, nvar].

    Matches `_riccati_linear` on the factorization of the same
    (H_bar, A, B): min 1/2 dz'H_bar dz + g_bar'dz s.t.
    dx_{k+1} = A dx_k + B du_k + r_k, dx_0 = 0."""
    Bb, N = B.shape[0], B.shape[1]
    r = g_bar[:, :N, :nu]
    q = g_bar[:, :N, nu:]
    kr = _chol_solve(prep.L_R, r.unsqueeze(-1)).squeeze(-1)  # R^{-1} r
    c_t = r_eq - _mv(B, kr)
    q_t = q - _mv(prep.Ks.mT, r)

    # Elements: stages 0..N-1, then the terminal node.
    zeros_m = prep.A_t.new_zeros(Bb, 1, nx, nx)
    elems = (torch.cat([prep.A_t, zeros_m], dim=1),
             torch.cat([c_t, c_t.new_zeros(Bb, 1, nx)], dim=1),
             torch.cat([prep.C, zeros_m], dim=1),
             torch.cat([-q_t, -g_bar[:, N:, nu:]], dim=1),
             torch.cat([prep.Q_t, prep.J_term.unsqueeze(1)], dim=1))
    # Entry k of the reverse scan = the cost-to-go at node k; recovery at
    # stage k needs the value at k+1.
    _, _, _, eta_s, J_s = _scan(_combine, elems, reverse=True)
    J_next = J_s[:, 1:]
    eta_next = eta_s[:, 1:]

    # du_t = -K x - d with M = R + B'J_{k+1}B (in completed-square coords)
    Bt = B.mT
    BtJ = Bt @ J_next
    M = prep.L_R @ prep.L_R.mT + BtJ @ B
    L_M = _cholesky(_sym(M))
    K_t = _chol_solve(L_M, BtJ @ prep.A_t)
    rhs = _mv(BtJ, c_t) - _mv(Bt, eta_next)
    d_t = -_chol_solve(L_M, rhs.unsqueeze(-1)).squeeze(-1)

    K_tot = K_t + prep.Ks  # du = -K_tot x + d_tot (original coords)
    d_tot = d_t - kr
    F = prep.A_t - B @ K_t  # = A - B K_tot
    v = _mv(B, d_tot) + r_eq

    # Forward rollout x_{k+1} = F_k x_k + v_k, x_0 = 0: entry k of the scan
    # maps x_0 to x_{k+1}.
    _, x_next = _scan(_compose, (F, v), reverse=False)
    xs = torch.cat([x_next.new_zeros(Bb, 1, nx), x_next[:, :-1]], dim=1)
    us = -_mv(K_tot, xs) + d_tot
    dz_term = torch.cat([us.new_zeros(Bb, 1, nu), x_next[:, -1:]], dim=-1)
    return torch.cat([torch.cat([us, xs], dim=-1), dz_term], dim=1)
