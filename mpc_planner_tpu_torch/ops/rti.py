"""The SQP-RTI loop with every step in plain torch: the plain version of the
fused kernel K3 (ops/cuda_rti.py::solve_rti_cuda), with the contract of
mpc_planner_tpu/ops/pallas_rti.py::solve_rti_pallas.

Per RTI iteration it runs the torch.func linearization (`linearize_torch`,
the plain version of the kernel's in-thread linearization), the plain
MIRROR (ops/jacobi_eigh.py) and the plain QP (solver/qp.py::solve_qp),
then Z += dz, with the kernel's warm-start ladder: the first QP starts
from the caller's duals (or cold) at `it0` IP iterations, later ones from
the previous QP's duals, where it converged (mu < 1e-2), at `warm_iters`.

Bounds come as templates [N+1, nrows] with +-1e15 sentinels on inactive
rows (u-box and h rows at the terminal node, x-box rows at stage 0,
infinite bounds), shifted by the iterate: lb = lb_template - r with
r = [z, h(z)]. Row masks follow from the sentinels (|bound| < 1e14).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

from mpc_planner_tpu_torch.ops.jacobi_eigh import mirror_nvar, mirror_unpacked
from mpc_planner_tpu_torch.solver.qp import QPData, solve_qp


class RTIResult(NamedTuple):
    Z: torch.Tensor  # [B, N+1, nvar] final iterate
    lam_l: torch.Tensor  # [B, N+1, nrows] final QP duals
    lam_u: torch.Tensor
    mu: torch.Tensor  # [B] final complementarity


class StageDerivatives(NamedTuple):
    """Values and derivatives of an OCP's stage functions along a batch of
    trajectories Z [B, N+1, nvar] (running stages 0..N-1; the terminal
    cost at z_N with its inputs set to zero)."""

    f: torch.Tensor  # [B, N, nx] dynamics x_{k+1} = f(z_k)
    Jf: torch.Tensor  # [B, N, nx, nvar]
    g_run: torch.Tensor  # [B, N, nvar] running-cost gradient
    H_run: torch.Tensor  # [B, N, nvar, nvar] running-cost Hessian
    g_term: torch.Tensor  # [B, nvar]
    H_term: torch.Tensor  # [B, nvar, nvar]
    h: Optional[torch.Tensor]  # [B, N, nh] constraints (None when nh = 0)
    Jh: Optional[torch.Tensor]  # [B, N, nh, nvar]


def _with_aux(f):
    """f -> (z, p) -> (f(z, p), f(z, p)), for jacfwd(has_aux=True): the
    Jacobian and the value from one evaluation."""
    def g(z, p):
        y = f(z, p)
        return y, y
    return g


def stage_derivatives(ocp, Z, P) -> StageDerivatives:
    """torch.func (vmap of jacfwd / grad / hessian) over all B*N stages."""
    N, nvar, nh = ocp.N, ocp.nvar, ocp.nh
    Bb = Z.shape[0]
    Zr = Z[:, :N].reshape(Bb * N, nvar)
    Pr = P[:, :N].reshape(Bb * N, -1)

    def per_stage(x):
        return x.reshape((Bb, N) + x.shape[1:])

    Jf, f = vmap(jacfwd(_with_aux(ocp.dynamics_fn), has_aux=True))(Zr, Pr)
    g_run = vmap(grad(ocp.running_cost))(Zr, Pr)
    H_run = vmap(hessian(ocp.running_cost))(Zr, Pr)
    zN = ocp.zero_inputs(Z[:, N])
    g_term = vmap(grad(ocp.terminal_cost))(zN, P[:, N])
    H_term = vmap(hessian(ocp.terminal_cost))(zN, P[:, N])
    h = Jh = None
    if nh:
        Jh, h = vmap(jacfwd(_with_aux(ocp.constraint_fn), has_aux=True))(Zr, Pr)
        Jh, h = per_stage(Jh), per_stage(h)
    out = StageDerivatives(f=per_stage(f), Jf=per_stage(Jf), g_run=per_stage(g_run),
                           H_run=per_stage(H_run), g_term=g_term, H_term=H_term, h=h, Jh=Jh)
    # torch.func's forward mode promotes the tangent of `0-d tensor (op)
    # Python float` to float64 (the bicycle's v / lr, the chance
    # constraint's sqrt(2 a'Sa)), and the Jacobian with it: back to Z's type.
    return StageDerivatives(*(None if x is None else x.to(Z.dtype) for x in out))


def linearize_torch(ocp, Z, P, lb_template, ub_template, lm: float,
                    mirror_x_only: bool) -> QPData:
    """The QP of the batch Z [B, N+1, nvar], P [B, N+1, npar], as the
    fused kernel linearizes it (pallas_rti.py:81-137): MIRROR on the
    running Hessians and on the terminal Hessian's x-block, whose u-block
    stays zero; bounds from the templates."""
    N, nu, nvar, nh = ocp.N, ocp.nu, ocp.nvar, ocp.nh
    Bb = Z.shape[0]
    d = stage_derivatives(ocp, Z, P)
    H_run = mirror_nvar(d.H_run.reshape(Bb * N, nvar, nvar), lm, nu, mirror_x_only)
    H_last = Z.new_zeros(Bb, 1, nvar, nvar)
    H_last[:, 0, nu:, nu:] = mirror_unpacked(d.H_term[:, nu:, nu:], lm)
    g_last = Z.new_zeros(Bb, 1, nvar)
    g_last[:, 0, nu:] = d.g_term[:, nu:]
    H = torch.cat([H_run.reshape(Bb, N, nvar, nvar), H_last], dim=1)
    g = torch.cat([d.g_run, g_last], dim=1)

    D = torch.eye(nvar, dtype=Z.dtype, device=Z.device).expand(Bb, N + 1, nvar, nvar)
    r = Z
    if nh:
        D = torch.cat([D, torch.cat([d.Jh, Z.new_zeros(Bb, 1, nh, nvar)], dim=1)], dim=2)
        r = torch.cat([Z, torch.cat([d.h, Z.new_zeros(Bb, 1, nh)], dim=1)], dim=2)
    lb = lb_template - r
    ub = ub_template - r
    return QPData(H=H, g=g, A=d.Jf[..., nu:], B=d.Jf[..., :nu], c=d.f - Z[:, 1:, nu:],
                  D=D.contiguous(), lb=lb, ub=ub, mask_l=(lb > -1e14).to(Z.dtype),
                  mask_u=(ub < 1e14).to(Z.dtype))


def solve_rti_torch(
    Z0,  # [B, N+1, nvar] warm start (x0 rows already pinned to xinit)
    P,  # [B, N+1, npar]
    ocp,
    *,
    lb_template,  # [N+1, nrows] bound values, -1e15 where inactive
    ub_template,  # [N+1, nrows], +1e15 where inactive
    num_iterations: int,
    it0: int,
    warm_iters: int,
    mu0: float = 1e1,
    reg: float = 1e-7,
    tau: float = 0.995,
    warm_duals=None,  # (lam_l [B, N+1, nrows], lam_u, ok [B] bool)
    mehrotra: bool = True,
    sigma_fixed: float = 0.1,
    lm: float = 1e-4,
    mirror_x_only: bool = False,
) -> RTIResult:
    """Whole SQP-RTI solve, `num_iterations` >= 1 full steps."""
    if num_iterations < 1:
        raise ValueError(f"num_iterations must be >= 1, got {num_iterations}")
    Z, warm = Z0, warm_duals
    for i in range(num_iterations):
        qp = linearize_torch(ocp, Z, P, lb_template, ub_template, lm, mirror_x_only)
        sol = solve_qp(qp, ocp.nu, ocp.nx, iterations=it0 if i == 0 else warm_iters, mu0=mu0,
                       reg=reg, tau=tau, warm_duals=warm, mehrotra=mehrotra,
                       sigma_fixed=sigma_fixed)
        Z = Z + sol.dz
        warm = (sol.lam_l, sol.lam_u, sol.mu < 1e-2)
    return RTIResult(Z=Z, lam_l=sol.lam_l, lam_u=sol.lam_u, mu=sol.mu)
