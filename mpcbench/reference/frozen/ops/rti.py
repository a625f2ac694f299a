"""The linearization of the plain route: values and derivatives of an
OCP's stage functions by torch.func, the plain version of the fused kernel
K3's in-thread linearization (the port's ops/rti.py)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap


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
