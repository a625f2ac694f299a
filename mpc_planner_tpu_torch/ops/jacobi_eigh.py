"""MIRROR regularization by cyclic Jacobi on tiny symmetric matrices.

Counterpart of mpc_planner_tpu/ops/jacobi_eigh.py::mirror_unpacked and
the plain torch version of the hand-written CUDA MIRROR kernel
(ops/cuda_qp.py::mirror_cuda). It is the MIRROR of every CPU solve too:
the JAX package's CPU path uses LAPACK eigh instead, and the difference
stays inside the solver tests' tolerance.

MIRROR (acados regularize_method, generate_acados_solver.py:161):
H -> V max(|w|, lm) V^T. A fixed count of cyclic Jacobi sweeps is exact
to f32 rounding for the n <= 9 stage Hessians after about 6 sweeps.
"""

from __future__ import annotations

import torch


def mirror_unpacked(H: torch.Tensor, lm: float, sweeps: int = 6) -> torch.Tensor:
    """MIRROR of H [..., n, n], with the n*n matrix elements unpacked into
    separate [...]-shaped tensors so every rotation is elementwise
    arithmetic over the batch. Rotation order and formulas are those of
    the reference (and of the CUDA kernel)."""
    n = H.shape[-1]
    a = [[H[..., i, j] for j in range(n)] for i in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            s = 0.5 * (a[i][j] + a[j][i])
            a[i][j] = s
            a[j][i] = s
    one = torch.ones_like(a[0][0])
    zero = torch.zeros_like(a[0][0])
    v = [[one if i == j else zero for j in range(n)] for i in range(n)]

    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq, app, aqq = a[p][q], a[p][p], a[q][q]
                # Stable rotation: t = sign(th)/(|th| + sqrt(th^2 + 1))
                nonzero = apq.abs() > 1e-30
                denom = torch.where(nonzero, apq, 1e-30)
                theta = (aqq - app) / (2.0 * denom)
                sign = torch.where(theta >= 0, 1.0, -1.0)
                t = sign / (theta.abs() + torch.sqrt(theta * theta + 1.0))
                t = torch.where(nonzero, t, 0.0)
                c = 1.0 / torch.sqrt(t * t + 1.0)
                s = t * c
                for k in range(n):  # rows p, q: A <- J^T A
                    akp, akq = a[p][k], a[q][k]
                    a[p][k] = c * akp - s * akq
                    a[q][k] = s * akp + c * akq
                for k in range(n):  # cols p, q: A <- A J
                    akp, akq = a[k][p], a[k][q]
                    a[k][p] = c * akp - s * akq
                    a[k][q] = s * akp + c * akq
                a[p][q] = zero
                a[q][p] = zero
                for k in range(n):  # eigenvector columns
                    vkp, vkq = v[k][p], v[k][q]
                    v[k][p] = c * vkp - s * vkq
                    v[k][q] = s * vkp + c * vkq

    w = [torch.clamp(a[d][d].abs(), min=lm) for d in range(n)]
    rows = []
    for i in range(n):
        row = []
        for k in range(n):
            acc = v[i][0] * w[0] * v[k][0]
            for j in range(1, n):
                acc = acc + v[i][j] * w[j] * v[k][j]
            row.append(acc)
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)
