// MIRROR regularization (eigenvalues -> max(|w|, lm)) of one small
// symmetric matrix held in registers, by cyclic Jacobi. Shared by K2
// (mirror_kernel.cu, one thread per matrix), K1 (ip_solve.cuh::
// mirror_stages, stage k on lane k before the solve) and K3
// (rti_kernel.cuh, on each stage Hessian inside the linearization).
//
// Same rotation order and formulas as mpc_planner_tpu/ops/pallas_qp.py::
// _mirror_lanes (:101-140) and the plain torch version
// ops/jacobi_eigh.py::mirror_unpacked, so the three agree to f32 rounding.
#pragma once

#include "common.cuh"

namespace mpc {

// a [n*n] row-major, in place: symmetrized (0.5 (a + a^T)), rotated
// `sweeps` times, and reassembled as V max(|w|, lm) V^T.
template <int n>
MPC_HD void mirror_inplace(float (&a)[n * n], float lm, int sweeps) {
  float v[n * n];
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < n; ++j) v[i * n + j] = (i == j) ? 1.0f : 0.0f;
#pragma unroll
    for (int j = i + 1; j < n; ++j) {
      const float s = 0.5f * (a[i * n + j] + a[j * n + i]);
      a[i * n + j] = s;
      a[j * n + i] = s;
    }
  }

#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int p = 0; p < n - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < n; ++q) {
        const float apq = a[p * n + q], app = a[p * n + p], aqq = a[q * n + q];
        const bool nonzero = fabsf(apq) > 1e-30f;
        const float denom = nonzero ? apq : 1e-30f;
        const float theta = (aqq - app) / (2.0f * denom);
        const float sign = theta >= 0.0f ? 1.0f : -1.0f;
        float t = sign / (fabsf(theta) + sqrtf(theta * theta + 1.0f));
        t = nonzero ? t : 0.0f;
        const float c = 1.0f / sqrtf(t * t + 1.0f);
        const float s = t * c;
#pragma unroll
        for (int k = 0; k < n; ++k) {  // rows p, q: A <- J^T A
          const float akp = a[p * n + k], akq = a[q * n + k];
          a[p * n + k] = c * akp - s * akq;
          a[q * n + k] = s * akp + c * akq;
        }
#pragma unroll
        for (int k = 0; k < n; ++k) {  // cols p, q: A <- A J
          const float akp = a[k * n + p], akq = a[k * n + q];
          a[k * n + p] = c * akp - s * akq;
          a[k * n + q] = s * akp + c * akq;
        }
        a[p * n + q] = 0.0f;
        a[q * n + p] = 0.0f;
#pragma unroll
        for (int k = 0; k < n; ++k) {  // eigenvector columns
          const float vkp = v[k * n + p], vkq = v[k * n + q];
          v[k * n + p] = c * vkp - s * vkq;
          v[k * n + q] = s * vkp + c * vkq;
        }
      }
    }
  }

  float w[n];
#pragma unroll
  for (int d = 0; d < n; ++d) w[d] = max_nan(fabsf(a[d * n + d]), lm);
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < n; ++k) {
      float acc = v[i * n] * w[0] * v[k * n];
#pragma unroll
      for (int j = 1; j < n; ++j) acc = acc + v[i * n + j] * w[j] * v[k * n + j];
      a[i * n + k] = acc;
    }
  }
}

// MIRROR of a stage Hessian in registers: the whole NV x NV matrix, or
// (x_only: u-block diagonal and decoupled, solver/sqp.py's probe)
// max(|H_uu|, lm) on the u-diagonal and the Jacobi on the NX x NX x-block
// (mpc_planner_tpu/ops/pallas_qp.py::_mirror_nvar_lanes :143-165).
template <int NU, int NX>
MPC_HD void mirror_stage(float (&H)[(NU + NX) * (NU + NX)], float lm, bool x_only) {
  constexpr int NV = NU + NX;
  if (!x_only) {
    mirror_inplace<NV>(H, lm, 6);
    return;
  }
  float hx[NX * NX], du[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) hx[i * NX + j] = H[(NU + i) * NV + NU + j];
#pragma unroll
  for (int i = 0; i < NU; ++i) du[i] = max_nan(fabsf(H[i * NV + i]), lm);
  mirror_inplace<NX>(hx, lm, 6);
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j)
      H[i * NV + j] = (i >= NU && j >= NU) ? hx[(i - NU) * NX + j - NU] : (i == j ? du[i] : 0.0f);
}

}  // namespace mpc
