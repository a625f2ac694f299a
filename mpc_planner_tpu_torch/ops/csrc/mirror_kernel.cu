// K2: MIRROR regularization (eigenvalues -> max(|w|, lm)) of a stack of
// tiny symmetric matrices by cyclic Jacobi.
//
// Replaces mpc_planner_tpu/ops/pallas_qp.py::_mirror_lanes (in-kernel
// MIRROR of the TPU QP kernel) and its XLA twin
// ops/jacobi_eigh.py::mirror_unpacked. Same rotation order and formulas
// (pallas_qp.py:101-140), so the plain torch version
// (mpc_planner_tpu_torch/ops/jacobi_eigh.py) agrees to f32 rounding.
//
// Design: one thread per matrix; the n*n entries of A and V live in
// registers (every index is a compile-time constant after unrolling, for
// n <= 9). The work is ~6 sweeps x n(n-1)/2 rotations x 6n FMAs per
// matrix against 2 n^2 floats of traffic, so at the solver's stacks
// ([B*(N+1), 5, 5] at B=1024, N=30) the bound is the per-thread
// dependent arithmetic, not memory.

#include "kernels.h"

namespace {

__device__ __forceinline__ float max_nan(float x, float lo) {
  return x < lo ? lo : x;  // propagates NaN in x, like jnp.maximum
}

template <int n>
__global__ void mirror_kernel(const float* __restrict__ H, float* __restrict__ out,
                              int64_t M, float lm, int sweeps) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const float* h = H + m * n * n;
  float a[n * n];
  float v[n * n];
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      a[i * n + j] = 0.5f * (h[i * n + j] + h[j * n + i]);
      v[i * n + j] = (i == j) ? 1.0f : 0.0f;
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
  float* o = out + m * n * n;
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < n; ++k) {
      float acc = v[i * n] * w[0] * v[k * n];
#pragma unroll
      for (int j = 1; j < n; ++j) acc = acc + v[i * n + j] * w[j] * v[k * n + j];
      o[i * n + k] = acc;
    }
  }
}

template <int n>
void launch(const float* H, float* out, int64_t M, float lm, int sweeps, cudaStream_t stream) {
  constexpr int threads = 128;
  const int64_t blocks = (M + threads - 1) / threads;
  mirror_kernel<n><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(H, out, M, lm, sweeps);
}

}  // namespace

cudaError_t launch_mirror(const float* H, float* out, int64_t M, int n, float lm,
                          int sweeps, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  switch (n) {
    case 2: launch<2>(H, out, M, lm, sweeps, stream); break;
    case 3: launch<3>(H, out, M, lm, sweeps, stream); break;
    case 4: launch<4>(H, out, M, lm, sweeps, stream); break;
    case 5: launch<5>(H, out, M, lm, sweeps, stream); break;
    case 6: launch<6>(H, out, M, lm, sweeps, stream); break;
    case 7: launch<7>(H, out, M, lm, sweeps, stream); break;
    case 8: launch<8>(H, out, M, lm, sweeps, stream); break;
    case 9: launch<9>(H, out, M, lm, sweeps, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}
