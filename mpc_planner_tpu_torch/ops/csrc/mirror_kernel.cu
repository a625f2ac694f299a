// K2: MIRROR regularization (eigenvalues -> max(|w|, lm)) of a stack of
// tiny symmetric matrices by cyclic Jacobi.
//
// Replaces mpc_planner_tpu/ops/pallas_qp.py::_mirror_lanes (in-kernel
// MIRROR of the TPU QP kernel) and its XLA twin
// ops/jacobi_eigh.py::mirror_unpacked. Same rotation order and formulas
// (pallas_qp.py:101-140), so the plain torch version
// (mpc_planner_tpu_torch/ops/jacobi_eigh.py) agrees to f32 rounding.
//
// Design: one thread per matrix, running mirror.cuh's Jacobi (which K3
// shares); the n*n entries of A and V live in registers (every index is a
// compile-time constant after unrolling, for n <= 9). The work is ~6 sweeps x n(n-1)/2 rotations x 6n FMAs per
// matrix against 2 n^2 floats of traffic, so at the solver's stacks
// ([B*(N+1), 5, 5] at B=1024, N=30) the bound is the per-thread
// dependent arithmetic, not memory.

#include "kernels.h"
#include "mirror.cuh"

namespace {

template <int n>
__global__ void mirror_kernel(const float* __restrict__ H, float* __restrict__ out,
                              int64_t M, float lm, int sweeps) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const float* h = H + m * n * n;
  float a[n * n];
#pragma unroll
  for (int i = 0; i < n * n; ++i) a[i] = h[i];
  mpc::mirror_inplace<n>(a, lm, sweeps);
  float* o = out + m * n * n;
#pragma unroll
  for (int i = 0; i < n * n; ++i) o[i] = a[i];
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
