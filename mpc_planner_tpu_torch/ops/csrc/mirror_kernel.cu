// K2: MIRROR regularization (eigenvalues -> max(|w|, lm)) of a stack of
// tiny symmetric matrices by cyclic Jacobi.
//
// Replaces mpc_planner_tpu/ops/pallas_qp.py::_mirror_lanes (in-kernel
// MIRROR of the TPU QP kernel) and its XLA twin
// ops/jacobi_eigh.py::mirror_unpacked. Same rotation order and formulas
// (pallas_qp.py:101-140), so the plain torch version
// (mpc_planner_tpu_torch/ops/jacobi_eigh.py) agrees to f32 rounding.
//
// Design: one thread per matrix, running mirror.cuh's Jacobi (which K1 and
// K3 share); the n*n entries of A and V live in registers (every index is
// a compile-time constant after unrolling, for n <= 9). The work is ~6
// sweeps x n(n-1)/2 rotations x 6n FMAs per matrix against 2 n^2 floats of
// traffic, so the bound is the per-thread dependent arithmetic, not
// memory; what memory costs is latency. A thread's matrix is n*n
// consecutive floats, so direct loads would stride by n*n floats across a
// warp: the block moves its 128 matrices through shared memory instead,
// with consecutive threads on consecutive floats both ways, and a thread
// reads its own matrix from a row of odd stride (no bank conflicts).
// The solver's unfused route no longer launches this kernel (K1 runs the
// MIRROR itself); it serves callers that hold a bare stack.

#include "kernels.h"
#include "mirror.cuh"

namespace {

constexpr int kThreads = 128;

template <int n>
__global__ void __launch_bounds__(kThreads) mirror_kernel(const float* __restrict__ H,
                                                          float* __restrict__ out, int64_t M,
                                                          float lm, int sweeps) {
  constexpr int nn = n * n, stride = nn | 1;
  __shared__ float tile[kThreads * stride];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int count = static_cast<int>(M - first < kThreads ? M - first : kThreads);
  const float* h = H + first * nn;
  for (int i = threadIdx.x; i < count * nn; i += kThreads) tile[(i / nn) * stride + i % nn] = h[i];
  __syncthreads();
  if (threadIdx.x < count) {
    float* mine = tile + threadIdx.x * stride;
    float a[nn];
#pragma unroll
    for (int i = 0; i < nn; ++i) a[i] = mine[i];
    mpc::mirror_inplace<n>(a, lm, sweeps);
#pragma unroll
    for (int i = 0; i < nn; ++i) mine[i] = a[i];
  }
  __syncthreads();
  float* o = out + first * nn;
  for (int i = threadIdx.x; i < count * nn; i += kThreads) o[i] = tile[(i / nn) * stride + i % nn];
}

template <int n>
void launch(const float* H, float* out, int64_t M, float lm, int sweeps, cudaStream_t stream) {
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  mirror_kernel<n><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(H, out, M, lm, sweeps);
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
