// Host launchers of the hand-written Hopper kernels (plain C++ interface:
// no PyTorch headers here, so nvcc compiles the .cu files in seconds; the
// one binding file, binding.cpp, wraps them for PyTorch).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// K2: MIRROR regularization of M symmetric n x n matrices (n <= 9).
// H, out: [M, n, n] row-major float32. Returns cudaErrorInvalidValue for
// an n the kernel is not instantiated for; launch errors are left for the
// caller's cudaGetLastError.
cudaError_t launch_mirror(const float* H, float* out, int64_t M, int n, float lm,
                          int sweeps, cudaStream_t stream);

// K1: fixed-count interior-point Riccati QP solve, one thread per batch
// element. Every array is batch-innermost ([..., B]):
//   H [N+1, nvar, nvar, B], g [N+1, nvar, B], A [N, nx, nx, B],
//   Bm [N, nx, nu, B], c [N, nx, B], Dh [N+1, max(nh,1), nvar, B],
//   lb/ub [N+1, nrows, B] with inactive rows folded to -/+1e15,
//   wl/wu [N+1, nrows, B] and wok [B] (read only when use_warm),
//   outputs dz [N+1, nvar, B], lam_l/lam_u [N+1, nrows, B], mu [B],
//   scratch: qp_scratch_floats(N, nu, nx, nh) * B floats.
struct QPLaunch {
  const float *H, *g, *A, *Bm, *c, *Dh, *lb, *ub, *wl, *wu, *wok;
  float *dz, *lam_l, *lam_u, *mu, *scratch;
  int B, N, nu, nx, nh, iterations;
  float mu0, reg, tau, sigma_fixed;
  int use_warm, mehrotra;
};

int64_t qp_scratch_floats(int N, int nu, int nx, int nh);

// Returns cudaErrorInvalidValue for an (nu, nx) pair the kernel is not
// instantiated for.
cudaError_t launch_qp(const QPLaunch& args, cudaStream_t stream);
