// Host launchers of the hand-written Hopper kernels (plain C++ interface:
// no PyTorch headers here, so nvcc compiles the .cu files in seconds; the
// one binding file, binding.cpp, wraps them for PyTorch).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "qp_launch.h"

// K2: MIRROR regularization of M symmetric n x n matrices (n <= 9).
// H, out: [M, n, n] row-major float32. Returns cudaErrorInvalidValue for
// an n the kernel is not instantiated for; launch errors are left for the
// caller's cudaGetLastError.
cudaError_t launch_mirror(const float* H, float* out, int64_t M, int n, float lm,
                          int sweeps, cudaStream_t stream);

// K1: see qp_launch.h for its arguments.
// Dynamic shared memory of one block (= one warp = one element), in bytes,
// without or with the QP's data and duals staged.
int64_t qp_shared_bytes(int N, int nu, int nx, int nh, bool staged);

// One-warp blocks with that much dynamic shared memory that the current
// device holds at once.
int64_t qp_resident_blocks(int64_t shared_bytes_per_block);

// Returns cudaErrorInvalidValue for an (nu, nx) pair the kernel is not
// instantiated for, or a working set above the 227 KB a block can have.
cudaError_t launch_qp(const QPLaunch& args, cudaStream_t stream);
