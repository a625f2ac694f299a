// Shared by the hand-written kernels and by the derivative code generated
// for each OCP (ops/stage_codegen.py). Everything here compiles with nvcc
// for the card and with a plain C++ compiler for the host, so the same
// generated stage code can be checked on a CPU.
#pragma once

#include <cmath>

#if defined(__CUDACC__)
#define MPC_HD __host__ __device__ __forceinline__
#else
#define MPC_HD inline
#endif

namespace mpc {

// NaN-propagating max/min/clip (jnp.maximum / jnp.clip semantics: a NaN
// operand stays NaN, so the IP solve's freeze guard sees it).
MPC_HD float max_nan(float x, float lo) { return x < lo ? lo : x; }
MPC_HD float min_nan(float x, float hi) { return x > hi ? hi : x; }
MPC_HD float clip_nan(float x, float lo, float hi) { return min_nan(max_nan(x, lo), hi); }
// Running minimum that keeps a NaN once seen (jnp.min semantics).
MPC_HD float runmin(float m, float r) { return (r < m || r != r) ? r : m; }

// Reads entry i of one element's vector in an array with the given
// stride: the batch size in a batch-innermost array, 1 in a dense one.
struct Strided {
  const float* p;
  int stride;
  MPC_HD float operator()(int i) const { return p[static_cast<long long>(i) * stride]; }
};

}  // namespace mpc
