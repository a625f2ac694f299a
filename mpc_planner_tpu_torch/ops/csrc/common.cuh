// Shared by the hand-written kernels and by the derivative code generated
// for each OCP (ops/stage_codegen.py). Everything here compiles with nvcc
// for the card and with a plain C++ compiler for the host, so the same
// generated stage code can be checked on a CPU.
#pragma once

#include <cmath>

#if defined(__CUDACC__)
#define MPC_HD __host__ __device__ __forceinline__
// The generated stage functions: each gets its own register allocation
// (the flagship's running cost blends 5 spline segments on Dual2 numbers).
#define MPC_STAGE __host__ __device__ __noinline__
#else
#define MPC_HD inline
#define MPC_STAGE inline
#endif

namespace mpc {

// NaN-propagating max/min/clip (jnp.maximum / jnp.clip semantics: a NaN
// operand stays NaN, so the IP solve's freeze guard sees it).
MPC_HD float max_nan(float x, float lo) { return x < lo ? lo : x; }
MPC_HD float min_nan(float x, float hi) { return x > hi ? hi : x; }
MPC_HD float clip_nan(float x, float lo, float hi) { return min_nan(max_nan(x, lo), hi); }
// Running minimum that keeps a NaN once seen (jnp.min semantics).
MPC_HD float runmin(float m, float r) { return (r < m || r != r) ? r : m; }

// True for a finite x (false for NaN and +-inf), on the card and the host.
MPC_HD bool is_finite(float x) { return fabsf(x) <= 3.402823466e38f; }

// The team of lanes that owns one batch element in K1 and K3: a warp on the
// card. Row and stage passes stride over the lanes, sums and minima are
// butterfly reductions, and every lane ends with the same value, so a
// branch on it is uniform over the team. A host build has a team of one
// lane, which makes the same code a plain sequential solve.
#if defined(__CUDACC__)
#define MPC_DEV __device__ __forceinline__
#define MPC_DEV_NOINLINE __device__ __noinline__
constexpr int kLanes = 32;
MPC_DEV int team_lane() { return threadIdx.x & (kLanes - 1); }
MPC_DEV void team_sync() { __syncwarp(); }  // also orders the team's memory accesses
MPC_DEV float team_xor(float v, int mask) { return __shfl_xor_sync(0xffffffffu, v, mask); }
MPC_DEV bool team_all(bool p) { return __all_sync(0xffffffffu, p) != 0; }
MPC_DEV float load_readonly(const float* p) { return __ldg(p); }
#else
#define MPC_DEV inline
#define MPC_DEV_NOINLINE inline
constexpr int kLanes = 1;
inline int team_lane() { return 0; }
inline void team_sync() {}
inline float team_xor(float v, int) { return v; }
inline bool team_all(bool p) { return p; }
inline float load_readonly(const float* p) { return *p; }
#endif

MPC_DEV float team_sum(float v) {
#pragma unroll
  for (int m = kLanes / 2; m > 0; m /= 2) v += team_xor(v, m);
  return v;
}
// Minimum over the team with runmin's rule at every step: a NaN on any lane
// reaches all of them (fminf would drop it, and the freeze guard with it).
MPC_DEV float team_runmin(float v) {
#pragma unroll
  for (int m = kLanes / 2; m > 0; m /= 2) v = runmin(v, team_xor(v, m));
  return v;
}

// Reads entry i of one element's vector in an array with the given
// stride (1 in the element-major arrays of K3 and of the host build).
struct Strided {
  const float* p;
  int stride;
  MPC_HD float operator()(int i) const { return p[static_cast<long long>(i) * stride]; }
};

}  // namespace mpc
