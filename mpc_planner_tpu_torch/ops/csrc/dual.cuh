// Forward-mode dual numbers for the derivative code that
// ops/stage_codegen.py generates for each OCP (it replaces the
// jax.jacfwd / jax.grad / jax.hessian that mpc_planner_tpu/ops/
// pallas_rti.py traces inside its kernel: CUDA has no autodiff).
//
//   Dual<N>  : value + gradient over N seed directions (f, df/dz and
//              h, dh/dz of the dynamics and the constraints);
//   Dual2<N> : value + gradient + Hessian (packed upper triangle) over N
//              directions (grad and Hessian of the running and terminal
//              costs).
//
// The value part is computed with exactly the float32 operations the
// traced torch graph performs (x*x for pow(x, 2), IEEE division), so the
// generated functions return torch's values up to the libm's last bits.
// Every function is MPC_HD: the same generated code builds with nvcc for
// the card and with g++ for the host-side test.
#pragma once

#include "common.cuh"

namespace mpc {

// -- plain floats, under the names the generated code calls ---------------
MPC_HD float msin(float x) { return sinf(x); }
MPC_HD float mcos(float x) { return cosf(x); }
MPC_HD float msqrt(float x) { return sqrtf(x); }
MPC_HD float mrecip(float x) { return 1.0f / x; }
MPC_HD float msq(float x) { return x * x; }
MPC_HD float mcube(float x) { return x * x * x; }
MPC_HD float mpow(float x, float e) { return powf(x, e); }
// Overflow-safe logistic function (the form of jax.nn.sigmoid): exp of a
// non-positive argument only, so no inf/inf.
MPC_HD float msigmoid(float x) {
  if (x >= 0.0f) return 1.0f / (1.0f + expf(-x));
  const float e = expf(x);
  return e / (1.0f + e);
}
// Floor mod a - b*floor(a/b), computed as torch.remainder (and jnp.mod) do:
// fmod, exact, then moved into b's sign.
MPC_HD float mrem(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}
// torch.clamp(x, min=lo): NaN stays NaN.
MPC_HD float mclamp_min(float x, float lo) { return max_nan(x, lo); }
// The value part, for predicates (comparisons look at values only).
MPC_HD float mval(float x) { return x; }

// -- first order ----------------------------------------------------------
template <int N>
struct Dual {
  float v;
  float d[N];
  Dual() = default;
  MPC_HD Dual(float x) : v(x) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = 0.0f;
  }
};

// Unary chain rule: value f0, derivative f1 * a'.
template <int N>
MPC_HD Dual<N> chain1(const Dual<N>& a, float f0, float f1) {
  Dual<N> r;
  r.v = f0;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = f1 * a.d[i];
  return r;
}

template <int N>
MPC_HD Dual<N> operator+(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <int N>
MPC_HD Dual<N> operator+(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = a.v + b;
  return r;
}
template <int N>
MPC_HD Dual<N> operator+(float a, const Dual<N>& b) {
  Dual<N> r = b;
  r.v = a + b.v;
  return r;
}
template <int N>
MPC_HD Dual<N> operator-(const Dual<N>& a) {
  Dual<N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}
template <int N>
MPC_HD Dual<N> operator-(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <int N>
MPC_HD Dual<N> operator-(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = a.v - b;
  return r;
}
template <int N>
MPC_HD Dual<N> operator-(float a, const Dual<N>& b) {
  Dual<N> r = -b;
  r.v = a - b.v;
  return r;
}
template <int N>
MPC_HD Dual<N> operator*(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.v * b.d[i] + b.v * a.d[i];
  return r;
}
template <int N>
MPC_HD Dual<N> operator*(const Dual<N>& a, float b) { return chain1(a, a.v * b, b); }
template <int N>
MPC_HD Dual<N> operator*(float a, const Dual<N>& b) { return chain1(b, a * b.v, a); }
template <int N>
MPC_HD Dual<N> operator/(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  return r;
}
template <int N>
MPC_HD Dual<N> operator/(const Dual<N>& a, float b) {
  Dual<N> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / b;
  return r;
}
template <int N>
MPC_HD Dual<N> operator/(float a, const Dual<N>& b) {
  const float q = a / b.v;
  return chain1(b, q, -q / b.v);
}
template <int N>
MPC_HD Dual<N> msin(const Dual<N>& a) { return chain1(a, sinf(a.v), cosf(a.v)); }
template <int N>
MPC_HD Dual<N> mcos(const Dual<N>& a) { return chain1(a, cosf(a.v), -sinf(a.v)); }
template <int N>
MPC_HD Dual<N> msqrt(const Dual<N>& a) {
  const float s = sqrtf(a.v);
  return chain1(a, s, 0.5f / s);
}
template <int N>
MPC_HD Dual<N> mrecip(const Dual<N>& a) {
  const float q = 1.0f / a.v;
  return chain1(a, q, -q * q);
}
template <int N>
MPC_HD Dual<N> msq(const Dual<N>& a) { return chain1(a, a.v * a.v, 2.0f * a.v); }
template <int N>
MPC_HD Dual<N> mcube(const Dual<N>& a) { return chain1(a, a.v * a.v * a.v, 3.0f * a.v * a.v); }
template <int N>
MPC_HD Dual<N> mpow(const Dual<N>& a, float e) {
  return chain1(a, powf(a.v, e), e * powf(a.v, e - 1.0f));
}
// sigma' = sigma (1 - sigma)
template <int N>
MPC_HD Dual<N> msigmoid(const Dual<N>& a) {
  const float s = msigmoid(a.v);
  return chain1(a, s, s * (1.0f - s));
}
// d(a mod b)/da = 1 (b a constant)
template <int N>
MPC_HD Dual<N> mrem(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = mrem(a.v, b);
  return r;
}
// below lo: the constant lo (no derivative); else a (torch passes the
// gradient where x >= min)
template <int N>
MPC_HD Dual<N> mclamp_min(const Dual<N>& a, float lo) { return a.v < lo ? Dual<N>(lo) : a; }
template <int N>
MPC_HD float mval(const Dual<N>& a) { return a.v; }

// -- second order ---------------------------------------------------------
// h holds the upper triangle row by row: (i, j), i <= j, at hidx(i, j).
template <int N>
struct Dual2 {
  static constexpr int K = N * (N + 1) / 2;
  float v;
  float g[N];
  float h[K];
  Dual2() = default;
  MPC_HD Dual2(float x) : v(x) {
#pragma unroll
    for (int i = 0; i < N; ++i) g[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < K; ++i) h[i] = 0.0f;
  }
  static MPC_HD int hidx(int i, int j) { return i * N - i * (i - 1) / 2 + (j - i); }
};

// Unary chain rule: value f0, gradient f1 a', Hessian f1 a'' + f2 a' a'^T.
template <int N>
MPC_HD Dual2<N> chain2(const Dual2<N>& a, float f0, float f1, float f2) {
  Dual2<N> r;
  r.v = f0;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = f1 * a.g[i];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) {
      const int k = Dual2<N>::hidx(i, j);
      r.h[k] = f1 * a.h[k] + f2 * a.g[i] * a.g[j];
    }
  return r;
}
// Scale every part by s, with value v.
template <int N>
MPC_HD Dual2<N> scale2(const Dual2<N>& a, float v, float s) {
  Dual2<N> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] * s;
#pragma unroll
  for (int k = 0; k < Dual2<N>::K; ++k) r.h[k] = a.h[k] * s;
  return r;
}

template <int N>
MPC_HD Dual2<N> operator+(const Dual2<N>& a, const Dual2<N>& b) {
  Dual2<N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] + b.g[i];
#pragma unroll
  for (int k = 0; k < Dual2<N>::K; ++k) r.h[k] = a.h[k] + b.h[k];
  return r;
}
template <int N>
MPC_HD Dual2<N> operator+(const Dual2<N>& a, float b) {
  Dual2<N> r = a;
  r.v = a.v + b;
  return r;
}
template <int N>
MPC_HD Dual2<N> operator+(float a, const Dual2<N>& b) {
  Dual2<N> r = b;
  r.v = a + b.v;
  return r;
}
template <int N>
MPC_HD Dual2<N> operator-(const Dual2<N>& a) { return scale2(a, -a.v, -1.0f); }
template <int N>
MPC_HD Dual2<N> operator-(const Dual2<N>& a, const Dual2<N>& b) {
  Dual2<N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] - b.g[i];
#pragma unroll
  for (int k = 0; k < Dual2<N>::K; ++k) r.h[k] = a.h[k] - b.h[k];
  return r;
}
template <int N>
MPC_HD Dual2<N> operator-(const Dual2<N>& a, float b) {
  Dual2<N> r = a;
  r.v = a.v - b;
  return r;
}
template <int N>
MPC_HD Dual2<N> operator-(float a, const Dual2<N>& b) { return scale2(b, a - b.v, -1.0f); }
template <int N>
MPC_HD Dual2<N> operator*(const Dual2<N>& a, const Dual2<N>& b) {
  Dual2<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.v * b.g[i] + b.v * a.g[i];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) {
      const int k = Dual2<N>::hidx(i, j);
      r.h[k] = a.v * b.h[k] + b.v * a.h[k] + a.g[i] * b.g[j] + b.g[i] * a.g[j];
    }
  return r;
}
template <int N>
MPC_HD Dual2<N> operator*(const Dual2<N>& a, float b) { return scale2(a, a.v * b, b); }
template <int N>
MPC_HD Dual2<N> operator*(float a, const Dual2<N>& b) { return scale2(b, a * b.v, a); }
// Quotient q = a / b: q' = (a' - q b') / b, q'' = (a'' - q b'' - q' b'^T - b' q'^T) / b.
template <int N>
MPC_HD Dual2<N> operator/(const Dual2<N>& a, const Dual2<N>& b) {
  Dual2<N> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = (a.g[i] - r.v * b.g[i]) / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) {
      const int k = Dual2<N>::hidx(i, j);
      r.h[k] = (a.h[k] - r.v * b.h[k] - r.g[i] * b.g[j] - b.g[i] * r.g[j]) / b.v;
    }
  return r;
}
template <int N>
MPC_HD Dual2<N> operator/(const Dual2<N>& a, float b) {
  Dual2<N> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] / b;
#pragma unroll
  for (int k = 0; k < Dual2<N>::K; ++k) r.h[k] = a.h[k] / b;
  return r;
}
template <int N>
MPC_HD Dual2<N> operator/(float a, const Dual2<N>& b) {
  const float q = a / b.v, q1 = -q / b.v;
  return chain2(b, q, q1, -2.0f * q1 / b.v);
}
template <int N>
MPC_HD Dual2<N> msin(const Dual2<N>& a) {
  const float s = sinf(a.v), c = cosf(a.v);
  return chain2(a, s, c, -s);
}
template <int N>
MPC_HD Dual2<N> mcos(const Dual2<N>& a) {
  const float s = sinf(a.v), c = cosf(a.v);
  return chain2(a, c, -s, -c);
}
template <int N>
MPC_HD Dual2<N> msqrt(const Dual2<N>& a) {
  const float s = sqrtf(a.v), d1 = 0.5f / s;
  return chain2(a, s, d1, -0.5f * d1 / a.v);
}
template <int N>
MPC_HD Dual2<N> mrecip(const Dual2<N>& a) {
  const float q = 1.0f / a.v;
  return chain2(a, q, -q * q, 2.0f * q * q * q);
}
template <int N>
MPC_HD Dual2<N> msq(const Dual2<N>& a) { return chain2(a, a.v * a.v, 2.0f * a.v, 2.0f); }
template <int N>
MPC_HD Dual2<N> mcube(const Dual2<N>& a) {
  return chain2(a, a.v * a.v * a.v, 3.0f * a.v * a.v, 6.0f * a.v);
}
template <int N>
MPC_HD Dual2<N> mpow(const Dual2<N>& a, float e) {
  return chain2(a, powf(a.v, e), e * powf(a.v, e - 1.0f), e * (e - 1.0f) * powf(a.v, e - 2.0f));
}
// sigma' = sigma (1 - sigma), sigma'' = sigma' (1 - 2 sigma)
template <int N>
MPC_HD Dual2<N> msigmoid(const Dual2<N>& a) {
  const float s = msigmoid(a.v), d1 = s * (1.0f - s);
  return chain2(a, s, d1, d1 * (1.0f - 2.0f * s));
}
template <int N>
MPC_HD Dual2<N> mrem(const Dual2<N>& a, float b) {
  Dual2<N> r = a;
  r.v = mrem(a.v, b);
  return r;
}
template <int N>
MPC_HD Dual2<N> mclamp_min(const Dual2<N>& a, float lo) { return a.v < lo ? Dual2<N>(lo) : a; }
template <int N>
MPC_HD float mval(const Dual2<N>& a) { return a.v; }

}  // namespace mpc
