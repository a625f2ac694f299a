// K3: the whole SQP-RTI solve of a batch of OCPs in ONE launch, one thread
// per batch element: per RTI iteration, the linearization (derivatives of
// the OCP's stage functions), MIRROR of the stage Hessians, the
// interior-point QP solve with its warm-start ladder, and Z += dz.
//
// Replaces mpc_planner_tpu/ops/pallas_rti.py::solve_rti_pallas ->
// _rti_kernel (:60-187). The TPU kernel differentiates the stage functions
// with jax.jacfwd / jax.hessian inside its trace; here the stage functions
// come as C++ generated for each OCP (ops/stage_codegen.py emits
// `mpc::Stages` and then includes this file), evaluated on the dual numbers
// of dual.cuh. The QP is the body of K1 (ip_solve.cuh), the MIRROR the
// Jacobi of K2 (mirror.cuh).
//
// Design: as K1, each thread owns one element and every array is
// batch-innermost ([rows, B]) in global memory, so a warp's 32 threads
// touch 32 consecutive floats. The linearized QP (H, g, A, B, c, Dh and the
// shifted bounds) is written to global scratch by the linearization and
// read back by the IP solve, with plain loads: the read-only cache is not
// coherent with the same launch's stores. Linearization and IP solve are
// separate __noinline__ functions, so each gets its own register
// allocation. What bounds it: the per-thread dependent chain (N stages x
// RTI iterations x IP iterations), as for K1; the launch count per solve
// drops from ~1,650 per RTI iteration (eager torch.func linearization) to
// one.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "dual.cuh"
#include "ip_solve.cuh"
#include "mirror.cuh"

namespace mpc {

// The linearized QP of every element, batch-innermost (the layout K1 reads):
// H [N+1, NV, NV], g [N+1, NV], A [N, NX, NX], Bm [N, NX, NU], c [N, NX],
// Dh [N+1, max(NH, 1), NV], lb/ub [N+1, NR] (inactive rows at -/+1e15).
struct QPArrays {
  float *H, *g, *A, *Bm, *c, *Dh, *lb, *ub;
};

template <class S>
struct Dims {
  static constexpr int NU = S::NU, NX = S::NX, NV = S::NU + S::NX, NH = S::NH;
  static constexpr int NR = NV + NH, NHD = NH > 0 ? NH : 1;
  static int64_t qp_floats(int N) {
    return static_cast<int64_t>(N + 1) * (NV * NV + NV + NHD * NV + 2 * NR)
           + static_cast<int64_t>(N) * (NX * NX + NX * NU + NX);
  }
};

// Carves QPArrays for B elements out of `s`; returns the first float after.
template <class S>
MPC_HD float* carve_qp(float* s, int N, int B, QPArrays& q) {
  using D = Dims<S>;
  const int64_t b = B;
  auto take = [&](int64_t n) { float* p = s; s += n * b; return p; };
  q.H = take((N + 1) * D::NV * D::NV);
  q.g = take((N + 1) * D::NV);
  q.A = take(static_cast<int64_t>(N) * D::NX * D::NX);
  q.Bm = take(static_cast<int64_t>(N) * D::NX * D::NU);
  q.c = take(static_cast<int64_t>(N) * D::NX);
  q.Dh = take((N + 1) * D::NHD * D::NV);
  q.lb = take((N + 1) * D::NR);
  q.ub = take((N + 1) * D::NR);
  return s;
}

// Where the generated stage functions put their outputs (`out(i, y)` for
// output entry i). All pointers are at the element's column; stride B.
template <int NU, int NX>
struct DynamicsOut {  // row i of x_{k+1} = f(z_k): c = f - x_{k+1}, A = df/dx, Bm = df/du
  float *A, *Bm, *c;
  const float* x_next;
  int B;
  MPC_HD void operator()(int i, const Dual<NU + NX>& y) const {
    const int64_t b = B;
    c[i * b] = y.v - x_next[i * b];
#pragma unroll
    for (int j = 0; j < NX; ++j) A[(i * NX + j) * b] = y.d[NU + j];
#pragma unroll
    for (int j = 0; j < NU; ++j) Bm[(i * NU + j) * b] = y.d[j];
  }
};
template <int NV>
struct ConstraintOut {  // row r of h(z_k): Dh = dh/dz; bounds shifted by h (templates lbT/ubT)
  float *Dh, *lb, *ub;
  const float *lbT, *ubT;
  int B;
  MPC_HD void operator()(int r, const Dual<NV>& y) const {
    const int64_t b = B;
#pragma unroll
    for (int j = 0; j < NV; ++j) Dh[(r * NV + j) * b] = y.d[j];
    lb[r * b] = lbT[r] - y.v;
    ub[r * b] = ubT[r] - y.v;
  }
};
template <int NV>
struct CostOut {
  Dual2<NV>* y;
  MPC_HD void operator()(int, const Dual2<NV>& v) const { *y = v; }
};

template <int NV>
MPC_HD void seed(const float (&z)[NV], Dual<NV> (&zd)[NV]) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    zd[j] = Dual<NV>(z[j]);
    zd[j].d[j] = 1.0f;
  }
}
template <int NV>
MPC_HD void seed(const float (&z)[NV], Dual2<NV> (&zd)[NV]) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    zd[j] = Dual2<NV>(z[j]);
    zd[j].g[j] = 1.0f;
  }
}

// MIRROR of a running-stage Hessian in registers: the whole NV x NV matrix,
// or (x_only: u-block diagonal and decoupled, solver/sqp.py's probe)
// max(|H_uu|, lm) on the u-diagonal and the Jacobi on the NX x NX x-block.
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

// Linearization of element b at the iterate Z [N+1, NV, B] with
// parameters P [N+1, NP, B] (pallas_rti.py:81-137 stage for stage):
// running stages 0..N-1 (cost derivatives + MIRROR, dynamics Jacobian,
// constraint Jacobian), then the terminal node (u-block of z_N zeroed,
// MIRROR of the x-block of its Hessian, zero u-block); box rows and h rows
// get the templates shifted by the iterate: lb = lbT - r, ub = ubT - r.
template <class S>
__device__ __noinline__ void linearize(const float* Z, const float* P, const float* lbT,
                                       const float* ubT, const QPArrays q, const int B,
                                       const int N, const float lm, const int x_only, const int b) {
  using D = Dims<S>;
  constexpr int NU = D::NU, NX = D::NX, NV = D::NV, NR = D::NR, NHD = D::NHD;
  const int64_t Bl = B;
  auto at = [&](const float* base, int64_t i) { return base[i * Bl + b]; };

  for (int k = 0; k < N; ++k) {
    float zk[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) zk[j] = at(Z, k * NV + j);
    const Strided pk{P + static_cast<int64_t>(k) * S::NP * Bl + b, B};

    Dual2<NV> z2[NV], cost;
    seed(zk, z2);
    S::running_cost(z2, pk, CostOut<NV>{&cost});
    float Hk[NV * NV];
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < NV; ++j)
        Hk[i * NV + j] = cost.h[i <= j ? Dual2<NV>::hidx(i, j) : Dual2<NV>::hidx(j, i)];
    mirror_stage<NU, NX>(Hk, lm, x_only != 0);
#pragma unroll
    for (int i = 0; i < NV * NV; ++i) q.H[(k * NV * NV + i) * Bl + b] = Hk[i];
#pragma unroll
    for (int j = 0; j < NV; ++j) q.g[(k * NV + j) * Bl + b] = cost.g[j];

    Dual<NV> z1[NV];
    seed(zk, z1);
    S::dynamics(z1, pk,
                DynamicsOut<NU, NX>{q.A + k * NX * NX * Bl + b, q.Bm + k * NX * NU * Bl + b,
                                    q.c + k * NX * Bl + b, Z + ((k + 1) * NV + NU) * Bl + b, B});
    float* lb = q.lb + k * NR * Bl + b;
    float* ub = q.ub + k * NR * Bl + b;
    S::constraints(z1, pk,
                   ConstraintOut<NV>{q.Dh + k * NHD * NV * Bl + b, lb + NV * Bl, ub + NV * Bl,
                                     lbT + k * NR + NV, ubT + k * NR + NV, B});
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      lb[j * Bl] = lbT[k * NR + j] - zk[j];
      ub[j * Bl] = ubT[k * NR + j] - zk[j];
    }
  }

  // terminal node
  float zN[NV], zc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    zN[j] = at(Z, N * NV + j);
    zc[j] = j < NU ? 0.0f : zN[j];
  }
  const Strided pN{P + static_cast<int64_t>(N) * S::NP * Bl + b, B};
  Dual2<NV> z2[NV], cost;
  seed(zc, z2);
  S::terminal_cost(z2, pN, CostOut<NV>{&cost});
  float hx[NX * NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j)
      hx[i * NX + j] = cost.h[i <= j ? Dual2<NV>::hidx(NU + i, NU + j) : Dual2<NV>::hidx(NU + j, NU + i)];
  mirror_inplace<NX>(hx, lm, 6);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      q.H[((N * NV + i) * NV + j) * Bl + b] = (i >= NU && j >= NU) ? hx[(i - NU) * NX + j - NU] : 0.0f;
    q.g[(N * NV + i) * Bl + b] = i < NU ? 0.0f : cost.g[i];
  }
  for (int i = 0; i < NHD * NV; ++i) q.Dh[(N * NHD * NV + i) * Bl + b] = 0.0f;
  for (int j = 0; j < NR; ++j) {
    const float r = j < NV ? zN[j] : 0.0f;
    q.lb[(N * NR + j) * Bl + b] = lbT[N * NR + j] - r;
    q.ub[(N * NR + j) * Bl + b] = ubT[N * NR + j] - r;
  }
}

template <int NU, int NX>
__device__ __noinline__ void rti_ip_solve(const QPLaunch a, const int b) {
  ip_solve<NU, NX, PLane>(a, b);
}

struct RTILaunch {
  const float *Z0, *P, *lbT, *ubT, *wl, *wu, *wok;
  float *Z, *lam_l, *lam_u, *mu, *scratch;
  int B, N, num_rti, it0, warm_iters, use_warm, mehrotra, mirror_x_only;
  float mu0, reg, tau, sigma_fixed, lm;
};

template <class S>
int64_t rti_scratch_floats(int N) {
  using D = Dims<S>;
  return D::qp_floats(N) + static_cast<int64_t>(N + 1) * D::NV + 1
         + ip_scratch_floats(N, D::NU, D::NX, D::NH);
}

template <class S>
__global__ void __launch_bounds__(32) rti_kernel(const RTILaunch a) {
  using D = Dims<S>;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int B = a.B, N = a.N;
  const int64_t Bl = B;
  QPArrays q;
  float* s = carve_qp<S>(a.scratch, N, B, q);
  float* zeta = s;
  float* okf = zeta + static_cast<int64_t>(N + 1) * D::NV * Bl;
  float* qp_scratch = okf + Bl;

  for (int i = 0; i < (N + 1) * D::NV; ++i) a.Z[i * Bl + b] = a.Z0[i * Bl + b];

  QPLaunch qp;
  qp.H = q.H;
  qp.g = q.g;
  qp.A = q.A;
  qp.Bm = q.Bm;
  qp.c = q.c;
  qp.Dh = q.Dh;
  qp.lb = q.lb;
  qp.ub = q.ub;
  qp.dz = zeta;
  qp.lam_l = a.lam_l;
  qp.lam_u = a.lam_u;
  qp.mu = a.mu;
  qp.scratch = qp_scratch;
  qp.B = B;
  qp.N = N;
  qp.nu = D::NU;
  qp.nx = D::NX;
  qp.nh = D::NH;
  qp.mu0 = a.mu0;
  qp.reg = a.reg;
  qp.tau = a.tau;
  qp.sigma_fixed = a.sigma_fixed;
  qp.mehrotra = a.mehrotra;

  for (int it = 0; it < a.num_rti; ++it) {
    linearize<S>(a.Z, a.P, a.lbT, a.ubT, q, B, N, a.lm, a.mirror_x_only, b);
    // First QP: the caller's duals (or a cold start) at it0 IP iterations;
    // later ones: the previous QP's duals, where it converged (mu < 1e-2),
    // at warm_iters (pallas_rti.py:150-184). The IP solve reads each dual
    // before it overwrites it, so lam_l/lam_u may be its own warm input.
    if (it == 0) {
      qp.wl = a.wl;
      qp.wu = a.wu;
      qp.wok = a.wok;
      qp.use_warm = a.use_warm;
      qp.iterations = a.it0;
    } else {
      qp.wl = a.lam_l;
      qp.wu = a.lam_u;
      qp.wok = okf;
      qp.use_warm = 1;
      qp.iterations = a.warm_iters;
    }
    rti_ip_solve<D::NU, D::NX>(qp, b);
    for (int i = 0; i < (N + 1) * D::NV; ++i) a.Z[i * Bl + b] += zeta[i * Bl + b];
    okf[b] = a.mu[b] < 1e-2f ? 1.0f : 0.0f;
  }
}

template <class S>
__global__ void __launch_bounds__(32) linearize_kernel(const float* Z, const float* P,
                                                       const float* lbT, const float* ubT,
                                                       const QPArrays q, int B, int N, float lm,
                                                       int x_only) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  linearize<S>(Z, P, lbT, ubT, q, B, N, lm, x_only, b);
}

constexpr int kRTIThreads = 32;  // one warp per block: spreads a small batch over the SMs

}  // namespace mpc

// Plain C entry points of the generated library (loaded with ctypes by
// ops/cuda_rti.py). Each launches on `stream` and returns
// cudaGetLastError() as an int (0: launched).
extern "C" {

int mpc_rti_dims(int* out) {
  out[0] = mpc::Stages::NU;
  out[1] = mpc::Stages::NX;
  out[2] = mpc::Stages::NH;
  out[3] = mpc::Stages::NP;
  return 0;
}

long long mpc_rti_scratch_floats(int N) { return mpc::rti_scratch_floats<mpc::Stages>(N); }

int mpc_rti_solve(const float* Z0, const float* P, const float* lbT, const float* ubT,
                  const float* wl, const float* wu, const float* wok, float* Z, float* lam_l,
                  float* lam_u, float* mu, float* scratch, int B, int N, int num_rti, int it0,
                  int warm_iters, int use_warm, int mehrotra, int mirror_x_only, float mu0,
                  float reg, float tau, float sigma_fixed, float lm, void* stream) {
  if (B == 0) return 0;
  const mpc::RTILaunch a{Z0,    P,     lbT,     ubT,        wl,       wu,       wok,
                         Z,     lam_l, lam_u,   mu,         scratch,  B,        N,
                         num_rti, it0, warm_iters, use_warm, mehrotra, mirror_x_only,
                         mu0,   reg,   tau,     sigma_fixed, lm};
  const int blocks = (B + mpc::kRTIThreads - 1) / mpc::kRTIThreads;
  mpc::rti_kernel<mpc::Stages><<<blocks, mpc::kRTIThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int mpc_rti_linearize(const float* Z, const float* P, const float* lbT, const float* ubT,
                      float* H, float* g, float* A, float* Bm, float* c, float* Dh, float* lb,
                      float* ub, int B, int N, int mirror_x_only, float lm, void* stream) {
  if (B == 0) return 0;
  const mpc::QPArrays q{H, g, A, Bm, c, Dh, lb, ub};
  const int blocks = (B + mpc::kRTIThreads - 1) / mpc::kRTIThreads;
  mpc::linearize_kernel<mpc::Stages><<<blocks, mpc::kRTIThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Z, P, lbT, ubT, q, B, N, lm, mirror_x_only);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
