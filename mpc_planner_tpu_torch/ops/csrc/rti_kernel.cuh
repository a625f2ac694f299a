// K3: the whole SQP-RTI solve of a batch of OCPs in ONE launch, one warp
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
// What bounds it on this card: the dependent chain of one element (RTI
// iterations x (a linearization + IP iterations x the Riccati recursion)),
// not bytes or operations; the launch count per solve is one instead of the
// ~1,650 per RTI iteration of the eager torch.func linearization. What the
// design does about the chain: the warp that owns the element
//   * linearizes the stages side by side, stage k on lane k (the stages are
//     independent; N+1 <= 32 on every supported horizon, else the lanes
//     loop), the terminal node on lane N;
//   * solves the QP as K1 does (ip_solve.cuh: row and stage passes over the
//     lanes, only the recursion serial, the iterate in shared memory);
//   * adds the step to Z over the lanes.
// Every array is element-major ([B, ...]), as the callers hold it. The
// linearized QP (H, g, A, B, c, Dh and the shifted bounds) is written by the
// linearization and read back by the IP solve with plain loads (the
// read-only cache is not coherent with the same launch's stores); a
// team_sync between writer and reader lanes orders the two. Where it lies
// is the launcher's choice from the batch size alone, as in K1
// (residency.cuh): in the block's shared memory, with the duals, while the
// whole batch is resident on the card at once even so (the robot's B=5: no
// wait on L2 inside the solve), else in a global scratch block of the
// element (B=1024: more warps an SM, which hide each other's waits).
// Linearization and IP solve are separate noinline functions, so each gets
// its own register allocation. Like ip_solve.cuh, the file also builds
// with a host compiler (a team of one lane) for the CPU tests.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "dual.cuh"
#include "ip_solve.cuh"
#include "mirror.cuh"

namespace mpc {

// The linearized QP of ONE element (the layout ip_solve reads), every
// pointer at the element's first entry: H [N+1, NV, NV], g [N+1, NV],
// A [N, NX, NX], Bm [N, NX, NU], c [N, NX], Dh [N+1, max(NH, 1), NV],
// lb/ub [N+1, NR] (inactive rows at -/+1e15).
struct QPArrays {
  float *H, *g, *A, *Bm, *c, *Dh, *lb, *ub;
};

template <class S>
struct Dims {
  static constexpr int NU = S::NU, NX = S::NX, NV = S::NU + S::NX, NH = S::NH;
  static constexpr int NR = NV + NH, NHD = NH > 0 ? NH : 1;
  static MPC_HD int64_t qp_floats(int N) {
    return static_cast<int64_t>(N + 1) * (NV * NV + NV + NHD * NV + 2 * NR)
           + static_cast<int64_t>(N) * (NX * NX + NX * NU + NX);
  }
};

// Carves one element's QPArrays out of its scratch block `s`.
template <class S>
MPC_HD void carve_qp(float* s, int N, QPArrays& q) {
  using D = Dims<S>;
  auto take = [&](int n) { float* p = s; s += n; return p; };
  q.H = take((N + 1) * D::NV * D::NV);
  q.g = take((N + 1) * D::NV);
  q.A = take(N * D::NX * D::NX);
  q.Bm = take(N * D::NX * D::NU);
  q.c = take(N * D::NX);
  q.Dh = take((N + 1) * D::NHD * D::NV);
  q.lb = take((N + 1) * D::NR);
  q.ub = take((N + 1) * D::NR);
}

// Where the generated stage functions put their outputs (`out(i, y)` for
// output entry i), all pointers at the stage's first entry.
template <int NU, int NX>
struct DynamicsOut {  // row i of x_{k+1} = f(z_k): c = f - x_{k+1}, A = df/dx, Bm = df/du
  float *A, *Bm, *c;
  const float* x_next;
  MPC_HD void operator()(int i, const Dual<NU + NX>& y) const {
    c[i] = y.v - x_next[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) A[i * NX + j] = y.d[NU + j];
#pragma unroll
    for (int j = 0; j < NU; ++j) Bm[i * NU + j] = y.d[j];
  }
};
template <int NV>
struct ConstraintOut {  // row r of h(z_k): Dh = dh/dz; bounds shifted by h (templates lbT/ubT)
  float *Dh, *lb, *ub;
  const float *lbT, *ubT;
  MPC_HD void operator()(int r, const Dual<NV>& y) const {
#pragma unroll
    for (int j = 0; j < NV; ++j) Dh[r * NV + j] = y.d[j];
    lb[r] = lbT[r] - y.v;
    ub[r] = ubT[r] - y.v;
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

// Linearization of one element at the iterate Z [N+1, NV] with parameters
// P [N+1, NP] (pallas_rti.py:81-137 stage for stage), stage k on lane k:
// a running stage (cost derivatives + MIRROR, dynamics Jacobian, constraint
// Jacobian), or the terminal node (u-block of z_N zeroed, MIRROR of the
// x-block of its Hessian, zero u-block); box rows and h rows get the
// templates shifted by the iterate: lb = lbT - r, ub = ubT - r. The caller
// syncs the team before anything reads q.
template <class S>
MPC_DEV_NOINLINE void linearize(const float* Z, const float* P, const float* lbT,
                                const float* ubT, const QPArrays q, const int N, const float lm,
                                const int x_only) {
  using D = Dims<S>;
  constexpr int NU = D::NU, NX = D::NX, NV = D::NV, NR = D::NR, NHD = D::NHD;

  for (int k = team_lane(); k <= N; k += kLanes) {
    const Strided pk{P + k * S::NP, 1};
    float* lb = q.lb + k * NR;
    float* ub = q.ub + k * NR;
    float zk[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) zk[j] = Z[k * NV + j];

    if (k < N) {
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
      for (int i = 0; i < NV * NV; ++i) q.H[k * NV * NV + i] = Hk[i];
#pragma unroll
      for (int j = 0; j < NV; ++j) q.g[k * NV + j] = cost.g[j];

      Dual<NV> z1[NV];
      seed(zk, z1);
      S::dynamics(z1, pk,
                  DynamicsOut<NU, NX>{q.A + k * NX * NX, q.Bm + k * NX * NU, q.c + k * NX,
                                      Z + (k + 1) * NV + NU});
      S::constraints(z1, pk,
                     ConstraintOut<NV>{q.Dh + k * NHD * NV, lb + NV, ub + NV, lbT + k * NR + NV,
                                       ubT + k * NR + NV});
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        lb[j] = lbT[k * NR + j] - zk[j];
        ub[j] = ubT[k * NR + j] - zk[j];
      }
    } else {  // the terminal node
      float zc[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) zc[j] = j < NU ? 0.0f : zk[j];
      Dual2<NV> z2[NV], cost;
      seed(zc, z2);
      S::terminal_cost(z2, pk, CostOut<NV>{&cost});
      float hx[NX * NX];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j)
          hx[i * NX + j] =
              cost.h[i <= j ? Dual2<NV>::hidx(NU + i, NU + j) : Dual2<NV>::hidx(NU + j, NU + i)];
      mirror_inplace<NX>(hx, lm, 6);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
#pragma unroll
        for (int j = 0; j < NV; ++j)
          q.H[(k * NV + i) * NV + j] = (i >= NU && j >= NU) ? hx[(i - NU) * NX + j - NU] : 0.0f;
        q.g[k * NV + i] = i < NU ? 0.0f : cost.g[i];
      }
      for (int i = 0; i < NHD * NV; ++i) q.Dh[k * NHD * NV + i] = 0.0f;
      for (int j = 0; j < NR; ++j) {
        const float r = j < NV ? zk[j] : 0.0f;
        lb[j] = lbT[k * NR + j] - r;
        ub[j] = ubT[k * NR + j] - r;
      }
    }
  }
}

template <int NU, int NX>
MPC_DEV_NOINLINE float rti_ip_solve(const IPElement q, const IPShared<NU, NX> m) {
  return ip_solve<NU, NX, PlainView>(q, m);
}

// Element-major arrays: Z0/Z [B, N+1, NV], P [B, N+1, NP], templates
// [N+1, NR], warm duals wl/wu and the duals lam_l/lam_u [B, N+1, NR],
// wok/mu [B], scratch [B, rti_scratch_floats(N)].
struct RTILaunch {
  const float *Z0, *P, *lbT, *ubT, *wl, *wu, *wok;
  float *Z, *lam_l, *lam_u, *mu, *scratch;
  int B, N, num_rti, it0, warm_iters, use_warm, mehrotra, mirror_x_only;
  float mu0, reg, tau, sigma_fixed, lm;
};

// Global scratch floats per element: its linearized QP.
template <class S>
MPC_HD int64_t rti_scratch_floats(int N) {
  return Dims<S>::qp_floats(N);
}
// Shared-memory floats per element: the IP solve's working set, and where
// `staged` the linearized QP and the duals as well (no global scratch then).
template <class S>
MPC_HD int64_t rti_shared_floats(int N, bool staged) {
  return ip_shared_floats(S::NU, S::NX, N, S::NH)
         + (staged ? qp_and_dual_floats(S::NU, S::NX, N, S::NH) : 0);
}

// The whole solve of element b by its team; `shared` holds
// rti_shared_floats(N, staged) floats of the team's own. Where `staged`,
// the linearized QP and the duals stay in shared memory for the whole
// solve (a.scratch is not touched), and the duals go out at the end.
template <class S>
MPC_DEV void rti_element(const RTILaunch& a, const int64_t b, float* shared, const bool staged) {
  using D = Dims<S>;
  const int N = a.N, NZ = (N + 1) * D::NV, lane = team_lane();
  const int64_t R1 = static_cast<int64_t>(N + 1) * D::NR;
  const float* P = a.P + b * (N + 1) * S::NP;
  float* Z = a.Z + b * NZ;
  const IPShared<D::NU, D::NX> m(shared, N, D::NH);
  float* const own = shared + IPShared<D::NU, D::NX>::floats(N, D::NH);
  QPArrays qa;
  carve_qp<S>(staged ? own : a.scratch + b * rti_scratch_floats<S>(N), N, qa);
  float* const lam_l = a.lam_l + b * R1;
  float* const lam_u = a.lam_u + b * R1;

  for (int i = lane; i < NZ; i += kLanes) Z[i] = a.Z0[b * NZ + i];
  team_sync();

  IPElement qp;
  qp.H = qa.H;
  qp.g = qa.g;
  qp.A = qa.A;
  qp.Bm = qa.Bm;
  qp.c = qa.c;
  qp.Dh = qa.Dh;
  qp.lb = qa.lb;
  qp.ub = qa.ub;
  qp.lam_l = staged ? own + rti_scratch_floats<S>(N) : lam_l;
  qp.lam_u = staged ? qp.lam_l + R1 : lam_u;
  qp.N = N;
  qp.nh = D::NH;
  qp.mehrotra = a.mehrotra != 0;
  qp.mu0 = a.mu0;
  qp.reg = a.reg;
  qp.tau = a.tau;
  qp.sigma_fixed = a.sigma_fixed;

  float mu = 0.0f;
  for (int it = 0; it < a.num_rti; ++it) {
    linearize<S>(Z, P, a.lbT, a.ubT, qa, N, a.lm, a.mirror_x_only);
    team_sync();
    // First QP: the caller's duals (or a cold start) at it0 IP iterations;
    // later ones: the previous QP's duals, where it converged (mu < 1e-2),
    // at warm_iters (pallas_rti.py:150-184). The IP solve reads each dual
    // before it overwrites it, on the same lane, so lam_l/lam_u are its
    // own warm input.
    if (it == 0) {
      qp.warm = a.use_warm && a.wok[b] > 0.0f;
      qp.wl = a.use_warm ? a.wl + b * R1 : nullptr;
      qp.wu = a.use_warm ? a.wu + b * R1 : nullptr;
      qp.iterations = a.it0;
    } else {
      qp.warm = mu < 1e-2f;
      qp.wl = qp.lam_l;
      qp.wu = qp.lam_u;
      qp.iterations = a.warm_iters;
    }
    mu = rti_ip_solve<D::NU, D::NX>(qp, m);
    for (int i = lane; i < NZ; i += kLanes) Z[i] += m.zeta[i];
    team_sync();
  }
  if (staged) {
    for (int i = lane; i < R1; i += kLanes) {
      lam_l[i] = qp.lam_l[i];
      lam_u[i] = qp.lam_u[i];
    }
  }
  if (lane == 0) a.mu[b] = mu;
}

// The linearization alone: element b's QP into element-major arrays
// (H [B, N+1, NV, NV], ...), as linearize_cuda returns them.
template <class S>
MPC_DEV void linearize_element(const float* Z, const float* P, const float* lbT, const float* ubT,
                               const QPArrays all, const int N, const float lm, const int x_only,
                               const int64_t b) {
  using D = Dims<S>;
  const int64_t s = N + 1, n = N;
  const QPArrays q{all.H + b * s * D::NV * D::NV, all.g + b * s * D::NV,
                   all.A + b * n * D::NX * D::NX, all.Bm + b * n * D::NX * D::NU,
                   all.c + b * n * D::NX,         all.Dh + b * s * D::NHD * D::NV,
                   all.lb + b * s * D::NR,        all.ub + b * s * D::NR};
  linearize<S>(Z + b * s * D::NV, P + b * s * S::NP, lbT, ubT, q, N, lm, x_only);
}

}  // namespace mpc

#if defined(__CUDACC__)

#include "residency.cuh"

namespace mpc {

template <class S>
__global__ void __launch_bounds__(kLanes) rti_kernel(const RTILaunch a, const bool staged) {
  extern __shared__ float shared[];
  rti_element<S>(a, blockIdx.x, shared, staged);
}

template <class S>
__global__ void __launch_bounds__(kLanes) linearize_kernel(const float* Z, const float* P,
                                                           const float* lbT, const float* ubT,
                                                           const QPArrays all, int N, float lm,
                                                           int x_only) {
  linearize_element<S>(Z, P, lbT, ubT, all, N, lm, x_only, blockIdx.x);
}

}  // namespace mpc

// Plain C entry points of the generated library (loaded with ctypes by
// ops/cuda_rti.py). Each launches on `stream`, one block of one warp per
// element, and returns a cudaError_t as an int (0: launched).
extern "C" {

int mpc_rti_dims(int* out) {
  out[0] = mpc::Stages::NU;
  out[1] = mpc::Stages::NX;
  out[2] = mpc::Stages::NH;
  out[3] = mpc::Stages::NP;
  return 0;
}

long long mpc_rti_scratch_floats(int N) { return mpc::rti_scratch_floats<mpc::Stages>(N); }

long long mpc_rti_shared_bytes(int N, int staged) {
  return mpc::rti_shared_floats<mpc::Stages>(N, staged != 0) * static_cast<long long>(sizeof(float));
}

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
  // Staged where every block of the batch is resident at once even with the
  // larger footprint (the robot's B=5 always is): then a lone warp on its SM
  // never waits on L2. A larger batch keeps its QPs in global scratch, so
  // that more warps fit an SM and hide each other's waits.
  const bool staged = mpc::all_resident(B, mpc_rti_shared_bytes(N, 1));
  const long long bytes = mpc_rti_shared_bytes(N, staged);
  if (bytes > mpc::kMaxBlockSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(mpc::rti_kernel<mpc::Stages>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mpc::rti_kernel<mpc::Stages><<<B, mpc::kLanes, bytes, static_cast<cudaStream_t>(stream)>>>(a, staged);
  return static_cast<int>(cudaGetLastError());
}

int mpc_rti_linearize(const float* Z, const float* P, const float* lbT, const float* ubT,
                      float* H, float* g, float* A, float* Bm, float* c, float* Dh, float* lb,
                      float* ub, int B, int N, int mirror_x_only, float lm, void* stream) {
  if (B == 0) return 0;
  const mpc::QPArrays all{H, g, A, Bm, c, Dh, lb, ub};
  mpc::linearize_kernel<mpc::Stages><<<B, mpc::kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      Z, P, lbT, ubT, all, N, lm, mirror_x_only);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

#endif  // __CUDACC__
