// K1: fixed-count interior-point Riccati QP solve of a batch of stagewise
// QPs, one warp per batch element.
//
// Replaces mpc_planner_tpu/ops/pallas_qp.py::solve_qp_pallas -> _qp_kernel
// -> _ip_solve (pallas_qp.py:198-550, closed-form R-hat inverse _sym_inv
// :168-195). It computes what that kernel computes, per element:
// Mehrotra predictor-corrector (or fixed-sigma) primal-dual IPM, each IP
// iteration building H-bar = H + D' diag(w) D, the backward Riccati
// factorization, the equality residual and gradient refresh, backward
// substitution + forward rollout (dx_0 = 0, terminal inputs pinned to 0)
// for each right-hand side, D dz, separate primal/dual fraction-to-
// boundary steps, and the freeze guard that keeps the OLD iterate on
// converged, diverged or non-finite elements. Row masks come from the
// +-1e15 bound sentinels; the box rows are the identity over z, so only
// the nh general rows carry a stored Jacobian (Dh).
//
// Design: the TPU kernel puts 128 batch elements on the vector lanes and
// walks rows and stages in sequence. On this card one element's solve is
// bound by its own dependent chain, not by bytes (~33 KB per element) or
// operations (~2 MFLOP), so the chain is what the design shortens: one
// warp owns one element, its 32 lanes share the row and stage passes, and
// only the Riccati recursion stays serial (ip_solve.cuh has the mapping).
// A block is one warp: the only thing a block's warps could share is
// shared memory, and each element needs its own working set there (24.8 KB
// at N=20, nrows=31; 36.7 KB at N=30), so larger blocks would buy nothing,
// and a batch of 5 lands on 5 SMs. What is left of the chain is mostly
// waiting on memory, so the launcher picks where the QP's read-only data
// and the duals live from the batch size alone (residency.cuh):
//   * while every block of the batch is resident on the card at once even
//     with the larger footprint (57 KB at N=20, 85 KB at N=30: 4 or 2
//     blocks an SM, 528 or 264 elements), each block first copies its QP
//     into shared memory and iterates the duals there, so a lone warp on
//     its SM never waits on L2 (the robot's B=5);
//   * a larger batch (B=1024) reads the QP through L1/L2 and keeps the
//     duals in the output arrays: 9 blocks an SM by shared memory, 16 by
//     registers (128), the whole batch in one wave, and the warps of an SM
//     hide each other's waits.
// Arrays are element-major, as the callers hold them: no transpose around
// the launch.
//
// MIRROR (K2's work) inside this kernel: with `mirror` set the caller hands
// over the RAW stage Hessians, and the block regularizes them first, stage
// k on lane k, into packed upper triangles (ip_solve.cuh::mirror_stages),
// in both launch modes; the staged mode then stages no H. The triangles go
// into the block's shared memory (2.4 KB at N=20, nvar=7: B=1024 is still
// one wave, and the solve reads them faster than it read H through L2),
// unless that would cost the batch another wave of blocks (the goal shape
// at N=30, B=1024: 924 resident blocks instead of 1,056): then into the
// caller's global scratch, read through L1/L2 like the rest of the QP.

#include <cstdint>

#include "ip_solve.cuh"
#include "kernels.h"
#include "residency.cuh"

namespace {

// MIRROR and STAGED are template parameters: each kernel holds one
// instantiation of the solve (FullH or PackedH) and takes the registers of
// that one (unstaged at (2, 5): 128 without the MIRROR, 167 with).
template <int NU, int NX, bool STAGED, bool MIRROR>
__global__ void __launch_bounds__(mpc::kLanes) qp_kernel(QPLaunch a) {
  using mpc::PlainView;
  using mpc::ReadOnlyView;
  extern __shared__ float shared[];
  constexpr int NV = NU + NX;
  const size_t b = blockIdx.x;
  const int lane = mpc::team_lane();
  const int N = a.N, NHD = a.nh > 0 ? a.nh : 1;
  const int R1 = (N + 1) * (NV + a.nh), NZ = (N + 1) * NV;
  mpc::IPElement q = mpc::qp_element<NU, NX>(a, b);
  float* const lam_l = q.lam_l;
  float* const lam_u = q.lam_u;

  const mpc::IPShared<NU, NX> m(shared, N, a.nh);
  const bool x_only = a.mirror_x_only != 0;
  float* const Hm = a.hm_global  // with MIRROR: the packed regularized Hessians
                        ? a.Hm + b * mpc::packed_hessian_floats(NU, NX, N)
                        : shared + mpc::IPShared<NU, NX>::floats(N, a.nh);
  float mu;
  if constexpr (STAGED) {
    // Copy the element's QP into shared memory once and iterate the duals
    // there: every later read of the solve is a shared-memory read. Raw
    // Hessians are not staged: the MIRROR reads them once, from global memory.
    float* s = Hm + (MIRROR ? mpc::packed_hessian_floats(NU, NX, N) : 0);
    auto stage = [&](const float*& p, int n) {
      for (int i = lane; i < n; i += mpc::kLanes) s[i] = __ldg(p + i);
      p = s;
      s += n;
    };
    if constexpr (!MIRROR) stage(q.H, NZ * NV);
    stage(q.g, NZ);
    stage(q.A, N * NX * NX);
    stage(q.Bm, N * NX * NU);
    stage(q.c, N * NX);
    stage(q.Dh, (N + 1) * NHD * NV);
    stage(q.lb, R1);
    stage(q.ub, R1);
    q.lam_l = s;
    q.lam_u = s + R1;
    mpc::team_sync();
    mu = mpc::qp_solve<NU, NX, MIRROR, PlainView, ReadOnlyView>(q, m, Hm, a.lm, x_only);
    for (int i = lane; i < R1; i += mpc::kLanes) {
      lam_l[i] = q.lam_l[i];
      lam_u[i] = q.lam_u[i];
    }
  } else {
    mu = mpc::qp_solve<NU, NX, MIRROR, ReadOnlyView, ReadOnlyView>(q, m, Hm, a.lm, x_only);
  }
  float* dz = a.dz + b * NZ;
  for (int i = lane; i < NZ; i += mpc::kLanes) dz[i] = m.zeta[i];
  if (lane == 0) a.mu[b] = mu;
}

template <int NU, int NX, bool STAGED, bool MIRROR>
cudaError_t launch_kernel(const QPLaunch& args, int64_t bytes, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(qp_kernel<NU, NX, STAGED, MIRROR>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  // one block of one warp per element
  qp_kernel<NU, NX, STAGED, MIRROR><<<args.B, mpc::kLanes, bytes, stream>>>(args);
  return cudaSuccess;
}

template <int NU, int NX, bool STAGED>
cudaError_t launch_as(const QPLaunch& args, int64_t bytes, cudaStream_t stream) {
  return args.mirror != 0 ? launch_kernel<NU, NX, STAGED, true>(args, bytes, stream)
                          : launch_kernel<NU, NX, STAGED, false>(args, bytes, stream);
}

// Waves of one-warp blocks a batch of B needs at `bytes` of shared memory each.
int64_t waves(int64_t B, int64_t bytes) {
  const int64_t resident = mpc::resident_blocks(bytes);
  return resident > 0 ? (B + resident - 1) / resident : INT64_MAX;
}

template <int NU, int NX>
cudaError_t launch(QPLaunch args, cudaStream_t stream) {
  // Staged where every block of the batch is resident at once even with the
  // larger footprint (the robot's B=5 always is): then a lone warp on its
  // SM never waits on L2. A larger batch keeps the QP data in global
  // memory, so that more warps fit an SM and hide each other's waits.
  const bool mirror = args.mirror != 0;
  const int64_t staged = qp_shared_bytes(args.N, NU, NX, args.nh, true, mirror);
  if (mpc::all_resident(args.B, staged)) return launch_as<NU, NX, true>(args, staged, stream);
  int64_t bytes = qp_shared_bytes(args.N, NU, NX, args.nh, false, mirror);
  if (mirror && args.Hm != nullptr && qp_mirror_in_global(args.B, args.N, NU, NX, args.nh)) {
    args.hm_global = 1;  // the packed Hessians in global scratch: one wave fewer
    bytes = qp_shared_bytes(args.N, NU, NX, args.nh, false, false);
  }
  if (bytes > mpc::kMaxBlockSharedBytes) return cudaErrorInvalidValue;
  return launch_as<NU, NX, false>(args, bytes, stream);
}

}  // namespace

int64_t qp_shared_bytes(int N, int nu, int nx, int nh, bool staged, bool mirror) {
  const int64_t nv = nu + nx;
  int64_t floats = mpc::ip_shared_floats(nu, nx, N, nh);
  if (staged) floats += mpc::qp_and_dual_floats(nu, nx, N, nh);
  // mirrored Hessians as packed triangles; the raw ones are never staged
  if (mirror) floats += mpc::packed_hessian_floats(nu, nx, N) - (staged ? (N + 1) * nv * nv : 0);
  return floats * static_cast<int64_t>(sizeof(float));
}

bool qp_mirror_in_global(int64_t B, int N, int nu, int nx, int nh) {
  if (mpc::all_resident(B, qp_shared_bytes(N, nu, nx, nh, true, true))) return false;  // staged
  return waves(B, qp_shared_bytes(N, nu, nx, nh, false, false))
         < waves(B, qp_shared_bytes(N, nu, nx, nh, false, true));
}

int64_t qp_resident_blocks(int64_t shared_bytes_per_block) {
  return mpc::resident_blocks(shared_bytes_per_block);
}

cudaError_t launch_qp(const QPLaunch& in, cudaStream_t stream) {
  if (in.B == 0) return cudaSuccess;
  QPLaunch args = in;
  args.hm_global = 0;  // the launcher's choice
  if (args.nu == 2 && args.nx == 4) return launch<2, 4>(args, stream);
  if (args.nu == 2 && args.nx == 5) return launch<2, 5>(args, stream);
  if (args.nu == 3 && args.nx == 5) return launch<3, 5>(args, stream);
  if (args.nu == 3 && args.nx == 6) return launch<3, 6>(args, stream);
  return cudaErrorInvalidValue;
}
