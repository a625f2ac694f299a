// K1: fixed-count interior-point Riccati QP solve of a batch of stagewise
// QPs, one thread per batch element.
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
// Design: the TPU kernel puts 128 batch elements on the vector lanes; here
// each thread owns one element and runs the sequential stage and IP loops
// itself. Every array is stored batch-innermost ([..., B]) in global
// memory, so the 32 threads of a warp touch 32 consecutive floats on each
// access. The per-element working set (~31 KB at N=30, nrows=19) is too
// large for registers or shared memory; it streams through L1/L2 (the
// whole B=1024 working set, ~32 MB, fits the 50 MB L2). Per-stage
// matrices (P, H-bar, A, B, K, ...) are held in registers inside each
// stage step. What bounds it: the dependent chain of ~N x 3 sweeps x IP
// iterations per thread, with few threads in flight (B threads in all),
// i.e. latency, not bandwidth or FLOPs.

#include "ip_solve.cuh"

namespace {

template <int NU, int NX>
__global__ void __launch_bounds__(32) qp_kernel(QPLaunch a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  mpc::ip_solve<NU, NX, mpc::CLane>(a, b);
}

template <int NU, int NX>
void launch(const QPLaunch& args, cudaStream_t stream) {
  constexpr int threads = 32;  // one warp per block: spreads a small batch over the SMs
  const int blocks = (args.B + threads - 1) / threads;
  qp_kernel<NU, NX><<<blocks, threads, 0, stream>>>(args);
}

}  // namespace

int64_t qp_scratch_floats(int N, int nu, int nx, int nh) {
  return mpc::ip_scratch_floats(N, nu, nx, nh);
}

cudaError_t launch_qp(const QPLaunch& args, cudaStream_t stream) {
  if (args.B == 0) return cudaSuccess;
  if (args.nu == 2 && args.nx == 4) launch<2, 4>(args, stream);
  else if (args.nu == 2 && args.nx == 5) launch<2, 5>(args, stream);
  else if (args.nu == 3 && args.nx == 5) launch<3, 5>(args, stream);
  else if (args.nu == 3 && args.nx == 6) launch<3, 6>(args, stream);
  else return cudaErrorInvalidValue;
  return cudaSuccess;
}
