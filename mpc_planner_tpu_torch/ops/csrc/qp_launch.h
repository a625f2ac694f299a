// The arguments of K1 (qp_kernel.cu), shared with its host build
// (qp_host.cpp): plain C++, no CUDA types.
#pragma once

// K1: fixed-count interior-point Riccati QP solve, one warp per batch
// element. Every array is element-major ([B, ...], contiguous):
//   H [B, N+1, nvar, nvar], g [B, N+1, nvar], A [B, N, nx, nx],
//   Bm [B, N, nx, nu], c [B, N, nx], Dh [B, N+1, max(nh,1), nvar],
//   lb/ub [B, N+1, nrows] with inactive rows folded to -/+1e15,
//   wl/wu [B, N+1, nrows] and wok [B] (read only when use_warm),
//   outputs dz [B, N+1, nvar], lam_l/lam_u [B, N+1, nrows], mu [B].
// The working set of an element lives in dynamic shared memory
// (qp_shared_bytes); no global scratch. Where the whole batch is resident
// on the card even so (qp_resident_blocks), the launcher also stages the
// element's QP data and duals there.
struct QPLaunch {
  const float *H, *g, *A, *Bm, *c, *Dh, *lb, *ub, *wl, *wu, *wok;
  float *dz, *lam_l, *lam_u, *mu;
  int B, N, nu, nx, nh, iterations;
  float mu0, reg, tau, sigma_fixed;
  int use_warm, mehrotra;
};
