// Host-side entry of the derivative code generated for an OCP
// (ops/stage_codegen.py emits `mpc::Stages` and then includes this file):
// evaluates every stage function and its derivatives at n points, so a CPU
// test can hold the generated code against torch.func; and runs K3's body
// (rti_kernel.cuh: linearization, MIRROR, IP solve, Z += dz) with a team of
// one lane, one element after another, so a CPU test can hold the very code
// the warp runs against the plain solve_rti_torch. Plain C++, no CUDA.
#pragma once

#include <vector>

#include "dual.cuh"
#include "rti_kernel.cuh"

namespace mpc {

template <int NV>
struct JacobianOut {  // row i: value and derivative over z
  float *val, *jac;
  void operator()(int i, const Dual<NV>& y) const {
    val[i] = y.v;
    for (int j = 0; j < NV; ++j) jac[i * NV + j] = y.d[j];
  }
};
template <int NV>
struct HessianOut {  // gradient and full symmetric Hessian of a scalar
  float *grad, *hess;
  void operator()(int, const Dual2<NV>& y) const {
    for (int i = 0; i < NV; ++i) {
      grad[i] = y.g[i];
      for (int j = 0; j < NV; ++j)
        hess[i * NV + j] = y.h[i <= j ? Dual2<NV>::hidx(i, j) : Dual2<NV>::hidx(j, i)];
    }
  }
};

}  // namespace mpc

// z [n, NV], p [n, NP] -> f [n, NX], Jf [n, NX, NV]; running cost g [n, NV],
// H [n, NV, NV]; terminal cost gT, HT (at z as given); h [n, NH],
// Jh [n, NH, NV].
extern "C" void mpc_stage_eval(int n, const float* z, const float* p, float* f, float* Jf,
                               float* g, float* H, float* gT, float* HT, float* h, float* Jh) {
  using S = mpc::Stages;
  constexpr int NV = S::NU + S::NX;
  for (int k = 0; k < n; ++k) {
    const float* zk = z + k * NV;
    const mpc::Strided pk{p + static_cast<long long>(k) * S::NP, 1};
    mpc::Dual<NV> z1[NV];
    mpc::Dual2<NV> z2[NV];
    for (int j = 0; j < NV; ++j) {
      z1[j] = mpc::Dual<NV>(zk[j]);
      z1[j].d[j] = 1.0f;
      z2[j] = mpc::Dual2<NV>(zk[j]);
      z2[j].g[j] = 1.0f;
    }
    S::dynamics(z1, pk, mpc::JacobianOut<NV>{f + k * S::NX, Jf + k * S::NX * NV});
    S::running_cost(z2, pk, mpc::HessianOut<NV>{g + k * NV, H + k * NV * NV});
    S::terminal_cost(z2, pk, mpc::HessianOut<NV>{gT + k * NV, HT + k * NV * NV});
    S::constraints(z1, pk, mpc::JacobianOut<NV>{h + k * S::NH, Jh + k * S::NH * NV});
  }
}

// K3's solve on the host: the arguments of mpc_rti_solve (rti_kernel.cuh)
// without the stream, and whether the QP is staged in the shared-memory
// block (as the launcher does for a small batch) or goes through scratch;
// both blocks are local.
extern "C" void mpc_rti_solve_host(const float* Z0, const float* P, const float* lbT,
                                   const float* ubT, const float* wl, const float* wu,
                                   const float* wok, float* Z, float* lam_l, float* lam_u,
                                   float* mu, int B, int N, int num_rti, int it0, int warm_iters,
                                   int use_warm, int mehrotra, int mirror_x_only, float mu0,
                                   float reg, float tau, float sigma_fixed, float lm, int staged) {
  using S = mpc::Stages;
  std::vector<float> scratch(mpc::rti_scratch_floats<S>(N) * B);
  std::vector<float> shared(mpc::rti_shared_floats<S>(N, staged != 0));
  const mpc::RTILaunch a{Z0,    P,     lbT,     ubT,        wl,       wu,       wok,
                         Z,     lam_l, lam_u,   mu,         scratch.data(), B,  N,
                         num_rti, it0, warm_iters, use_warm, mehrotra, mirror_x_only,
                         mu0,   reg,   tau,     sigma_fixed, lm};
  for (int b = 0; b < B; ++b) mpc::rti_element<S>(a, b, shared.data(), staged != 0);
}

// K3's linearization alone on the host, into element-major arrays.
extern "C" void mpc_rti_linearize_host(const float* Z, const float* P, const float* lbT,
                                       const float* ubT, float* H, float* g, float* A, float* Bm,
                                       float* c, float* Dh, float* lb, float* ub, int B, int N,
                                       int mirror_x_only, float lm) {
  const mpc::QPArrays all{H, g, A, Bm, c, Dh, lb, ub};
  for (int b = 0; b < B; ++b)
    mpc::linearize_element<mpc::Stages>(Z, P, lbT, ubT, all, N, lm, mirror_x_only, b);
}
