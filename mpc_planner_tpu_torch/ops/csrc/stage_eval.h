// Host-side entry of the derivative code generated for an OCP
// (ops/stage_codegen.py emits `mpc::Stages` and then includes this file):
// evaluates every stage function and its derivatives at n points, so a CPU
// test can hold the generated code against torch.func. Plain C++, no CUDA.
#pragma once

#include "dual.cuh"

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
