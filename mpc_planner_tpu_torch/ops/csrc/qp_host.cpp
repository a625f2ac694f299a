// Host build of K1's body: ip_solve.cuh with a team of one lane
// (common.cuh), one element after another, its shared-memory working set in
// a heap buffer. Same arguments and element-major layout as the kernel
// (qp_launch.h). Plain C++, no CUDA: it lets a CPU test hold the very code
// the warp runs against the plain torch solve_qp.
#include <vector>

#include "ip_solve.cuh"

namespace {

template <int NU, int NX>
void solve(const QPLaunch& a) {
  std::vector<float> shared(mpc::ip_shared_floats(NU, NX, a.N, a.nh));
  const long long NZ = static_cast<long long>(a.N + 1) * (NU + NX);
  for (long long b = 0; b < a.B; ++b) {
    const mpc::IPShared<NU, NX> m(shared.data(), a.N, a.nh);
    a.mu[b] = mpc::ip_solve<NU, NX, mpc::PlainView>(mpc::qp_element<NU, NX>(a, b), m);
    for (long long i = 0; i < NZ; ++i) a.dz[b * NZ + i] = m.zeta[i];
  }
}

}  // namespace

// Returns 0, or 1 for an (nu, nx) pair without an instantiation.
extern "C" int mpc_qp_solve_host(const QPLaunch* a) {
  if (a->nu == 2 && a->nx == 4) solve<2, 4>(*a);
  else if (a->nu == 2 && a->nx == 5) solve<2, 5>(*a);
  else if (a->nu == 3 && a->nx == 5) solve<3, 5>(*a);
  else if (a->nu == 3 && a->nx == 6) solve<3, 6>(*a);
  else return 1;
  return 0;
}
