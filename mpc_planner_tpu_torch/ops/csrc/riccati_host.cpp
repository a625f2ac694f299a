// Host build of K4's "team" mapping (riccati_probe.cu): riccati_step.cuh
// with a team of one lane (common.cuh), one element after another, its
// stage data gathered from the element-innermost arrays into one block in
// the order the kernel stages it. Plain C++, no CUDA: it lets a CPU test
// hold the very step the warp shares against the JAX probe.
#include <vector>

#include "riccati_step.cuh"

// H [N+1, 7, 7, E], A [N, 5, 5, E], B [N, 5, 2, E] -> P [5, 5, E].
extern "C" void riccati_team_host(const float* H, const float* A, const float* B, float* P, int E,
                                  int N, int sweeps) {
  using namespace mpc::riccati;
  std::vector<float> staged(stage_floats(N)), scratch(kScratchFloats);
  for (int e = 0; e < E; ++e) {
    for (int k = 0; k <= N; ++k)
      for (int r = 0; r < NV * NV; ++r)
        staged[staged_h(k, r)] = H[(static_cast<long long>(k) * NV * NV + r) * E + e];
    for (int k = 0; k < N; ++k) {
      for (int r = 0; r < NX * NX; ++r)
        staged[staged_a(k, r)] = A[(static_cast<long long>(k) * NX * NX + r) * E + e];
      for (int r = 0; r < NX * NU; ++r)
        staged[staged_b(k, r)] = B[(static_cast<long long>(k) * NX * NU + r) * E + e];
    }
    team_chain(staged.data(), N, sweeps, scratch.data());
    for (int i = 0; i < NX * NX; ++i) P[static_cast<long long>(i) * E + e] = scratch[kP + i];
  }
}
