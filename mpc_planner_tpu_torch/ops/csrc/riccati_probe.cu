// K4: a probe of the backward Riccati factorization on Hopper (N stages,
// nu = 2, nx = 5, `sweeps` passes over the horizon with P carried), on
// synthetic stage data, in three thread mappings.
//
// Replaces the layout probes of experiments/riccati_ilp_probe.py (main :278,
// kernels _factor_chain :72-94, "single", "interleaved", "wide"/"packed").
// The TPU question was how to fill vector lanes and hide the recursion's
// latency; Hopper's is how many threads one element's recursion should
// use. K1 (qp_kernel.cu) runs one thread per element, which leaves 32
// one-warp blocks for 132 SMs at B=1024. The three answers timed here:
//   (a) one thread per element: K1's mapping ("single");
//   (b) two elements per thread, their recursions interleaved in one loop
//       body: independent chains in one instruction stream ("interleaved",
//       the ILP hypothesis);
//   (c) eight lanes per element, row r of P on lane r, products across
//       rows by __shfl_sync ("wide"/"packed": more threads, shorter chain
//       per thread).
// Every step does what K1's factorization does: R-hat = H_uu + B'PB + 1e-7 I,
// its closed-form 2x2 inverse, K = -R-hat^-1 S-hat, P <- sym(H_xx + A'PA +
// S-hat'K). Arrays are batch-innermost: H [N+1, 7, 7, E], A [N, 5, 5, E],
// B [N, 5, 2, E] -> P [5, 5, E]. What bounds it: the dependent chain of
// sweeps x N steps per element, i.e. latency, not bytes or FLOPs.

#include <cuda_runtime.h>

namespace {

constexpr int NU = 2, NX = 5, NV = NU + NX;
constexpr int kThreads = 32;  // one warp per block, as K1
constexpr int kGroup = 8;     // lanes per element in mapping (c)

struct Chain {
  const float *H, *A, *B;
  int E, N;
  __device__ __forceinline__ float h(int k, int i, int j, int e) const {
    return H[(static_cast<long long>(k * NV + i) * NV + j) * E + e];
  }
  __device__ __forceinline__ float a(int k, int i, int j, int e) const {
    return A[(static_cast<long long>(k * NX + i) * NX + j) * E + e];
  }
  __device__ __forceinline__ float b(int k, int i, int j, int e) const {
    return B[(static_cast<long long>(k * NX + i) * NU + j) * E + e];
  }
};

// One backward step for element e at stage k: P <- step(P).
__device__ __forceinline__ void step(const Chain& c, int k, int e, float (&P)[NX][NX]) {
  float Ak[NX][NX], Bk[NX][NU], PA[NX][NX], PB[NX][NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) Ak[i][j] = c.a(k, i, j, e);
#pragma unroll
    for (int j = 0; j < NU; ++j) Bk[i][j] = c.b(k, i, j, e);
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int l = 0; l < NX; ++l) acc += P[i][l] * Ak[l][j];
      PA[i][j] = acc;
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int l = 0; l < NX; ++l) acc += P[i][l] * Bk[l][j];
      PB[i][j] = acc;
    }
  }
  float R[NU][NU], S[NU][NX];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int l = 0; l < NX; ++l) acc += Bk[l][i] * PB[l][j];
      R[i][j] = c.h(k, i, j, e) + acc + (i == j ? 1e-7f : 0.0f);
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int l = 0; l < NX; ++l) acc += Bk[l][i] * PA[l][j];
      S[i][j] = c.h(k, i, NU + j, e) + acc;
    }
  }
  const float inv_det = 1.0f / (R[0][0] * R[1][1] - R[0][1] * R[0][1]);
  const float Ri[NU][NU] = {{R[1][1] * inv_det, -R[0][1] * inv_det},
                            {-R[0][1] * inv_det, R[0][0] * inv_det}};
  float K[NU][NX];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) K[i][j] = -(Ri[i][0] * S[0][j] + Ri[i][1] * S[1][j]);
  float Pn[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int l = 0; l < NX; ++l) acc += Ak[l][i] * PA[l][j];
      float acc2 = 0.0f;
#pragma unroll
      for (int l = 0; l < NU; ++l) acc2 += S[l][i] * K[l][j];
      Pn[i][j] = c.h(k, NU + i, NU + j, e) + acc + acc2;
    }
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) P[i][j] = 0.5f * (Pn[i][j] + Pn[j][i]);
}

__device__ __forceinline__ void load_terminal(const Chain& c, int e, float (&P)[NX][NX]) {
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) P[i][j] = c.h(c.N, NU + i, NU + j, e);
}

__device__ __forceinline__ void store(float* out, int E, int e, const float (&P)[NX][NX]) {
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) out[static_cast<long long>(i * NX + j) * E + e] = P[i][j];
}

// (a) one thread per element
__global__ void __launch_bounds__(kThreads) single_kernel(Chain c, float* out, int sweeps) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= c.E) return;
  float P[NX][NX];
  load_terminal(c, e, P);
  for (int s = 0; s < sweeps; ++s)
    for (int k = c.N - 1; k >= 0; --k) step(c, k, e, P);
  store(out, c.E, e, P);
}

// (b) elements e and e + half on one thread, advanced stage by stage in the
// same loop body (independent chains for the scheduler to interleave).
__global__ void __launch_bounds__(kThreads) interleaved_kernel(Chain c, float* out, int sweeps) {
  const int half = (c.E + 1) / 2;
  const int e0 = blockIdx.x * blockDim.x + threadIdx.x;
  if (e0 >= half) return;
  const int e1 = e0 + half < c.E ? e0 + half : e0;  // odd E: the last thread repeats e0
  float P0[NX][NX], P1[NX][NX];
  load_terminal(c, e0, P0);
  load_terminal(c, e1, P1);
  for (int s = 0; s < sweeps; ++s)
    for (int k = c.N - 1; k >= 0; --k) {
      step(c, k, e0, P0);
      step(c, k, e1, P1);
    }
  store(out, c.E, e0, P0);
  store(out, c.E, e1, P1);
}

// Entry j of a register row by a run-time index (a select chain, not
// local memory).
__device__ __forceinline__ float pick(const float (&v)[NX], int j) {
  float x = 0.0f;
#pragma unroll
  for (int i = 0; i < NX; ++i) x = (i == j) ? v[i] : x;
  return x;
}

// (c) kGroup lanes per element: lane r < NX holds row r of P; lanes NX..7
// hold zeros and only take part in the shuffles.
__global__ void __launch_bounds__(kThreads) lanes_kernel(Chain c, float* out, int sweeps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % 32, r = lane % kGroup, base = lane - r;
  const int e_raw = t / kGroup;
  const bool valid = e_raw < c.E;
  const int e = valid ? e_raw : c.E - 1;  // idle groups shadow the last element
  const bool row = r < NX;
  const unsigned full = 0xffffffffu;
  auto group_sum = [&](float v) {
#pragma unroll
    for (int off = kGroup / 2; off > 0; off /= 2) v += __shfl_xor_sync(full, v, off, kGroup);
    return v;
  };

  float p[NX];
#pragma unroll
  for (int j = 0; j < NX; ++j) p[j] = row ? c.h(c.N, NU + r, NU + j, e) : 0.0f;

  for (int s = 0; s < sweeps; ++s)
    for (int k = c.N - 1; k >= 0; --k) {
      float Ak[NX][NX], Bk[NX][NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) Ak[i][j] = c.a(k, i, j, e);
#pragma unroll
        for (int j = 0; j < NU; ++j) Bk[i][j] = c.b(k, i, j, e);
      }
      // row r of PA and PB
      float pa[NX], pb[NU];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int l = 0; l < NX; ++l) acc += p[l] * Ak[l][j];
        pa[j] = acc;
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int l = 0; l < NX; ++l) acc += p[l] * Bk[l][j];
        pb[j] = acc;
      }
      // R-hat and S-hat: sums over the rows of P, i.e. across the group
      float br0 = 0.0f, br1 = 0.0f;  // B[r][:], by selects (r is not a constant)
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        br0 = (i == r) ? Bk[i][0] : br0;
        br1 = (i == r) ? Bk[i][1] : br1;
      }
      float R[NU][NU], S[NU][NX];
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        R[0][j] = c.h(k, 0, j, e) + group_sum(br0 * pb[j]) + (j == 0 ? 1e-7f : 0.0f);
        R[1][j] = c.h(k, 1, j, e) + group_sum(br1 * pb[j]) + (j == 1 ? 1e-7f : 0.0f);
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        S[0][j] = c.h(k, 0, NU + j, e) + group_sum(br0 * pa[j]);
        S[1][j] = c.h(k, 1, NU + j, e) + group_sum(br1 * pa[j]);
      }
      const float inv_det = 1.0f / (R[0][0] * R[1][1] - R[0][1] * R[0][1]);
      const float Ri[NU][NU] = {{R[1][1] * inv_det, -R[0][1] * inv_det},
                                {-R[0][1] * inv_det, R[0][0] * inv_det}};
      // row r of Pn = H_xx + A'PA + S'K: A'PA gathers every row of PA
      float pn[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        const float K0 = -(Ri[0][0] * S[0][j] + Ri[0][1] * S[1][j]);
        const float K1 = -(Ri[1][0] * S[0][j] + Ri[1][1] * S[1][j]);
        const float sr0 = pick(S[0], r), sr1 = pick(S[1], r);
        pn[j] = (row ? c.h(k, NU + r, NU + j, e) : 0.0f) + sr0 * K0 + sr1 * K1;
      }
#pragma unroll
      for (int l = 0; l < NX; ++l) {
        const float alr = pick(Ak[l], r);  // 0 on lanes r >= NX
#pragma unroll
        for (int j = 0; j < NX; ++j) pn[j] += alr * __shfl_sync(full, pa[j], base + l);
      }
      // symmetrize: Pn[j][r] lives on lane j at entry r; in round d lane s
      // sends its entry (s - d) mod NX and lane r reads lane (r + d) mod NX
      float tr[NX] = {};
#pragma unroll
      for (int d = 0; d < NX; ++d) {
        const int send = (r - d + NX) % NX, from = (r + d) % NX;
        const float v = __shfl_sync(full, pick(pn, send), base + from);
#pragma unroll
        for (int j = 0; j < NX; ++j) tr[j] = (j == from) ? v : tr[j];
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) p[j] = row ? 0.5f * (pn[j] + tr[j]) : 0.0f;
    }

  if (valid && row) {
#pragma unroll
    for (int j = 0; j < NX; ++j) out[static_cast<long long>(r * NX + j) * c.E + e] = p[j];
  }
}

}  // namespace

// mapping 0: one thread per element, 1: two interleaved per thread,
// 2: eight lanes per element. Returns cudaGetLastError() as an int.
extern "C" int riccati_probe_launch(int mapping, const float* H, const float* A, const float* B,
                                    float* P, int E, int N, int sweeps, void* stream) {
  if (E == 0) return 0;
  const Chain c{H, A, B, E, N};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long threads = mapping == 0 ? E : mapping == 1 ? (E + 1) / 2 : static_cast<long long>(E) * kGroup;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  if (mapping == 0) single_kernel<<<blocks, kThreads, 0, st>>>(c, P, sweeps);
  else if (mapping == 1) interleaved_kernel<<<blocks, kThreads, 0, st>>>(c, P, sweeps);
  else if (mapping == 2) lanes_kernel<<<blocks, kThreads, 0, st>>>(c, P, sweeps);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
