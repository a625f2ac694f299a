// K4: a probe of the backward Riccati factorization on Hopper (N stages,
// nu = 2, nx = 5, `sweeps` passes over the horizon with P carried), on
// synthetic stage data, in six thread mappings.
//
// Replaces the layout probes of experiments/riccati_ilp_probe.py (main :278,
// kernels _factor_chain :72-94, "single", "interleaved", "wide"/"packed").
// The TPU question was how to fill vector lanes and hide the recursion's
// latency; Hopper's is how many threads one element's recursion should
// use, and where its stage data should sit. K1 (qp_kernel.cu) gives each
// element a warp, spreads the row and stage passes over its lanes and keeps
// this recursion serial, redundant on every lane, out of shared memory
// (ip_solve.cuh). The answers timed here:
//   (a) one thread per element: K1's first mapping ("single");
//   (b) two elements per thread, their recursions interleaved in one loop
//       body: independent chains in one instruction stream ("interleaved",
//       the ILP hypothesis);
//   (c) eight lanes per element, row r of P on lane r, products across
//       rows by __shfl_sync ("wide"/"packed": more threads, shorter chain
//       per thread);
//   (d) one warp per element, the recursion run redundantly on all 32
//       lanes (one stream of operations, broadcast loads, lane 0 stores)
//       ("warp").
// (a)-(d) read every stage's data from global memory at every step. The
// two designed for the card stage an element's H, A and B (6.9 KB at N=20,
// 10.3 KB at N=30) into shared memory first, by asynchronous copies
// (cp.async, 4 bytes a copy: the element-innermost rows are 4-byte
// aligned only, which rules out cp.async.bulk and TMA, and a TMA box would
// keep the elements innermost in shared memory, where a warp reading one
// element's matrix hits 4 banks), completed by cp.async.wait_group and a
// block barrier; the 8 sweeps then read shared memory only. A block of 8
// warps stages 8 consecutive elements, so a warp's copy covers 4 rows x 8
// elements: every 32-byte sector it reads is whole, and the element-major
// rows in shared memory, padded to 4 mod 32 floats, take 32 distinct banks.
// 55 KB a block at N=20 and 82 KB at N=30 (team: + 3.2 KB of scratch):
// above 48 KB, so each launch sets cudaFuncAttributeMaxDynamicSharedMemorySize
// and fails if it is refused.
//   (e) "staged": (d) on the staged data, K1's own pattern (ip_solve.cuh's
//       factorization), the like-for-like baseline;
//   (f) "team": the step shared over the warp's lanes (riccati_step.cuh):
//       P A and P B, then R-hat, S-hat and A'PA, then the new P, one entry
//       a lane, a __syncwarp between the phases.
// Every step does what K1's factorization does: R-hat = H_uu + B'PB + 1e-7 I,
// its closed-form 2x2 inverse, K = -R-hat^-1 S-hat, P <- sym(H_xx + A'PA +
// S-hat'K). Arrays are batch-innermost: H [N+1, 7, 7, E], A [N, 5, 5, E],
// B [N, 5, 2, E] -> P [5, 5, E]. What bounds it: the dependent chain of
// sweeps x N steps per element, i.e. latency, not bytes or FLOPs (1,007
// FLOPs a step against 6.9 KB read once for 160 steps). Tensor cores do not
// apply: the rule is float32 with TF32 off (reduced precision breaks the
// Riccati's positive definiteness, mpc_planner_tpu/solver/sqp.py:421-425),
// and the 5x5 and 2x5 products are below the smallest mma tile.

#include <cuda_runtime.h>

#include "riccati_step.cuh"

namespace {

constexpr int NU = 2, NX = 5, NV = NU + NX;
constexpr int kThreads = 32;  // one warp per block, as K1
constexpr int kGroup = 8;     // lanes per element in mapping (c)
constexpr int kElems = 8;     // elements (warps) per block in mappings (e), (f)

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

// One backward step for element e at stage k: P <- step(P). `View` is
// Chain (global memory) or StagedView (one element's staged data).
template <class View>
__device__ __forceinline__ void step(const View& c, int k, int e, float (&P)[NX][NX]) {
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

template <class View>
__device__ __forceinline__ void load_terminal(const View& c, int e, float (&P)[NX][NX]) {
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

// (d) one warp (one block) per element; every lane runs the same recursion.
__global__ void __launch_bounds__(kThreads) warp_kernel(Chain c, float* out, int sweeps) {
  const int e = blockIdx.x;
  float P[NX][NX];
  load_terminal(c, e, P);
  for (int s = 0; s < sweeps; ++s)
    for (int k = c.N - 1; k >= 0; --k) step(c, k, e, P);
  if (threadIdx.x == 0) store(out, c.E, e, P);
}

// Floats from one element's staged data to the next: the data padded to
// 4 mod 32, so that the 32 lanes of a copy (8 elements x 4 rows) write 32
// distinct banks.
int staged_stride(int N) {
  const int f = mpc::riccati::stage_floats(N);
  return f + (36 - f % 32) % 32;
}

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Entries [0, per_stage * stages) of the element-innermost array X (stage
// after stage, each stage's matrix row-major), elements e0 .. e0 + 7, to
// smem[g * stride + staged offset] (thread t: element t % 8, entry t / 8;
// entry r is entry r % per_stage of stage r / per_stage, at `offset` in
// that stage's block).
__device__ __forceinline__ void copy_rows(const float* X, int per_stage, int stages, int offset,
                                          int E, int e0, float* smem, int stride) {
  using mpc::riccati::kStageFloats;
  for (int t = threadIdx.x; t < per_stage * stages * kElems; t += blockDim.x) {
    const int g = t % kElems, r = t / kElems;
    if (e0 + g < E)
      copy_async4(smem + g * stride + (r / per_stage) * kStageFloats + offset + r % per_stage,
                  X + static_cast<long long>(r) * E + e0 + g);
  }
}

// The block's 8 elements' stage data into shared memory, element-major in
// riccati_step.cuh's order, then wait for every copy of the block.
__device__ __forceinline__ void stage_block(const Chain& c, int e0, float* smem, int stride) {
  using namespace mpc::riccati;
  copy_rows(c.H, NV * NV, c.N + 1, 0, c.E, e0, smem, stride);
  copy_rows(c.A, NX * NX, c.N, kOffA, c.E, e0, smem, stride);
  copy_rows(c.B, NX * NU, c.N, kOffB, c.E, e0, smem, stride);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Chain's accessors on one element's staged data (the element index is
// ignored).
struct StagedView {
  const float* p;
  int N;
  __device__ __forceinline__ float h(int k, int i, int j, int) const {
    return p[mpc::riccati::staged_h(k, i * NV + j)];
  }
  __device__ __forceinline__ float a(int k, int i, int j, int) const {
    return p[mpc::riccati::staged_a(k, i * NX + j)];
  }
  __device__ __forceinline__ float b(int k, int i, int j, int) const {
    return p[mpc::riccati::staged_b(k, i * NU + j)];
  }
};

// (e) one warp per element on its staged data, the recursion redundant on
// every lane. A warp past E returns after the block's barrier, whole.
__global__ void __launch_bounds__(kElems * kThreads)
    staged_kernel(Chain c, float* out, int sweeps, int stride) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kThreads, e = blockIdx.x * kElems + warp;
  stage_block(c, blockIdx.x * kElems, smem, stride);
  if (e >= c.E) return;
  const StagedView v{smem + warp * stride, c.N};
  float P[NX][NX];
  load_terminal(v, e, P);
  for (int s = 0; s < sweeps; ++s)
    for (int k = c.N - 1; k >= 0; --k) step(v, k, e, P);
  if (threadIdx.x % kThreads == 0) store(out, c.E, e, P);
}

// (f) one warp per element on its staged data, each step shared over the
// lanes (riccati_step.cuh), the warp's scratch after the 8 elements' data.
__global__ void __launch_bounds__(kElems * kThreads)
    team_kernel(Chain c, float* out, int sweeps, int stride) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kThreads, e = blockIdx.x * kElems + warp;
  stage_block(c, blockIdx.x * kElems, smem, stride);
  if (e >= c.E) return;
  float* s = smem + kElems * stride + warp * mpc::riccati::kScratchFloats;
  mpc::riccati::team_chain(smem + warp * stride, c.N, sweeps, s);
  for (int i = mpc::team_lane(); i < NX * NX; i += kThreads)
    out[static_cast<long long>(i) * c.E + e] = s[mpc::riccati::kP + i];
}

// Latencies on one warp, in clock64 cycles for n of each, lane 0's clock:
// dependent float32 fused multiply-adds, dependent divisions 1 / x, lane
// exchanges through shared memory (a store, __syncwarp, the next lane's
// load: one phase boundary of the team step) and exchanges by shuffle.
// The empty asm statements pin each chain between its two clock reads.
__global__ void latency_kernel(float x, int n, long long* cycles, float* sink) {
  __shared__ float buf[2][kThreads];
  const int lane = threadIdx.x, next = (lane + 1) % kThreads;
  float a = x, b = x, c = x + lane, d = x + lane;
  const long long t0 = clock64();
  asm volatile("" : "+f"(a)::"memory");
  for (int i = 0; i < n; ++i) a = fmaf(a, 0.999f, 1e-3f);
  asm volatile("" : "+f"(a)::"memory");
  const long long t1 = clock64();
  asm volatile("" : "+f"(b)::"memory");
  for (int i = 0; i < n; ++i) b = 1.0f / b;
  asm volatile("" : "+f"(b)::"memory");
  const long long t2 = clock64();
  asm volatile("" : "+f"(c)::"memory");
  for (int i = 0; i < n; ++i) {  // two buffers: a store never overtakes a load of the round before
    buf[i & 1][lane] = c;
    __syncwarp();
    c = buf[i & 1][next];
  }
  asm volatile("" : "+f"(c)::"memory");
  const long long t3 = clock64();
  asm volatile("" : "+f"(d)::"memory");
  for (int i = 0; i < n; ++i) d = __shfl_sync(0xffffffffu, d, next);
  asm volatile("" : "+f"(d)::"memory");
  const long long t4 = clock64();
  if (lane == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = t2 - t1;
    cycles[2] = t3 - t2;
    cycles[3] = t4 - t3;
  }
  sink[lane] = a + b + c + d;
}

}  // namespace

// mapping 0: one thread per element, 1: two interleaved per thread,
// 2: eight lanes per element, 3: one warp per element, 4: one warp per
// element on staged data, 5: the same with the step shared over the lanes.
// Returns cudaGetLastError() (or the refusal of the shared-memory size) as
// an int.
extern "C" int riccati_probe_launch(int mapping, const float* H, const float* A, const float* B,
                                    float* P, int E, int N, int sweeps, void* stream) {
  if (E == 0) return 0;
  const Chain c{H, A, B, E, N};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mapping == 4 || mapping == 5) {
    const int stride = staged_stride(N);
    const int bytes = static_cast<int>(sizeof(float))
                      * (kElems * stride + (mapping == 5 ? kElems * mpc::riccati::kScratchFloats : 0));
    const cudaError_t err =
        mapping == 4
            ? cudaFuncSetAttribute(staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
            : cudaFuncSetAttribute(team_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left behind for the next launch's check
      return static_cast<int>(err);
    }
    const int blocks = (E + kElems - 1) / kElems;
    if (mapping == 4) staged_kernel<<<blocks, kElems * kThreads, bytes, st>>>(c, P, sweeps, stride);
    else team_kernel<<<blocks, kElems * kThreads, bytes, st>>>(c, P, sweeps, stride);
    return static_cast<int>(cudaGetLastError());
  }
  const long long threads = mapping == 0   ? E
                            : mapping == 1 ? (E + 1) / 2
                            : mapping == 2 ? static_cast<long long>(E) * kGroup
                                           : static_cast<long long>(E) * kThreads;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  if (mapping == 0) single_kernel<<<blocks, kThreads, 0, st>>>(c, P, sweeps);
  else if (mapping == 1) interleaved_kernel<<<blocks, kThreads, 0, st>>>(c, P, sweeps);
  else if (mapping == 2) lanes_kernel<<<blocks, kThreads, 0, st>>>(c, P, sweeps);
  else if (mapping == 3) warp_kernel<<<blocks, kThreads, 0, st>>>(c, P, sweeps);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// latency_kernel's four counts (cycles[0..3]) for n of each; synchronizes.
// Returns a cudaError_t as an int.
extern "C" int riccati_probe_latency(int n, long long* cycles) {
  long long* d_cycles = nullptr;
  float* d_sink = nullptr;
  cudaError_t err = cudaMalloc(&d_cycles, 4 * sizeof(long long));
  if (err == cudaSuccess) err = cudaMalloc(&d_sink, kThreads * sizeof(float));
  if (err == cudaSuccess) {
    latency_kernel<<<1, kThreads>>>(1.5f, n, d_cycles, d_sink);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) err = cudaMemcpy(cycles, d_cycles, 4 * sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(d_cycles);
  cudaFree(d_sink);
  return static_cast<int>(err);
}
