// One step of the backward Riccati factorization of K4 (riccati_probe.cu),
// shared over the lanes of a team (common.cuh: a warp under nvcc, one lane
// under a host compiler, so riccati_host.cpp runs this very body on the CPU).
//
// The step, as in K1 (ip_solve.cuh) and the TPU probe's `_factor_chain`
// (experiments/riccati_ilp_probe.py:72-94), nu = 2, nx = 5:
//   R-hat = H_uu + B'PB + 1e-7 I,  S-hat = H_ux + B'PA,
//   K = -R-hat^-1 S-hat (closed-form 2x2 inverse),
//   P <- sym(H_xx + A'PA + S-hat'K).
// Three phases over kSlots = 32 slots (one a lane on the card; one lane
// walks them all on the host), a team_sync() after each, the team's state
// in `s` (kScratchFloats, shared memory on the card):
//   1. slots 0-24: (P A)[i][j]; 25-29: row r of P B (two entries);
//   2. slots 0-24: (A'PA)[i][j]; 25-29: column r of S-hat (two entries);
//      30-31: row c of R-hat (two entries);
//   3. slots 0-24: the new P's entry (i, j): every such lane forms the 2x2
//      inverse itself (one division, no broadcast round), the columns i and
//      j of K, and 0.5 (Pn_ij + Pn_ji), so the symmetrization needs no
//      fourth phase.
// Every slot of a phase runs the same instructions (two dot products of 5
// terms, operands at offsets and strides fixed per slot by slot_plan before
// the first step; idle slots store to kSink): one round a phase, and no
// branch diverges. Phase 1 reads P, phase 3 writes it; the sync after phase 1
// orders the two. The longest dependency path of a step
// (riccati_probe.py::CHAIN_OPS counts it): 5 (P B) + 7 (R-hat) + 2 (the
// determinant) + the division + 1 (the inverse) + 2 (K) + 2 (S'K) + 1 + 2
// (the new P) dependent f32 operations.
//
// The stage data of one element is one block of floats in the order the
// kernels stage it: stage k's H_k [7][7], A_k [5][5], B_k [5][2]
// (kStageFloats) for k < N, then H_N.
#pragma once

#include "common.cuh"

namespace mpc {
namespace riccati {

constexpr int NU = 2, NX = 5, NV = NU + NX;
constexpr int kOffA = NV * NV, kOffB = kOffA + NX * NX, kStageFloats = kOffB + NX * NU;

// Floats of one element's stage data.
MPC_HD int stage_floats(int N) { return N * kStageFloats + NV * NV; }

// Where entry r of stage k's H, A or B lies in the staged data (r counts
// the entries of the stage's matrix, row-major).
MPC_HD int staged_h(int k, int r) { return k * kStageFloats + r; }
MPC_HD int staged_a(int k, int r) { return k * kStageFloats + kOffA + r; }
MPC_HD int staged_b(int k, int r) { return k * kStageFloats + kOffB + r; }

// Offsets in a team's scratch; kSink takes the stores of slots with
// nothing to store, so that every slot runs the same instructions.
constexpr int kP = 0, kPA = kP + NX * NX, kPB = kPA + NX * NX, kR = kPB + NX * NU,
              kS = kR + NU * NU, kAPA = kS + NU * NX, kSink = kAPA + NX * NX,
              kScratchFloats = kSink + 1;
constexpr int kSlots = 32;

// What one slot computes, as offsets into a stage block `st` and the
// scratch `s`:
//   phase 1: s[o1a] = sum_l s[x1 + l] st[y1a + l ys1], and b alike;
//   phase 2: s[o2a] = (hm2 st[h2a] + sum_l st[x2a + l xs2] s[y2a + l ys2])
//            + reg2a, and b alike without reg (hm2 = 1 where the entry has
//            an H term, 0 for A'PA: exact either way);
//   phase 3: the new P's entry (i, j) into s[o3] (i = j = 0 and o3 = kSink
//            on the idle slots).
struct Slot {
  int x1, y1a, y1b, ys1, o1a, o1b;
  int x2a, x2b, xs2, y2a, y2b, ys2, h2a, h2b, o2a, o2b;
  float hm2, reg2a;
  int i, j, o3;
};

MPC_HD Slot slot_plan(int q) {
  Slot p{kP, kOffA, kOffA, NX, kSink, kSink,                           // phase 1: idle
         kOffA, kOffA, NX, kPA, kPA, NX, 0, 0, kSink, kSink, 0.0f, 0.0f,  // phase 2: idle
         0, 0, kSink};                                                  // phase 3: idle
  if (q < NX * NX) {  // (P A)[i][j], (A'PA)[i][j], the new P[i][j]
    const int i = q / NX, j = q % NX;
    p.x1 = kP + i * NX, p.y1a = p.y1b = kOffA + j, p.o1a = kPA + q;
    p.x2a = p.x2b = kOffA + i, p.y2a = p.y2b = kPA + j, p.o2a = kAPA + q;
    p.i = i, p.j = j, p.o3 = kP + q;
  } else if (q < NX * NX + NX) {  // row r of P B; column r of S-hat
    const int r = q - NX * NX;
    p.x1 = kP + r * NX, p.y1a = kOffB, p.y1b = kOffB + 1, p.ys1 = NU;
    p.o1a = kPB + r * NU, p.o1b = kPB + r * NU + 1;
    p.x2a = kOffB, p.x2b = kOffB + 1, p.xs2 = NU, p.y2a = p.y2b = kPA + r;
    p.h2a = NU + r, p.h2b = NV + NU + r, p.o2a = kS + r, p.o2b = kS + NX + r, p.hm2 = 1.0f;
  } else if (q < NX * NX + NX + NU) {  // row c of R-hat: R[c][c] (+ reg), R[c][1 - c]
    const int c = q - NX * NX - NX;
    p.x2a = p.x2b = kOffB + c, p.xs2 = NU, p.y2a = kPB + c, p.y2b = kPB + 1 - c, p.ys2 = NU;
    p.h2a = c * NV + c, p.h2b = c * NV + 1 - c, p.o2a = kR + c * NU + c, p.o2b = kR + c * NU + 1 - c;
    p.hm2 = 1.0f, p.reg2a = 1e-7f;
  }
  return p;
}

constexpr int kSlotsPerLane = kSlots / kLanes;

MPC_DEV void team_step(const float* st, float* s, const Slot (&mine)[kSlotsPerLane]) {
#pragma unroll
  for (int q = 0; q < kSlotsPerLane; ++q) {
    const Slot& p = mine[q];
    float a = s[p.x1] * st[p.y1a], b = s[p.x1] * st[p.y1b];
#pragma unroll
    for (int l = 1; l < NX; ++l) {
      a += s[p.x1 + l] * st[p.y1a + l * p.ys1];
      b += s[p.x1 + l] * st[p.y1b + l * p.ys1];
    }
    s[p.o1a] = a;
    s[p.o1b] = b;
  }
  team_sync();
#pragma unroll
  for (int q = 0; q < kSlotsPerLane; ++q) {
    const Slot& p = mine[q];
    const float ha = p.hm2 * st[p.h2a], hb = p.hm2 * st[p.h2b];
    float a = st[p.x2a] * s[p.y2a], b = st[p.x2b] * s[p.y2b];
#pragma unroll
    for (int l = 1; l < NX; ++l) {
      a += st[p.x2a + l * p.xs2] * s[p.y2a + l * p.ys2];
      b += st[p.x2b + l * p.xs2] * s[p.y2b + l * p.ys2];
    }
    s[p.o2a] = (ha + a) + p.reg2a;
    s[p.o2b] = hb + b;
  }
  team_sync();
#pragma unroll
  for (int q = 0; q < kSlotsPerLane; ++q) {
    const Slot& p = mine[q];
    const int i = p.i, j = p.j;
    // every operand first: none waits behind the division
    const float r00 = s[kR], r01 = s[kR + 1], r11 = s[kR + 3];
    const float s0i = s[kS + i], s1i = s[kS + NX + i], s0j = s[kS + j], s1j = s[kS + NX + j];
    const float hij = st[(NU + i) * NV + NU + j] + s[kAPA + i * NX + j];
    const float hji = st[(NU + j) * NV + NU + i] + s[kAPA + j * NX + i];
    const float inv_det = 1.0f / (r00 * r11 - r01 * r01);
    const float i00 = r11 * inv_det, i01 = -r01 * inv_det, i11 = r00 * inv_det;
    const float k0j = -(i00 * s0j + i01 * s1j), k1j = -(i01 * s0j + i11 * s1j);
    const float k0i = -(i00 * s0i + i01 * s1i), k1i = -(i01 * s0i + i11 * s1i);
    s[p.o3] = 0.5f * ((hij + (s0i * k0j + s1i * k1j)) + (hji + (s0j * k0i + s1j * k1i)));
  }
  team_sync();
}

// `sweeps` backward passes over one element's staged data (`staged`, N
// stages), P starting from H_xx of the terminal stage and carried; P ends
// in s[kP .. kP + 25).
MPC_DEV void team_chain(const float* staged, int N, int sweeps, float* s) {
  Slot mine[kSlotsPerLane];
#pragma unroll
  for (int q = 0; q < kSlotsPerLane; ++q) mine[q] = slot_plan(team_lane() + q * kLanes);
  const float* Hn = staged + staged_h(N, 0);
  for (int w = team_lane(); w < NX * NX; w += kLanes) s[kP + w] = Hn[(NU + w / NX) * NV + NU + w % NX];
  team_sync();
  for (int sweep = 0; sweep < sweeps; ++sweep)
    for (int k = N - 1; k >= 0; --k) team_step(staged + staged_h(k, 0), s, mine);
}

}  // namespace riccati
}  // namespace mpc
