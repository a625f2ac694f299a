// The interior-point Riccati QP solve of ONE batch element by a team of
// lanes (one warp on the card): the body of K1 (qp_kernel.cu), shared with
// K3 (rti_kernel.cuh), which calls it on the QP its own linearization wrote.
//
// Replaces mpc_planner_tpu/ops/pallas_qp.py::_ip_solve (:198-550); see
// qp_kernel.cu for what it computes.
//
// What bounds it on this card: neither bytes nor operations (a QP is ~40 KB
// and a few MFLOP) but the length of the chain of dependent operations of one
// element. Most of that chain is not serial by nature: about ten passes per
// IP iteration over the (N+1)*nrows constraint rows, every row independent
// of the others, and the per-stage assembly of H-bar, of the gradient and
// of D dz, every stage independent of the others. Only the Riccati
// recursion and its two substitutions must walk the horizon in order. So:
//   * row passes stride over the team's lanes (lane l takes rows l,
//     l + 32, ...); their sums and minima are butterfly reductions that
//     keep runmin's NaN rule, and the freeze decision is taken on reduced,
//     team-uniform values, so the whole team skips an update together;
//   * H-bar (its upper triangle, 28 entries a stage at nvar = 7), the
//     equality residual, the gradients and D dz are flattened over
//     (stage, entry) and strided over the lanes in the same way;
//   * the recursion itself runs redundantly on every lane out of shared
//     memory (one stream of operations, broadcast loads, lane 0 stores): it
//     costs what one lane would, needs no exchange between lanes, and its
//     small matrices stay in registers;
//   * the iterate (slacks, carried D zeta, targets, step), the stage
//     vectors, H-bar and the Riccati factors live in shared memory
//     (IPShared; 24.8 KB at N = 20, nrows = 31); the duals are iterated in
//     place wherever the caller put them, each row always by the same
//     lane; the QP's read-only data is read through the pointers of
//     IPElement: global memory (through L1/L2) for a large batch, shared
//     memory where the launcher staged it for a small one (qp_kernel.cu).
// All arrays are element-major: a lane's neighbours hold the neighbouring
// rows of the same element, so every pass reads consecutive floats.
//
// `In` reads the QP's data: ReadOnlyView (the read-only cache) where it is
// global data that is constant for the whole launch (K1, not staged),
// PlainView (plain loads) where it lies in shared memory or the same launch
// rewrites it between solves (K3). The code also builds
// with a host compiler, where the team is one lane (common.cuh): that is
// how the CPU tests run this very body against the plain solve_qp.
#pragma once

#include "common.cuh"
#include "qp_launch.h"

namespace mpc {

constexpr float kSMin = 1e-7f;
constexpr float kWMax = 1e7f;
constexpr float kMuFreeze = 1e-9f;

// Inverse of a symmetric matrix in closed form; reads the upper triangle.
template <int NU>
MPC_DEV void sym_inv(const float (&M)[NU][NU], float (&out)[NU][NU]) {
  if constexpr (NU == 1) {
    out[0][0] = 1.0f / M[0][0];
  } else if constexpr (NU == 2) {
    const float a = M[0][0], b = M[0][1], d = M[1][1];
    const float inv_det = 1.0f / (a * d - b * b);
    out[0][0] = d * inv_det;
    out[0][1] = -b * inv_det;
    out[1][0] = -b * inv_det;
    out[1][1] = a * inv_det;
  } else {
    static_assert(NU == 3, "closed-form inverse for nu <= 3");
    const float a = M[0][0], b = M[0][1], c = M[0][2];
    const float d = M[1][1], e = M[1][2], f = M[2][2];
    const float A = d * f - e * e, Bc = c * e - b * f, C = b * e - c * d;
    const float inv_det = 1.0f / (a * A + b * Bc + c * C);
    const float D = a * f - c * c, E = b * c - a * e, F = a * d - b * b;
    out[0][0] = A * inv_det;  out[0][1] = Bc * inv_det; out[0][2] = C * inv_det;
    out[1][0] = Bc * inv_det; out[1][1] = D * inv_det;  out[1][2] = E * inv_det;
    out[2][0] = C * inv_det;  out[2][1] = E * inv_det;  out[2][2] = F * inv_det;
  }
}

struct ReadOnlyView {
  const float* p;
  MPC_DEV float operator[](int i) const { return load_readonly(p + i); }
};
struct PlainView {
  const float* p;
  MPC_DEV float operator[](int i) const { return p[i]; }
};

// Index of entry (i, j) of a symmetric n x n matrix in its upper triangle,
// packed row by row.
MPC_HD constexpr int tri(int n, int i, int j) {
  return i <= j ? i * n - i * (i - 1) / 2 + (j - i) : j * n - j * (j - 1) / 2 + (i - j);
}

// Floats of one element's working set (IPShared), and of its QP data
// (H, g, A, Bm, c, Dh, lb, ub) plus its two dual arrays.
MPC_HD long long ip_shared_floats(int nu, int nx, int N, int nh) {
  const long long nv = nu + nx, rows = static_cast<long long>(N + 1) * (nv + nh);
  return 6 * rows + (N + 1) * (4 * nv + nv * (nv + 1) / 2)
         + static_cast<long long>(N) * (nx + nx * nx + 2 * nu * nx + nu * nu + nu);
}
MPC_HD long long qp_and_dual_floats(int nu, int nx, int N, int nh) {
  const long long nv = nu + nx, rows = static_cast<long long>(N + 1) * (nv + nh);
  return (N + 1) * (nv * nv + nv + (nh > 0 ? nh : 1) * nv) + 2 * rows
         + static_cast<long long>(N) * (nx * nx + nx * nu + nx) + 2 * rows;
}

// One element's working set in shared memory, carved from one float array
// of ip_shared_floats(NU, NX, N, nh) floats.
template <int NU, int NX>
struct IPShared {
  static constexpr int NV = NU + NX, NS = NV * (NV + 1) / 2;
  // per row [(N+1)*nrows]: slacks, the carried D zeta, D dz of the current
  // direction (before that: the barrier weights w, then the gradient
  // weights of the rows; each is consumed before the next is written), and
  // the complementarity targets
  float *s_l, *s_u, *ecar, *e, *rcl, *rcu;
  float *zeta, *dzt, *gb, *gst;  // [(N+1)*NV]: iterate, step, g-bar, stationarity gradient
  float* req;                    // [N*NX] equality residual
  float* Hb;                     // [(N+1)*NS] H-bar, upper triangles
  float *Pn, *K, *Sh, *Rinv, *kff;  // Riccati factors per stage

  static MPC_HD long long floats(int N, int nh) { return ip_shared_floats(NU, NX, N, nh); }
  MPC_HD IPShared(float* s, int N, int nh) {
    const int R1 = (N + 1) * (NV + nh), NZ = (N + 1) * NV;
    auto take = [&](int n) { float* p = s; s += n; return p; };
    s_l = take(R1); s_u = take(R1); ecar = take(R1); e = take(R1); rcl = take(R1); rcu = take(R1);
    zeta = take(NZ); dzt = take(NZ); gb = take(NZ); gst = take(NZ);
    req = take(N * NX);
    Hb = take((N + 1) * NS);
    Pn = take(N * NX * NX); K = take(N * NU * NX); Sh = take(N * NU * NX);
    Rinv = take(N * NU * NU); kff = take(N * NU);
  }
};

// One element's QP: every pointer at the element's first entry.
// H [N+1, NV, NV], g [N+1, NV], A [N, NX, NX], Bm [N, NX, NU], c [N, NX],
// Dh [N+1, max(nh, 1), NV] (the general rows; the box rows are the identity),
// lb/ub [N+1, NV + nh] with inactive rows at -/+1e15. lam_l/lam_u
// [N+1, NV + nh] are the duals, iterated in place; wl/wu are read where
// `warm` (they may be lam_l/lam_u themselves: each row is read before it
// is written, by the same lane).
struct IPElement {
  const float *H, *g, *A, *Bm, *c, *Dh, *lb, *ub, *wl, *wu;
  float *lam_l, *lam_u;
  int N, nh, iterations;
  bool warm, mehrotra;
  float mu0, reg, tau, sigma_fixed;
};

// Element b of a K1 launch (qp_launch.h).
template <int NU, int NX>
MPC_HD IPElement qp_element(const QPLaunch& a, const long long b) {
  constexpr int NV = NU + NX;
  const int N = a.N, NHD = a.nh > 0 ? a.nh : 1;
  const long long R1 = static_cast<long long>(N + 1) * (NV + a.nh), NZ = static_cast<long long>(N + 1) * NV;
  IPElement q;
  q.H = a.H + b * NZ * NV;
  q.g = a.g + b * NZ;
  q.A = a.A + b * N * NX * NX;
  q.Bm = a.Bm + b * N * NX * NU;
  q.c = a.c + b * N * NX;
  q.Dh = a.Dh + b * (N + 1) * NHD * NV;
  q.lb = a.lb + b * R1;
  q.ub = a.ub + b * R1;
  q.warm = a.use_warm && a.wok[b] > 0.0f;
  q.wl = a.use_warm ? a.wl + b * R1 : nullptr;
  q.wu = a.use_warm ? a.wu + b * R1 : nullptr;
  q.lam_l = a.lam_l + b * R1;
  q.lam_u = a.lam_u + b * R1;
  q.N = N;
  q.nh = a.nh;
  q.iterations = a.iterations;
  q.mehrotra = a.mehrotra != 0;
  q.mu0 = a.mu0;
  q.reg = a.reg;
  q.tau = a.tau;
  q.sigma_fixed = a.sigma_fixed;
  return q;
}

// Solves q with the team; leaves dz in m.zeta and the duals in
// q.lam_l/q.lam_u, and returns the final complementarity mu (the same
// value on every lane). Ends with a team_sync.
template <int NU, int NX, class In>
MPC_DEV float ip_solve(const IPElement& q, const IPShared<NU, NX>& m) {
  constexpr int NV = NU + NX, NS = NV * (NV + 1) / 2;
  const int N = q.N, nh = q.nh, NR = NV + nh, NHD = nh > 0 ? nh : 1;
  const int R1 = (N + 1) * NR, NZ = (N + 1) * NV;
  const int lane = team_lane();
  const bool writer = lane == 0;  // of what the serial parts store

  const In H{q.H}, g{q.g}, A{q.A}, Bm{q.Bm}, c{q.c}, Dh{q.Dh}, lb{q.lb}, ub{q.ub};
  float* const lam_l = q.lam_l;
  float* const lam_u = q.lam_u;

  // ---- init --------------------------------------------------------------
  float nact = 0.0f;
  for (int i = lane; i < R1; i += kLanes) {
    const float l = lb[i], u = ub[i];
    const float ml = l > -1e14f ? 1.0f : 0.0f, mm = u < 1e14f ? 1.0f : 0.0f;
    nact += ml + mm;
    const float sl = ml > 0.0f ? max_nan(-l, 1e-2f) : 1.0f;
    const float su = mm > 0.0f ? max_nan(u, 1e-2f) : 1.0f;
    m.s_l[i] = sl;
    m.s_u[i] = su;
    float ll = ml > 0.0f ? q.mu0 / sl : 0.0f;
    float lu = mm > 0.0f ? q.mu0 / su : 0.0f;
    if (q.warm) {
      ll = ml > 0.0f ? clip_nan(q.wl[i], 1e-8f, kWMax) : 0.0f;
      lu = mm > 0.0f ? clip_nan(q.wu[i], 1e-8f, kWMax) : 0.0f;
    }
    lam_l[i] = ll;
    lam_u[i] = lu;
    m.ecar[i] = 0.0f;
  }
  for (int i = lane; i < NZ; i += kLanes) m.zeta[i] = 0.0f;
  const float n_active = max_nan(team_sum(nact), 1.0f);
  team_sync();

  // One row's state, loaded once per pass.
  struct Row { float l, u, ml, mm, sl, su, ll, lu, ec; };
  auto row = [&](int i) {
    Row r;
    r.l = lb[i];
    r.u = ub[i];
    r.ml = r.l > -1e14f ? 1.0f : 0.0f;
    r.mm = r.u < 1e14f ? 1.0f : 0.0f;
    r.sl = m.s_l[i];
    r.su = m.s_u[i];
    r.ll = lam_l[i];
    r.lu = lam_u[i];
    r.ec = m.ecar[i];
    return r;
  };
  auto complementarity = [&]() {
    float sum_l = 0.0f, sum_u = 0.0f;
    for (int i = lane; i < R1; i += kLanes) {
      const float ml = lb[i] > -1e14f ? 1.0f : 0.0f, mm = ub[i] < 1e14f ? 1.0f : 0.0f;
      sum_l += m.s_l[i] * lam_l[i] * ml;
      sum_u += m.s_u[i] * lam_u[i] * mm;
    }
    return (team_sum(sum_l) + team_sum(sum_u)) / n_active;
  };

  // Slack residuals vs the carried e = D zeta, and the Newton directions
  // of a row for complementarity targets (rc_l, rc_u) and D dz = e.
  struct Dir { float ds_l, ds_u, dl_l, dl_u; };
  auto direction = [](const Row& r, float e, float rc_l, float rc_u) {
    const float rho_l = (r.ec - r.l - r.sl) * r.ml;
    const float rho_u = (r.u - r.ec - r.su) * r.mm;
    Dir d;
    d.ds_l = (e + rho_l) * r.ml;
    d.ds_u = (rho_u - e) * r.mm;
    d.dl_l = ((rc_l - r.ll * d.ds_l) / r.sl) * r.ml;
    d.dl_u = ((rc_u - r.lu * d.ds_u) / r.su) * r.mm;
    return d;
  };

  // Newton direction for the targets in rcl/rcu: fills dzt (dz) and e (D dz).
  auto linear_solve = [&]() {
    // gradient weight of every row in g-bar, parked in e
    for (int i = lane; i < R1; i += kLanes) {
      const Row r = row(i);
      const float rho_l = (r.ec - r.l - r.sl) * r.ml;
      const float rho_u = (r.u - r.ec - r.su) * r.mm;
      m.e[i] = -r.ml * r.ll + r.mm * r.lu - r.ml * (m.rcl[i] - r.ll * rho_l) / r.sl
               + r.mm * (m.rcu[i] - r.lu * rho_u) / r.su;
    }
    team_sync();
    for (int t = lane; t < NZ; t += kLanes) {
      const int k = t / NV, j = t - k * NV;
      float acc = m.gst[t] + m.e[k * NR + j];
      for (int r = 0; r < nh; ++r) acc += Dh[(k * NHD + r) * NV + j] * m.e[k * NR + NV + r];
      m.gb[t] = acc;
    }
    team_sync();

    // backward substitution (serial over the stages, the same on every lane)
    float p[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) p[i] = m.gb[N * NV + NU + i];
    for (int k = N - 1; k >= 0; --k) {
      float pc[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float acc = p[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += m.Pn[(k * NX + i) * NX + j] * m.req[k * NX + j];
        pc[i] = acc;
      }
      float r_hat[NU], kff[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float acc = m.gb[k * NV + i];
#pragma unroll
        for (int l = 0; l < NX; ++l) acc += Bm[(k * NX + l) * NU + i] * pc[l];
        r_hat[i] = acc;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NU; ++j) acc += m.Rinv[(k * NU + i) * NU + j] * r_hat[j];
        kff[i] = -acc;
        if (writer) m.kff[k * NU + i] = kff[i];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float acc = m.gb[k * NV + NU + i];
#pragma unroll
        for (int l = 0; l < NX; ++l) acc += A[(k * NX + l) * NX + i] * pc[l];
#pragma unroll
        for (int l = 0; l < NU; ++l) acc += m.Sh[(k * NU + l) * NX + i] * kff[l];
        p[i] = acc;
      }
    }
    team_sync();

    // forward rollout from dx_0 = 0
    float dx[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[i] = 0.0f;
    for (int k = 0; k <= N; ++k) {
      float dz[NV];
      if (k < N) {
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < NX; ++j) acc += m.K[(k * NU + i) * NX + j] * dx[j];
          dz[i] = acc + m.kff[k * NU + i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < NU; ++i) dz[i] = 0.0f;  // terminal inputs pinned
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) dz[NU + i] = dx[i];
      if (writer) {
#pragma unroll
        for (int j = 0; j < NV; ++j) m.dzt[k * NV + j] = dz[j];
      }
      if (k < N) {
        float nx_[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < NX; ++j) acc += A[(k * NX + i) * NX + j] * dx[j];
#pragma unroll
          for (int j = 0; j < NU; ++j) acc += Bm[(k * NX + i) * NU + j] * dz[j];
          nx_[i] = acc + m.req[k * NX + i];
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) dx[i] = nx_[i];
      }
    }
    team_sync();

    // e = D dz: the box rows are dz itself, the general rows Dh dz
    for (int i = lane; i < R1; i += kLanes) {
      const int k = i / NR, r = i - k * NR;
      float acc;
      if (r < NV) {
        acc = m.dzt[k * NV + r];
      } else {
        acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NV; ++j) acc += Dh[(k * NHD + r - NV) * NV + j] * m.dzt[k * NV + j];
      }
      m.e[i] = acc;
    }
    team_sync();
  };

  // ---- IP iterations -----------------------------------------------------
  for (int it = 0; it < q.iterations; ++it) {
    const float mu = complementarity();
    const bool converged = mu < kMuFreeze;

    // barrier weights of the rows, parked in e (free until linear_solve)
    float* const w = m.e;
    for (int i = lane; i < R1; i += kLanes) {
      const float ml = lb[i] > -1e14f ? 1.0f : 0.0f, mm = ub[i] < 1e14f ? 1.0f : 0.0f;
      w[i] = clip_nan(ml * lam_l[i] / m.s_l[i] + mm * lam_u[i] / m.s_u[i], 0.0f, kWMax);
    }
    team_sync();

    // H-bar_k = H_k + diag(w_k[:nvar]) + Dh_k' diag(w_k[nvar:]) Dh_k, upper
    // triangle, one (stage, entry) per lane and round
    for (int t = lane; t < (N + 1) * NS; t += kLanes) {
      const int k = t / NS;
      int j = t - k * NS, i = 0;
      while (j >= NV - i) {
        j -= NV - i;
        ++i;
      }
      j += i;
      float acc = H[(k * NV + i) * NV + j] + (i == j ? w[k * NR + i] : 0.0f);
      for (int r = 0; r < nh; ++r)
        acc += Dh[(k * NHD + r) * NV + i] * Dh[(k * NHD + r) * NV + j] * w[k * NR + NV + r];
      m.Hb[t] = acc;
    }
    // equality residual and gradient at the current iterate
    for (int t = lane; t < N * NX; t += kLanes) {
      const int k = t / NX, i = t - k * NX;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += A[(k * NX + i) * NX + j] * m.zeta[k * NV + NU + j];
      float acc2 = 0.0f;
#pragma unroll
      for (int j = 0; j < NU; ++j) acc2 += Bm[(k * NX + i) * NU + j] * m.zeta[k * NV + j];
      m.req[t] = acc + acc2 + c[t] - m.zeta[(k + 1) * NV + NU + i];
    }
    for (int t = lane; t < NZ; t += kLanes) {
      const int k = t / NV;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NV; ++j) acc += H[t * NV + j] * m.zeta[k * NV + j];
      m.gst[t] = g[t] + acc;
    }
    team_sync();

    // Riccati factorization (backward; serial, the same on every lane)
    {
      float P[NX][NX];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) P[i][j] = m.Hb[N * NS + tri(NV, NU + i, NU + j)];
      for (int k = N - 1; k >= 0; --k) {
        const float* Hk = m.Hb + k * NS;
        float PA[NX][NX], PB[NX][NU];
#pragma unroll
        for (int i = 0; i < NX; ++i) {
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            float acc = 0.0f;
#pragma unroll
            for (int l = 0; l < NX; ++l) acc += P[i][l] * A[(k * NX + l) * NX + j];
            PA[i][j] = acc;
          }
#pragma unroll
          for (int j = 0; j < NU; ++j) {
            float acc = 0.0f;
#pragma unroll
            for (int l = 0; l < NX; ++l) acc += P[i][l] * Bm[(k * NX + l) * NU + j];
            PB[i][j] = acc;
          }
        }
        float R_hat[NU][NU], S_hat[NU][NX], Ri[NU][NU], K[NU][NX];
#pragma unroll
        for (int i = 0; i < NU; ++i) {
#pragma unroll
          for (int j = 0; j < NU; ++j) {
            float acc = 0.0f;
#pragma unroll
            for (int l = 0; l < NX; ++l) acc += Bm[(k * NX + l) * NU + i] * PB[l][j];
            R_hat[i][j] = Hk[tri(NV, i, j)] + acc + (i == j ? q.reg : 0.0f);
          }
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            float acc = 0.0f;
#pragma unroll
            for (int l = 0; l < NX; ++l) acc += Bm[(k * NX + l) * NU + i] * PA[l][j];
            S_hat[i][j] = Hk[tri(NV, i, NU + j)] + acc;
          }
        }
        sym_inv<NU>(R_hat, Ri);
#pragma unroll
        for (int i = 0; i < NU; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            float acc = 0.0f;
#pragma unroll
            for (int l = 0; l < NU; ++l) acc += Ri[i][l] * S_hat[l][j];
            K[i][j] = -acc;
          }
        if (writer) {
#pragma unroll
          for (int i = 0; i < NX; ++i)
#pragma unroll
            for (int j = 0; j < NX; ++j) m.Pn[(k * NX + i) * NX + j] = P[i][j];
#pragma unroll
          for (int i = 0; i < NU; ++i) {
#pragma unroll
            for (int j = 0; j < NU; ++j) m.Rinv[(k * NU + i) * NU + j] = Ri[i][j];
#pragma unroll
            for (int j = 0; j < NX; ++j) {
              m.K[(k * NU + i) * NX + j] = K[i][j];
              m.Sh[(k * NU + i) * NX + j] = S_hat[i][j];
            }
          }
        }
        float Pnew[NX][NX];
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            float acc = 0.0f;
#pragma unroll
            for (int l = 0; l < NX; ++l) acc += A[(k * NX + l) * NX + i] * PA[l][j];
            float acc2 = 0.0f;
#pragma unroll
            for (int l = 0; l < NU; ++l) acc2 += S_hat[l][i] * K[l][j];
            Pnew[i][j] = Hk[tri(NV, NU + i, NU + j)] + acc + acc2;
          }
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) P[i][j] = 0.5f * (Pnew[i][j] + Pnew[j][i]);
      }
    }
    team_sync();

    if (q.mehrotra) {
      // predictor: affine targets
      for (int i = lane; i < R1; i += kLanes) {
        const float ml = lb[i] > -1e14f ? 1.0f : 0.0f, mm = ub[i] < 1e14f ? 1.0f : 0.0f;
        m.rcl[i] = (-m.s_l[i] * lam_l[i]) * ml;
        m.rcu[i] = (-m.s_u[i] * lam_u[i]) * mm;
      }
      linear_solve();
      float apa = 1.0f, ada = 1.0f;
      for (int i = lane; i < R1; i += kLanes) {
        const Row r = row(i);
        const Dir d = direction(r, m.e[i], m.rcl[i], m.rcu[i]);
        if (d.ds_l < 0.0f && r.ml > 0.0f) apa = runmin(apa, -r.sl / (d.ds_l - 1e-30f));
        if (d.ds_u < 0.0f && r.mm > 0.0f) apa = runmin(apa, -r.su / (d.ds_u - 1e-30f));
        if (d.dl_l < 0.0f && r.ml > 0.0f) ada = runmin(ada, -r.ll / (d.dl_l - 1e-30f));
        if (d.dl_u < 0.0f && r.mm > 0.0f) ada = runmin(ada, -r.lu / (d.dl_u - 1e-30f));
      }
      apa = clip_nan(team_runmin(apa), 0.0f, 1.0f);
      ada = clip_nan(team_runmin(ada), 0.0f, 1.0f);
      float aff_l = 0.0f, aff_u = 0.0f;
      for (int i = lane; i < R1; i += kLanes) {
        const Row r = row(i);
        const Dir d = direction(r, m.e[i], m.rcl[i], m.rcu[i]);
        aff_l += (r.sl + apa * d.ds_l) * (r.ll + ada * d.dl_l) * r.ml;
        aff_u += (r.su + apa * d.ds_u) * (r.lu + ada * d.dl_u) * r.mm;
      }
      const float ratio = ((team_sum(aff_l) + team_sum(aff_u)) / n_active) / (mu + 1e-30f);
      const float smu = clip_nan(ratio * ratio * ratio, 0.0f, 1.0f) * mu;
      // corrector targets: centering + second-order correction
      for (int i = lane; i < R1; i += kLanes) {
        const Row r = row(i);
        const Dir d = direction(r, m.e[i], m.rcl[i], m.rcu[i]);
        m.rcl[i] = (smu - r.sl * r.ll - d.ds_l * d.dl_l) * r.ml;
        m.rcu[i] = (smu - r.su * r.lu - d.ds_u * d.dl_u) * r.mm;
      }
    } else {
      const float smu = q.sigma_fixed * mu;
      for (int i = lane; i < R1; i += kLanes) {
        const float ml = lb[i] > -1e14f ? 1.0f : 0.0f, mm = ub[i] < 1e14f ? 1.0f : 0.0f;
        m.rcl[i] = (smu - m.s_l[i] * lam_l[i]) * ml;
        m.rcu[i] = (smu - m.s_u[i] * lam_u[i]) * mm;
      }
    }
    linear_solve();

    // step sizes and the freeze guard
    float a_p = 1.0f, a_d = 1.0f;
    bool finite_step = true;
    for (int i = lane; i < R1; i += kLanes) {
      const Row r = row(i);
      const Dir d = direction(r, m.e[i], m.rcl[i], m.rcu[i]);
      if (d.ds_l < 0.0f && r.ml > 0.0f) a_p = runmin(a_p, -q.tau * r.sl / (d.ds_l - 1e-30f));
      if (d.ds_u < 0.0f && r.mm > 0.0f) a_p = runmin(a_p, -q.tau * r.su / (d.ds_u - 1e-30f));
      if (d.dl_l < 0.0f && r.ml > 0.0f) a_d = runmin(a_d, -q.tau * r.ll / (d.dl_l - 1e-30f));
      if (d.dl_u < 0.0f && r.mm > 0.0f) a_d = runmin(a_d, -q.tau * r.lu / (d.dl_u - 1e-30f));
      finite_step = finite_step && is_finite(d.dl_l) && is_finite(d.dl_u);
    }
    for (int i = lane; i < NZ; i += kLanes) finite_step = finite_step && is_finite(m.dzt[i]);
    a_p = clip_nan(team_runmin(a_p), 0.0f, 1.0f);
    a_d = clip_nan(team_runmin(a_d), 0.0f, 1.0f);
    const bool bad = converged || mu > 1e6f || !is_finite(mu);
    // Reduced over the team first: every lane takes the same branch, so no
    // lane waits at a team_sync the others skipped.
    if (bad || !team_all(finite_step)) continue;  // frozen: keep the old iterate

    for (int i = lane; i < NZ; i += kLanes) m.zeta[i] = m.zeta[i] + a_p * m.dzt[i];
    for (int i = lane; i < R1; i += kLanes) {
      const Row r = row(i);  // the old iterate of this row, before it is overwritten
      const float e = m.e[i];
      const Dir d = direction(r, e, m.rcl[i], m.rcu[i]);
      m.ecar[i] = r.ec + a_p * e;
      m.s_l[i] = r.ml > 0.0f ? max_nan(r.sl + a_p * d.ds_l, kSMin) : 1.0f;
      m.s_u[i] = r.mm > 0.0f ? max_nan(r.su + a_p * d.ds_u, kSMin) : 1.0f;
      lam_l[i] = r.ml > 0.0f ? clip_nan(r.ll + a_d * d.dl_l, 0.0f, kWMax) : 0.0f;
      lam_u[i] = r.mm > 0.0f ? clip_nan(r.lu + a_d * d.dl_u, 0.0f, kWMax) : 0.0f;
    }
    team_sync();
  }
  const float mu = complementarity();
  team_sync();
  return mu;
}

}  // namespace mpc
