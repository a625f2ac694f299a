// The interior-point Riccati QP solve of ONE batch element, run by one
// thread: the body of K1 (qp_kernel.cu), shared with K3 (rti_kernel.cuh),
// which calls it on the QP its own linearization wrote.
//
// Replaces mpc_planner_tpu/ops/pallas_qp.py::_ip_solve (:198-550); see
// qp_kernel.cu for what it computes and how the data is laid out. `In`
// reads the QP's data: CLane (read-only cache) where the data is constant
// for the whole launch (K1), PLane (plain loads) where the same launch
// rewrites it between solves (K3).
#pragma once

#include "common.cuh"
#include "kernels.h"

namespace mpc {

constexpr float kSMin = 1e-7f;
constexpr float kWMax = 1e7f;
constexpr float kMuFreeze = 1e-9f;

template <int NU>
__device__ __forceinline__ void sym_inv(const float (&M)[NU][NU], float (&out)[NU][NU]) {
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

// Strided view of one element's entries in a batch-innermost array.
struct Lane {
  float* p;
  int B;
  __device__ __forceinline__ float& operator[](int i) const { return p[static_cast<size_t>(i) * B]; }
};
struct CLane {
  const float* p;
  int B;
  __device__ __forceinline__ float operator[](int i) const { return __ldg(p + static_cast<size_t>(i) * B); }
};
struct PLane {
  const float* p;
  int B;
  __device__ __forceinline__ float operator[](int i) const { return p[static_cast<size_t>(i) * B]; }
};

// Scratch floats per element that ip_solve carves from QPLaunch::scratch.
inline int64_t ip_scratch_floats(int N, int nu, int nx, int nh) {
  const int64_t nv = nu + nx, nr = nv + nh;
  return 7 * (N + 1) * nr + 3 * (N + 1) * nv
         + static_cast<int64_t>(N) * (nx + nu * nu + 2 * nu * nx + nx * nx + nu);
}

// One element's solve: reads a's QP at column b of every batch-innermost
// array, writes its dz, duals and final mu (a.dz, a.lam_l, a.lam_u, a.mu).
template <int NU, int NX, class In>
__device__ __forceinline__ void ip_solve(const QPLaunch& a, const int b) {
  constexpr int NV = NU + NX;
  const int B = a.B, N = a.N, nh = a.nh, NR = NV + nh, NHD = nh > 0 ? nh : 1;
  const int R1 = (N + 1) * NR;

  const In H{a.H + b, B}, g{a.g + b, B}, A{a.A + b, B}, Bm{a.Bm + b, B}, c{a.c + b, B};
  const In Dh{a.Dh + b, B}, lb{a.lb + b, B}, ub{a.ub + b, B};
  const Lane zeta{a.dz + b, B}, lam_l{a.lam_l + b, B}, lam_u{a.lam_u + b, B};

  // Scratch, same layout rule (see ip_scratch_floats for the sizes).
  float* s = a.scratch + b;
  auto take = [&](int n) { Lane l{s, B}; s += static_cast<size_t>(n) * B; return l; };
  const Lane s_l = take(R1), s_u = take(R1), w = take(R1), e = take(R1), ecar = take(R1),
             rcl = take(R1), rcu = take(R1);
  const Lane dzt = take((N + 1) * NV), gb = take((N + 1) * NV), gst = take((N + 1) * NV);
  const Lane req = take(N * NX), Rinv_s = take(N * NU * NU), K_s = take(N * NU * NX),
             Sh_s = take(N * NU * NX), Pn_s = take(N * NX * NX), kff_s = take(N * NU);

  // ---- init --------------------------------------------------------------
  float nact = 0.0f;
  const bool ok = a.use_warm && a.wok[b] > 0.0f;
  for (int i = 0; i < R1; ++i) {
    const float l = lb[i], u = ub[i];
    const float ml = l > -1e14f ? 1.0f : 0.0f, mm = u < 1e14f ? 1.0f : 0.0f;
    nact += ml + mm;
    const float sl = ml > 0.0f ? max_nan(-l, 1e-2f) : 1.0f;
    const float su = mm > 0.0f ? max_nan(u, 1e-2f) : 1.0f;
    s_l[i] = sl;
    s_u[i] = su;
    float ll = ml > 0.0f ? a.mu0 / sl : 0.0f;
    float lu = mm > 0.0f ? a.mu0 / su : 0.0f;
    if (ok) {
      ll = ml > 0.0f ? clip_nan(a.wl[static_cast<size_t>(i) * B + b], 1e-8f, kWMax) : 0.0f;
      lu = mm > 0.0f ? clip_nan(a.wu[static_cast<size_t>(i) * B + b], 1e-8f, kWMax) : 0.0f;
    }
    lam_l[i] = ll;
    lam_u[i] = lu;
    ecar[i] = 0.0f;
  }
  for (int i = 0; i < (N + 1) * NV; ++i) zeta[i] = 0.0f;
  const float n_active = max_nan(nact, 1.0f);

  auto mask_l = [&](int i) { return lb[i] > -1e14f ? 1.0f : 0.0f; };
  auto mask_u = [&](int i) { return ub[i] < 1e14f ? 1.0f : 0.0f; };
  auto complementarity = [&]() {
    float sum_l = 0.0f, sum_u = 0.0f;
    for (int i = 0; i < R1; ++i) {
      sum_l += s_l[i] * lam_l[i] * mask_l(i);
      sum_u += s_u[i] * lam_u[i] * mask_u(i);
    }
    return (sum_l + sum_u) / n_active;
  };

  // H-bar_k = H_k + diag(w_k[:nvar]) + Dh_k' diag(w_k[nvar:]) Dh_k
  auto hbar = [&](int k, float (&Hb)[NV][NV]) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < NV; ++j)
        Hb[i][j] = H[(k * NV + i) * NV + j] + (i == j ? w[k * NR + i] : 0.0f);
    for (int r = 0; r < nh; ++r) {
      const float wr = w[k * NR + NV + r];
      float d[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) d[j] = Dh[(k * NHD + r) * NV + j];
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int j = 0; j < NV; ++j) Hb[i][j] += d[i] * d[j] * wr;
    }
  };

  // Slack residuals vs the carried e = D zeta, and the Newton directions
  // of row i for complementarity targets (rc_l, rc_u) and D dz = e[i].
  struct Dir { float ds_l, ds_u, dl_l, dl_u; };
  auto direction = [&](int i, float rc_l, float rc_u) {
    const float ml = mask_l(i), mm = mask_u(i);
    const float rho_l = (ecar[i] - lb[i] - s_l[i]) * ml;
    const float rho_u = (ub[i] - ecar[i] - s_u[i]) * mm;
    Dir d;
    d.ds_l = (e[i] + rho_l) * ml;
    d.ds_u = (rho_u - e[i]) * mm;
    d.dl_l = ((rc_l - lam_l[i] * d.ds_l) / s_l[i]) * ml;
    d.dl_u = ((rc_u - lam_u[i] * d.ds_u) / s_u[i]) * mm;
    return d;
  };

  // Newton direction for the targets in rcl/rcu: fills dzt (dz) and e (D dz).
  auto coef = [&](int i) {  // gradient weight of row i in g-bar
    const float ml = mask_l(i), mm = mask_u(i);
    const float rho_l = (ecar[i] - lb[i] - s_l[i]) * ml;
    const float rho_u = (ub[i] - ecar[i] - s_u[i]) * mm;
    return -ml * lam_l[i] + mm * lam_u[i]
           - ml * (rcl[i] - lam_l[i] * rho_l) / s_l[i]
           + mm * (rcu[i] - lam_u[i] * rho_u) / s_u[i];
  };
  auto linear_solve = [&]() {
    for (int k = 0; k <= N; ++k) {
      float gk[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) gk[j] = gst[k * NV + j] + coef(k * NR + j);
      for (int r = 0; r < nh; ++r) {
        const float cr = coef(k * NR + NV + r);
#pragma unroll
        for (int j = 0; j < NV; ++j) gk[j] += Dh[(k * NHD + r) * NV + j] * cr;
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) gb[k * NV + j] = gk[j];
    }

    // backward substitution
    float p[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) p[i] = gb[N * NV + NU + i];
    for (int k = N - 1; k >= 0; --k) {
      float pc[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float acc = p[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += Pn_s[(k * NX + i) * NX + j] * req[k * NX + j];
        pc[i] = acc;
      }
      float r_hat[NU], kff[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float acc = gb[k * NV + i];
#pragma unroll
        for (int l = 0; l < NX; ++l) acc += Bm[(k * NX + l) * NU + i] * pc[l];
        r_hat[i] = acc;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NU; ++j) acc += Rinv_s[(k * NU + i) * NU + j] * r_hat[j];
        kff[i] = -acc;
        kff_s[k * NU + i] = kff[i];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float acc = gb[k * NV + NU + i];
#pragma unroll
        for (int l = 0; l < NX; ++l) acc += A[(k * NX + l) * NX + i] * pc[l];
#pragma unroll
        for (int l = 0; l < NU; ++l) acc += Sh_s[(k * NU + l) * NX + i] * kff[l];
        p[i] = acc;
      }
    }

    // forward rollout from dx_0 = 0, with D dz per stage
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
          for (int j = 0; j < NX; ++j) acc += K_s[(k * NU + i) * NX + j] * dx[j];
          dz[i] = acc + kff_s[k * NU + i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < NU; ++i) dz[i] = 0.0f;  // terminal inputs pinned
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) dz[NU + i] = dx[i];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        dzt[k * NV + j] = dz[j];
        e[k * NR + j] = dz[j];
      }
      for (int r = 0; r < nh; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NV; ++j) acc += Dh[(k * NHD + r) * NV + j] * dz[j];
        e[k * NR + NV + r] = acc;
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
          nx_[i] = acc + req[k * NX + i];
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) dx[i] = nx_[i];
      }
    }
  };

  // ---- IP iterations -----------------------------------------------------
  for (int it = 0; it < a.iterations; ++it) {
    const float mu = complementarity();
    const bool converged = mu < kMuFreeze;

    for (int i = 0; i < R1; ++i)
      w[i] = clip_nan(mask_l(i) * lam_l[i] / s_l[i] + mask_u(i) * lam_u[i] / s_u[i], 0.0f, kWMax);

    // Riccati factorization (backward)
    float P[NX][NX];
    {
      float Hb[NV][NV];
      hbar(N, Hb);
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) P[i][j] = Hb[NU + i][NU + j];
    }
    for (int k = N - 1; k >= 0; --k) {
      float Hb[NV][NV];
      hbar(k, Hb);
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
          R_hat[i][j] = Hb[i][j] + acc + (i == j ? a.reg : 0.0f);
        }
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int l = 0; l < NX; ++l) acc += Bm[(k * NX + l) * NU + i] * PA[l][j];
          S_hat[i][j] = Hb[i][NU + j] + acc;
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
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) Pn_s[(k * NX + i) * NX + j] = P[i][j];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NU; ++j) Rinv_s[(k * NU + i) * NU + j] = Ri[i][j];
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          K_s[(k * NU + i) * NX + j] = K[i][j];
          Sh_s[(k * NU + i) * NX + j] = S_hat[i][j];
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
          Pnew[i][j] = Hb[NU + i][NU + j] + acc + acc2;
        }
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) P[i][j] = 0.5f * (Pnew[i][j] + Pnew[j][i]);
    }

    // equality residual and gradient at the current iterate
    for (int k = 0; k < N; ++k) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += A[(k * NX + i) * NX + j] * zeta[k * NV + NU + j];
        float acc2 = 0.0f;
#pragma unroll
        for (int j = 0; j < NU; ++j) acc2 += Bm[(k * NX + i) * NU + j] * zeta[k * NV + j];
        req[k * NX + i] = acc + acc2 + c[k * NX + i] - zeta[(k + 1) * NV + NU + i];
      }
    }
    for (int k = 0; k <= N; ++k) {
      float z[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) z[j] = zeta[k * NV + j];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NV; ++j) acc += H[(k * NV + i) * NV + j] * z[j];
        gst[k * NV + i] = g[k * NV + i] + acc;
      }
    }

    if (a.mehrotra) {
      // predictor: affine targets
      for (int i = 0; i < R1; ++i) {
        rcl[i] = (-s_l[i] * lam_l[i]) * mask_l(i);
        rcu[i] = (-s_u[i] * lam_u[i]) * mask_u(i);
      }
      linear_solve();
      float apa = 1.0f, ada = 1.0f;
      for (int i = 0; i < R1; ++i) {
        const Dir d = direction(i, rcl[i], rcu[i]);
        const float ml = mask_l(i), mm = mask_u(i);
        if (d.ds_l < 0.0f && ml > 0.0f) apa = runmin(apa, -s_l[i] / (d.ds_l - 1e-30f));
        if (d.ds_u < 0.0f && mm > 0.0f) apa = runmin(apa, -s_u[i] / (d.ds_u - 1e-30f));
        if (d.dl_l < 0.0f && ml > 0.0f) ada = runmin(ada, -lam_l[i] / (d.dl_l - 1e-30f));
        if (d.dl_u < 0.0f && mm > 0.0f) ada = runmin(ada, -lam_u[i] / (d.dl_u - 1e-30f));
      }
      apa = clip_nan(apa, 0.0f, 1.0f);
      ada = clip_nan(ada, 0.0f, 1.0f);
      float aff_l = 0.0f, aff_u = 0.0f;
      for (int i = 0; i < R1; ++i) {
        const Dir d = direction(i, rcl[i], rcu[i]);
        aff_l += (s_l[i] + apa * d.ds_l) * (lam_l[i] + ada * d.dl_l) * mask_l(i);
        aff_u += (s_u[i] + apa * d.ds_u) * (lam_u[i] + ada * d.dl_u) * mask_u(i);
      }
      const float ratio = ((aff_l + aff_u) / n_active) / (mu + 1e-30f);
      const float smu = clip_nan(ratio * ratio * ratio, 0.0f, 1.0f) * mu;
      // corrector targets: centering + second-order correction
      for (int i = 0; i < R1; ++i) {
        const Dir d = direction(i, rcl[i], rcu[i]);
        rcl[i] = (smu - s_l[i] * lam_l[i] - d.ds_l * d.dl_l) * mask_l(i);
        rcu[i] = (smu - s_u[i] * lam_u[i] - d.ds_u * d.dl_u) * mask_u(i);
      }
    } else {
      const float smu = a.sigma_fixed * mu;
      for (int i = 0; i < R1; ++i) {
        rcl[i] = (smu - s_l[i] * lam_l[i]) * mask_l(i);
        rcu[i] = (smu - s_u[i] * lam_u[i]) * mask_u(i);
      }
    }
    linear_solve();

    // step sizes and the freeze guard
    float a_p = 1.0f, a_d = 1.0f;
    bool finite_step = true;
    for (int i = 0; i < R1; ++i) {
      const Dir d = direction(i, rcl[i], rcu[i]);
      const float ml = mask_l(i), mm = mask_u(i);
      if (d.ds_l < 0.0f && ml > 0.0f) a_p = runmin(a_p, -a.tau * s_l[i] / (d.ds_l - 1e-30f));
      if (d.ds_u < 0.0f && mm > 0.0f) a_p = runmin(a_p, -a.tau * s_u[i] / (d.ds_u - 1e-30f));
      if (d.dl_l < 0.0f && ml > 0.0f) a_d = runmin(a_d, -a.tau * lam_l[i] / (d.dl_l - 1e-30f));
      if (d.dl_u < 0.0f && mm > 0.0f) a_d = runmin(a_d, -a.tau * lam_u[i] / (d.dl_u - 1e-30f));
      finite_step = finite_step && isfinite(d.dl_l) && isfinite(d.dl_u);
    }
    for (int i = 0; i < (N + 1) * NV; ++i) finite_step = finite_step && isfinite(dzt[i]);
    a_p = clip_nan(a_p, 0.0f, 1.0f);
    a_d = clip_nan(a_d, 0.0f, 1.0f);
    const bool bad = converged || mu > 1e6f || !isfinite(mu);
    if (bad || !finite_step) continue;  // frozen: keep the old iterate

    for (int i = 0; i < (N + 1) * NV; ++i) zeta[i] = zeta[i] + a_p * dzt[i];
    for (int i = 0; i < R1; ++i) {
      const Dir d = direction(i, rcl[i], rcu[i]);  // reads the old iterate
      ecar[i] = ecar[i] + a_p * e[i];
      s_l[i] = mask_l(i) > 0.0f ? max_nan(s_l[i] + a_p * d.ds_l, kSMin) : 1.0f;
      s_u[i] = mask_u(i) > 0.0f ? max_nan(s_u[i] + a_p * d.ds_u, kSMin) : 1.0f;
      lam_l[i] = mask_l(i) > 0.0f ? clip_nan(lam_l[i] + a_d * d.dl_l, 0.0f, kWMax) : 0.0f;
      lam_u[i] = mask_u(i) > 0.0f ? clip_nan(lam_u[i] + a_d * d.dl_u, 0.0f, kWMax) : 0.0f;
    }
  }
  a.mu[b] = complementarity();
}

}  // namespace mpc
