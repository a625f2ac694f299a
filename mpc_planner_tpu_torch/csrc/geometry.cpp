// Native geometry kernels for the per-cycle host hot path.
//
// TPU-native equivalent of the reference's C++ runtime geometry: the
// ros_tools Spline2D fit + closest-point search (consumed at
// contouring.cpp:28-48), the Douglas-Rachford collision projection
// (linearized_constraints.cpp:130-148), and the decomp_util-style
// free-space polytope construction (decomp_constraints.cpp:62-118).
// Exposed as a C ABI consumed through ctypes (mpc_planner_tpu/native).
//
// Everything operates on plain double arrays; no dependencies beyond the
// C++17 standard library.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <map>
#include <vector>

extern "C" {

// Natural cubic spline through (t_i, y_i), i = 0..n-1.
// coeffs_out: (n-1) rows of (a, b, c, d) with
//   y(s) = a u^3 + b u^2 + c u + d, u = s - t_i.
// Returns 0 on success.
int fit_natural_cubic(const double* t, const double* y, int64_t n,
                      double* coeffs_out) {
  if (n < 2) return 1;
  if (n == 2) {
    double h = t[1] - t[0];
    if (h <= 0) return 2;
    coeffs_out[0] = 0.0;
    coeffs_out[1] = 0.0;
    coeffs_out[2] = (y[1] - y[0]) / h;
    coeffs_out[3] = y[0];
    return 0;
  }
  std::vector<double> h(n - 1);
  for (int64_t i = 0; i + 1 < n; ++i) {
    h[i] = t[i + 1] - t[i];
    if (h[i] <= 0) return 2;
  }
  // Tridiagonal solve for interior second derivatives (Thomas algorithm)
  int64_t m = n - 2;
  std::vector<double> diag(m), rhs(m), upper(m);
  for (int64_t i = 0; i < m; ++i) {
    diag[i] = 2.0 * (h[i] + h[i + 1]);
    rhs[i] = 6.0 * ((y[i + 2] - y[i + 1]) / h[i + 1] - (y[i + 1] - y[i]) / h[i]);
    upper[i] = h[i + 1];
  }
  for (int64_t i = 1; i < m; ++i) {
    double w = h[i] / diag[i - 1];
    diag[i] -= w * upper[i - 1];
    rhs[i] -= w * rhs[i - 1];
  }
  std::vector<double> M(n, 0.0);
  M[m] = rhs[m - 1] / diag[m - 1];
  for (int64_t i = m - 2; i >= 0; --i)
    M[i + 1] = (rhs[i] - upper[i] * M[i + 2]) / diag[i];

  for (int64_t i = 0; i + 1 < n; ++i) {
    double* c = coeffs_out + 4 * i;
    c[0] = (M[i + 1] - M[i]) / (6.0 * h[i]);
    c[1] = M[i] / 2.0;
    c[2] = (y[i + 1] - y[i]) / h[i] - h[i] * (2.0 * M[i] + M[i + 1]) / 6.0;
    c[3] = y[i];
  }
  return 0;
}

static inline int64_t find_segment(const double* knots, int64_t n_seg, double s) {
  // knots has n_seg + 1 entries; return segment index clamped.
  int64_t lo = 0, hi = n_seg;  // search in knots[0..n_seg]
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (knots[mid] <= s)
      lo = mid + 1;
    else
      hi = mid;
  }
  int64_t idx = lo - 1;
  if (idx < 0) idx = 0;
  if (idx >= n_seg) idx = n_seg - 1;
  return idx;
}

static inline void eval_spline(const double* coeffs, const double* knots,
                               int64_t n_seg, double s, double* v, double* dv,
                               double* ddv) {
  int64_t i = find_segment(knots, n_seg, s);
  const double* c = coeffs + 4 * i;
  double u = s - knots[i];
  *v = ((c[0] * u + c[1]) * u + c[2]) * u + c[3];
  *dv = (3.0 * c[0] * u + 2.0 * c[1]) * u + c[2];
  *ddv = 6.0 * c[0] * u + 2.0 * c[1];
}

// Closest point on a 2D path spline (coeffs_x/coeffs_y over shared knots).
// Coarse sampling over [lo, hi] followed by Newton refinement
// (ros_tools Spline2D::findClosestPoint equivalent).
double closest_point(const double* coeffs_x, const double* coeffs_y,
                     const double* knots, int64_t n_seg, double px, double py,
                     double lo, double hi, int64_t samples) {
  if (samples < 2) samples = 2;
  double best_s = lo, best_d = 1e300;
  for (int64_t i = 0; i < samples; ++i) {
    double s = lo + (hi - lo) * (double)i / (double)(samples - 1);
    double x, y, dx_, dy_, ddx_, ddy_;
    eval_spline(coeffs_x, knots, n_seg, s, &x, &dx_, &ddx_);
    eval_spline(coeffs_y, knots, n_seg, s, &y, &dy_, &ddy_);
    double d = (x - px) * (x - px) + (y - py) * (y - py);
    if (d < best_d) {
      best_d = d;
      best_s = s;
    }
  }
  double s = best_s;
  double s_min = knots[0], s_max = knots[n_seg];
  for (int it = 0; it < 10; ++it) {
    double x, y, dx, dy, ddx, ddy;
    eval_spline(coeffs_x, knots, n_seg, s, &x, &dx, &ddx);
    eval_spline(coeffs_y, knots, n_seg, s, &y, &dy, &ddy);
    double ex = x - px, ey = y - py;
    double g = 2.0 * (ex * dx + ey * dy);
    double hss = 2.0 * (dx * dx + dy * dy + ex * ddx + ey * ddy);
    if (std::fabs(hss) < 1e-12) break;
    double step = g / hss;
    s -= step;
    if (s < s_min) s = s_min;
    if (s > s_max) s = s_max;
    if (std::fabs(step) < 1e-10) break;
  }
  return s;
}

// Douglas-Rachford-style projection of trajectory points out of obstacle
// discs (linearized_constraints.cpp:130-148): for each of n_points
// (in-place), at most `iters` sweeps over all obstacles.
// points: [n_points, 2]; obstacles: [n_obs, 2] per point-step?  No —
// obstacle positions per point are passed as [n_points, n_obs, 2]
// (per-stage predictions), radii as [n_obs].
void dr_project(double* points, int64_t n_points, const double* obstacles,
                const double* radii, int64_t n_obs, int iters) {
  for (int64_t p = 0; p < n_points; ++p) {
    double* pt = points + 2 * p;
    const double* obs_p = obstacles + 2 * n_obs * p;
    for (int it = 0; it < iters; ++it) {
      bool any = false;
      for (int64_t o = 0; o < n_obs; ++o) {
        double ox = obs_p[2 * o], oy = obs_p[2 * o + 1];
        double dx = pt[0] - ox, dy = pt[1] - oy;
        double dist = std::sqrt(dx * dx + dy * dy);
        double r = radii[o];
        if (dist < r) {
          any = true;
          if (dist < 1e-9) {
            // Degenerate: push toward the first obstacle's anchor direction
            double ax = pt[0] - obs_p[0], ay = pt[1] - obs_p[1];
            double an = std::sqrt(ax * ax + ay * ay);
            if (an < 1e-9) {
              ax = 1.0;
              ay = 0.0;
              an = 1.0;
            }
            pt[0] = ox + ax / an * r;
            pt[1] = oy + ay / an * r;
          } else {
            pt[0] = ox + dx / dist * r;
            pt[1] = oy + dy / dist * r;
          }
        }
      }
      if (!any) break;
    }
  }
}

// Free-space polytope: iterative nearest-occupied-point cuts
// (decomp_constraints.cpp:62-118 capability). rows_out: [max_constraints, 3]
// rows (a1, a2, b) meaning a.x <= b; unused rows are inactive (x <= 1e6).
void free_polytope(double seed_x, double seed_y, const double* points,
                   int64_t n_points, int64_t max_constraints, double radius,
                   double* rows_out) {
  for (int64_t c = 0; c < max_constraints; ++c) {
    rows_out[3 * c] = 1.0;
    rows_out[3 * c + 1] = 0.0;
    rows_out[3 * c + 2] = 1e6;
  }
  std::vector<double> px(points, points + 2 * n_points);
  std::vector<char> alive(n_points, 1);
  int64_t remaining = n_points;
  for (int64_t c = 0; c < max_constraints && remaining > 0; ++c) {
    // nearest alive point
    int64_t best = -1;
    double best_d = 1e300;
    for (int64_t i = 0; i < n_points; ++i) {
      if (!alive[i]) continue;
      double dx = px[2 * i] - seed_x, dy = px[2 * i + 1] - seed_y;
      double d = dx * dx + dy * dy;
      if (d < best_d) {
        best_d = d;
        best = i;
      }
    }
    if (best < 0) break;
    double dx = px[2 * best] - seed_x, dy = px[2 * best + 1] - seed_y;
    double d = std::sqrt(best_d);
    if (d < 1e-9) d = 1e-9;  // matches the Python fallback semantics
    double a1 = dx / d, a2 = dy / d;
    double cutx = px[2 * best] - a1 * radius;
    double cuty = px[2 * best + 1] - a2 * radius;
    double b = a1 * cutx + a2 * cuty;
    if (a1 * seed_x + a2 * seed_y - b > 0) {
      // Seed itself infeasible for this cut: drop the point and leave the
      // row inactive (consumes the slot, matching the Python fallback).
      alive[best] = 0;
      --remaining;
      continue;
    }
    rows_out[3 * c] = a1;
    rows_out[3 * c + 1] = a2;
    rows_out[3 * c + 2] = b;
    // prune points excluded by the cut
    for (int64_t i = 0; i < n_points; ++i) {
      if (!alive[i]) continue;
      if (px[2 * i] * a1 + px[2 * i + 1] * a2 - b >= radius || i == best) {
        alive[i] = 0;
        --remaining;
      }
    }
  }
}

// Space-time Visibility-PRM search core (the reference's guidance_planner
// hot loop, SURVEY.md §2.4): visibility edges in (x, y, k) between sampled
// nodes, winding-number homology bookkeeping per obstacle, and a label-
// correcting DP over the time-ordered DAG that keeps the best-cost path
// per distinct homology key at every node. Returns up to `max_out`
// cost-ordered, key-distinct goal-reaching node chains; the Python layer
// (guidance/prm.py) resamples/smooths them onto the horizon.
//
// nodes: pos [n, 2], tk [n] (node 0 = start; the LAST n_goals nodes are
// goals). Obstacles: pred [M, Np1, 2] space-time tracks, clear [M] radii
// (obstacle + robot + margin). Edge feasibility: required speed <= v_max
// and clearance at every integer time slice along the segment.
int prm_search(const double* pos, const int64_t* tk, int64_t n,
               int64_t n_goals, const double* goal_cost, const double* pred,
               const double* clear_r,
               int64_t M, int64_t Np1, double dt, double v_max,
               int64_t labels_per_node, int64_t max_out, int64_t* out_count,
               double* out_cost, int64_t* out_len, int64_t* out_nodes) {
  *out_count = 0;
  if (n <= 0 || n_goals <= 0 || max_out <= 0) return 1;
  const double PI = 3.14159265358979323846;

  // --- edges -------------------------------------------------------------
  struct Edge {
    int32_t to;
    double cost;
    int32_t wind_ofs;  // index into wind pool (M doubles), -1 if M == 0
  };
  std::vector<std::vector<Edge>> adj(n);
  std::vector<double> wind_pool;
  wind_pool.reserve((size_t)n * 8 * std::max<int64_t>(M, 1));

  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < n; ++j) {
      if (tk[j] <= tk[i]) continue;
      double span = (double)(tk[j] - tk[i]);
      double dx = pos[2 * j] - pos[2 * i], dy = pos[2 * j + 1] - pos[2 * i + 1];
      double seg = std::sqrt(dx * dx + dy * dy);
      if (seg / (span * dt) > v_max) continue;

      // Collision + winding along integer time slices
      bool hit = false;
      int32_t wofs = -1;
      if (M > 0) {
        wofs = (int32_t)wind_pool.size();
        wind_pool.resize(wind_pool.size() + M, 0.0);
        double prev_th[64];  // M <= 64 obstacles supported natively
        if (M > 64) return 2;
        for (int64_t k = tk[i]; k <= tk[j] && k < Np1; ++k) {
          double f = (double)(k - tk[i]) / span;
          double x = pos[2 * i] + f * dx, y = pos[2 * i + 1] + f * dy;
          for (int64_t m = 0; m < M; ++m) {
            double ox = pred[(m * Np1 + k) * 2], oy = pred[(m * Np1 + k) * 2 + 1];
            double rx = x - ox, ry = y - oy;
            double d2 = rx * rx + ry * ry;
            if (d2 < clear_r[m] * clear_r[m]) {
              hit = true;
              break;
            }
            double th = std::atan2(ry, rx);
            if (k > tk[i]) {
              double dth = th - prev_th[m];
              while (dth > PI) dth -= 2.0 * PI;
              while (dth < -PI) dth += 2.0 * PI;
              wind_pool[wofs + m] += dth;
            }
            prev_th[m] = th;
          }
          if (hit) break;
        }
        if (hit) {
          wind_pool.resize(wofs);  // discard the edge's winding slot
          continue;
        }
      }
      adj[i].push_back(Edge{(int32_t)j, seg, wofs});
    }
  }

  // --- label-correcting DP over the time-ordered DAG ----------------------
  struct Label {
    double cost;
    int32_t node;
    int32_t parent;  // global label index, -1 at start
    int32_t wind_ofs;  // cumulative winding (M doubles), -1 if M == 0
  };
  std::vector<Label> labels;
  std::vector<double> cum_pool;
  // per node: homology key -> label index
  std::vector<std::map<std::vector<int8_t>, int32_t>> node_labels(n);

  labels.push_back(Label{0.0, 0, -1, M > 0 ? 0 : -1});
  if (M > 0) cum_pool.resize(M, 0.0);
  node_labels[0][std::vector<int8_t>(M, 0)] = 0;

  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return tk[a] < tk[b]; });

  std::vector<int8_t> key(M);
  for (int64_t oi = 0; oi < n; ++oi) {
    int64_t i = order[oi];
    auto& lmap = node_labels[i];
    if (lmap.empty()) continue;
    // prune to the cheapest labels_per_node entries
    if ((int64_t)lmap.size() > labels_per_node) {
      std::vector<std::pair<double, std::vector<int8_t>>> by_cost;
      by_cost.reserve(lmap.size());
      for (auto& kv : lmap) by_cost.push_back({labels[kv.second].cost, kv.first});
      std::sort(by_cost.begin(), by_cost.end());
      for (size_t r = labels_per_node; r < by_cost.size(); ++r)
        lmap.erase(by_cost[r].second);
    }
    for (auto& kv : lmap) {
      int32_t li = kv.second;
      double base_cost = labels[li].cost;
      for (const Edge& e : adj[i]) {
        double c_new = base_cost + e.cost;
        int32_t cofs = -1;
        if (M > 0) {
          cofs = (int32_t)cum_pool.size();
          const double* cw = &cum_pool[labels[li].wind_ofs];
          const double* ew = &wind_pool[e.wind_ofs];
          for (int64_t m = 0; m < M; ++m) {
            double w = cw[m] + ew[m];
            cum_pool.push_back(w);
            double q = std::nearbyint(w / PI);
            key[m] = (int8_t)std::max(-127.0, std::min(127.0, q));
          }
        }
        auto& tmap = node_labels[e.to];
        auto it = tmap.find(key);
        if (it == tmap.end() || labels[it->second].cost > c_new) {
          labels.push_back(Label{c_new, e.to, li, cofs});
          if (it == tmap.end())
            tmap[key] = (int32_t)(labels.size() - 1);
          else
            it->second = (int32_t)(labels.size() - 1);
        } else if (M > 0) {
          cum_pool.resize(cofs);  // dominated: discard winding slot
        }
      }
    }
  }

  // --- collect goal labels, cost-ordered, key-distinct ---------------------
  // goal_cost: optional per-goal additive penalty (longitudinal shortfall
  // of nearer goal stations) applied BEFORE the homology-class dedup so
  // the preferred goal of each class survives.
  std::vector<std::pair<double, int32_t>> cands;
  std::map<std::vector<int8_t>, char> seen;
  for (int64_t g = n - n_goals; g < n; ++g) {
    const double gc = goal_cost ? goal_cost[g - (n - n_goals)] : 0.0;
    for (auto& kv : node_labels[g])
      cands.push_back({labels[kv.second].cost + gc, kv.second});
  }
  std::sort(cands.begin(), cands.end());

  int64_t count = 0;
  for (auto& c : cands) {
    if (count >= max_out) break;
    // re-derive the key from the label's cumulative winding
    std::vector<int8_t> k2(M);
    if (M > 0) {
      const double* cw = &cum_pool[labels[c.second].wind_ofs];
      for (int64_t m = 0; m < M; ++m) {
        double q = std::nearbyint(cw[m] / PI);
        k2[m] = (int8_t)std::max(-127.0, std::min(127.0, q));
      }
    }
    if (seen.count(k2)) continue;
    seen[k2] = 1;
    // backtrack
    std::vector<int64_t> chain;
    for (int32_t li = c.second; li >= 0; li = labels[li].parent)
      chain.push_back(labels[li].node);
    std::reverse(chain.begin(), chain.end());
    out_cost[count] = c.first;
    out_len[count] = (int64_t)chain.size();
    for (size_t q = 0; q < chain.size(); ++q)
      out_nodes[count * n + (int64_t)q] = chain[q];
    ++count;
  }
  *out_count = count;
  return 0;
}

}  // extern "C"
