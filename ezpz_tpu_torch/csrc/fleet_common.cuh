// Device code shared by the fleet kernels for Hopper (sm_90a):
// fused_fleet.cu (make_fused_fleet_solver) and coarse_fleet.cu
// (make_coarse_fleet_solver), both in ezpz_tpu/ops/pallas_fleet.py.
//
// The 23 residual kernels in float, double and forward-mode dual numbers,
// the instance-table residual rows, the f32 normal equations, the damped
// Crout solve on the planned fill, and the coarse phase: the f32
// Levenberg-Marquardt loop both kernels run first (coarse_phase below).
// Everything is per lane (one thread per sketch) and table-driven; see
// fused_fleet.cu for what bounds the kernels and what the design does
// about it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Kind ids: the order of ezpz_tpu_torch/ops/kernels.py:KERNELS.
enum Kind {
  K_line_tangent_circle = 0,
  K_circle_tangent_circle = 1,
  K_distance = 2,
  K_distance_var = 3,
  K_vertical_distance = 4,
  K_horizontal_distance = 5,
  K_vertical = 6,
  K_horizontal = 7,
  K_lines_at_angle = 8,
  K_fixed = 9,
  K_scalar_equal = 10,
  K_points_coincident = 11,
  K_circle_radius = 12,
  K_lines_equal_length = 13,
  K_arc = 14,
  K_midpoint = 15,
  K_point_line_distance = 16,
  K_vertical_point_line_distance = 17,
  K_horizontal_point_line_distance = 18,
  K_symmetric = 19,
  K_point_arc_coincident = 20,
  K_arc_length = 21,
  K_points_at_angle = 22,
};

// Instance table columns (ezpz_tpu_torch/ops/fleet_plan.py).
constexpr int INST_KIND = 0, INST_NV = 1, INST_DIM = 2, INST_CID = 3,
              INST_POFF = 4, INST_PK = 5, INST_IDS = 6, MAX_NV = 8,
              INST_COLS = INST_IDS + MAX_NV;

constexpr double EPSILON = 1e-4;
constexpr double EPS2 = 1e-4 * 1e-4;  // kernels._EPS2, the same double

// ---------------------------------------------------------------------------
// Forward-mode dual numbers over float (Jacobian columns). Each rule is
// torch's forward-mode formula for the primitive.

struct DF {
  float v, d;
};

__device__ __forceinline__ DF operator+(DF a, DF b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ DF operator-(DF a, DF b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ DF operator*(DF a, DF b) {
  return {a.v * b.v, a.d * b.v + b.d * a.v};
}
__device__ __forceinline__ DF operator/(DF a, DF b) {
  float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
__device__ __forceinline__ DF operator-(DF a, float b) { return {a.v - b, a.d}; }
__device__ __forceinline__ DF operator*(DF a, float b) { return {a.v * b, a.d * b}; }
__device__ __forceinline__ DF operator*(float a, DF b) { return {a * b.v, b.d * a}; }
__device__ __forceinline__ DF operator/(DF a, float b) { return {a.v / b, a.d / b}; }
__device__ __forceinline__ DF operator/(float a, DF b) {
  float q = a / b.v;
  return {q, (0.0f - q * b.d) / b.v};
}

__device__ __forceinline__ float val(float a) { return a; }
__device__ __forceinline__ double val(double a) { return a; }
__device__ __forceinline__ float val(DF a) { return a.v; }

__device__ __forceinline__ float msqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double msqrt(double a) { return sqrt(a); }
__device__ __forceinline__ DF msqrt(DF a) {
  float s = sqrtf(a.v);
  return {s, a.d / (2.0f * s)};
}

__device__ __forceinline__ float mabs(float a) { return fabsf(a); }
__device__ __forceinline__ double mabs(double a) { return fabs(a); }
__device__ __forceinline__ DF mabs(DF a) {
  const float sg = a.v > 0.0f ? 1.0f : (a.v < 0.0f ? -1.0f : 0.0f);  // torch.sgn
  return {fabsf(a.v), a.d * sg};
}

__device__ __forceinline__ float msin(float a) { return sinf(a); }
__device__ __forceinline__ double msin(double a) { return sin(a); }
__device__ __forceinline__ DF msin(DF a) { return {sinf(a.v), a.d * cosf(a.v)}; }
__device__ __forceinline__ float mcos(float a) { return cosf(a); }
__device__ __forceinline__ double mcos(double a) { return cos(a); }
__device__ __forceinline__ DF mcos(DF a) { return {cosf(a.v), a.d * (-sinf(a.v))}; }

__device__ __forceinline__ float recip(float a) { return 1.0f / a; }
__device__ __forceinline__ double recip(double a) { return 1.0 / a; }
__device__ __forceinline__ DF recip(DF a) {
  float r = 1.0f / a.v;
  return {r, (-a.d) * (r * r)};
}

template <class T>
__device__ __forceinline__ T sel(bool c, T a, T b) { return c ? a : b; }

// Residual value = raw when degenerate, with a zero tangent.
__device__ __forceinline__ float guard(bool deg, float raw, float smooth) {
  return deg ? raw : smooth;
}
__device__ __forceinline__ double guard(bool deg, double raw, double smooth) {
  return deg ? raw : smooth;
}
__device__ __forceinline__ DF guard(bool deg, DF raw, DF smooth) {
  return deg ? DF{raw.v, 0.0f} : smooth;
}

// Scalar of the base type of T (float for DF).
template <class T> struct BaseOf { using type = T; };
template <> struct BaseOf<DF> { using type = float; };

template <class T> __device__ __forceinline__ T lift(typename BaseOf<T>::type c);
template <> __device__ __forceinline__ float lift<float>(float c) { return c; }
template <> __device__ __forceinline__ double lift<double>(double c) { return c; }
template <> __device__ __forceinline__ DF lift<DF>(float c) { return {c, 0.0f}; }

template <class T>
__device__ __forceinline__ T safe_sqrt(T q, bool deg) {
  using B = typename BaseOf<T>::type;
  return msqrt(sel(deg, lift<T>(B(1)), q));
}

template <class T>
__device__ __forceinline__ T cross(T ax, T ay, T bx, T by) { return ax * by - ay * bx; }

template <class T>
__device__ __forceinline__ bool ccw_angle_less(T sx, T sy, T px, T py, T ex, T ey) {
  float z = 0;
  auto c_p = val(cross(sx, sy, px, py));
  auto c_e = val(cross(sx, sy, ex, ey));
  auto d_p = val(sx * px + sy * py);
  auto d_e = val(sx * ex + sy * ey);
  bool h_p = (c_p > z) || ((c_p == z) && (d_p > z));
  bool h_e = (c_e > z) || ((c_e == z) && (d_e > z));
  bool in_half = val(cross(px, py, ex, ey)) > z;
  bool same = h_p == h_e;
  return (same && in_half) || (!same && h_p);
}

// ---------------------------------------------------------------------------
// The 23 residual kernels, as ezpz_tpu_torch/ops/kernels.py (operation for
// operation). T: float, double or DF; S: the parameter type (float or
// double). Writes dim rows to res and returns the degenerate flag.

template <class T, class S>
__device__ bool eval_kind(int kind, const T* v, const S* p, T* res) {
  using B = typename BaseOf<T>::type;
  const B eps2 = B(EPS2), eps = B(EPSILON);
  switch (kind) {
    case K_line_tangent_circle: {
      T ux = v[2] - v[0], uy = v[3] - v[1];
      T q = ux * ux + uy * uy;
      bool deg = val(q) <= eps2;
      T mag = safe_sqrt(q, deg);
      T vx = v[4] - v[0], vy = v[5] - v[1];
      T cen = B(p[0]) * cross(ux, uy, vx, vy) / mag;
      res[0] = guard(deg, lift<T>(B(0)), cen - mabs(v[6]));
      return deg;
    }
    case K_circle_tangent_circle: {
      T dx = v[0] - v[3], dy = v[1] - v[4];
      T q = dx * dx + dy * dy;
      bool deg = val(q) <= eps2;
      T dist_smooth = safe_sqrt(q, deg);
      T dist_raw = msqrt(q);
      T ra = mabs(v[2]), rb = mabs(v[5]);
      T r_int = mabs(ra - rb);
      T r_ext = ra + rb;
      T base = sel(B(p[0]) > B(0.5), r_int, r_ext);
      res[0] = guard(deg, base - dist_raw, base - dist_smooth);
      return deg;
    }
    case K_distance: {
      T dx = v[0] - v[2], dy = v[1] - v[3];
      T q = dx * dx + dy * dy;
      bool deg = val(q) < eps2;
      res[0] = guard(deg, msqrt(q) - B(p[0]), safe_sqrt(q, deg) - B(p[0]));
      return deg;
    }
    case K_distance_var: {
      T dx = v[0] - v[2], dy = v[1] - v[3];
      T q = dx * dx + dy * dy;
      bool deg = val(q) < eps2;
      res[0] = guard(deg, msqrt(q) - v[4], safe_sqrt(q, deg) - v[4]);
      return deg;
    }
    case K_vertical_distance:
    case K_horizontal_distance:
      res[0] = v[0] - v[1] - B(p[0]);
      return false;
    case K_vertical:
    case K_horizontal:
    case K_scalar_equal:
      res[0] = v[0] - v[1];
      return false;
    case K_lines_at_angle: {
      B s = B(p[0]), c = B(p[1]);
      T ux = v[2] - v[0], uy = v[3] - v[1];
      T vx = v[6] - v[4], vy = v[7] - v[5];
      T qu = ux * ux + uy * uy;
      T qv = vx * vx + vy * vy;
      bool deg = (val(qu) <= eps2) || (val(qv) <= eps2);
      T lu = safe_sqrt(qu, deg);
      T lv = safe_sqrt(qv, deg);
      T rvx = c * vx + s * vy;
      T rvy = (-s) * vx + c * vy;
      T r = cross(ux, uy, rvx, rvy) / ((lu + lv) * B(0.5));
      res[0] = guard(deg, lift<T>(B(0)), r);
      return deg;
    }
    case K_fixed:
    case K_circle_radius:
      res[0] = v[0] - B(p[0]);
      return false;
    case K_points_coincident:
      res[0] = v[0] - v[2];
      res[1] = v[1] - v[3];
      return false;
    case K_lines_equal_length:
    case K_arc: {
      // lines_equal_length: |(v0,v1)-(v2,v3)| - |(v4,v5)-(v6,v7)|
      // arc:                |(v0,v1)-(v4,v5)| - |(v2,v3)-(v4,v5)|
      bool arc = kind == K_arc;
      T a = arc ? v[0] - v[4] : v[0] - v[2];
      T b = arc ? v[1] - v[5] : v[1] - v[3];
      T c = arc ? v[2] - v[4] : v[4] - v[6];
      T d = arc ? v[3] - v[5] : v[5] - v[7];
      T q0 = a * a + b * b;
      T q1 = c * c + d * d;
      bool deg = arc ? (val(q0) <= eps2) || (val(q1) <= eps2)
                     : (val(q0) < eps2) || (val(q1) < eps2);
      T raw = msqrt(q0) - msqrt(q1);
      T smooth = safe_sqrt(q0, deg) - safe_sqrt(q1, deg);
      res[0] = guard(deg, raw, smooth);
      return deg;
    }
    case K_midpoint:
      res[0] = v[4] - v[0] / B(2) - v[2] / B(2);
      res[1] = v[5] - v[1] / B(2) - v[3] / B(2);
      return false;
    case K_point_line_distance: {
      T a = v[3] - v[5];
      T b = v[4] - v[2];
      T c = v[2] * v[5] - v[4] * v[3];
      T q = a * a + b * b;
      bool deg = val(q) < eps2;
      T denom = safe_sqrt(q, deg);
      T r = (a * v[0] + b * v[1] + c) / denom - B(p[0]);
      res[0] = guard(deg, lift<T>(B(0)), r);
      return deg;
    }
    case K_vertical_point_line_distance: {
      T dx = v[4] - v[2], dy = v[5] - v[3];
      bool deg = (val(mabs(dx)) <= eps) || (val(dx * dx + dy * dy) <= eps2);
      T dx_s = sel(deg, lift<T>(B(1)), dx);
      T r = v[1] - v[3] - dy / dx_s * (v[0] - v[2]) - B(p[0]);
      res[0] = guard(deg, lift<T>(B(0)), r);
      return deg;
    }
    case K_horizontal_point_line_distance: {
      T dx = v[4] - v[2], dy = v[5] - v[3];
      bool deg = (val(mabs(dy)) <= eps) || (val(dx * dx + dy * dy) <= eps2);
      T dy_s = sel(deg, lift<T>(B(1)), dy);
      T r = v[0] - v[2] - dx / dy_s * (v[1] - v[3]) - B(p[0]);
      res[0] = guard(deg, lift<T>(B(0)), r);
      return deg;
    }
    case K_symmetric: {
      T px = v[0], py = v[1];
      T dx = v[2] - px, dy = v[3] - py;
      T r = dx * dx + dy * dy;
      bool deg = val(r * r) < eps;
      T r_s = sel(deg, lift<T>(B(1)), r);
      T sx = v[4] - px, sy = v[5] - py;
      T dot = sx * dx + sy * dy;
      T refx = B(2) * dx * dot / r_s - sx;
      T refy = B(2) * dy * dot / r_s - sy;
      T r_z = sel(val(r) == B(0), lift<T>(B(1)), r);
      T raw_refx = B(2) * dx * dot / r_z - sx;
      T raw_refy = B(2) * dy * dot / r_z - sy;
      res[0] = guard(deg, raw_refx - v[6] + px, refx - v[6] + px);
      res[1] = guard(deg, raw_refy - v[7] + py, refy - v[7] + py);
      return deg;
    }
    case K_point_arc_coincident: {
      T cx = v[0], cy = v[1];
      T sxr = v[2] - cx, syr = v[3] - cy;
      T exr = v[4] - cx, eyr = v[5] - cy;
      T pxr = v[6] - cx, pyr = v[7] - cy;
      T qs = sxr * sxr + syr * syr;
      T qe = exr * exr + eyr * eyr;
      T qp = pxr * pxr + pyr * pyr;
      bool deg = (val(qs) < eps2) || (val(qe) < eps2) || (val(qp) < eps2);
      T r = safe_sqrt(qs, deg);
      T r_e = safe_sqrt(qe, deg);
      T r_p = safe_sqrt(qp, deg);
      T scale_e = r / r_e;
      T epx = exr * scale_e, epy = eyr * scale_e;
      bool interior = ccw_angle_less(sxr, syr, pxr, pyr, epx, epy);
      T ex_ = epx - pxr, ey_ = epy - pyr;
      T sx_ = sxr - pxr, sy_ = syr - pyr;
      T d_end2 = ex_ * ex_ + ey_ * ey_;
      T d_start2 = sx_ * sx_ + sy_ * sy_;
      bool nearest_end = val(d_end2) < val(d_start2);
      T k = r / r_p - B(1);
      T r0 = interior ? pxr * k : (nearest_end ? ex_ : sx_);
      T r1 = interior ? pyr * k : (nearest_end ? ey_ : sy_);
      res[0] = guard(deg, lift<T>(B(0)), r0);
      res[1] = guard(deg, lift<T>(B(0)), r1);
      return deg;
    }
    case K_arc_length: {
      T cx = v[0], cy = v[1];
      T ux = v[2] - cx, uy = v[3] - cy;
      T r2 = ux * ux + uy * uy;
      bool deg = val(r2) <= eps2;
      T r = safe_sqrt(r2, deg);
      T alpha = B(p[0]) / r;
      T sa = msin(alpha), ca = mcos(alpha);
      T rux = ca * ux - sa * uy;
      T ruy = sa * ux + ca * uy;
      res[0] = guard(deg, lift<T>(B(0)), (v[4] - cx) - rux);
      res[1] = guard(deg, lift<T>(B(0)), (v[5] - cy) - ruy);
      return deg;
    }
    case K_points_at_angle: {
      B s = B(p[0]), c = B(p[1]);
      T ux = v[2] - v[0], uy = v[3] - v[1];
      T vx = v[4] - v[0], vy = v[5] - v[1];
      T qu = ux * ux + uy * uy;
      T qv = vx * vx + vy * vy;
      bool deg = (val(qu) <= eps2) || (val(qv) <= eps2);
      T lu = safe_sqrt(qu, deg);
      T lv = safe_sqrt(qv, deg);
      T rux = c * ux - s * uy;
      T ruy = s * ux + c * uy;
      T inv_scale = recip((lu + lv) * B(0.5));
      res[0] = guard(deg, lift<T>(B(0)), (vx * lu - rux * lv) * inv_scale);
      res[1] = guard(deg, lift<T>(B(0)), (vy * lu - ruy * lv) * inv_scale);
      return deg;
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// Per-lane LM machinery.

struct Topo {
  const int* inst;
  const float* w32;
  const double* w64;
  const int* perm;
  const int* inv;
  const uint8_t* nzl;  // (n, n), permuted numbering, lower triangle
  int n_inst, n, m, n_cons, P;
};

struct Settings {
  int coarse_trips, refine_trips, max_it;
  float ctol, cstol, stol, lam0, decr, incr;
  double rtol;
};

// NaN-propagating max (torch.maximum / jnp.maximum).
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ double nmax(double a, double b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <class V>
__device__ __forceinline__ V weight_of(const Topo& t, int i);
template <> __device__ __forceinline__ float weight_of<float>(const Topo& t, int i) { return t.w32[i]; }
template <> __device__ __forceinline__ double weight_of<double>(const Topo& t, int i) { return t.w64[i]; }

// Weighted residual rows at x (V = float: phase 1; double: phase 2), the
// degenerate words, and in phase 2 the unsatisfied words (some unweighted
// row of the constraint not below 1e-4; NaN rows count as unsatisfied).
template <class V, int W>
__device__ void residual_rows(const Topo& t, const V* x, const double* p64,
                              V* r, uint32_t* deg, uint32_t* unsat) {
  for (int w = 0; w < W; ++w) {
    deg[w] = 0u;
    if (unsat) unsat[w] = 0u;
  }
  int row = 0;
  for (int i = 0; i < t.n_inst; ++i) {
    const int* I = t.inst + i * INST_COLS;
    const int nv = I[INST_NV], dim = I[INST_DIM], cid = I[INST_CID];
    const int poff = I[INST_POFF], pk = I[INST_PK];
    V v[MAX_NV], p[2], res[2];
    for (int a = 0; a < nv; ++a) v[a] = x[I[INST_IDS + a]];
    for (int k = 0; k < pk; ++k) p[k] = V(p64[poff + k]);
    bool dg = eval_kind<V, V>(I[INST_KIND], v, p, res);
    const V w = weight_of<V>(t, i);
    for (int d = 0; d < dim; ++d) {
      if (unsat && !(mabs(res[d]) < V(1e-4))) unsat[cid >> 5] |= 1u << (cid & 31);
      r[row + d] = res[d] * w;
    }
    if (dg) deg[cid >> 5] |= 1u << (cid & 31);
    row += dim;
  }
}

template <class V>
__device__ __forceinline__ V rows_max_abs(const V* r, int m) {
  V acc = mabs(r[0]);
  for (int i = 1; i < m; ++i) acc = nmax(acc, mabs(r[i]));
  return acc;
}

template <class V>
__device__ __forceinline__ V rows_sumsq(const V* r, int m) {
  V s = r[0] * r[0];
  for (int i = 1; i < m; ++i) s = s + r[i] * r[i];
  return s;
}

// f32 normal equations at x against the rhs rows: JtJ as the packed lower
// triangle of the PERMUTED matrix, Jtr in the original numbering, and the
// degenerate words of the evaluation.
template <int W>
__device__ void normal_equations(const Topo& t, const float* x, const double* p64,
                                 const float* rhs, float* A, float* jtr,
                                 uint32_t* deg) {
  const int n = t.n;
  for (int k = 0; k < n * (n + 1) / 2; ++k) A[k] = 0.0f;
  for (int j = 0; j < n; ++j) jtr[j] = 0.0f;
  for (int w = 0; w < W; ++w) deg[w] = 0u;
  int row = 0;
  for (int i = 0; i < t.n_inst; ++i) {
    const int* I = t.inst + i * INST_COLS;
    const int kind = I[INST_KIND], nv = I[INST_NV], dim = I[INST_DIM];
    const int cid = I[INST_CID], poff = I[INST_POFF], pk = I[INST_PK];
    DF v[MAX_NV], res[2];
    float p[2], cols[MAX_NV][2];
    int ids[MAX_NV];
    for (int a = 0; a < nv; ++a) {
      ids[a] = I[INST_IDS + a];
      v[a] = DF{x[ids[a]], 0.0f};
    }
    for (int k = 0; k < pk; ++k) p[k] = float(p64[poff + k]);
    bool dg = false;
    for (int a = 0; a < nv; ++a) {
      v[a].d = 1.0f;
      dg = eval_kind<DF, float>(kind, v, p, res);
      v[a].d = 0.0f;
      for (int d = 0; d < dim; ++d) cols[a][d] = res[d].d;
    }
    const float w = t.w32[i];
    for (int a = 0; a < nv; ++a) {
      float acc = (cols[a][0] * w) * rhs[row];
      for (int d = 1; d < dim; ++d) acc = acc + (cols[a][d] * w) * rhs[row + d];
      jtr[ids[a]] = jtr[ids[a]] + acc;
      const int pa = t.inv[ids[a]];
      for (int b = 0; b < nv; ++b) {
        const int pb = t.inv[ids[b]];
        if (pa < pb) continue;
        float acc2 = (cols[a][0] * w) * (cols[b][0] * w);
        for (int d = 1; d < dim; ++d) acc2 = acc2 + (cols[a][d] * w) * (cols[b][d] * w);
        A[tri(pa, pb)] = A[tri(pa, pb)] + acc2;
      }
    }
    if (dg) deg[cid >> 5] |= 1u << (cid & 31);
    row += dim;
  }
}

// Damp the diagonal by max(lam, 1e-6 * max|diag|), factor by Crout on the
// planned fill (structurally zero entries skipped), solve for
// step = -(JtJ + damping)^-1 Jtr. A NaN on the factor's diagonal fails the
// lane and zeroes its step. y: scratch of n floats. Returns fail.
__device__ bool damped_solve(const Topo& t, float* A, const float* jtr, float lam,
                             float* step, float* y) {
  const int n = t.n;
  const uint8_t* nz = t.nzl;
  float maxdiag = fabsf(A[0]);
  for (int i = 1; i < n; ++i) maxdiag = nmax(maxdiag, fabsf(A[tri(i, i)]));
  const float lam_eff = nmax(lam, maxdiag * 1e-6f);
  for (int i = 0; i < n; ++i) A[tri(i, i)] = A[tri(i, i)] + lam_eff;
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      if (!nz[i * n + j]) continue;
      float s = A[tri(i, j)];
      for (int k = 0; k < j; ++k)
        if (nz[i * n + k] && nz[j * n + k]) s = s - A[tri(i, k)] * A[tri(j, k)];
      A[tri(i, j)] = (i == j) ? sqrtf(s) : s / A[tri(j, j)];
    }
  }
  bool fail = false;
  for (int i = 0; i < n; ++i) fail = fail || isnan(A[tri(i, i)]);
  for (int i = 0; i < n; ++i) {
    const float di = A[tri(i, i)];
    A[tri(i, i)] = (isnan(di) || di == 0.0f) ? 1.0f : di;
    for (int k = 0; k < i; ++k)
      if (nz[i * n + k] && isnan(A[tri(i, k)])) A[tri(i, k)] = 0.0f;
  }
  for (int i = 0; i < n; ++i) {
    float s = -jtr[t.perm[i]];
    for (int k = 0; k < i; ++k)
      if (nz[i * n + k]) s = s - A[tri(i, k)] * y[k];
    y[i] = s / A[tri(i, i)];
  }
  for (int i = n - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < n; ++k)
      if (nz[k * n + i]) s = s - A[tri(k, i)] * y[k];
    y[i] = s / A[tri(i, i)];
  }
  for (int k = 0; k < n; ++k) step[t.perm[k]] = fail ? 0.0f : y[k];
  return fail;
}
// The coarse phase of both kernels: up to s.coarse_trips f32 LM trips of
// one lane, from x0 (the lane's n doubles, rounded to float) toward the
// per-lane tolerances max(tol, 1e-7 * max(1, |x0|_inf)). A done lane leaves
// the loop (later trips would change nothing). On return x holds the coarse
// point, r its residual rows, lam the carried damping and deg the
// degenerate words; coarse_its is the JAX coarse kernel's iteration count
// (pallas_fleet.py:753-759) and the result its converged flag.
// xn, step, jtr, y (n floats), rn (m floats), A (the packed factor), dj, dr
// (W words) are scratch.
template <int W>
__device__ __forceinline__ bool coarse_phase(
    const Topo& t, const Settings& s, const double* x0, const double* p64,
    float* x, float* xn, float* step, float* jtr, float* y, float* r,
    float* rn, float* A, uint32_t* deg, uint32_t* dj, uint32_t* dr,
    float& lam, int& coarse_its) {
  const int n = t.n, m = t.m;
  float scale = 1.0f;
  for (int j = 0; j < n; ++j) {
    x[j] = float(x0[j]);
    scale = nmax(scale, fabsf(x[j]));
  }
  const float ctol_l = nmax(s.ctol, scale * 1e-7f);
  const float cstol_l = nmax(s.cstol, scale * 1e-7f);
  residual_rows<float, W>(t, x, p64, r, deg, nullptr);
  float r2 = rows_sumsq(r, m);
  lam = s.lam0;
  int it = 0, iters = 0;
  bool done = false;
  for (int trip = 0; trip < s.coarse_trips && !done; ++trip) {
    if (rows_max_abs(r, m) <= ctol_l) {
      done = true;
      iters = it;
      break;
    }
    normal_equations<W>(t, x, p64, r, A, jtr, dj);
    const bool fail = damped_solve(t, A, jtr, lam, step, y);
    float step_inf = fabsf(step[0]);
    for (int j = 1; j < n; ++j) step_inf = nmax(step_inf, fabsf(step[j]));
    for (int j = 0; j < n; ++j) xn[j] = x[j] + step[j];
    residual_rows<float, W>(t, xn, p64, rn, dr, nullptr);
    const float r2n = rows_sumsq(rn, m);
    const bool accept = !fail && r2n < r2;
    if (accept) {
      for (int j = 0; j < n; ++j) x[j] = xn[j];
      for (int i = 0; i < m; ++i) r[i] = rn[i];
      r2 = r2n;
      lam = lam * s.decr;
    } else {
      lam = lam * s.incr;
    }
    for (int w = 0; w < W; ++w) deg[w] |= dj[w] | dr[w];
    if (!fail && step_inf <= cstol_l) {
      done = true;
      iters = it;
    }
    ++it;
  }
  if (done) {
    coarse_its = iters;
    return true;
  }
  const bool converged = rows_max_abs(r, m) <= ctol_l;
  coarse_its = converged ? it : s.coarse_trips;
  return converged;
}

// Compiled capacities (max variables, max residual rows), smallest first.
// Mirrors CAPACITIES in ezpz_tpu_torch/ops/_build.py.
constexpr int CAPS[][2] = {{4, 8}, {16, 32}, {64, 256}};
constexpr int N_CAPS = sizeof(CAPS) / sizeof(CAPS[0]);

}  // namespace
