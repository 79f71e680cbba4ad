// Device code shared by the fleet kernels for Hopper (sm_90a):
// fused_fleet.cu (make_fused_fleet_solver) and coarse_fleet.cu
// (make_coarse_fleet_solver), both in ezpz_tpu/ops/pallas_fleet.py.
//
// The 23 residual kernels in float, double and forward-mode dual numbers
// that carry all of an instance's tangents, the two lane layouts, and the
// LM phases both kernels run (coarse_phase, then refine_phase in the fused
// kernel). One thread per sketch; everything works in the planner's
// elimination numbering (variable k of a lane is x[perm[k]]), so the
// factor of the normal equations is packed by the planned fill and perm is
// applied only where x0 is read and x is written.
//
// Two lane layouts run the same phases:
//   * SmallLane<NV, NI>: an exact-shape topology of at most NV variables
//     and NI instances. The whole lane state (x, residual rows, the packed
//     factor, lambda, flag words, parameters) is in registers: every array
//     is indexed by compile-time constants or through unrolled selects
//     (Reg::get/set), each instance owns row slots 2i and 2i + 1 (a
//     one-row kind leaves the second at +0.0, which changes neither |r|^2
//     nor max|r|), and the topology sits in the kernel's parameter space
//     (__grid_constant__), so its fields are constant-bank operands.
//   * BigLane: any topology the kernel gate admits (at most 256
//     instances, a planned fill of at most 2080). The instance table and
//     weights are copied into shared memory once per block; the lane state
//     lives in lane-interleaved scratch (slot k of lane l at k * B + l, so a
//     warp's accesses coalesce) that the wrapper allocates; the Crout
//     factorization and both triangular solves follow schedules the
//     planner computed (ops/fleet_plan.py), not a mask test per entry.
//
// Arithmetic is the plain versions' (ops/fleet_common.py) operation for
// operation: IEEE division and sqrt, no FMA contraction (--fmad=false),
// the NaN-propagating nmax, native f64 in the refine phase, the
// atan2-free ccw_angle_less. Each dual-number tangent takes the same
// forward-mode rule as a one-tangent evaluation, so the Jacobian columns
// are bit-identical to torch.func.jvp with one-hot tangents.

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

// Variables, parameters and residual rows of each kind (KernelSpec).
constexpr int ARITY[23] = {7, 6, 4, 5, 2, 2, 2, 2, 8, 1, 2, 4,
                           1, 8, 6, 6, 6, 6, 6, 8, 8, 6, 6};
constexpr int NPAR[23] = {1, 1, 1, 0, 1, 1, 0, 0, 2, 1, 0, 0,
                          1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 2};
constexpr int DIM[23] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2,
                         1, 1, 1, 2, 1, 1, 1, 2, 2, 2, 2};

// Kernel instance table columns (ops/fleet_plan.py, KI_*): the first
// KI_SMALL columns are what a SmallLane reads; KI_SLOTS holds 64 int16
// factor slots, one per instance variable pair (a, b), -1 where the pair
// adds nothing (perm position of a below that of b).
constexpr int KI_KIND = 0, KI_DIM = 1, KI_NV = 2, KI_POFF = 3, KI_WORD = 4,
              KI_BIT = 5, KI_PK = 6, KI_IDS = 8, KI_SMALL = 16, KI_SLOTS = 16,
              KI_COLS = 48, MAX_NV = 8;

constexpr double EPSILON = 1e-4;
constexpr double EPS2 = 1e-4 * 1e-4;  // kernels._EPS2, the same double

// ---------------------------------------------------------------------------
// Forward-mode dual numbers over float with K tangents (all of an
// instance's Jacobian columns in one evaluation). Each rule is torch's
// forward-mode formula for the primitive, applied to every tangent.

template <int K>
struct DN {
  float v;
  float d[K];
};

#define EZPZ_DN_LOOP _Pragma("unroll") for (int t = 0; t < K; ++t)

template <int K> __device__ __forceinline__ DN<K> operator+(DN<K> a, DN<K> b) {
  DN<K> o; o.v = a.v + b.v; EZPZ_DN_LOOP o.d[t] = a.d[t] + b.d[t]; return o;
}
template <int K> __device__ __forceinline__ DN<K> operator-(DN<K> a, DN<K> b) {
  DN<K> o; o.v = a.v - b.v; EZPZ_DN_LOOP o.d[t] = a.d[t] - b.d[t]; return o;
}
template <int K> __device__ __forceinline__ DN<K> operator*(DN<K> a, DN<K> b) {
  DN<K> o; o.v = a.v * b.v; EZPZ_DN_LOOP o.d[t] = a.d[t] * b.v + b.d[t] * a.v; return o;
}
template <int K> __device__ __forceinline__ DN<K> operator/(DN<K> a, DN<K> b) {
  DN<K> o; const float q = a.v / b.v; o.v = q;
  EZPZ_DN_LOOP o.d[t] = (a.d[t] - q * b.d[t]) / b.v;
  return o;
}
template <int K> __device__ __forceinline__ DN<K> operator-(DN<K> a, float b) {
  DN<K> o; o.v = a.v - b; EZPZ_DN_LOOP o.d[t] = a.d[t]; return o;
}
template <int K> __device__ __forceinline__ DN<K> operator*(DN<K> a, float b) {
  DN<K> o; o.v = a.v * b; EZPZ_DN_LOOP o.d[t] = a.d[t] * b; return o;
}
template <int K> __device__ __forceinline__ DN<K> operator*(float a, DN<K> b) {
  DN<K> o; o.v = a * b.v; EZPZ_DN_LOOP o.d[t] = b.d[t] * a; return o;
}
template <int K> __device__ __forceinline__ DN<K> operator/(DN<K> a, float b) {
  DN<K> o; o.v = a.v / b; EZPZ_DN_LOOP o.d[t] = a.d[t] / b; return o;
}
template <int K> __device__ __forceinline__ DN<K> operator/(float a, DN<K> b) {
  DN<K> o; const float q = a / b.v; o.v = q;
  EZPZ_DN_LOOP o.d[t] = (0.0f - q * b.d[t]) / b.v;
  return o;
}

__device__ __forceinline__ float val(float a) { return a; }
__device__ __forceinline__ double val(double a) { return a; }
template <int K> __device__ __forceinline__ float val(DN<K> a) { return a.v; }

__device__ __forceinline__ float msqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double msqrt(double a) { return sqrt(a); }
template <int K> __device__ __forceinline__ DN<K> msqrt(DN<K> a) {
  DN<K> o; const float s = sqrtf(a.v); o.v = s;
  const float s2 = 2.0f * s;
  EZPZ_DN_LOOP o.d[t] = a.d[t] / s2;
  return o;
}

__device__ __forceinline__ float mabs(float a) { return fabsf(a); }
__device__ __forceinline__ double mabs(double a) { return fabs(a); }
template <int K> __device__ __forceinline__ DN<K> mabs(DN<K> a) {
  const float sg = a.v > 0.0f ? 1.0f : (a.v < 0.0f ? -1.0f : 0.0f);  // torch.sgn
  DN<K> o; o.v = fabsf(a.v); EZPZ_DN_LOOP o.d[t] = a.d[t] * sg; return o;
}

__device__ __forceinline__ float msin(float a) { return sinf(a); }
__device__ __forceinline__ double msin(double a) { return sin(a); }
template <int K> __device__ __forceinline__ DN<K> msin(DN<K> a) {
  DN<K> o; o.v = sinf(a.v); const float c = cosf(a.v);
  EZPZ_DN_LOOP o.d[t] = a.d[t] * c;
  return o;
}
__device__ __forceinline__ float mcos(float a) { return cosf(a); }
__device__ __forceinline__ double mcos(double a) { return cos(a); }
template <int K> __device__ __forceinline__ DN<K> mcos(DN<K> a) {
  DN<K> o; o.v = cosf(a.v); const float ms = -sinf(a.v);
  EZPZ_DN_LOOP o.d[t] = a.d[t] * ms;
  return o;
}

__device__ __forceinline__ float recip(float a) { return 1.0f / a; }
__device__ __forceinline__ double recip(double a) { return 1.0 / a; }
template <int K> __device__ __forceinline__ DN<K> recip(DN<K> a) {
  DN<K> o; const float r = 1.0f / a.v; o.v = r; const float r2 = r * r;
  EZPZ_DN_LOOP o.d[t] = (-a.d[t]) * r2;
  return o;
}

#undef EZPZ_DN_LOOP

template <class T>
__device__ __forceinline__ T sel(bool c, T a, T b) { return c ? a : b; }

// Scalar of the base type of T (float for a dual number).
template <class T> struct BaseOf { using type = T; };
template <int K> struct BaseOf<DN<K>> { using type = float; };

template <class T> struct Lift {
  __device__ __forceinline__ static T of(T c) { return c; }
};
template <int K> struct Lift<DN<K>> {
  __device__ __forceinline__ static DN<K> of(float c) {
    DN<K> o; o.v = c;
#pragma unroll
    for (int t = 0; t < K; ++t) o.d[t] = 0.0f;
    return o;
  }
};
template <class T>
__device__ __forceinline__ T lift(typename BaseOf<T>::type c) { return Lift<T>::of(c); }

// Residual value = raw when degenerate, with a zero tangent.
template <class T>
__device__ __forceinline__ T guard(bool deg, T raw, T smooth) {
  return deg ? lift<T>(val(raw)) : smooth;
}

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
// operation). T: float, double or DN<K>; S: the parameter type (float or
// double). Writes the kind's rows to res and returns the degenerate flag.
// Always called with a constant kind, so the switch folds away.

template <class T, class S>
__device__ __forceinline__ bool eval_kind(int kind, const T* v, const S* p, T* res) {
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

#define EZPZ_KINDS(X)                                                         \
  X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22)

// One instance's residual rows at the values getv(a) of its variables and
// the parameters getp(k), for a runtime kind. Kinds with more than KMAX
// variables are not compiled in (the host never sends them); a kind < 0
// (a padding instance) writes nothing.
template <int KMAX, class T, class S, class GetV, class GetP>
__device__ __forceinline__ bool eval_instance(int kind, GetV getv, GetP getp, T* res) {
  switch (kind) {
#define EZPZ_CASE(K)                                                \
    case K:                                                         \
      if constexpr (ARITY[K] <= KMAX) {                             \
        constexpr int A = ARITY[K], NP = NPAR[K];                   \
        T v[A];                                                     \
        S p[2] = {S(0), S(0)};                                      \
        _Pragma("unroll") for (int a = 0; a < A; ++a) v[a] = getv(a); \
        _Pragma("unroll") for (int k = 0; k < NP; ++k) p[k] = getp(k); \
        return eval_kind<T, S>(K, v, p, res);                       \
      }                                                             \
      break;
    EZPZ_KINDS(EZPZ_CASE)
#undef EZPZ_CASE
    default:
      break;
  }
  return false;
}

// One instance's Jacobian columns cols[a][d] = d row_d / d var_a in ONE
// evaluation: a dual number with one tangent per instance variable (as
// many as the kind has), seeded one-hot. Returns the degenerate flag.
template <int KMAX, class GetV, class GetP>
__device__ __forceinline__ bool jac_instance(int kind, GetV getv, GetP getp,
                                             float (&cols)[KMAX][2]) {
  switch (kind) {
#define EZPZ_CASE(K)                                                \
    case K:                                                         \
      if constexpr (ARITY[K] <= KMAX) {                             \
        constexpr int A = ARITY[K], NP = NPAR[K], D = DIM[K];       \
        DN<A> v[A], res[2];                                         \
        float p[2] = {0.0f, 0.0f};                                  \
        _Pragma("unroll") for (int a = 0; a < A; ++a) {             \
          v[a].v = getv(a);                                         \
          _Pragma("unroll") for (int t = 0; t < A; ++t)             \
              v[a].d[t] = (t == a) ? 1.0f : 0.0f;                   \
        }                                                           \
        _Pragma("unroll") for (int k = 0; k < NP; ++k) p[k] = getp(k); \
        const bool dg = eval_kind<DN<A>, float>(K, v, p, res);      \
        _Pragma("unroll") for (int d = 0; d < D; ++d)               \
          _Pragma("unroll") for (int a = 0; a < A; ++a)             \
              cols[a][d] = res[d].d[a];                             \
        return dg;                                                  \
      }                                                             \
      break;
    EZPZ_KINDS(EZPZ_CASE)
#undef EZPZ_CASE
    default:
      break;
  }
  return false;
}

// ---------------------------------------------------------------------------
// Lane storage.

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

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// N values in registers. get/set take any index: after unrolling, a
// constant index is a register, a runtime one a chain of selects.
template <class T, int N>
struct Reg {
  T a[N];
  __device__ __forceinline__ T get(int k) const {
    T v = a[0];
#pragma unroll
    for (int s = 1; s < N; ++s)
      if (k == s) v = a[s];
    return v;
  }
  __device__ __forceinline__ void set(int k, T v) {
#pragma unroll
    for (int s = 0; s < N; ++s)
      if (k == s) a[s] = v;
  }
};

// One lane's slots in lane-interleaved scratch: slot k at p[k * stride].
template <class T>
struct Scr {
  T* p;
  int stride;
  __device__ __forceinline__ T get(int k) const { return p[(size_t)k * stride]; }
  __device__ __forceinline__ void set(int k, T v) const { p[(size_t)k * stride] = v; }
};

// Make the trial values (point or rows) the current ones: a copy in
// registers; for scratch, a swap of the two views (the trial slots are
// all rewritten before they are read again).
template <class T, int N>
__device__ __forceinline__ void take(Reg<T, N>& cur, const Reg<T, N>& trial) { cur = trial; }
template <class T>
__device__ __forceinline__ void take(Scr<T>& cur, Scr<T>& trial) {
  const Scr<T> old = cur;
  cur = trial;
  trial = old;
}

// W words of per-constraint bits, in registers.
template <int W>
struct Flags {
  uint32_t w[W];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < W; ++s) w[s] = 0u;
  }
  __device__ __forceinline__ void set(int word, uint32_t bit) {
#pragma unroll
    for (int s = 0; s < W; ++s)
      if (word == s) w[s] |= bit;
  }
  __device__ __forceinline__ void add(const Flags& a, const Flags& b) {
#pragma unroll
    for (int s = 0; s < W; ++s) w[s] |= a.w[s] | b.w[s];
  }
  __device__ __forceinline__ bool test(int c) const {
    uint32_t v = w[0];
#pragma unroll
    for (int s = 1; s < W; ++s)
      if ((c >> 5) == s) v = w[s];
    return (v >> (c & 31)) & 1u;
  }
};

template <class V> __device__ __forceinline__ V weight(float w32, double w64);
template <> __device__ __forceinline__ float weight<float>(float w32, double) { return w32; }
template <> __device__ __forceinline__ double weight<double>(float, double w64) { return w64; }

// Weighted rows of one evaluated instance into slots 2i and 2i + 1 (+0.0
// where the kind has no such row), and, in phase 2, its unsatisfied bit
// (some unweighted row not below 1e-4; NaN counts as unsatisfied).
template <class V, bool UNSAT, class RA, class FL>
__device__ __forceinline__ void put_rows(RA& r, int i, int dim, const V (&res)[2], V w,
                                         int word, uint32_t bit, FL& unsat) {
  V r0 = V(0), r1 = V(0);
  bool bad = false;
  if (dim > 0) {
    r0 = res[0] * w;
    bad = !(mabs(res[0]) < V(1e-4));
  }
  if (dim > 1) {
    r1 = res[1] * w;
    bad = bad || !(mabs(res[1]) < V(1e-4));
  }
  r.set(2 * i, r0);
  r.set(2 * i + 1, r1);
  if (UNSAT && bad) unsat.set(word, bit);
}

// -- exact-shape topologies in registers ------------------------------------

// The ladder of exact-shape instantiations (variables, instances), smallest
// first. Mirrors SMALL_SHAPES in ezpz_tpu_torch/ops/_build.py.
constexpr int SMALL_SHAPES[][2] = {{1, 1}, {2, 2}, {4, 4}, {8, 8}};
constexpr int N_SMALL = sizeof(SMALL_SHAPES) / sizeof(SMALL_SHAPES[0]);

// Threads per block of every launch, and the __launch_bounds__ minimum
// resident blocks per SM of the instantiations of at most 2 variables (the
// main path's): 8 blocks of 128 threads, 1024 resident threads, cap them
// at 64 registers with no spills. Both chosen by timing on the H100
// (PERF.md): 64, 128 and 256 threads per block came within 3% of each
// other; 768 resident threads (the compiler's own choice) were 9% slower
// on the fused kernel, and 2048 (32 registers) spilled.
constexpr int THREADS = 128;
constexpr int SMALL_MIN_BLOCKS = 8;

// A small topology, passed by value as a __grid_constant__ kernel
// parameter. Padding instances have kind -1; padding variables (positions
// n..NV-1 of the elimination order) have perm -1, no rows and a diagonal
// factor entry only, so their step is exactly zero.
template <int NV, int NI>
struct SmallTopo {
  int inst[NI][KI_SMALL];
  float w32[NI];
  double w64[NI];
  int perm[NV];
  unsigned long long fill;  // bit tri(i, j): factor entry (i, j) is structural
  int n, n_cons, P;
};

// Instance loops: unrolled for a few instances (every index a constant),
// a plain loop above (one copy of the 23-kind dispatch).
template <int N, class F>
__device__ __forceinline__ void for_inst(F f) {
  if constexpr (N <= 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) f(i);
  } else {
#pragma unroll 1
    for (int i = 0; i < N; ++i) f(i);
  }
}

template <int NV, int NI>
struct SmallLane {
  static constexpr int n = NV, m = 2 * NI, S = NV * (NV + 1) / 2;
  static constexpr int KMAX = NV < MAX_NV ? NV : MAX_NV;
  using FlagT = Flags<1>;
  const SmallTopo<NV, NI>& t;
  const double* x0row;
  Reg<double, 2 * NI> p;  // parameter k of instance i in slot 2i + k
  Reg<float, NV> x, xn, y, jtr;
  Reg<float, 2 * NI> r, rn;
  Reg<float, S> A;
  Reg<double, NV> xd, xnd;
  Reg<double, 2 * NI> rd, rnd;
  FlagT deg;

  __device__ __forceinline__ SmallLane(const SmallTopo<NV, NI>& topo, const double* x0,
                                       const double* par)
      : t(topo), x0row(x0) {
    // The lane's parameters, read once.
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int pk = t.inst[i][KI_PK], poff = t.inst[i][KI_POFF];
      p.a[2 * i] = pk > 0 ? par[poff] : 0.0;
      p.a[2 * i + 1] = pk > 1 ? par[poff + 1] : 0.0;
    }
  }

  __device__ __forceinline__ double x0(int k) const {
    const int j = t.perm[k];
    return j < 0 ? 0.0 : x0row[j];
  }

  template <class V, bool UNSAT, class XA, class RA>
  __device__ __forceinline__ void rows(const XA& xs, RA& out, FlagT& dg_out, FlagT& unsat) {
    dg_out.clear();
    if (UNSAT) unsat.clear();
    for_inst<NI>([&](int i) {
      const int* I = t.inst[i];
      V res[2] = {V(0), V(0)};
      const bool dg = eval_instance<KMAX, V, V>(
          I[KI_KIND], [&](int a) { return xs.get(I[KI_IDS + a]); },
          [&](int k) { return V(p.get(2 * i + k)); }, res);
      put_rows<V, UNSAT>(out, i, I[KI_DIM], res, weight<V>(t.w32[i], t.w64[i]),
                         I[KI_WORD], uint32_t(I[KI_BIT]), unsat);
      if (dg) dg_out.set(I[KI_WORD], uint32_t(I[KI_BIT]));
    });
  }

  // f32 normal equations at xs against the rhs rows: the packed lower
  // triangle of JtJ and Jtr, both in the elimination numbering. Each
  // instance's columns are spread into the dense numbering by selects (the
  // host routes a topology here only when no instance repeats a variable),
  // so every JtJ entry takes the same additions in the same order as the
  // plain version's pairwise loop.
  __device__ __forceinline__ void normal_equations(const Reg<float, NV>& xs,
                                                   const Reg<float, 2 * NI>& rhs,
                                                   FlagT& dj) {
#pragma unroll
    for (int k = 0; k < S; ++k) A.a[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) jtr.a[j] = 0.0f;
    dj.clear();
    for_inst<NI>([&](int i) {
      const int* I = t.inst[i];
      const int kind = I[KI_KIND], dim = I[KI_DIM], nv = I[KI_NV];
      float cols[KMAX][2];
#pragma unroll
      for (int a = 0; a < KMAX; ++a) cols[a][0] = cols[a][1] = 0.0f;
      const bool dg = jac_instance<KMAX>(
          kind, [&](int a) { return xs.get(I[KI_IDS + a]); },
          [&](int k) { return float(p.get(2 * i + k)); }, cols);
      const float w = t.w32[i];
      const float r0 = rhs.get(2 * i), r1 = rhs.get(2 * i + 1);
      float c0[NV], c1[NV];
      bool on[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        on[j] = false;
        c0[j] = c1[j] = 0.0f;
      }
#pragma unroll
      for (int a = 0; a < KMAX; ++a) {
        if (a < nv) {
          const int pa = I[KI_IDS + a];
#pragma unroll
          for (int j = 0; j < NV; ++j)
            if (pa == j) {
              on[j] = true;
              c0[j] = cols[a][0];
              c1[j] = cols[a][1];
            }
        }
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!on[j]) continue;
        float acc = (c0[j] * w) * r0;
        if (dim > 1) acc = acc + (c1[j] * w) * r1;
        jtr.a[j] = jtr.a[j] + acc;
#pragma unroll
        for (int k = 0; k <= j; ++k) {
          if (!on[k]) continue;
          float acc2 = (c0[j] * w) * (c0[k] * w);
          if (dim > 1) acc2 = acc2 + (c1[j] * w) * (c1[k] * w);
          A.a[tri(j, k)] = A.a[tri(j, k)] + acc2;
        }
      }
      if (dg) dj.set(I[KI_WORD], uint32_t(I[KI_BIT]));
    });
  }

  __device__ __forceinline__ bool nz(int i, int j) const { return (t.fill >> tri(i, j)) & 1ull; }

  // Damp the diagonal by max(lam, 1e-6 * max|diag|), factor by Crout on the
  // planned fill, solve; y = the step in the elimination numbering (zero
  // when a NaN on the factor's diagonal fails the lane). Returns fail.
  __device__ __forceinline__ bool solve(float lam) {
    float maxdiag = fabsf(A.a[0]);
#pragma unroll
    for (int i = 1; i < NV; ++i) maxdiag = nmax(maxdiag, fabsf(A.a[tri(i, i)]));
    const float lam_eff = nmax(lam, maxdiag * 1e-6f);
#pragma unroll
    for (int i = 0; i < NV; ++i) A.a[tri(i, i)] = A.a[tri(i, i)] + lam_eff;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        if (!nz(i, j)) continue;
        float s = A.a[tri(i, j)];
#pragma unroll
        for (int k = 0; k < j; ++k)
          if (nz(i, k) && nz(j, k)) s = s - A.a[tri(i, k)] * A.a[tri(j, k)];
        A.a[tri(i, j)] = (i == j) ? sqrtf(s) : s / A.a[tri(j, j)];
      }
    }
    bool fail = false;
#pragma unroll
    for (int i = 0; i < NV; ++i) fail = fail || isnan(A.a[tri(i, i)]);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float di = A.a[tri(i, i)];
      A.a[tri(i, i)] = (isnan(di) || di == 0.0f) ? 1.0f : di;
#pragma unroll
      for (int k = 0; k < i; ++k)
        if (nz(i, k) && isnan(A.a[tri(i, k)])) A.a[tri(i, k)] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float s = -jtr.a[i];
#pragma unroll
      for (int k = 0; k < i; ++k)
        if (nz(i, k)) s = s - A.a[tri(i, k)] * y.a[k];
      y.a[i] = s / A.a[tri(i, i)];
    }
#pragma unroll
    for (int i = NV - 1; i >= 0; --i) {
      float s = y.a[i];
#pragma unroll
      for (int k = i + 1; k < NV; ++k)
        if (nz(k, i)) s = s - A.a[tri(k, i)] * y.a[k];
      y.a[i] = s / A.a[tri(i, i)];
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) y.a[k] = fail ? 0.0f : y.a[k];
    return fail;
  }

  __device__ __forceinline__ int out_col(int k) const { return t.perm[k]; }
  __device__ __forceinline__ int n_cons() const { return t.n_cons; }
};

// -- any admitted topology: shared-memory tables, scratch lane state --------

// Global tables of a topology (device pointers; ops/fleet_plan.py).
struct BigTopo {
  const int* inst;       // (n_inst, KI_COLS)
  const float* w32;      // (n_inst,)
  const double* w64;     // (n_inst,)
  const int* perm;       // (n,)
  const int* row_start;  // (n + 1,): row i of the factor is slots [row_start[i], row_start[i+1]); its diagonal is the last
  const int* ent_col;    // (fill,): column of each slot
  const int* cr_start;   // (fill + 1,): Crout updates of slot e are cr_pair[cr_start[e] .. cr_start[e+1])
  const int* cr_pair;    // slot(i,k) | slot(j,k) << 16, ascending k
  const int* col_start;  // (n + 1,): column i below the diagonal is col_ent[col_start[i] .. col_start[i+1])
  const int* col_ent;    // slot | row << 16, ascending row
  int n, n_inst, n_cons, P, fill;
};

// Scratch slots of one lane (floats, then doubles), for the wrapper.
struct BigSlots {
  int X, XN, Y, JTR, R, RN, A, F32;   // float slots
  int PAR, XD, XND, RD, RND, F64;     // double slots
  __host__ __device__ BigSlots(int n, int n_inst, int fill, int P, bool f64) {
    const int m = 2 * n_inst;
    X = 0; XN = n; Y = 2 * n; JTR = 3 * n; R = 4 * n; RN = R + m; A = RN + m;
    F32 = A + fill;
    PAR = 0; XD = P; XND = XD + n; RD = XND + n; RND = RD + m;
    F64 = f64 ? RND + m : P;
  }
};

// Copy a topology's instance table and weights into shared memory (all
// threads of the block), then sync. Layout: w64, w32, inst.
__device__ __forceinline__ void load_shared_topology(const BigTopo& g, unsigned char* smem,
                                                     const int** inst, const float** w32,
                                                     const double** w64) {
  double* s64 = reinterpret_cast<double*>(smem);
  float* s32 = reinterpret_cast<float*>(s64 + g.n_inst);
  int* sinst = reinterpret_cast<int*>(s32 + g.n_inst);
  for (int k = threadIdx.x; k < g.n_inst; k += blockDim.x) {
    s64[k] = g.w64[k];
    s32[k] = g.w32[k];
  }
  for (int k = threadIdx.x; k < g.n_inst * KI_COLS; k += blockDim.x) sinst[k] = g.inst[k];
  __syncthreads();
  *inst = sinst;
  *w32 = s32;
  *w64 = s64;
}

__host__ __device__ constexpr size_t big_shared_bytes(int n_inst) {
  return (size_t)n_inst * (sizeof(double) + sizeof(float) + KI_COLS * sizeof(int));
}

struct BigLane {
  static constexpr int KMAX = MAX_NV;
  using FlagT = Flags<8>;  // up to 256 constraints
  const BigTopo& g;
  const int* inst;
  const float* w32;
  const double* w64;
  int n, m;
  const double* x0row;
  Scr<double> p;
  Scr<float> x, xn, y, jtr, r, rn, A;
  Scr<double> xd, xnd, rd, rnd;
  FlagT deg;

  __device__ __forceinline__ BigLane(const BigTopo& topo, const int* si, const float* s32,
                                     const double* s64, const double* x0, const double* par,
                                     float* f, double* d, int lane, int stride, bool f64)
      : g(topo), inst(si), w32(s32), w64(s64), n(topo.n), m(2 * topo.n_inst), x0row(x0) {
    const BigSlots q(topo.n, topo.n_inst, topo.fill, topo.P, f64);
    auto fs = [&](int slot) { return Scr<float>{f + (size_t)slot * stride + lane, stride}; };
    auto ds = [&](int slot) { return Scr<double>{d + (size_t)slot * stride + lane, stride}; };
    p = ds(q.PAR);
    x = fs(q.X); xn = fs(q.XN); y = fs(q.Y); jtr = fs(q.JTR);
    r = fs(q.R); rn = fs(q.RN); A = fs(q.A);
    xd = ds(q.XD); xnd = ds(q.XND); rd = ds(q.RD); rnd = ds(q.RND);
    // The lane's parameters, read once into coalesced scratch.
    for (int k = 0; k < topo.P; ++k) p.set(k, par[k]);
  }

  __device__ __forceinline__ double x0(int k) const { return x0row[__ldg(g.perm + k)]; }

  template <class V, bool UNSAT, class XA, class RA>
  __device__ __forceinline__ void rows(const XA& xs, RA& out, FlagT& dg_out, FlagT& unsat) {
    dg_out.clear();
    if (UNSAT) unsat.clear();
#pragma unroll 1
    for (int i = 0; i < g.n_inst; ++i) {
      const int* I = inst + i * KI_COLS;
      const int poff = I[KI_POFF];
      V res[2] = {V(0), V(0)};
      const bool dg = eval_instance<KMAX, V, V>(
          I[KI_KIND], [&](int a) { return V(xs.get(I[KI_IDS + a])); },
          [&](int k) { return V(p.get(poff + k)); }, res);
      put_rows<V, UNSAT>(out, i, I[KI_DIM], res, weight<V>(w32[i], w64[i]), I[KI_WORD],
                         uint32_t(I[KI_BIT]), unsat);
      if (dg) dg_out.set(I[KI_WORD], uint32_t(I[KI_BIT]));
    }
  }

  // As SmallLane::normal_equations, with each pair's factor slot from the
  // planner (KI_SLOTS) in the plain version's pair order.
  template <class XA, class RA>
  __device__ __forceinline__ void normal_equations(const XA& xs, const RA& rhs, FlagT& dj) {
    for (int k = 0; k < g.fill; ++k) A.set(k, 0.0f);
    for (int j = 0; j < n; ++j) jtr.set(j, 0.0f);
    dj.clear();
#pragma unroll 1
    for (int i = 0; i < g.n_inst; ++i) {
      const int* I = inst + i * KI_COLS;
      const int kind = I[KI_KIND], dim = I[KI_DIM], nv = I[KI_NV], poff = I[KI_POFF];
      const short* slot = reinterpret_cast<const short*>(I + KI_SLOTS);
      float cols[KMAX][2];
#pragma unroll
      for (int a = 0; a < KMAX; ++a) cols[a][0] = cols[a][1] = 0.0f;
      const bool dg = jac_instance<KMAX>(
          kind, [&](int a) { return xs.get(I[KI_IDS + a]); },
          [&](int k) { return float(p.get(poff + k)); }, cols);
      const float w = w32[i];
      const float r0 = rhs.get(2 * i), r1 = rhs.get(2 * i + 1);
#pragma unroll
      for (int a = 0; a < KMAX; ++a) {
        if (a < nv) {
          const int pa = I[KI_IDS + a];
          float acc = (cols[a][0] * w) * r0;
          if (dim > 1) acc = acc + (cols[a][1] * w) * r1;
          jtr.set(pa, jtr.get(pa) + acc);
#pragma unroll
          for (int b = 0; b < KMAX; ++b) {
            const int q = b < nv ? slot[a * MAX_NV + b] : -1;
            if (q >= 0) {
              float acc2 = (cols[a][0] * w) * (cols[b][0] * w);
              if (dim > 1) acc2 = acc2 + (cols[a][1] * w) * (cols[b][1] * w);
              A.set(q, A.get(q) + acc2);
            }
          }
        }
      }
      if (dg) dj.set(I[KI_WORD], uint32_t(I[KI_BIT]));
    }
  }

  __device__ __forceinline__ int diag(int i) const { return __ldg(g.row_start + i + 1) - 1; }

  // As SmallLane::solve, following the planner's schedules.
  __device__ __forceinline__ bool solve(float lam) {
    float maxdiag = fabsf(A.get(0));
    for (int i = 1; i < n; ++i) maxdiag = nmax(maxdiag, fabsf(A.get(diag(i))));
    const float lam_eff = nmax(lam, maxdiag * 1e-6f);
    for (int i = 0; i < n; ++i) A.set(diag(i), A.get(diag(i)) + lam_eff);
    int e = 0;
    for (int i = 0; i < n; ++i) {
      const int end = __ldg(g.row_start + i + 1);
      for (; e < end; ++e) {
        float s = A.get(e);
        const int q1 = __ldg(g.cr_start + e + 1);
        for (int q = __ldg(g.cr_start + e); q < q1; ++q) {
          const int pr = __ldg(g.cr_pair + q);
          s = s - A.get(pr & 0xffff) * A.get(pr >> 16);
        }
        A.set(e, e == end - 1 ? sqrtf(s) : s / A.get(diag(__ldg(g.ent_col + e))));
      }
    }
    bool fail = false;
    for (int i = 0; i < n; ++i) fail = fail || isnan(A.get(diag(i)));
    e = 0;
    for (int i = 0; i < n; ++i) {
      const int d = diag(i);
      for (; e < d; ++e)
        if (isnan(A.get(e))) A.set(e, 0.0f);
      const float di = A.get(d);
      A.set(d, (isnan(di) || di == 0.0f) ? 1.0f : di);
      e = d + 1;
    }
    e = 0;
    for (int i = 0; i < n; ++i) {
      const int d = diag(i);
      float s = -jtr.get(i);
      for (; e < d; ++e) s = s - A.get(e) * y.get(__ldg(g.ent_col + e));
      y.set(i, s / A.get(d));
      e = d + 1;
    }
    for (int i = n - 1; i >= 0; --i) {
      float s = y.get(i);
      const int q1 = __ldg(g.col_start + i + 1);
      for (int q = __ldg(g.col_start + i); q < q1; ++q) {
        const int ce = __ldg(g.col_ent + q);
        s = s - A.get(ce & 0xffff) * y.get(ce >> 16);
      }
      y.set(i, s / A.get(diag(i)));
    }
    if (fail)
      for (int k = 0; k < n; ++k) y.set(k, 0.0f);
    return fail;
  }

  __device__ __forceinline__ int out_col(int k) const { return __ldg(g.perm + k); }
  __device__ __forceinline__ int n_cons() const { return g.n_cons; }
};

// ---------------------------------------------------------------------------
// The LM phases, for either lane layout.

template <class RA>
__device__ __forceinline__ auto rows_max_abs(const RA& r, int m) -> decltype(r.get(0)) {
  auto acc = mabs(r.get(0));
#pragma unroll
  for (int i = 1; i < m; ++i) acc = nmax(acc, mabs(r.get(i)));
  return acc;
}

template <class RA>
__device__ __forceinline__ auto rows_sumsq(const RA& r, int m) -> decltype(r.get(0)) {
  auto s = r.get(0) * r.get(0);
#pragma unroll
  for (int i = 1; i < m; ++i) s = s + r.get(i) * r.get(i);
  return s;
}

// The step's max |component| (y holds the step).
template <class L>
__device__ __forceinline__ float step_max_abs(const L& l) {
  float acc = fabsf(l.y.get(0));
#pragma unroll
  for (int j = 1; j < l.n; ++j) acc = nmax(acc, fabsf(l.y.get(j)));
  return acc;
}

// The coarse phase of both kernels: up to s.coarse_trips f32 LM trips of
// one lane, from x0 (rounded to float) toward the per-lane tolerances
// max(tol, 1e-7 * max(1, |x0|_inf)). A done lane leaves the loop (later
// trips would change nothing). On return l.x holds the coarse point, l.r
// its residual rows, lam the carried damping and l.deg the degenerate
// words; coarse_its is the JAX coarse kernel's iteration count
// (pallas_fleet.py:753-759) and the result its converged flag.
template <class L>
__device__ __forceinline__ bool coarse_phase(L& l, const Settings& s, float& lam,
                                             int& coarse_its) {
  float scale = 1.0f;
#pragma unroll
  for (int j = 0; j < l.n; ++j) {
    const float v = float(l.x0(j));
    l.x.set(j, v);
    scale = nmax(scale, fabsf(v));
  }
  const float ctol_l = nmax(s.ctol, scale * 1e-7f);
  const float cstol_l = nmax(s.cstol, scale * 1e-7f);
  typename L::FlagT dj, dr, none;
  l.template rows<float, false>(l.x, l.r, l.deg, none);
  float r2 = rows_sumsq(l.r, l.m);
  lam = s.lam0;
  int it = 0, iters = 0;
  bool done = false;
#pragma unroll 1
  for (int trip = 0; trip < s.coarse_trips && !done; ++trip) {
    if (rows_max_abs(l.r, l.m) <= ctol_l) {
      done = true;
      iters = it;
      break;
    }
    l.normal_equations(l.x, l.r, dj);
    const bool fail = l.solve(lam);
    const float step_inf = step_max_abs(l);
#pragma unroll
    for (int j = 0; j < l.n; ++j) l.xn.set(j, l.x.get(j) + l.y.get(j));
    l.template rows<float, false>(l.xn, l.rn, dr, none);
    const float r2n = rows_sumsq(l.rn, l.m);
    const bool accept = !fail && r2n < r2;
    if (accept) {
      take(l.x, l.xn);
      take(l.r, l.rn);
      r2 = r2n;
      lam = lam * s.decr;
    } else {
      lam = lam * s.incr;
    }
    l.deg.add(dj, dr);
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
  const bool converged = rows_max_abs(l.r, l.m) <= ctol_l;
  coarse_its = converged ? it : s.coarse_trips;
  return converged;
}

// Phase 2 of the fused kernel: f64 residuals, f32 steps, from exactly the
// coarse point; each lane's budget is min(max(max_it - coarse_its, 0),
// refine_trips). Leaves the point in l.xd and the unsatisfied words in
// unsat; returns the converged flag, cnt the refine trips taken.
template <class L>
__device__ __forceinline__ bool refine_phase(L& l, const Settings& s, float lam,
                                             int coarse_its, int& cnt,
                                             typename L::FlagT& unsat) {
  const int refine_limit = min(max(s.max_it - coarse_its, 0), s.refine_trips);
  typename L::FlagT dj, dr, unsat_n;
#pragma unroll
  for (int j = 0; j < l.n; ++j) l.xd.set(j, double(l.x.get(j)));
  l.template rows<double, true>(l.xd, l.rd, dr, unsat);
  l.deg.add(dr, dr);
  double r2d = rows_sumsq(l.rd, l.m);
  cnt = 0;
  bool done = false;
#pragma unroll 1
  for (int trip = 0; trip < s.refine_trips; ++trip) {
    if (rows_max_abs(l.rd, l.m) <= s.rtol) {
      done = true;
      break;
    }
    if (cnt >= refine_limit) break;  // inactive from here on
#pragma unroll
    for (int j = 0; j < l.n; ++j) l.x.set(j, float(l.xd.get(j)));
#pragma unroll
    for (int i = 0; i < l.m; ++i) l.r.set(i, float(l.rd.get(i)));
    l.normal_equations(l.x, l.r, dj);
    const bool fail = l.solve(lam);
    const float step_inf = step_max_abs(l);
#pragma unroll
    for (int j = 0; j < l.n; ++j) l.xnd.set(j, l.xd.get(j) + double(l.y.get(j)));
    l.template rows<double, true>(l.xnd, l.rnd, dr, unsat_n);
    const double r2n = rows_sumsq(l.rnd, l.m);
    const bool accept = !fail && r2n < r2d;
    if (accept) {
      take(l.xd, l.xnd);
      take(l.rd, l.rnd);
      unsat = unsat_n;
      r2d = r2n;
      lam = lam * s.decr;
    } else {
      lam = lam * s.incr;
    }
    l.deg.add(dj, dr);
    ++cnt;
    if (!fail && step_inf <= s.stol) {
      done = true;
      break;
    }
  }
  return (rows_max_abs(l.rd, l.m) <= s.rtol) || done;
}

}  // namespace
