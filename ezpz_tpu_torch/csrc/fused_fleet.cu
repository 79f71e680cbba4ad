// Fused mixed-precision fleet solver for Hopper (sm_90a).
//
// Replaces ezpz_tpu/ops/pallas_fleet.py:make_fused_fleet_solver (the Pallas
// kernel body at :950-1174). Every sketch of a fleet shares one topology;
// each runs a fixed budget of Levenberg-Marquardt trips: phase 1 in f32
// toward a per-lane coarse tolerance, phase 2 with native f64 residuals and
// f32 steps toward the absolute 1e-8 tolerance (the TPU kernel emulates f64
// with double-single arithmetic; the H100 has f64, so this kernel does not).
//
// What bounds it on the H100: the main path's sketches are tiny (1 or 2
// variables, 1 or 2 residual rows), so a sketch is a few hundred flops and
// 8-24 bytes of input per trip budget. The work is latency-bound per thread
// (long dependent chains: Jacobian, factorization, solve, re-evaluation) and
// the kernel as a whole is bound by reading x0/pars and writing x and the
// flags once (~40 bytes per sketch), far below the 3.35 TB/s the card offers.
// Larger topologies are bound by per-thread local memory: the factor of an
// n-variable sketch is n(n+1)/2 floats.
//
// What the design does about it:
//   * one thread per sketch, no inter-thread communication; the sketch's
//     whole state (x, residual rows, packed factor, lambda, counters, flag
//     words) lives in registers or local memory, and the loop exits per
//     lane as soon as the lane is done (trips on a done lane change nothing);
//   * table-driven: one build serves every topology. The host uploads the
//     instance table (kind, var ids, parameter offset, weight, constraint
//     id), the planned elimination order and the factor's fill mask; all
//     threads read the same table entries (broadcast loads);
//   * a few compile-time capacities (CAPS in fleet_common.cuh) size the
//     local arrays; the host picks the smallest that holds the topology,
//     so the 1- and 2-variable main-path buckets run with tiny frames;
//   * Jacobian columns by forward-mode dual numbers (one tangent per
//     instance variable, as jax.jvp with one-hot tangents does in the TPU
//     kernel), with derivative formulas written as torch's forward-mode
//     rules so the plain PyTorch version agrees operation for operation.
//
// Phase 1 is coarse_phase of fleet_common.cuh, which the coarse kernel
// (coarse_fleet.cu) runs on its own.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (IEEE division and sqrt, no FMA contraction: the f32 phase stays
// comparable with the plain version). The C entry points return the
// cudaError_t of the launch.

#include "fleet_common.cuh"

namespace {

template <int N, int R>
__global__ void __launch_bounds__(128)
fused_fleet_kernel(const double* __restrict__ x0, const double* __restrict__ par,
                   int B, Topo t, Settings s, double* __restrict__ x_out,
                   int* __restrict__ it_out, uint8_t* __restrict__ conv_out,
                   uint8_t* __restrict__ sat_out, uint8_t* __restrict__ deg_out) {
  constexpr int W = (R + 31) / 32;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int n = t.n, m = t.m;
  const double* p64 = par + (size_t)lane * t.P;

  float x[N], xn[N], step[N], jtr[N], y[N];
  float r[R], rn[R];
  float A[N * (N + 1) / 2];
  uint32_t deg[W], dj[W], dr[W];

  // ---- phase 1: f32 LM toward the per-lane coarse tolerance
  float lam;
  int coarse_its;
  coarse_phase<W>(t, s, x0 + (size_t)lane * n, p64, x, xn, step, jtr, y, r,
                  rn, A, deg, dj, dr, lam, coarse_its);
  const int refine_limit = min(max(s.max_it - coarse_its, 0), s.refine_trips);

  // ---- phase 2: f64 residuals, f32 steps, from exactly the coarse point
  double xd[N], xnd[N], rd[R], rnd[R];
  uint32_t unsat[W], unsat_n[W];
  for (int j = 0; j < n; ++j) xd[j] = double(x[j]);
  residual_rows<double, W>(t, xd, p64, rd, dr, unsat);
  for (int w = 0; w < W; ++w) deg[w] |= dr[w];
  double r2d = rows_sumsq(rd, m);
  int cnt = 0;
  bool done = false;
  for (int trip = 0; trip < s.refine_trips; ++trip) {
    if (rows_max_abs(rd, m) <= s.rtol) {
      done = true;
      break;
    }
    if (cnt >= refine_limit) break;  // inactive from here on
    for (int j = 0; j < n; ++j) x[j] = float(xd[j]);
    for (int i = 0; i < m; ++i) r[i] = float(rd[i]);
    normal_equations<W>(t, x, p64, r, A, jtr, dj);
    const bool fail = damped_solve(t, A, jtr, lam, step, y);
    float step_inf = fabsf(step[0]);
    for (int j = 1; j < n; ++j) step_inf = nmax(step_inf, fabsf(step[j]));
    for (int j = 0; j < n; ++j) xnd[j] = xd[j] + double(step[j]);
    residual_rows<double, W>(t, xnd, p64, rnd, dr, unsat_n);
    const double r2n = rows_sumsq(rnd, m);
    const bool accept = !fail && r2n < r2d;
    if (accept) {
      for (int j = 0; j < n; ++j) xd[j] = xnd[j];
      for (int i = 0; i < m; ++i) rd[i] = rnd[i];
      for (int w = 0; w < W; ++w) unsat[w] = unsat_n[w];
      r2d = r2n;
      lam = lam * s.decr;
    } else {
      lam = lam * s.incr;
    }
    for (int w = 0; w < W; ++w) deg[w] |= dj[w] | dr[w];
    ++cnt;
    if (!fail && step_inf <= s.stol) {
      done = true;
      break;
    }
  }
  const bool converged = (rows_max_abs(rd, m) <= s.rtol) || done;

  for (int j = 0; j < n; ++j) x_out[(size_t)lane * n + j] = xd[j];
  it_out[lane] = coarse_its + cnt;
  conv_out[lane] = converged ? 1 : 0;
  for (int c = 0; c < t.n_cons; ++c) {
    const uint32_t bit = 1u << (c & 31);
    sat_out[(size_t)lane * t.n_cons + c] = (unsat[c >> 5] & bit) ? 0 : 1;
    deg_out[(size_t)lane * t.n_cons + c] = (deg[c >> 5] & bit) ? 1 : 0;
  }
}

template <int N, int R>
int launch(const double* x0, const double* par, int B, const Topo& t,
           const Settings& s, double* x_out, int* it_out, uint8_t* conv_out,
           uint8_t* sat_out, uint8_t* deg_out, cudaStream_t stream) {
  if (t.n > N || t.m > R || t.n_inst > R || t.n_cons > R) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  fused_fleet_kernel<N, R><<<blocks, threads, 0, stream>>>(
      x0, par, B, t, s, x_out, it_out, conv_out, sat_out, deg_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ezpz_fused_fleet_capacity(int idx, int* n_max, int* rows_max) {
  if (idx < 0 || idx >= N_CAPS) return 1;
  *n_max = CAPS[idx][0];
  *rows_max = CAPS[idx][1];
  return 0;
}

const char* ezpz_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int ezpz_fused_fleet(int n_max, int rows_max, const double* x0, const double* par,
                     int B, int n, int m, int n_cons, int P, const int* inst,
                     int n_inst, const float* w32, const double* w64,
                     const int* perm, const int* inv, const uint8_t* nzl,
                     int coarse_trips, int refine_trips, int max_it, float ctol,
                     float cstol, float stol, double rtol, float lam0, float decr,
                     float incr, double* x_out, int* it_out, uint8_t* conv_out,
                     uint8_t* sat_out, uint8_t* deg_out, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || m < 1 || n_inst < 1 || n_cons < 1) return (int)cudaErrorInvalidValue;
  const Topo t{inst, w32, w64, perm, inv, nzl, n_inst, n, m, n_cons, P};
  const Settings s{coarse_trips, refine_trips, max_it, ctol, cstol, stol,
                   lam0, decr, incr, rtol};
  cudaStream_t st = (cudaStream_t)stream;
  if (n_max == CAPS[0][0] && rows_max == CAPS[0][1])
    return launch<CAPS[0][0], CAPS[0][1]>(x0, par, B, t, s, x_out, it_out,
                                          conv_out, sat_out, deg_out, st);
  if (n_max == CAPS[1][0] && rows_max == CAPS[1][1])
    return launch<CAPS[1][0], CAPS[1][1]>(x0, par, B, t, s, x_out, it_out,
                                          conv_out, sat_out, deg_out, st);
  if (n_max == CAPS[2][0] && rows_max == CAPS[2][1])
    return launch<CAPS[2][0], CAPS[2][1]>(x0, par, B, t, s, x_out, it_out,
                                          conv_out, sat_out, deg_out, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
