// Coarse f32 fleet solver for Hopper (sm_90a).
//
// Replaces ezpz_tpu/ops/pallas_fleet.py:make_coarse_fleet_solver (the
// Pallas kernel body at :642-763). Every sketch of a fleet shares one
// topology; each runs at most coarse_trips f32 Levenberg-Marquardt trips
// toward the per-lane tolerance max(tol, 1e-7 * max(1, |x0|_inf)) and writes
// the coarse point (f32), the iteration count, the converged flag and the
// degenerate flags. The batched f64-residual refinement
// (ezpz_tpu_torch/solver.py:solve_lm_refine) finishes the solve on the host
// side of PyTorch.
//
// What bounds it on the H100: the same as phase 1 of the fused kernel
// (fused_fleet.cu), whose device code it shares (coarse_phase in
// fleet_common.cuh). On the main path a sketch is 1 or 2 variables and 1 or
// 2 rows, a few hundred flops over at most 3 trips, against ~30 bytes read
// and written per sketch: the card's memory rate bounds the whole kernel far
// below what per-thread latency (dependent chains, local-memory arrays)
// makes it take.
//
// What the design does about it: one thread per sketch, table-driven from
// the same plan_fleet tables as the fused kernel, the same three compiled
// capacities (the host picks the smallest that fits), and per-lane early
// exit. Inputs are read once (x0 and params in f64, rounded to f32 as the
// JAX package's pack_fleet rounds them) and outputs written once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false, as
// the fused kernel: no FMA contraction, IEEE division and sqrt, so the
// kernel matches its plain version (ops/coarse_fleet.py) bit for bit. The C
// entry point returns the cudaError_t of the launch.

#include "fleet_common.cuh"

namespace {

template <int N, int R>
__global__ void __launch_bounds__(128)
coarse_fleet_kernel(const double* __restrict__ x0, const double* __restrict__ par,
                    int B, Topo t, Settings s, float* __restrict__ x_out,
                    int* __restrict__ it_out, uint8_t* __restrict__ conv_out,
                    uint8_t* __restrict__ deg_out) {
  constexpr int W = (R + 31) / 32;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int n = t.n;
  const double* p64 = par + (size_t)lane * t.P;

  float x[N], xn[N], step[N], jtr[N], y[N];
  float r[R], rn[R];
  float A[N * (N + 1) / 2];
  uint32_t deg[W], dj[W], dr[W];
  float lam;
  int its;
  const bool converged = coarse_phase<W>(t, s, x0 + (size_t)lane * n, p64, x,
                                         xn, step, jtr, y, r, rn, A, deg, dj,
                                         dr, lam, its);

  for (int j = 0; j < n; ++j) x_out[(size_t)lane * n + j] = x[j];
  it_out[lane] = its;
  conv_out[lane] = converged ? 1 : 0;
  for (int c = 0; c < t.n_cons; ++c)
    deg_out[(size_t)lane * t.n_cons + c] = (deg[c >> 5] >> (c & 31)) & 1u;
}

template <int N, int R>
int launch(const double* x0, const double* par, int B, const Topo& t,
           const Settings& s, float* x_out, int* it_out, uint8_t* conv_out,
           uint8_t* deg_out, cudaStream_t stream) {
  if (t.n > N || t.m > R || t.n_inst > R || t.n_cons > R) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  coarse_fleet_kernel<N, R><<<blocks, threads, 0, stream>>>(
      x0, par, B, t, s, x_out, it_out, conv_out, deg_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ezpz_coarse_fleet(int n_max, int rows_max, const double* x0, const double* par,
                      int B, int n, int m, int n_cons, int P, const int* inst,
                      int n_inst, const float* w32, const double* w64,
                      const int* perm, const int* inv, const uint8_t* nzl,
                      int trips, float ctol, float cstol, float lam0, float decr,
                      float incr, float* x_out, int* it_out, uint8_t* conv_out,
                      uint8_t* deg_out, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || m < 1 || n_inst < 1 || n_cons < 1) return (int)cudaErrorInvalidValue;
  const Topo t{inst, w32, w64, perm, inv, nzl, n_inst, n, m, n_cons, P};
  // The refine fields (refine_trips, max_it, stol, rtol) are unused here.
  const Settings s{trips, 0, 0, ctol, cstol, 0.0f, lam0, decr, incr, 0.0};
  cudaStream_t st = (cudaStream_t)stream;
  if (n_max == CAPS[0][0] && rows_max == CAPS[0][1])
    return launch<CAPS[0][0], CAPS[0][1]>(x0, par, B, t, s, x_out, it_out,
                                          conv_out, deg_out, st);
  if (n_max == CAPS[1][0] && rows_max == CAPS[1][1])
    return launch<CAPS[1][0], CAPS[1][1]>(x0, par, B, t, s, x_out, it_out,
                                          conv_out, deg_out, st);
  if (n_max == CAPS[2][0] && rows_max == CAPS[2][1])
    return launch<CAPS[2][0], CAPS[2][1]>(x0, par, B, t, s, x_out, it_out,
                                          conv_out, deg_out, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
