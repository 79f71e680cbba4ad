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
// variables, 1 or 2 residual rows), a few hundred flops each, against ~31
// and ~49 bytes read and written per sketch: the card's memory rate bounds
// the kernel (~0.16 ms per main-path solve). What keeps it from that bound
// is per-thread latency: every lane is a serial chain of 2-5 LM trips
// (Jacobian, factor, solve, re-evaluation), so the card needs many
// resident lanes whose state needs no memory round trip.
//
// What the design does about it (fleet_common.cuh):
//   * exact-shape instantiations (SMALL_SHAPES: 1x1, 2x2, 4x4, 8x8
//     variables x instances) keep the whole lane in registers: no local
//     memory arrays, row slots fixed per instance, variable ids resolved by
//     unrolled selects, the topology in the kernel's parameter space;
//   * each lane's parameters are read from memory once, before the trips;
//   * the Jacobian of an instance takes one dual-number evaluation that
//     carries all of its tangents;
//   * every other topology the kernel gate admits (<= 256 instances, a
//     planned fill <= 2080) takes fused_big_kernel: the instance table in
//     shared memory, loaded once per block, the lane state in
//     lane-interleaved scratch from the wrapper, the Crout factorization
//     as the planner's schedule of nonzero updates.
// Tensor cores, wgmma and TMA do not apply: a lane's system has 1-64
// variables and no two lanes share an operand tile.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (IEEE division and sqrt, no FMA contraction: the kernel stays
// comparable with the plain version bit for bit). The C entry points
// return the cudaError_t of the launch.

#include "fleet_common.cuh"

namespace {

struct Outputs {
  double* x;
  int* it;
  uint8_t* conv;
  uint8_t* sat;
  uint8_t* deg;
};

template <class L>
__device__ __forceinline__ void fused_lane(L& l, const Settings& s, int lane, int n,
                                           const Outputs& o) {
  float lam;
  int coarse_its, cnt;
  coarse_phase(l, s, lam, coarse_its);
  typename L::FlagT unsat;
  const bool converged = refine_phase(l, s, lam, coarse_its, cnt, unsat);
#pragma unroll
  for (int k = 0; k < l.n; ++k) {
    const int j = l.out_col(k);
    if (j >= 0) o.x[(size_t)lane * n + j] = l.xd.get(k);
  }
  o.it[lane] = coarse_its + cnt;
  o.conv[lane] = converged ? 1 : 0;
  const int nc = l.n_cons();
  for (int c = 0; c < nc; ++c) {
    o.sat[(size_t)lane * nc + c] = unsat.test(c) ? 0 : 1;
    o.deg[(size_t)lane * nc + c] = l.deg.test(c) ? 1 : 0;
  }
}

template <int NV, int NI>
__global__ void __launch_bounds__(THREADS, NV <= 2 ? SMALL_MIN_BLOCKS : 1)
fused_small_kernel(const double* __restrict__ x0, const double* __restrict__ par, int B,
                   const __grid_constant__ SmallTopo<NV, NI> t, const Settings s,
                   const Outputs o) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  SmallLane<NV, NI> l(t, x0 + (size_t)lane * t.n, par + (size_t)lane * t.P);
  fused_lane(l, s, lane, t.n, o);
}

__global__ void __launch_bounds__(THREADS)
fused_big_kernel(const double* __restrict__ x0, const double* __restrict__ par, int B,
                 const __grid_constant__ BigTopo g, const Settings s, float* fscr,
                 double* dscr, const Outputs o) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int* inst;
  const float* w32;
  const double* w64;
  load_shared_topology(g, smem, &inst, &w32, &w64);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  BigLane l(g, inst, w32, w64, x0 + (size_t)lane * g.n, par + (size_t)lane * g.P, fscr,
            dscr, lane, B, true);
  fused_lane(l, s, lane, g.n, o);
}

template <int NV, int NI>
int launch_small(const double* x0, const double* par, int B, int n, int n_cons, int P,
                 const int* inst, int n_inst, const float* w32, const double* w64,
                 const int* perm, unsigned long long fill, const Settings& s,
                 const Outputs& o, cudaStream_t stream) {
  if (n > NV || n_inst > NI || n_cons > 32) return (int)cudaErrorInvalidValue;
  SmallTopo<NV, NI> t{};
  for (int i = 0; i < NI; ++i) {
    for (int c = 0; c < KI_SMALL; ++c) t.inst[i][c] = i < n_inst ? inst[i * KI_COLS + c] : 0;
    if (i >= n_inst) t.inst[i][KI_KIND] = -1;
    t.w32[i] = i < n_inst ? w32[i] : 0.0f;
    t.w64[i] = i < n_inst ? w64[i] : 0.0;
  }
  t.fill = fill;
  for (int k = 0; k < NV; ++k) {
    t.perm[k] = k < n ? perm[k] : -1;
    if (k >= n) t.fill |= 1ull << tri(k, k);
  }
  t.n = n;
  t.n_cons = n_cons;
  t.P = P;
  const int blocks = (B + THREADS - 1) / THREADS;
  fused_small_kernel<NV, NI><<<blocks, THREADS, 0, stream>>>(x0, par, B, t, s, o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ezpz_small_shape(int idx, int* nv, int* ni) {
  if (idx < 0 || idx >= N_SMALL) return 1;
  *nv = SMALL_SHAPES[idx][0];
  *ni = SMALL_SHAPES[idx][1];
  return 0;
}

const char* ezpz_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Small path: inst (n_inst, KI_COLS), w32, w64 and perm are HOST arrays,
// copied into the kernel's parameters.
int ezpz_fused_fleet_small(int nv, int ni, const double* x0, const double* par, int B, int n,
                           int n_cons, int P, const int* inst, int n_inst, const float* w32,
                           const double* w64, const int* perm, unsigned long long fill,
                           int coarse_trips, int refine_trips, int max_it, float ctol,
                           float cstol, float stol, double rtol, float lam0, float decr,
                           float incr, double* x_out, int* it_out, uint8_t* conv_out,
                           uint8_t* sat_out, uint8_t* deg_out, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n_inst < 1 || n_cons < 1) return (int)cudaErrorInvalidValue;
  const Settings s{coarse_trips, refine_trips, max_it, ctol, cstol, stol,
                   lam0, decr, incr, rtol};
  const Outputs o{x_out, it_out, conv_out, sat_out, deg_out};
  cudaStream_t st = (cudaStream_t)stream;
#define EZPZ_SMALL(NV_, NI_)                                                          \
  if (nv == NV_ && ni == NI_)                                                         \
    return launch_small<NV_, NI_>(x0, par, B, n, n_cons, P, inst, n_inst, w32, w64,   \
                                  perm, fill, s, o, st);
  EZPZ_SMALL(1, 1)
  EZPZ_SMALL(2, 2)
  EZPZ_SMALL(4, 4)
  EZPZ_SMALL(8, 8)
#undef EZPZ_SMALL
  return (int)cudaErrorInvalidValue;
}

// Big path: every table is a DEVICE array; fscr/dscr are the lane-
// interleaved scratch (BigSlots(...).F32 floats and .F64 doubles per lane).
int ezpz_fused_fleet_big(const double* x0, const double* par, int B, int n, int n_cons, int P,
                         const int* inst, int n_inst, const float* w32, const double* w64,
                         const int* perm, const int* row_start, const int* ent_col,
                         const int* cr_start, const int* cr_pair, const int* col_start,
                         const int* col_ent, int fill, float* fscr, double* dscr,
                         int coarse_trips, int refine_trips, int max_it, float ctol,
                         float cstol, float stol, double rtol, float lam0, float decr,
                         float incr, double* x_out, int* it_out, uint8_t* conv_out,
                         uint8_t* sat_out, uint8_t* deg_out, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n_inst < 1 || n_inst > 256 || n_cons < 1 || n_cons > 256 || fill >= 65536 ||
      n >= 65536)
    return (int)cudaErrorInvalidValue;
  const BigTopo g{inst, w32, w64, perm, row_start, ent_col, cr_start, cr_pair,
                  col_start, col_ent, n, n_inst, n_cons, P, fill};
  const Settings s{coarse_trips, refine_trips, max_it, ctol, cstol, stol,
                   lam0, decr, incr, rtol};
  const Outputs o{x_out, it_out, conv_out, sat_out, deg_out};
  const size_t smem = big_shared_bytes(n_inst);
  cudaError_t err = cudaFuncSetAttribute(fused_big_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + THREADS - 1) / THREADS;
  fused_big_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(x0, par, B, g, s, fscr,
                                                                    dscr, o);
  return (int)cudaGetLastError();
}

// Resident threads per SM of an instantiation (nv = 0: the big-topology
// kernel with the shared memory of n_inst instances), for the record of
// registers against occupancy.
int ezpz_fused_fleet_occupancy(int nv, int ni, int n_inst, int* threads_per_sm) {
  size_t smem = 0;
  const void* fn = nullptr;
  if (nv == 0) {
    fn = (const void*)fused_big_kernel;
    smem = big_shared_bytes(n_inst);
    const cudaError_t err = cudaFuncSetAttribute(
        fused_big_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
#define EZPZ_SMALL(NV_, NI_) \
  if (nv == NV_ && ni == NI_) fn = (const void*)fused_small_kernel<NV_, NI_>;
  EZPZ_SMALL(1, 1)
  EZPZ_SMALL(2, 2)
  EZPZ_SMALL(4, 4)
  EZPZ_SMALL(8, 8)
#undef EZPZ_SMALL
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, smem);
  *threads_per_sm = blocks * THREADS;
  return (int)err;
}

}  // extern "C"
