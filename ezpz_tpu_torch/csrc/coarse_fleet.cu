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
// (fused_fleet.cu), whose device code it shares (coarse_phase and the two
// lane layouts of fleet_common.cuh). On the main path a sketch is 1 or 2
// variables and 1 or 2 rows, a few hundred flops over at most 3 trips,
// against ~26 and ~39 bytes read and written per sketch: the memory rate
// bounds the kernel, per-thread latency is what keeps it from that bound.
//
// What the design does about it: the fused kernel's (exact-shape lanes in
// registers with the topology in the parameter space, parameters read
// once, one dual-number evaluation per instance for the Jacobian, and the
// shared-memory/scratch layout with a scheduled Crout for every other
// admitted topology). Inputs are read once (x0 and params in f64, rounded
// to f32 as the JAX package's pack_fleet rounds them) and outputs written
// once. Tensor cores, wgmma and TMA do not apply (see fused_fleet.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false, as
// the fused kernel: no FMA contraction, IEEE division and sqrt, so the
// kernel matches its plain version (ops/coarse_fleet.py) bit for bit. The C
// entry points return the cudaError_t of the launch.

#include "fleet_common.cuh"

namespace {

struct Outputs {
  float* x;
  int* it;
  uint8_t* conv;
  uint8_t* deg;
};

template <class L>
__device__ __forceinline__ void coarse_lane(L& l, const Settings& s, int lane, int n,
                                            const Outputs& o) {
  float lam;
  int its;
  const bool converged = coarse_phase(l, s, lam, its);
#pragma unroll
  for (int k = 0; k < l.n; ++k) {
    const int j = l.out_col(k);
    if (j >= 0) o.x[(size_t)lane * n + j] = l.x.get(k);
  }
  o.it[lane] = its;
  o.conv[lane] = converged ? 1 : 0;
  const int nc = l.n_cons();
  for (int c = 0; c < nc; ++c) o.deg[(size_t)lane * nc + c] = l.deg.test(c) ? 1 : 0;
}

template <int NV, int NI>
__global__ void __launch_bounds__(THREADS, NV <= 2 ? SMALL_MIN_BLOCKS : 1)
coarse_small_kernel(const double* __restrict__ x0, const double* __restrict__ par, int B,
                    const __grid_constant__ SmallTopo<NV, NI> t, const Settings s,
                    const Outputs o) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  SmallLane<NV, NI> l(t, x0 + (size_t)lane * t.n, par + (size_t)lane * t.P);
  coarse_lane(l, s, lane, t.n, o);
}

__global__ void __launch_bounds__(THREADS)
coarse_big_kernel(const double* __restrict__ x0, const double* __restrict__ par, int B,
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
            dscr, lane, B, false);
  coarse_lane(l, s, lane, g.n, o);
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
  coarse_small_kernel<NV, NI><<<blocks, THREADS, 0, stream>>>(x0, par, B, t, s, o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Small path: inst (n_inst, KI_COLS), w32, w64 and perm are HOST arrays,
// copied into the kernel's parameters.
int ezpz_coarse_fleet_small(int nv, int ni, const double* x0, const double* par, int B, int n,
                            int n_cons, int P, const int* inst, int n_inst, const float* w32,
                            const double* w64, const int* perm, unsigned long long fill,
                            int trips, float ctol, float cstol, float lam0, float decr,
                            float incr, float* x_out, int* it_out, uint8_t* conv_out,
                            uint8_t* deg_out, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n_inst < 1 || n_cons < 1) return (int)cudaErrorInvalidValue;
  // The refine fields (refine_trips, max_it, stol, rtol) are unused here.
  const Settings s{trips, 0, 0, ctol, cstol, 0.0f, lam0, decr, incr, 0.0};
  const Outputs o{x_out, it_out, conv_out, deg_out};
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
int ezpz_coarse_fleet_big(const double* x0, const double* par, int B, int n, int n_cons, int P,
                          const int* inst, int n_inst, const float* w32, const double* w64,
                          const int* perm, const int* row_start, const int* ent_col,
                          const int* cr_start, const int* cr_pair, const int* col_start,
                          const int* col_ent, int fill, float* fscr, double* dscr, int trips,
                          float ctol, float cstol, float lam0, float decr, float incr,
                          float* x_out, int* it_out, uint8_t* conv_out, uint8_t* deg_out,
                          void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n_inst < 1 || n_inst > 256 || n_cons < 1 || n_cons > 256 || fill >= 65536 ||
      n >= 65536)
    return (int)cudaErrorInvalidValue;
  const BigTopo g{inst, w32, w64, perm, row_start, ent_col, cr_start, cr_pair,
                  col_start, col_ent, n, n_inst, n_cons, P, fill};
  const Settings s{trips, 0, 0, ctol, cstol, 0.0f, lam0, decr, incr, 0.0};
  const Outputs o{x_out, it_out, conv_out, deg_out};
  const size_t smem = big_shared_bytes(n_inst);
  cudaError_t err = cudaFuncSetAttribute(coarse_big_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + THREADS - 1) / THREADS;
  coarse_big_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(x0, par, B, g, s, fscr,
                                                                     dscr, o);
  return (int)cudaGetLastError();
}

// Resident threads per SM of an instantiation (nv = 0: the big-topology
// kernel with the shared memory of n_inst instances), for the record of
// registers against occupancy.
int ezpz_coarse_fleet_occupancy(int nv, int ni, int n_inst, int* threads_per_sm) {
  size_t smem = 0;
  const void* fn = nullptr;
  if (nv == 0) {
    fn = (const void*)coarse_big_kernel;
    smem = big_shared_bytes(n_inst);
    const cudaError_t err = cudaFuncSetAttribute(
        coarse_big_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
#define EZPZ_SMALL(NV_, NI_) \
  if (nv == NV_ && ni == NI_) fn = (const void*)coarse_small_kernel<NV_, NI_>;
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
