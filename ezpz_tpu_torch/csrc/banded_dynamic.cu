// The dynamic-width banded SPD kernel: factor, forward and backward
// substitution of B bands in one launch, one warp per lane, for bands
// wider than the warp kernel's largest capacity (32), up to bw = 237 in
// f32 and 166 in f64 (banded_spd.cu takes the narrower bands, and the
// wider ones by its general-width kernel).
//
// Replaces, at those widths, ezpz_tpu/ops/banded.py's banded_spd_solve
// (banded_cholesky at :37 and banded_solve at :85), as banded_spd.cu's
// kernels do at theirs.
//
// What bounds it: the rows' serial chain, not bytes or operations (a lane
// is n * bw dependent divisions long against ~4 n (bw + 3) bytes in f32).
// The design is banded_spd.cu's warp kernel with the band width a run-time
// argument:
//
// - Thread d owns entries d, d + 32, ... of the row being factored (K =
//   ceil((bw + 1) / 32) slots, a template parameter) with their running
//   sums in registers, so a link is one division by a reciprocal taken
//   before the row, one shuffle and K multiply-adds, and no sum touches
//   memory. The division is banded_spd.cu's: div.rn's fast path, the lane
//   solved again with div.rn where a kept quotient left its range, a zero
//   numerator answered as itself.
// - The ring (the factor window, bw + 1 rows, and STAGE staged band rows)
//   is sized at launch in dynamic shared memory, past 48 KB by the
//   kernel's opt-in attribute, at banded_spd.cu's odd-stride rule, with as
//   many lanes a block (at most 4) as keep the most lanes resident on an
//   SM. The window values a step adds are read from the ring a step ahead.
//   One lane must fit a block's 227 KB, which bounds bw at 237 in f32 and
//   166 in f64.
// - Rows are staged by cp.async, as in the warp kernel: TMA's bulk copies
//   need sizes and addresses that are multiples of 16 bytes, which a (bw +
//   1)-entry row of the callers' layout generally is not. The backward
//   pass streams the factor rows back through the same ring in reverse.
// - The forward substitution of the first right-hand side is fused into
//   the factor loop; further right-hand sides take a separate pass.
//
// Arithmetic is the plain version's (ops/banded.py) in the same order, as
// in banded_spd.cu, so that the kernel agrees with it bit for bit.

#include <atomic>
#include <type_traits>

#include "banded_common.cuh"

namespace {

// The dynamic-width kernel: the warp kernel's design with the band width a
// run-time argument. Thread d owns entries d, d + 32, ..., one slot of K
// each (K = ceil((bw + 1) / 32), a template parameter), holding the
// entry's band value, running sum, divisor and its reciprocal in
// registers; the factor window and the staged rows live in a per-lane ring
// in dynamic shared memory, (bw + 1 + STAGE) rows at an odd stride minus
// one (dyn_stride), sized at launch. The window values are read from the
// ring one step ahead of the step that adds them. A block may use
// DYN_BLOCK_SMEM bytes (the opt-in limit): one lane fits up to bw =
// dyn_max_bw<T>() (237 in f32, 166 in f64), so float takes K 2..8 and
// double 2..6. Mirrored by _build.BANDED_DYN_BLOCK_SMEM,
// _build.banded_dyn_lane_bytes and _build.banded_dyn_max_bw.
constexpr int DYN_BLOCK_SMEM = 232448;

__host__ __device__ constexpr int dyn_stride(int bw) { return bw % 2 == 0 ? bw + 2 : bw + 3; }
__host__ __device__ constexpr int dyn_lane_elems(int bw) {
  return (bw + 1 + STAGE) * dyn_stride(bw);
}
template <typename T>
constexpr int dyn_lane_bytes(int bw) {
  return dyn_lane_elems(bw) * static_cast<int>(sizeof(T));
}
template <typename T>
constexpr int dyn_max_bw() {
  int bw = 0;
  while (dyn_lane_bytes<T>(bw + 1) <= DYN_BLOCK_SMEM) ++bw;
  return bw;
}
template <typename T>
constexpr int dyn_max_slots() { return (dyn_max_bw<T>() + 1 + 31) / 32; }
static_assert(dyn_max_bw<float>() == 237 && dyn_max_bw<double>() == 166,
              "the dynamic-width kernel's limits are mirrored in _build");
static_assert(dyn_max_slots<float>() == 8 && dyn_max_slots<double>() == 6,
              "slots per thread at each type's widest band");

// stage_row for K slots: entry e by thread e % 32, the extra value by
// thread (bw + 1) % 32.
template <typename T, int K>
__device__ __forceinline__ void stage_row_dyn(unsigned dst, const T* row, const T* extra,
                                              int bw, int tid) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = tid + 32 * k;
    if (e <= bw) cp_async<sizeof(T)>(dst + e * sizeof(T), row + e);
  }
  if (tid == ((bw + 1) & 31)) cp_async<sizeof(T)>(dst + (bw + 1) * sizeof(T), extra);
}

// The sum, in order d = 0..terms-1, of entry d's p (thread d % 32's slot
// d / 32); every thread returns it. A chunk's 32 shuffles are issued
// before its adds.
template <typename T, int K>
__device__ __forceinline__ T ordered_sum_dyn(const T (&p)[K], int terms) {
  T s = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (32 * k < terms) {
      T v[32];
#pragma unroll
      for (int l = 0; l < 32; ++l) v[l] = __shfl_sync(FULL, p[k], l);
#pragma unroll
      for (int l = 0; l < 32; ++l) s = 32 * k + l < terms ? s + v[l] : s;
    }
  }
  return s;
}

// One lane's solve by the dynamic-width kernel's warp: solve_lane's steps
// with K slots a thread and the ring's geometry computed from bw. SAFE as
// in solve_lane.
template <typename T, int K, bool SAFE>
__device__ __forceinline__ bool solve_lane_dyn(const T* __restrict__ ab,
                                               const T* __restrict__ rhs, T* __restrict__ lb,
                                               T* __restrict__ x,
                                               unsigned char* __restrict__ fail, T* win, int n,
                                               int bw, int m, int tid) {
  const int S = dyn_stride(bw);
  const int R = bw + 1;            // factor window rows
  const int RB = R + STAGE;        // backward ring rows (the whole buffer)
  const unsigned ROW = S * sizeof(T);
  T* const stage = win + R * S;
  const unsigned win_s = static_cast<unsigned>(__cvta_generic_to_shared(win));
  const unsigned stage_s = win_s + R * ROW;
  const int bwp1 = bw + 1;
  const int dq = bw & 31;        // writes the diagonal
  const int xo = (bw + 1) & 31;  // stages and writes the right-hand side / y / x
  bool off = false;

  // Factor, with the forward substitution of column 0. The window starts
  // as identity rows above the top.
  __syncwarp();
  for (int r = 0; r < R; ++r)
    for (int c = tid; c < S; c += 32) win[r * S + c] = c == bw ? T(1) : T(0);
#pragma unroll
  for (int r = 0; r < STAGE; ++r) {
    if (r < n) stage_row_dyn<T, K>(stage_s + r * ROW, ab + static_cast<size_t>(r) * bwp1, rhs + static_cast<size_t>(r) * m, bw, tid);
    cp_async_commit();
  }
  bool bad_any = false;
  T yh[K];  // slot k of thread d: y[i - bw + d + 32 k] (zero above the top)
#pragma unroll
  for (int k = 0; k < K; ++k) yh[k] = T(0);
  int cur = 0;  // window slot of row i
  const T* ab_next = ab + static_cast<size_t>(STAGE) * bwp1;  // row i + STAGE
  const T* rhs_next = rhs + static_cast<size_t>(STAGE) * m;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGE - 1>();
    __syncwarp();
    const int slot = i % STAGE;
    const T* st = stage + slot * S;
    // Entry d = tid + 32 k's window row j = i - bw + d: wp[k][t] = L[j, t -
    // d + bw] (read for t < d; the reads past it stay inside the buffer,
    // as in solve_lane), its divisor L[j, bw] and the divisor's reciprocal.
    T a[K], wd[K], wr[K];
    const T* wp[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = tid + 32 * k;
      const bool act = d < bw;
      int sd = cur - bw + d;
      if (sd < 0) sd += R;
      a[k] = act ? st[d] : T(0);
      wp[k] = win + (act ? sd * S + bw - d : 0);
      wd[k] = act ? wp[k][d] : T(1);
      wr[k] = recip(wd[k]);
    }
    const T a_diag = st[bw];
    const T b_i = st[bw + 1];
    T s[K], own[K], wn[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s[k] = T(0);
      own[k] = T(0);
      wn[k] = wp[k][0];
    }
    // Step t = 32 k + t0: entry t is thread t0's slot k; slot k's later
    // entries (tid > t0) and every entry of the slots after it add
    // r * L[j, t - d + bw]. Every thread takes the diagonal's sum.
    T s_diag = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int steps = min(32, bw - 32 * k);
#pragma unroll 4
      for (int t0 = 0; t0 < steps; ++t0) {
        const int t = 32 * k + t0;
        T wc[K];
#pragma unroll
        for (int kk = k; kk < K; ++kk) {
          wc[kk] = wn[kk];
          wn[kk] = wp[kk][t + 1];
        }
        const T r = __shfl_sync(FULL, quot<SAFE>(a[k] - s[k], wd[k], wr[k]), t0);
        if (tid == t0) own[k] = r;
        if (tid > t0 && tid + 32 * k < bw) s[k] = s[k] + r * wc[k];
#pragma unroll
        for (int kk = k + 1; kk < K; ++kk)
          if (tid + 32 * kk < bw) s[kk] = s[kk] + r * wc[kk];
        s_diag = s_diag + r * r;
      }
    }
    // Each entry's sum stopped at its own step, so a - s is its numerator:
    // whether the fast path's quotient was div.rn's is asked off the chain.
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (!SAFE) off = off | ((tid + 32 * k < bw) & !fast_ok(a[k] - s[k], wd[k], wr[k]));
    // Every thread holds the same diagonal. A failed pivot is sanitised
    // to 1.
    const T diag2 = a_diag - s_diag;
    const bool bad = !(diag2 > T(0)) | !bfinite(diag2);
    const T root = bsqrt(bad ? T(1) : diag2);
    bad_any = bad_any | bad;
    const T diag = bad ? T(1) : root;
    T* wrow = win + cur * S;
    T* lrow = lb + static_cast<size_t>(i) * bwp1;
    T p[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = tid + 32 * k;
      if (d < bw) {
        wrow[d] = own[k];
        lrow[d] = own[k];
      }
      p[k] = d < bw ? own[k] * yh[k] : T(0);
    }
    if (tid == dq) {
      wrow[bw] = diag;
      lrow[bw] = diag;
    }
    // Forward: y[i] = (b[i] - sum_d L[i, i-bw+d] y[i-bw+d]) / L[i, i].
    const T y_num = b_i - ordered_sum_dyn<T, K>(p, bw);
    const T diag_rcp = recip(diag);
    const T y_i = quot<SAFE>(y_num, diag, diag_rcp);
    if (!SAFE) off = off | !fast_ok(y_num, diag, diag_rcp);
    // The window moves down one entry across the slots.
    T next[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T up = __shfl_down_sync(FULL, yh[k], 1);
      const T carry = k + 1 < K ? __shfl_sync(FULL, yh[k + 1 < K ? k + 1 : k], 0) : T(0);
      next[k] = tid + 32 * k == bw - 1 ? y_i : tid == 31 ? carry : up;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) yh[k] = next[k];
    if (tid == xo) x[static_cast<size_t>(i) * m] = y_i;
    __syncwarp();
    if (i + STAGE < n) stage_row_dyn<T, K>(stage_s + slot * ROW, ab_next, rhs_next, bw, tid);
    cp_async_commit();
    ab_next += bwp1;
    rhs_next += m;
    cur = cur + 1 == R ? 0 : cur + 1;
  }
  if (!SAFE && __any_sync(FULL, off)) return true;
  if (tid == 0) *fail = bad_any ? 1 : 0;
  if (bad_any) {
    for (size_t e = tid; e < static_cast<size_t>(n) * m; e += 32) x[e] = T(0);
    return false;
  }
  __syncwarp();

  // Forward substitution of columns 1..m-1, reading the factor back.
  for (int c = 1; c < m; ++c) {
    T yc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) yc[k] = T(0);
    for (int i = 0; i < n; ++i) {
      const T* lrow = lb + static_cast<size_t>(i) * bwp1;
      T p[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = tid + 32 * k;
        p[k] = d < bw ? lrow[d] * yc[k] : T(0);
      }
      const T y_num = rhs[static_cast<size_t>(i) * m + c] - ordered_sum_dyn<T, K>(p, bw);
      const T diag = lrow[bw], diag_rcp = recip(diag);
      const T y_i = quot<SAFE>(y_num, diag, diag_rcp);
      if (!SAFE) off = off | !fast_ok(y_num, diag, diag_rcp);
      T next[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T up = __shfl_down_sync(FULL, yc[k], 1);
        const T carry = k + 1 < K ? __shfl_sync(FULL, yc[k + 1 < K ? k + 1 : k], 0) : T(0);
        next[k] = tid + 32 * k == bw - 1 ? y_i : tid == 31 ? carry : up;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) yc[k] = next[k];
      if (tid == xo) x[static_cast<size_t>(i) * m + c] = y_i;
    }
  }
  // The backward pass stages factor rows and y, written above, by cp.async.
  __threadfence_block();
  __syncwarp();

  // Backward with L^T: x[i] = (y[i] - sum_{t=1..bw, i+t<n} L[i+t, i] x[i+t])
  // / L[i, i]; entry d = tid + 32 k holds x[i + 1 + d] and reads L[i + 1 +
  // d, bw - 1 - d] from the ring.
  T* const ring = win;
  for (int c = 0; c < m; ++c) {
#pragma unroll
    for (int r = 0; r < STAGE; ++r) {
      const int row = n - 1 - r;
      if (row >= 0) stage_row_dyn<T, K>(win_s + (row % RB) * ROW, lb + static_cast<size_t>(row) * bwp1, x + static_cast<size_t>(row) * m + c, bw, tid);
      cp_async_commit();
    }
    T xh[K];
#pragma unroll
    for (int k = 0; k < K; ++k) xh[k] = T(0);
    int si = (n - 1) % RB;  // ring slot of row i
    for (int i = n - 1; i >= 0; --i) {
      cp_async_wait<STAGE - 1>();
      __syncwarp();
      const T* cr = ring + si * S;
      const T diag = cr[bw];
      const T diag_rcp = recip(diag);
      const T y_i = cr[bw + 1];
      const int terms = min(bw, n - 1 - i);
      T p[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = tid + 32 * k;
        int sj = si + 1 + d;  // slot of row i + 1 + d
        if (sj >= RB) sj -= RB;
        p[k] = d < terms ? ring[sj * S + bw - 1 - d] * xh[k] : T(0);
      }
      const T x_num = y_i - ordered_sum_dyn<T, K>(p, terms);
      const T x_i = quot<SAFE>(x_num, diag, diag_rcp);
      if (!SAFE) off = off | !fast_ok(x_num, diag, diag_rcp);
      // The window moves up one entry across the slots.
      T next[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T up = __shfl_up_sync(FULL, xh[k], 1);
        const T carry = k > 0 ? __shfl_sync(FULL, xh[k > 0 ? k - 1 : 0], 31) : x_i;
        next[k] = tid == 0 ? carry : up;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) xh[k] = next[k];
      if (tid == xo) x[static_cast<size_t>(i) * m + c] = x_i;
      __syncwarp();
      const int nx = i - STAGE;
      const int sn = si < STAGE ? si + RB - STAGE : si - STAGE;  // slot of row nx
      if (nx >= 0) stage_row_dyn<T, K>(win_s + sn * ROW, lb + static_cast<size_t>(nx) * bwp1, x + static_cast<size_t>(nx) * m + c, bw, tid);
      cp_async_commit();
      si = si == 0 ? RB - 1 : si - 1;
    }
    __syncwarp();
  }
  return !SAFE && __any_sync(FULL, off);
}

// ab, lb: (B, n, bw + 1); rhs, x: (B, n, m); fail: (B,). One warp per lane,
// blockDim.x / 32 lanes a block (chosen at launch), each lane's ring
// dyn_lane_bytes<T>(bw) of the block's dynamic shared memory. K = ceil((bw
// + 1) / 32). A minimum of one block an SM lets a thread take up to 255
// registers, which keeps the wider slot counts from spilling.
template <typename T, int K>
__global__ void __launch_bounds__(WARPS * 32, 1)
banded_spd_dynamic_kernel(const T* __restrict__ ab, const T* __restrict__ rhs,
                          T* __restrict__ lb, T* __restrict__ x,
                          unsigned char* __restrict__ fail, int B, int n, int bw, int m) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int tid = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lane = blockIdx.x * (blockDim.x >> 5) + warp;
  if (lane >= B) return;
  T* const win = reinterpret_cast<T*>(dyn_smem) + static_cast<size_t>(warp) * dyn_lane_elems(bw);
  ab += static_cast<size_t>(lane) * n * (bw + 1);
  lb += static_cast<size_t>(lane) * n * (bw + 1);
  rhs += static_cast<size_t>(lane) * n * m;
  x += static_cast<size_t>(lane) * n * m;
  if (solve_lane_dyn<T, K, false>(ab, rhs, lb, x, fail + lane, win, n, bw, m, tid))
    solve_lane_dyn<T, K, true>(ab, rhs, lb, x, fail + lane, win, n, bw, m, tid);
}

// Lets banded_spd_dynamic_kernel<T, K> use DYN_BLOCK_SMEM bytes of dynamic
// shared memory on the current device: once per instantiation and device.
template <typename T, int K>
cudaError_t dyn_opt_in() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(banded_spd_dynamic_kernel<T, K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, DYN_BLOCK_SMEM);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// Lanes a block (1..WARPS) of the dynamic-width kernel at bw on the current
// device: the count that keeps the most lanes resident on an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the larger on a tie.
// Sets *lanes; 0 when no block fits.
template <typename T, int K>
cudaError_t dyn_lanes(int bw, int* lanes) {
  *lanes = 0;
  cudaError_t err = dyn_opt_in<T, K>();
  if (err != cudaSuccess) return err;
  const int bytes = dyn_lane_bytes<T>(bw);
  int best = 0;
  for (int w = WARPS; w >= 1; --w) {
    if (w * bytes > DYN_BLOCK_SMEM) continue;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, banded_spd_dynamic_kernel<T, K>,
                                                        w * 32, static_cast<size_t>(w) * bytes);
    if (err != cudaSuccess) return err;
    if (blocks * w > best) {
      best = blocks * w;
      *lanes = w;
    }
  }
  return cudaSuccess;
}

template <typename T, int K>
cudaError_t launch_dyn(const void* ab, const void* rhs, void* lb, void* x, unsigned char* fail,
                       int B, int n, int bw, int m, cudaStream_t stream) {
  int w = 0;
  const cudaError_t err = dyn_lanes<T, K>(bw, &w);
  if (err != cudaSuccess) return err;
  if (w == 0) return cudaErrorInvalidConfiguration;
  const int blocks = (B + w - 1) / w;
  banded_spd_dynamic_kernel<T, K><<<blocks, w * 32, static_cast<size_t>(w) * dyn_lane_bytes<T>(bw),
                                    stream>>>(
      static_cast<const T*>(ab), static_cast<const T*>(rhs), static_cast<T*>(lb),
      static_cast<T*>(x), fail, B, n, bw, m);
  return cudaGetLastError();
}

// f(std::integral_constant<int, K>()) for the slots a thread of the
// dynamic-width kernel needs at bw (T's instantiations), else -1.
template <typename T, typename F>
int by_slots(int bw, F&& f) {
  if (bw < 0 || bw > dyn_max_bw<T>()) return -1;
  switch ((bw + 1 + 31) / 32) {
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    default:
      if constexpr (dyn_max_slots<T>() >= 8) {
        switch ((bw + 1 + 31) / 32) {
          case 7: return f(std::integral_constant<int, 7>());
          case 8: return f(std::integral_constant<int, 8>());
        }
      }
      return -1;
  }
}

template <typename T>
int dyn_lanes_at(int bw) {
  return by_slots<T>(bw, [&](auto k) {
    int w = 0;
    return dyn_lanes<T, decltype(k)::value>(bw, &w) == cudaSuccess ? w : -1;
  });
}

template <typename T>
int launch_dyn_at(const void* ab, const void* rhs, void* lb, void* x, unsigned char* fail, int B,
                  int n, int bw, int m, cudaStream_t stream) {
  const int err = by_slots<T>(bw, [&](auto k) {
    return static_cast<int>(
        launch_dyn<T, decltype(k)::value>(ab, rhs, lb, x, fail, B, n, bw, m, stream));
  });
  return err < 0 ? static_cast<int>(cudaErrorInvalidValue) : err;
}

}  // namespace

extern "C" {

// The dynamic-width kernel's shared memory a lane at bw in bytes, or -1
// where it takes no such band (bw < 32 or past the type's limit).
int ezpz_banded_dyn_lane_bytes(int bw, int f64) {
  return f64 ? by_slots<double>(bw, [&](auto) { return dyn_lane_bytes<double>(bw); })
             : by_slots<float>(bw, [&](auto) { return dyn_lane_bytes<float>(bw); });
}

// The widest band of the dynamic-width kernel (f64 selects double).
int ezpz_banded_dyn_max_bw(int f64) { return f64 ? dyn_max_bw<double>() : dyn_max_bw<float>(); }

// Lanes a block of the dynamic-width kernel at bw on the current device
// (what a launch takes); -1 where it takes no such band or on error.
int ezpz_banded_dyn_lanes(int bw, int f64) {
  return f64 ? dyn_lanes_at<double>(bw) : dyn_lanes_at<float>(bw);
}

// One launch of the dynamic-width kernel: 32 <= bw <= its limit for the
// type, buffers in the callers' layout. Returns the launch's cudaError_t
// (also when the shared-memory attribute or the occupancy query fails).
int ezpz_banded_spd_dyn(int f64, const void* ab, const void* rhs, void* lb, void* x,
                        unsigned char* fail, int B, int n, int bw, int m, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_dyn_at<double>(ab, rhs, lb, x, fail, B, n, bw, m, s)
             : launch_dyn_at<float>(ab, rhs, lb, x, fail, B, n, bw, m, s);
}

}  // extern "C"
