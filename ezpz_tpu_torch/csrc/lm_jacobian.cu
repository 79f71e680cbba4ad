// The batched LM loop's weighted Jacobian and its per-instance products,
// for Hopper (sm_90a): one launch a CompiledSystem.normal_equations call on
// the card, float32 or float64 (ops/lm_jacobian.py).
//
// Replaces no Pallas kernel: the JAX package leaves this step to jax.jvp
// under XLA, which fuses it. In eager PyTorch the same step was one
// torch.func.jvp pass per instance variable of every kind block, then one
// op per product and a torch.cat of the product lists: ~300 small ops a
// call that the host takes ~7 ms to dispatch against ~1.3 ms of device
// work. For every lane and instance this kernel writes, in one pass,
//   * the weighted residual rows (unless the caller gives the rhs rows),
//   * every product the assembly sums: jj[k, l] = dot(wjac[k], wjac[l])
//     and jr[k] = dot(wjac[k], wres), into the column buffers that the
//     assembly's fixed gathers read, at the columns the instance table
//     names (ops/lm_jacobian.instance_table owns the numbering: product
//     (k, l) of an instance at its first JtJ column + (k * A + l) * nb,
//     product k at its first Jtr column + k * nb), each buffer ending in
//     the zero column that pads the gathers,
//   * the degenerate flag of each instance of a block that can degenerate.
//
// What bounds it on the H100: bytes. The arithmetic is a few hundred flops
// an instance; at rect_chain(64)'s size a lane writes 4,100 product floats,
// 386 rows and 128 flags and reads its x, parameters and rhs: ~20 KB a
// lane, ~0.5 GB for 24,576 lanes, ~0.15 ms at 3.35 TB/s.
//
// What the design does about it:
//   * one thread per (lane, instance), instances fastest: for a fixed
//     (k, l) neighbouring threads write neighbouring columns of one lane's
//     row, so every store of a warp is one contiguous run;
//   * one dual-number evaluation an instance (eval_kind on DN<A> in float,
//     on this file's DD<A> in double) gives the residual rows and all A
//     Jacobian columns: no intermediate leaves registers;
//   * the instance table (kind, block, output columns, variable ids) and
//     the weights are small device tables cached per device by the
//     wrapper and read through the cache; each block's parameter pointer
//     and lane stride ride in the kernel's parameter space;
//   * one instantiation a precision, compiled for every kind (up to 8
//     variables): on the chain it ran faster than one compiled only up to
//     its widest kind (4 variables), PERF.md.
//
// Arithmetic is the plain version's (ops/lm_jacobian.products_reference)
// operation for operation: wjac = tangent * w, wres = row * w, each dot
// summed over the rows in order, IEEE division and sqrt and no FMA
// contraction (--fmad=false). Each tangent follows torch's forward-mode
// rule (fleet_common.cuh; DD below copies DN's rules in double), so the
// outputs are bit-equal to the plain version's on the card.

#include "fleet_common.cuh"

namespace {

constexpr int LMJ_THREADS = 256;
constexpr int LMJ_MAX_BLOCKS = 32;

// Instance table columns (ops/lm_jacobian.py, IC_*): the kind, its block
// (the parameter pointer's index), its index in the block and the block's
// size (the stride between its product columns), its first JtJ and Jtr
// product column and residual row, its degenerate flag's column (-1: the
// kind never degenerates), then its variable ids.
constexpr int IC_KIND = 0, IC_BLOCK = 1, IC_INDEX = 2, IC_NB = 3, IC_JJ = 4, IC_JR = 5,
              IC_ROW = 6, IC_DEG = 7, IC_IDS = 8, IC_COLS = 16;

// ---------------------------------------------------------------------------
// Forward-mode dual numbers over double with K tangents: DN's rules
// (fleet_common.cuh), each one torch's forward-mode formula, in double.

template <int K>
struct DD {
  double v;
  double d[K];
};

#define EZPZ_DD_LOOP _Pragma("unroll") for (int t = 0; t < K; ++t)

template <int K> __device__ __forceinline__ DD<K> operator+(DD<K> a, DD<K> b) {
  DD<K> o; o.v = a.v + b.v; EZPZ_DD_LOOP o.d[t] = a.d[t] + b.d[t]; return o;
}
template <int K> __device__ __forceinline__ DD<K> operator-(DD<K> a, DD<K> b) {
  DD<K> o; o.v = a.v - b.v; EZPZ_DD_LOOP o.d[t] = a.d[t] - b.d[t]; return o;
}
template <int K> __device__ __forceinline__ DD<K> operator*(DD<K> a, DD<K> b) {
  DD<K> o; o.v = a.v * b.v; EZPZ_DD_LOOP o.d[t] = a.d[t] * b.v + b.d[t] * a.v; return o;
}
template <int K> __device__ __forceinline__ DD<K> operator/(DD<K> a, DD<K> b) {
  DD<K> o; const double q = a.v / b.v; o.v = q;
  EZPZ_DD_LOOP o.d[t] = (a.d[t] - q * b.d[t]) / b.v;
  return o;
}
template <int K> __device__ __forceinline__ DD<K> operator-(DD<K> a, double b) {
  DD<K> o; o.v = a.v - b; EZPZ_DD_LOOP o.d[t] = a.d[t]; return o;
}
template <int K> __device__ __forceinline__ DD<K> operator*(DD<K> a, double b) {
  DD<K> o; o.v = a.v * b; EZPZ_DD_LOOP o.d[t] = a.d[t] * b; return o;
}
template <int K> __device__ __forceinline__ DD<K> operator*(double a, DD<K> b) {
  DD<K> o; o.v = a * b.v; EZPZ_DD_LOOP o.d[t] = b.d[t] * a; return o;
}
template <int K> __device__ __forceinline__ DD<K> operator/(DD<K> a, double b) {
  DD<K> o; o.v = a.v / b; EZPZ_DD_LOOP o.d[t] = a.d[t] / b; return o;
}
template <int K> __device__ __forceinline__ DD<K> operator/(double a, DD<K> b) {
  DD<K> o; const double q = a / b.v; o.v = q;
  EZPZ_DD_LOOP o.d[t] = (0.0 - q * b.d[t]) / b.v;
  return o;
}

template <int K> __device__ __forceinline__ double val(DD<K> a) { return a.v; }

template <int K> __device__ __forceinline__ DD<K> msqrt(DD<K> a) {
  DD<K> o; const double s = sqrt(a.v); o.v = s;
  const double s2 = 2.0 * s;
  EZPZ_DD_LOOP o.d[t] = a.d[t] / s2;
  return o;
}
template <int K> __device__ __forceinline__ DD<K> mabs(DD<K> a) {
  const double sg = a.v > 0.0 ? 1.0 : (a.v < 0.0 ? -1.0 : 0.0);  // torch.sgn
  DD<K> o; o.v = fabs(a.v); EZPZ_DD_LOOP o.d[t] = a.d[t] * sg; return o;
}
template <int K> __device__ __forceinline__ DD<K> msin(DD<K> a) {
  DD<K> o; o.v = sin(a.v); const double c = cos(a.v);
  EZPZ_DD_LOOP o.d[t] = a.d[t] * c;
  return o;
}
template <int K> __device__ __forceinline__ DD<K> mcos(DD<K> a) {
  DD<K> o; o.v = cos(a.v); const double ms = -sin(a.v);
  EZPZ_DD_LOOP o.d[t] = a.d[t] * ms;
  return o;
}
template <int K> __device__ __forceinline__ DD<K> recip(DD<K> a) {
  DD<K> o; const double r = 1.0 / a.v; o.v = r; const double r2 = r * r;
  EZPZ_DD_LOOP o.d[t] = (-a.d[t]) * r2;
  return o;
}

#undef EZPZ_DD_LOOP

template <int K> struct BaseOf<DD<K>> { using type = double; };
template <int K> struct Lift<DD<K>> {
  __device__ __forceinline__ static DD<K> of(double c) {
    DD<K> o; o.v = c;
#pragma unroll
    for (int t = 0; t < K; ++t) o.d[t] = 0.0;
    return o;
  }
};

// The dual number of A tangents over the scalar S.
template <class S, int A> struct DualOf;
template <int A> struct DualOf<float, A> { using type = DN<A>; };
template <int A> struct DualOf<double, A> { using type = DD<A>; };

// ---------------------------------------------------------------------------

// Each block's parameters: (lanes, nb, np) S with `stride` elements
// between lanes (0: one table shared by every lane).
struct BlockPars {
  const void* p[LMJ_MAX_BLOCKS];
  long long stride[LMJ_MAX_BLOCKS];
};

template <class S>
struct JacOut {
  S* r;       // (B, n_rows); unused when the caller gives the rhs rows
  S* jj;      // (B, n_jj + 1), the last column zero
  S* jr;      // (B, n_jr + 1), the last column zero
  int* deg;   // (B, n_deg)
  int n_rows, n_jj, n_jr, n_deg;
};

template <int K, class S>
__device__ __forceinline__ void instance_products(long long lane, const int* I, S w,
                                                  const S* __restrict__ xl,
                                                  const S* __restrict__ rl,
                                                  const BlockPars& bp, const JacOut<S>& o) {
  constexpr int A = ARITY[K], D = DIM[K], NP = NPAR[K];
  using T = typename DualOf<S, A>::type;
  const int i = __ldg(I + IC_INDEX), nb = __ldg(I + IC_NB);
  S p[2] = {S(0), S(0)};
  if constexpr (NP > 0) {
    const int b = __ldg(I + IC_BLOCK);
    const S* pl = static_cast<const S*>(bp.p[b]) + lane * bp.stride[b] + (long long)i * NP;
#pragma unroll
    for (int k = 0; k < NP; ++k) p[k] = pl[k];
  }
  // The residual rows (res[d].v) and every tangent (res[d].d[a] = d row_d
  // / d variable a) from ONE evaluation, the variables seeded one-hot.
  T v[A], res[2];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    v[a].v = xl[__ldg(I + IC_IDS + a)];
#pragma unroll
    for (int t = 0; t < A; ++t) v[a].d[t] = (t == a) ? S(1) : S(0);
  }
  const bool dg = eval_kind<T, S>(K, v, p, res);
  S wj[A][D];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int d = 0; d < D; ++d) wj[a][d] = res[d].d[a] * w;
  S wr[D];
  const int row = __ldg(I + IC_ROW);
  if (rl != nullptr) {
#pragma unroll
    for (int d = 0; d < D; ++d) wr[d] = rl[row + d];
  } else {
    S* r = o.r + lane * o.n_rows + row;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      wr[d] = res[d].v * w;
      r[d] = wr[d];
    }
  }
  S* jr = o.jr + lane * (o.n_jr + 1) + __ldg(I + IC_JR);
#pragma unroll
  for (int k = 0; k < A; ++k) {
    S acc = wj[k][0] * wr[0];
#pragma unroll
    for (int d = 1; d < D; ++d) acc = acc + wj[k][d] * wr[d];
    jr[(long long)k * nb] = acc;
  }
  // dot(wjac[k], wjac[l]) and dot(wjac[l], wjac[k]) multiply the same
  // pairs and add them in the same order: one sum, stored at both.
  S* jj = o.jj + lane * (o.n_jj + 1) + __ldg(I + IC_JJ);
#pragma unroll
  for (int k = 0; k < A; ++k) {
#pragma unroll
    for (int l = 0; l <= k; ++l) {
      S acc = wj[k][0] * wj[l][0];
#pragma unroll
      for (int d = 1; d < D; ++d) acc = acc + wj[k][d] * wj[l][d];
      jj[(long long)(k * A + l) * nb] = acc;
      if (l != k) jj[(long long)(l * A + k) * nb] = acc;
    }
  }
  const int dcol = __ldg(I + IC_DEG);
  if (dcol >= 0) o.deg[lane * o.n_deg + dcol] = dg ? 1 : 0;
}

template <class S>
__global__ void __launch_bounds__(LMJ_THREADS)
lm_jacobian_kernel(const int* __restrict__ inst, const S* __restrict__ w, int n_inst,
                   const S* __restrict__ x, int n_vars, const S* __restrict__ rhs,
                   long long total, const __grid_constant__ BlockPars bp,
                   const __grid_constant__ JacOut<S> o) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long lane = t / n_inst;
  const int g = (int)(t - lane * n_inst);
  const int* I = inst + (long long)g * IC_COLS;
  const S* xl = x + lane * n_vars;
  const S* rl = rhs == nullptr ? nullptr : rhs + lane * o.n_rows;
  if (g == 0) {
    o.jj[lane * (o.n_jj + 1) + o.n_jj] = S(0);
    o.jr[lane * (o.n_jr + 1) + o.n_jr] = S(0);
  }
  const S wg = __ldg(w + g);
  switch (__ldg(I + IC_KIND)) {
#define EZPZ_CASE(K)                                                  \
    case K:                                                           \
      instance_products<K, S>(lane, I, wg, xl, rl, bp, o);            \
      break;
    EZPZ_KINDS(EZPZ_CASE)
#undef EZPZ_CASE
    default:
      break;
  }
}

template <class S>
int launch_lm_jacobian(const int* inst, const void* w, int n_inst, const void* x, int n_vars,
                       const void* rhs, long long total, const BlockPars& bp, void* r,
                       void* jj, int n_jj, void* jr, int n_jr, int* deg, int n_deg,
                       int n_rows, cudaStream_t stream) {
  const JacOut<S> o{static_cast<S*>(r), static_cast<S*>(jj), static_cast<S*>(jr), deg,
                    n_rows, n_jj, n_jr, n_deg};
  const long long blocks = (total + LMJ_THREADS - 1) / LMJ_THREADS;
  lm_jacobian_kernel<S><<<(unsigned)blocks, LMJ_THREADS, 0, stream>>>(
      inst, static_cast<const S*>(w), n_inst, static_cast<const S*>(x), n_vars,
      static_cast<const S*>(rhs), total, bp, o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The table layout this library was built with: instance table columns,
// parameter blocks a launch takes.
void ezpz_lm_jacobian_layout(int* cols, int* max_blocks) {
  *cols = IC_COLS;
  *max_blocks = LMJ_MAX_BLOCKS;
}

// f64: 0 for float32 data, 1 for float64. inst (n_inst, IC_COLS) int32 and
// w (n_inst,) are DEVICE tables; x (B, n_vars), rhs (B, n_rows) or null,
// and the outputs are device arrays, all in the one precision but deg
// (int32); pars (n_blocks pointers) and par_strides (n_blocks) are HOST
// arrays, copied into the kernel's parameters.
int ezpz_lm_jacobian(int f64, const int* inst, const void* w, int n_inst, const void* x,
                     int n_vars, const void* rhs, int n_rows, const void* const* pars,
                     const long long* par_strides, int n_blocks, void* r, void* jj, int n_jj,
                     void* jr, int n_jr, int* deg, int n_deg, int B, void* stream) {
  if (B < 0 || n_inst < 0 || n_blocks < 0 || n_blocks > LMJ_MAX_BLOCKS || (f64 != 0 && f64 != 1))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * n_inst;
  if (total == 0) return 0;
  if ((total + LMJ_THREADS - 1) / LMJ_THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  BlockPars bp{};
  for (int b = 0; b < n_blocks; ++b) {
    bp.p[b] = pars[b];
    bp.stride[b] = par_strides[b];
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    return launch_lm_jacobian<double>(inst, w, n_inst, x, n_vars, rhs, total, bp, r, jj, n_jj,
                                      jr, n_jr, deg, n_deg, n_rows, st);
  return launch_lm_jacobian<float>(inst, w, n_inst, x, n_vars, rhs, total, bp, r, jj, n_jj,
                                   jr, n_jr, deg, n_deg, n_rows, st);
}

}  // extern "C"
