// quant_per_token and swiglu_quant: per-row dynamic int8 quantization, alone
// and fused behind SwiGLU, for Hopper.
//
// Replace the TPU kernels sgl_kernel_npu_tpu/ops/quant.py:quant_per_token
// (_quant_kernel) and sgl_kernel_npu_tpu/ops/activation.py:swiglu_quant
// (_swiglu_quant_kernel), which quantize a block of rows held whole in VMEM.
//
// Bound on the H100: bytes, and at the serving path's sizes (8-64 rows of
// 4,096-28,672 values, 0.1-2 MB) really the launch: a call is a few
// microseconds of fixed cost against a bound of well under one.
//
// Both run on csrc/row_reduce.cuh: at decode a row of over 16 KB of input
// split across a cluster of up to 8 blocks, at chunk sizes several rows a
// block (the wrapper's plan, ops/row_reduce.py); each thread's 16-byte
// vectors held in registers from the load to the int8 store, the row's
// |max| reduced over the block and the cluster.  Max does not depend on the order, and each
// level is IEEE division's (`level` below), so the bits are the plain
// version's.
//
// quant_per_token (K5): scale = max(amax / 127, 1e-12), and that clamped
// scale is returned (written by cluster rank 0, thread 0).
//
// swiglu_quant (K7a): the output row of I is the reduced row; a thread's
// vector j is made from the gate's 16 bytes at column jN and the up's at
// I + jN, each loaded once, and v = silu(gate) * up is computed once in f32
// (a precise expf and an IEEE division, as the plain version's sigmoid) and
// held in registers through the |max| and the levels, while the next row's
// gate and up land in the registers they left.  Its plan reads two inputs
// a vector (ops/row_reduce.py, inputs = 2): Llama's decode rows (57 KB of
// gate || up) in clusters of 8, one vector a thread up to 512, four rows a
// block at chunk sizes.  Rows at or past
// `total` (a device scalar: the group list's total) are zeros; they still
// take the row's reductions, so every block of a cluster meets its barriers.
// The returned scale is amax / 127 UNCLAMPED (a zero row returns 0), only
// the division uses max(scale, 1e-12).  Without quant v is written in the
// input's type on the same plan, no reduction, and the scales are zeros.
//
// Both round as IEEE division (no fast math), as the plain versions divide:
// a bare reciprocal multiply would flip values at rounding ties by one level
// (sgl_kernel_npu_tpu/ops/quant.py:wire_quant records the same hazard).
#include "common.cuh"
#include "row_reduce.cuh"

namespace quant {

__device__ __forceinline__ int8_t saturate(float v) {
  return (int8_t)fminf(fmaxf(rintf(v), -128.f), 127.f);
}

__device__ __forceinline__ float silu_mul(float gate, float up) {
  return gate * (1.f / (1.f + expf(-gate))) * up;
}

// The int8 level of v: round_half_even(v / s) saturated, v / s by IEEE
// division (ops/quant.py quant_levels_plain repeats the rule on the CPU).
// rs = 1 / s rounded once, and |v / s| <= 127 (s >= amax / 127), so
// q = v rs lies within 2^-16 of v / s, and the IEEE quotient within 2^-18:
// where q lies at least 2^-15 from a half-integer both round to one level,
// read off q (rounded half to even by adding 1.5 2^23); elsewhere __fdiv_rn
// decides, as it does for NaN.  (Dividing every value made a 2048-row chunk
// 15 % slower than the two-pass kernel this one replaced: PERF.md §6.)
__device__ __forceinline__ int level(float v, float s, float rs) {
  constexpr float MAGIC = 12582912.f;   // 1.5 2^23: a sum in [2^23, 2^24) is an integer
  const float q = __fmul_rn(v, rs);
  const float t = __fadd_rn(q, MAGIC);
  if (fabsf(__fadd_rn(q, -__fadd_rn(t, -MAGIC))) <= 0.5f - 0x1p-15f)
    return min(max(__float_as_int(t) - __float_as_int(MAGIC), -128), 127);
  return saturate(__fdiv_rn(v, s));
}

// x [rows, hidden] of T -> q [rows, hidden] int8, scale [rows] f32.  Grid:
// rowr::Rows (a row's cluster, or block_rows rows a block); N elements a
// vector (16 bytes' worth, or 1); VM vectors a thread held in registers (the
// launch's vecs rounded up to 1, 2, 4 or 8).
template <typename T, int N, int VM>
__global__ void __launch_bounds__(rowr::MAX_THREADS)
    quant_per_token_kernel(const T* __restrict__ x, int rows, int hidden, int cluster, int vecs,
                           int block_rows, int8_t* __restrict__ q, float* __restrict__ scale) {
  __shared__ float red[2][rowr::MAX_THREADS / 32];
  __shared__ float part;
  const rowr::Rows rw(rows, cluster, block_rows);
  const rowr::Span span(hidden / N, cluster, rw.rank);
  rowr::Pack<T, N> cur[VM], nxt[VM];
  rowr::load_held(cur, x + (size_t)rw.lo * hidden, span, vecs);
  for (int row = rw.lo; row < rw.hi; ++row) {
    const T* xr = x + (size_t)row * hidden;
    int8_t* qr = q + (size_t)row * hidden;
    if constexpr (rowr::AHEAD<VM>)
      if (row + 1 < rw.hi) rowr::load_held(nxt, xr + hidden, span, vecs);
    float m = 0.f;
#pragma unroll
    for (int v = 0; v < VM; ++v)
      if (v < vecs && span.at(v) >= 0)
#pragma unroll
        for (int i = 0; i < N; ++i) m = fmaxf(m, fabsf(cur[v].get(i)));
    for (int v = VM; v < vecs && span.at(v) >= 0; ++v) {   // a row past the registers
      rowr::Pack<T, N> p;
      p.load(xr + (size_t)span.at(v) * N);
#pragma unroll
      for (int i = 0; i < N; ++i) m = fmaxf(m, fabsf(p.get(i)));
    }
    m = rowr::cluster_all<rowr::Max>(rowr::block_all<rowr::Max>(m, red[(row - rw.lo) & 1]),
                                     &part, cluster);
    const float s = fmaxf(__fdiv_rn(m, 127.f), 1e-12f), rs = __fdiv_rn(1.f, s);
#pragma unroll
    for (int v = 0; v < VM; ++v) {
      if (v < vecs && span.at(v) >= 0) {
        int l[N];
#pragma unroll
        for (int i = 0; i < N; ++i) l[i] = level(cur[v].get(i), s, rs);
        rowr::store(qr + (size_t)span.at(v) * N, l);
      }
    }
    for (int v = VM; v < vecs && span.at(v) >= 0; ++v) {
      rowr::Pack<T, N> p;
      p.load(xr + (size_t)span.at(v) * N);
      int l[N];
#pragma unroll
      for (int i = 0; i < N; ++i) l[i] = level(p.get(i), s, rs);
      rowr::store(qr + (size_t)span.at(v) * N, l);
    }
    if (rw.rank == 0 && threadIdx.x == 0) scale[row] = s;
    if (row + 1 < rw.hi) {
      if constexpr (rowr::AHEAD<VM>) {
#pragma unroll
        for (int v = 0; v < VM; ++v) cur[v] = nxt[v];
      } else {
        rowr::load_held(cur, xr + hidden, span, vecs);
      }
    }
  }
  rowr::cluster_done(cluster);
}

// N output values of K7a at element `at` of out: levels with QUANT, else f in T.
template <typename T, bool QUANT, int N>
__device__ __forceinline__ void put_swiglu(void* out, size_t at, const float (&f)[N], float s,
                                           float rs) {
  if constexpr (QUANT) {
    int l[N];
#pragma unroll
    for (int i = 0; i < N; ++i) l[i] = level(f[i], s, rs);
    rowr::store(static_cast<int8_t*>(out) + at, l);
  } else {
    rowr::store(static_cast<T*>(out) + at, f);
  }
}

// x [rows, 2I] of T (gate || up) -> out [rows, I] (int8 levels with QUANT,
// else T), scale [rows] f32.  Grid and vectors as quant_per_token_kernel's,
// over the output row of I: vector j of a row reads x[row, jN ..] (gate)
// and x[row, I + jN ..] (up).  total: device row count or null.
template <typename T, bool QUANT, int N, int VM>
__global__ void __launch_bounds__(rowr::MAX_THREADS)
    swiglu_quant_kernel(const T* __restrict__ x, int rows, int I, const int* __restrict__ total,
                        int cluster, int vecs, int block_rows, void* __restrict__ out,
                        float* __restrict__ scale) {
  __shared__ float red[2][rowr::MAX_THREADS / 32];
  __shared__ float part;
  const rowr::Rows rw(rows, cluster, block_rows);
  const rowr::Span span(I / N, cluster, rw.rank);
  const int live = total == nullptr ? rows : *total;   // rows [0, live) are live
  const size_t in = 2 * (size_t)I;
  rowr::Pack<T, N> g[VM], u[VM];
  if (rw.lo < live) {
    rowr::load_held(g, x + rw.lo * in, span, vecs);
    rowr::load_held(u, x + rw.lo * in + I, span, vecs);
  }
  for (int row = rw.lo; row < rw.hi; ++row) {
    const T* xr = x + row * in;
    const bool on = row < live;
    float v[VM][N];
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < VM; ++j)
      if (j < vecs && span.at(j) >= 0)
#pragma unroll
        for (int i = 0; i < N; ++i) {
          v[j][i] = on ? silu_mul(g[j].get(i), u[j].get(i)) : 0.f;
          m = fmaxf(m, fabsf(v[j][i]));
        }
    // the next row's vectors land in the same registers while this one is
    // reduced and written
    if (row + 1 < rw.hi && row + 1 < live) {
      rowr::load_held(g, xr + in, span, vecs);
      rowr::load_held(u, xr + in + I, span, vecs);
    }
    if constexpr (QUANT) {
      for (int j = VM; on && j < vecs && span.at(j) >= 0; ++j) {   // a row past the registers
        rowr::Pack<T, N> a, b;
        a.load(xr + (size_t)span.at(j) * N);
        b.load(xr + I + (size_t)span.at(j) * N);
#pragma unroll
        for (int i = 0; i < N; ++i) m = fmaxf(m, fabsf(silu_mul(a.get(i), b.get(i))));
      }
      m = rowr::cluster_all<rowr::Max>(rowr::block_all<rowr::Max>(m, red[(row - rw.lo) & 1]),
                                       &part, cluster);
    }
    const float s = __fdiv_rn(m, 127.f), safe = fmaxf(s, 1e-12f), rs = __fdiv_rn(1.f, safe);
    const size_t o = (size_t)row * I;
#pragma unroll
    for (int j = 0; j < VM; ++j)
      if (j < vecs && span.at(j) >= 0)
        put_swiglu<T, QUANT>(out, o + (size_t)span.at(j) * N, v[j], safe, rs);
    for (int j = VM; j < vecs && span.at(j) >= 0; ++j) {
      float f[N] = {};
      if (on) {
        rowr::Pack<T, N> a, b;
        a.load(xr + (size_t)span.at(j) * N);
        b.load(xr + I + (size_t)span.at(j) * N);
#pragma unroll
        for (int i = 0; i < N; ++i) f[i] = silu_mul(a.get(i), b.get(i));
      }
      put_swiglu<T, QUANT>(out, o + (size_t)span.at(j) * N, f, safe, rs);
    }
    if (rw.rank == 0 && threadIdx.x == 0) scale[row] = QUANT ? s : 0.f;
  }
  if constexpr (QUANT) rowr::cluster_done(cluster);
}

template <typename T, int N>
int launch_per_token_n(const void* x, int rows, int hidden, int cluster, int threads, int vecs,
                       int block_rows, void* q, void* scale, cudaStream_t s) {
  auto kernel = vecs <= 1   ? quant_per_token_kernel<T, N, 1>
                : vecs <= 2 ? quant_per_token_kernel<T, N, 2>
                : vecs <= 4 ? quant_per_token_kernel<T, N, 4>
                            : quant_per_token_kernel<T, N, rowr::VMAX>;
  const int blocks = cluster > 1 ? rows * cluster : (rows + block_rows - 1) / block_rows;
  return rowr::launch(kernel, blocks, threads, cluster, s, (const T*)x, rows, hidden, cluster,
                      vecs, block_rows, (int8_t*)q, (float*)scale);
}

template <typename T>
int launch_per_token(const void* x, int rows, int hidden, int cluster, int threads, int vecs,
                     int elems, int block_rows, void* q, void* scale, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  return elems == N ? launch_per_token_n<T, N>(x, rows, hidden, cluster, threads, vecs,
                                               block_rows, q, scale, s)
                    : launch_per_token_n<T, 1>(x, rows, hidden, cluster, threads, vecs,
                                               block_rows, q, scale, s);
}

template <typename T, bool QUANT>
int launch_swiglu(const void* x, int rows, int I, const int* total, int cluster, int threads,
                  int vecs, int elems, int block_rows, void* out, void* scale, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  // the element path holds VMAX single elements: few registers, one instance
  auto kernel = elems == 1  ? swiglu_quant_kernel<T, QUANT, 1, rowr::VMAX>
                : vecs <= 1 ? swiglu_quant_kernel<T, QUANT, N, 1>
                : vecs <= 2 ? swiglu_quant_kernel<T, QUANT, N, 2>
                : vecs <= 4 ? swiglu_quant_kernel<T, QUANT, N, 4>
                            : swiglu_quant_kernel<T, QUANT, N, rowr::VMAX>;
  const int blocks = cluster > 1 ? rows * cluster : (rows + block_rows - 1) / block_rows;
  return rowr::launch(kernel, blocks, threads, cluster, s, (const T*)x, rows, I, total, cluster,
                      vecs, block_rows, out, (float*)scale);
}

}  // namespace quant

// x [rows, hidden] (bf16 if in_bf16 else f32) -> q [rows, hidden] int8,
// scale [rows] f32, on the wrapper's plan (ops/row_reduce.py _row_plan):
// `cluster` blocks a row (or, with cluster 1, `block_rows` rows a block) of
// `threads` threads, `vecs` vectors a thread of `elems` elements (16 bytes'
// worth, or 1).
extern "C" int quant_per_token_launch(const void* x, int rows, int hidden, int in_bf16,
                                      int cluster, int threads, int vecs, int elems,
                                      int block_rows, void* q, void* scale, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = in_bf16 ? quant::launch_per_token<__nv_bfloat16> : quant::launch_per_token<float>;
  return run(x, rows, hidden, cluster, threads, vecs, elems, block_rows, q, scale, s);
}

// x [rows, 2I] (bf16 if in_bf16 else f32), total = device int32 row count or
// null (every row live) -> out [rows, I] (int8 if need_quant, else x's type),
// scale [rows] f32, on the wrapper's plan over the output row of I
// (ops/row_reduce.py _row_plan with halves = 2), as quant_per_token_launch's.
extern "C" int swiglu_quant_launch(const void* x, int rows, int I, int in_bf16,
                                   const void* total, int need_quant, int cluster, int threads,
                                   int vecs, int elems, int block_rows, void* out, void* scale,
                                   void* stream) {
  if (rows == 0) return 0;
  using bf16 = __nv_bfloat16;
  auto run = in_bf16 ? (need_quant ? quant::launch_swiglu<bf16, true>
                                   : quant::launch_swiglu<bf16, false>)
                     : (need_quant ? quant::launch_swiglu<float, true>
                                   : quant::launch_swiglu<float, false>);
  return run(x, rows, I, (const int*)total, cluster, threads, vecs, elems, block_rows, out, scale,
             (cudaStream_t)stream);
}
