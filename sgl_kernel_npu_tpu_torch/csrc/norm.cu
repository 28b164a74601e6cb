// rms_norm: RMSNorm over the last dim of [rows, hidden], for Hopper; and its
// fused variants add_rms_norm (residual add + RMSNorm + bias, optionally
// quantized to int8, or the Gemma scale w + 1) and l1_norm (a row over its
// signed sum).
//
// Replaces the TPU kernels of sgl_kernel_npu_tpu/ops/norm.py: rms_norm
// (_rms_norm_kernel, K6a), add_rms_norm_bias (_add_rms_norm_bias_kernel, K6b)
// and add_gemma_rms_norm (_add_gemma_kernel, K6c), both by add_rms_norm_kernel
// below, and l1_norm (_l1_norm_kernel, K6d).  Each TPU kernel normalizes a
// block of up to 128 or 256 whole rows held in VMEM.
//
// Bound on the H100: bytes.  Each row is read once and written once (2 x 2880
// x 2 B a row in bf16 at GPT-OSS width, 11.5 KB); the arithmetic is a few
// operations an element.  At the serving path's sizes (8 decode rows, a
// 512-row prefill chunk) a call is mostly its launch.
//
// rms_norm (K6a) runs on csrc/row_reduce.cuh: at decode a row is split
// across a cluster of up to 8 blocks (the wrapper's plan), at chunk sizes a
// block takes `block_rows` rows one after another.  Each thread loads its
// 16-byte vectors of x once into registers (8 bf16 or 4 f32 a load: hidden
// = 2880 is 360 bf16 vectors, not a power of two, so the last threads hold
// fewer), sums x^2 in f32 in a fixed order (__fmul_rn / __fadd_rn, its
// vectors in order, then the block and the cluster: ops/norm.py
// rms_norm_rows_plain repeats it bit for bit), and writes
// x * (1 / sqrt(sum / hidden + eps)) * w in f32, rounded once to x's type,
// from the same registers.  The weight is loaded with 16-byte vectors once
// per block into registers and reused over the block's rows.  Rows whose
// width or address does not allow 16-byte accesses take the same kernel one
// element a vector.
//
// add_rms_norm (K6b / K6c) is bound by bytes too: x and the residual read,
// the sum and the output written (4 x 2 B an element in bf16).  It runs on
// row_reduce.cuh with K6a's plan: each thread loads its 16-byte vectors of x
// and r once, forms a = x + r in f32 rounded to x's type (as the TPU
// kernel's astype), writes it as `added` from the registers and sums a^2 in
// K6a's fixed order (ops/norm.py add_rms_norm_rows_plain repeats it bit for
// bit); then r = 1 / sqrt(sum / hidden + eps) as K6a, and a * r * w + b (or
// a * r * (w + 1)) in f32 from the same registers, rounded once to x's type,
// or quantized to int8 by a static per-channel scale and offset: round half
// to even, then clamp to [-128, 127].  The weight and bias (and the quant
// scale and offset, see HOLD_QUANT) are loaded with 16-byte vectors once per
// block and reused over its rows; their types are template parameters.  The
// plan reads two inputs a vector (ops/row_reduce.py, inputs = 2): one vector
// a thread up to 512, four rows a block at chunk sizes; a block loads the
// next row's x and r into the same registers once `added` is formed.
// The epilogue uses __fmul_rn / __fadd_rn so that nvcc contracts no product
// into an FMA: the plain version rounds each operation, and a contracted
// one would move int8 levels at rounding ties.
//
// l1_norm (K6d) is bound by bytes: x read once and the f32 output written
// once (6 B an element from bf16).  It runs on row_reduce.cuh with K6a's
// kernel shape (one input) on a plan of its own (ops/row_reduce.py l1_plan):
// a vector is 16 bytes of the f32 output (4 elements: an 8-byte load of bf16,
// so that a warp's loads and its stores each cover one contiguous span; 16
// bytes of bf16 made two 16-byte stores a thread, each warp store half of
// every sector, and ran 1.3-1.7x slower), four a thread at chunk sizes.
// Each thread loads its vectors of x once into registers, sums them signed
// in f32 in K6a's fixed order (its vectors in order, then the warp
// butterfly, the warps in index order and the cluster's blocks in rank
// order: ops/norm.py l1_norm_rows_plain repeats it bit for bit), and writes
// x / sum in IEEE division (__fdiv_rn, as JAX divides; not a multiply by the
// reciprocal) from the same registers.  A row that sums to 0 gives +-inf or
// NaN, as the reference does.
#include "common.cuh"
#include "row_reduce.cuh"

namespace rmsnorm {

// x, out [rows, hidden] of T; w [hidden] of W.  N: elements a vector (16
// bytes of x, or 1); VM: vectors a thread held in registers (the launch's
// vecs rounded up to 1, 2, 4 or 8).  Grid: rowr::Rows (a row's cluster, or
// block_rows rows a block).
template <typename T, typename W, int N, int VM>
__global__ void __launch_bounds__(rowr::MAX_THREADS)
    rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
                    int rows, int hidden, int cluster, int vecs, int block_rows, float eps) {
  __shared__ float red[2][rowr::MAX_THREADS / 32];
  __shared__ float part;
  const rowr::Rows rw(rows, cluster, block_rows);
  const rowr::Span span(hidden / N, cluster, rw.rank);
  rowr::Pack<W, N> wh[VM];
  rowr::load_held(wh, w, span, vecs);
  rowr::Pack<T, N> cur[VM], nxt[VM];
  rowr::load_held(cur, x + (size_t)rw.lo * hidden, span, vecs);
  for (int row = rw.lo; row < rw.hi; ++row) {
    const T* xr = x + (size_t)row * hidden;
    T* yr = out + (size_t)row * hidden;
    if constexpr (rowr::AHEAD<VM>)
      if (row + 1 < rw.hi) rowr::load_held(nxt, xr + hidden, span, vecs);
    float ss = 0.f;
#pragma unroll
    for (int v = 0; v < VM; ++v)
      if (v < vecs && span.at(v) >= 0)
#pragma unroll
        for (int i = 0; i < N; ++i) ss = __fadd_rn(ss, __fmul_rn(cur[v].get(i), cur[v].get(i)));
    for (int v = VM; v < vecs && span.at(v) >= 0; ++v) {   // a row past the registers
      rowr::Pack<T, N> p;
      p.load(xr + (size_t)span.at(v) * N);
#pragma unroll
      for (int i = 0; i < N; ++i) ss = __fadd_rn(ss, __fmul_rn(p.get(i), p.get(i)));
    }
    const float total = rowr::cluster_all<rowr::Sum>(
        rowr::block_all<rowr::Sum>(ss, red[(row - rw.lo) & 1]), &part, cluster);
    const float r =
        __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(total, (float)hidden), eps)));
#pragma unroll
    for (int v = 0; v < VM; ++v) {
      if (v < vecs && span.at(v) >= 0) {
        float f[N];
#pragma unroll
        for (int i = 0; i < N; ++i) f[i] = __fmul_rn(__fmul_rn(cur[v].get(i), r), wh[v].get(i));
        rowr::store(yr + (size_t)span.at(v) * N, f);
      }
    }
    for (int v = VM; v < vecs && span.at(v) >= 0; ++v) {
      rowr::Pack<T, N> p;
      rowr::Pack<W, N> q;
      p.load(xr + (size_t)span.at(v) * N);
      q.load(w + (size_t)span.at(v) * N);
      float f[N];
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = __fmul_rn(__fmul_rn(p.get(i), r), q.get(i));
      rowr::store(yr + (size_t)span.at(v) * N, f);
    }
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

__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

enum AddMode { kBias = 0, kBiasQuant = 1, kGemma = 2 };

// Whether the quantized mode holds the quant scale and offset in registers
// for a block of several rows (true) or reads them a row through the
// read-only cache (false): the faster at [512, 4096] and [512, 7168] on the
// H100 (PERF.md §6).  A block of one row (decode) reads them once either
// way, in its epilogue, after the row's loads; and they are held only up to
// 4 vectors a thread: at 8 the two alone would take 128 registers.
constexpr bool HOLD_QUANT = true;

// The output value of a = x + r: (a * rs) * w + b, (a * rs) * (w + 1) in
// the Gemma mode, then * qs + qo in the quantized mode; each operation
// rounded (no FMA contraction).
template <int MODE>
__device__ __forceinline__ float add_norm_value(float a, float rs, float w, float b, float qs,
                                                float qo) {
  float v = __fmul_rn(__fmul_rn(a, rs), MODE == kGemma ? __fadd_rn(w, 1.f) : w);
  if (MODE != kGemma) v = __fadd_rn(v, b);
  if (MODE == kBiasQuant) v = __fadd_rn(__fmul_rn(v, qs), qo);
  return v;
}

// The N outputs at element `at` of out from a = x + r there and the
// vectors' values: int8 levels in kBiasQuant, else T.
template <typename T, int MODE, int N, typename W, typename B>
__device__ __forceinline__ void put_add(void* out, size_t at, const float (&a)[N], float rs,
                                        const rowr::Pack<W, N>& w, const rowr::Pack<B, N>& b,
                                        const rowr::Pack<float, N>& qs,
                                        const rowr::Pack<float, N>& qo) {
  float f[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    f[i] = add_norm_value<MODE>(a[i], rs, w.get(i), MODE == kGemma ? 0.f : b.get(i),
                                MODE == kBiasQuant ? qs.get(i) : 0.f,
                                MODE == kBiasQuant ? qo.get(i) : 0.f);
  if constexpr (MODE == kBiasQuant) {
    int l[N];
#pragma unroll
    for (int i = 0; i < N; ++i) l[i] = (int)fminf(fmaxf(rintf(f[i]), -128.f), 127.f);
    rowr::store(static_cast<int8_t*>(out) + at, l);
  } else {
    rowr::store(static_cast<T*>(out) + at, f);
  }
}

// x, r, added [rows, hidden] of T; w [hidden] of W, b [hidden] of B (unread
// in kGemma); qs, qo [hidden] f32 (kBiasQuant only); out [rows, hidden] of
// T, or int8 in kBiasQuant.  Grid and vectors as rms_norm_kernel's.
template <typename T, typename W, typename B, int MODE, int N, int VM>
__global__ void __launch_bounds__(rowr::MAX_THREADS)
    add_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                        const W* __restrict__ w, const B* __restrict__ b,
                        const float* __restrict__ qs, const float* __restrict__ qo,
                        void* __restrict__ out, T* __restrict__ added, int rows, int hidden,
                        int cluster, int vecs, int block_rows, float eps) {
  constexpr bool QUANT = MODE == kBiasQuant, GEMMA = MODE == kGemma;
  constexpr bool HOLDQ = QUANT && HOLD_QUANT && VM <= 4;
  __shared__ float red[2][rowr::MAX_THREADS / 32];
  __shared__ float part;
  const rowr::Rows rw(rows, cluster, block_rows);
  const rowr::Span span(hidden / N, cluster, rw.rank);
  rowr::Pack<W, N> wh[VM];
  rowr::Pack<B, N> bh[VM];
  rowr::Pack<float, N> sh[VM], oh[VM];
  rowr::load_held(wh, w, span, vecs);
  if constexpr (!GEMMA) rowr::load_held(bh, b, span, vecs);
  const bool hold = HOLDQ && rw.hi - rw.lo > 1;
  if (hold) {
    rowr::load_held(sh, qs, span, vecs);
    rowr::load_held(oh, qo, span, vecs);
  }
  rowr::Pack<T, N> xc[VM], rc[VM], ah[VM];
  rowr::load_held(xc, x + (size_t)rw.lo * hidden, span, vecs);
  rowr::load_held(rc, r + (size_t)rw.lo * hidden, span, vecs);
  for (int row = rw.lo; row < rw.hi; ++row) {
    const size_t at = (size_t)row * hidden;
    float ss = 0.f;
#pragma unroll
    for (int v = 0; v < VM; ++v) {
      if (v < vecs && span.at(v) >= 0) {
        float a[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          a[i] = round_as(__fadd_rn(xc[v].get(i), rc[v].get(i)), x);
          ss = __fadd_rn(ss, __fmul_rn(a[i], a[i]));
        }
        ah[v].set(a);                                    // exact: a lies on T's grid
        ah[v].store(added + at + (size_t)span.at(v) * N);
      }
    }
    // the next row's vectors land in the same registers while this one is
    // reduced and written
    if (row + 1 < rw.hi) {
      rowr::load_held(xc, x + at + hidden, span, vecs);
      rowr::load_held(rc, r + at + hidden, span, vecs);
    }
    for (int v = VM; v < vecs && span.at(v) >= 0; ++v) {   // a row past the registers
      rowr::Pack<T, N> p, q;
      p.load(x + at + (size_t)span.at(v) * N);
      q.load(r + at + (size_t)span.at(v) * N);
      float f[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        f[i] = round_as(__fadd_rn(p.get(i), q.get(i)), x);
        ss = __fadd_rn(ss, __fmul_rn(f[i], f[i]));
      }
      rowr::store(added + at + (size_t)span.at(v) * N, f);
    }
    const float total = rowr::cluster_all<rowr::Sum>(
        rowr::block_all<rowr::Sum>(ss, red[(row - rw.lo) & 1]), &part, cluster);
    const float rs =
        __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(total, (float)hidden), eps)));
#pragma unroll
    for (int v = 0; v < VM; ++v) {
      if (v < vecs && span.at(v) >= 0) {
        const int g = span.at(v);
        rowr::Pack<float, N> sv, ov;
        if constexpr (QUANT) {
          if (hold) {
            sv = sh[v], ov = oh[v];
          } else {                      // through the read-only cache, a row
            sv.load(qs + (size_t)g * N);
            ov.load(qo + (size_t)g * N);
          }
        }
        float a[N];
#pragma unroll
        for (int i = 0; i < N; ++i) a[i] = ah[v].get(i);
        put_add<T, MODE>(out, at + (size_t)g * N, a, rs, wh[v], bh[v], sv, ov);
      }
    }
    for (int v = VM; v < vecs && span.at(v) >= 0; ++v) {
      const int g = span.at(v);
      rowr::Pack<T, N> p, q;
      rowr::Pack<W, N> wv;
      rowr::Pack<B, N> bv;
      rowr::Pack<float, N> sv, ov;
      p.load(x + at + (size_t)g * N);
      q.load(r + at + (size_t)g * N);
      wv.load(w + (size_t)g * N);
      if constexpr (!GEMMA) bv.load(b + (size_t)g * N);
      if constexpr (QUANT) {
        sv.load(qs + (size_t)g * N);
        ov.load(qo + (size_t)g * N);
      }
      float f[N];
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = round_as(__fadd_rn(p.get(i), q.get(i)), x);
      put_add<T, MODE>(out, at + (size_t)g * N, f, rs, wv, bv, sv, ov);
    }
  }
  rowr::cluster_done(cluster);
}

// x [rows, hidden] of T -> out [rows, hidden] f32 = x / (its signed row
// sum).  N: elements a vector (16 bytes of out, or 1); VM: vectors a thread
// held in registers.  Grid and vectors as rms_norm_kernel's.
template <typename T, int N, int VM>
__global__ void __launch_bounds__(rowr::MAX_THREADS)
    l1_norm_kernel(const T* __restrict__ x, float* __restrict__ out, int rows, int hidden,
                   int cluster, int vecs, int block_rows) {
  __shared__ float red[2][rowr::MAX_THREADS / 32];
  __shared__ float part;
  const rowr::Rows rw(rows, cluster, block_rows);
  const rowr::Span span(hidden / N, cluster, rw.rank);
  rowr::Pack<T, N> cur[VM], nxt[VM];
  rowr::load_held(cur, x + (size_t)rw.lo * hidden, span, vecs);
  for (int row = rw.lo; row < rw.hi; ++row) {
    const T* xr = x + (size_t)row * hidden;
    float* yr = out + (size_t)row * hidden;
    if constexpr (rowr::AHEAD<VM>)
      if (row + 1 < rw.hi) rowr::load_held(nxt, xr + hidden, span, vecs);
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < VM; ++v)
      if (v < vecs && span.at(v) >= 0)
#pragma unroll
        for (int i = 0; i < N; ++i) s = __fadd_rn(s, cur[v].get(i));
    for (int v = VM; v < vecs && span.at(v) >= 0; ++v) {   // a row past the registers
      rowr::Pack<T, N> p;
      p.load(xr + (size_t)span.at(v) * N);
#pragma unroll
      for (int i = 0; i < N; ++i) s = __fadd_rn(s, p.get(i));
    }
    const float total = rowr::cluster_all<rowr::Sum>(
        rowr::block_all<rowr::Sum>(s, red[(row - rw.lo) & 1]), &part, cluster);
#pragma unroll
    for (int v = 0; v < VM; ++v) {
      if (v < vecs && span.at(v) >= 0) {
        float f[N];
#pragma unroll
        for (int i = 0; i < N; ++i) f[i] = __fdiv_rn(cur[v].get(i), total);
        rowr::store(yr + (size_t)span.at(v) * N, f);
      }
    }
    for (int v = VM; v < vecs && span.at(v) >= 0; ++v) {
      rowr::Pack<T, N> p;
      p.load(xr + (size_t)span.at(v) * N);
      float f[N];
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = __fdiv_rn(p.get(i), total);
      rowr::store(yr + (size_t)span.at(v) * N, f);
    }
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

template <typename T, typename W, typename B, int MODE>
int launch_add(const void* x, const void* r, const void* w, const void* b, const void* qs,
               const void* qo, void* out, void* added, int rows, int hidden, float eps,
               int cluster, int threads, int vecs, int elems, int block_rows, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  // the element path holds VMAX single elements: few registers, one instance
  auto kernel = elems == 1  ? add_rms_norm_kernel<T, W, B, MODE, 1, rowr::VMAX>
                : vecs <= 1 ? add_rms_norm_kernel<T, W, B, MODE, N, 1>
                : vecs <= 2 ? add_rms_norm_kernel<T, W, B, MODE, N, 2>
                : vecs <= 4 ? add_rms_norm_kernel<T, W, B, MODE, N, 4>
                            : add_rms_norm_kernel<T, W, B, MODE, N, rowr::VMAX>;
  const int blocks = cluster > 1 ? rows * cluster : (rows + block_rows - 1) / block_rows;
  return rowr::launch(kernel, blocks, threads, cluster, s, (const T*)x, (const T*)r, (const W*)w,
                      (const B*)b, (const float*)qs, (const float*)qo, out, (T*)added, rows,
                      hidden, cluster, vecs, block_rows, eps);
}

// launch_add for the mode and the weight's and bias's types (the Gemma mode
// reads no bias: it takes the weight's type)
template <typename T>
int launch_add_mode(const void* x, const void* r, const void* w, const void* b, const void* qs,
                    const void* qo, void* out, void* added, int rows, int hidden, int w_bf16,
                    int b_bf16, int mode, float eps, int cluster, int threads, int vecs,
                    int elems, int block_rows, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  using Fn = int (*)(const void*, const void*, const void*, const void*, const void*,
                     const void*, void*, void*, int, int, float, int, int, int, int, int,
                     cudaStream_t);
  static constexpr Fn bias[2][2] = {{launch_add<T, float, float, kBias>,
                                     launch_add<T, float, bf16, kBias>},
                                    {launch_add<T, bf16, float, kBias>,
                                     launch_add<T, bf16, bf16, kBias>}};
  static constexpr Fn quant[2][2] = {{launch_add<T, float, float, kBiasQuant>,
                                      launch_add<T, float, bf16, kBiasQuant>},
                                     {launch_add<T, bf16, float, kBiasQuant>,
                                      launch_add<T, bf16, bf16, kBiasQuant>}};
  static constexpr Fn gemma[2] = {launch_add<T, float, float, kGemma>,
                                  launch_add<T, bf16, bf16, kGemma>};
  const Fn run = mode == kGemma       ? gemma[w_bf16 != 0]
                 : mode == kBiasQuant ? quant[w_bf16 != 0][b_bf16 != 0]
                                      : bias[w_bf16 != 0][b_bf16 != 0];
  return run(x, r, w, b, qs, qo, out, added, rows, hidden, eps, cluster, threads, vecs, elems,
             block_rows, s);
}

template <typename T, int N>
int launch_l1_n(const void* x, void* out, int rows, int hidden, int cluster, int threads,
                int vecs, int block_rows, cudaStream_t s) {
  auto kernel = vecs <= 1   ? l1_norm_kernel<T, N, 1>
                : vecs <= 2 ? l1_norm_kernel<T, N, 2>
                : vecs <= 4 ? l1_norm_kernel<T, N, 4>
                            : l1_norm_kernel<T, N, rowr::VMAX>;
  const int blocks = cluster > 1 ? rows * cluster : (rows + block_rows - 1) / block_rows;
  return rowr::launch(kernel, blocks, threads, cluster, s, (const T*)x, (float*)out, rows, hidden,
                      cluster, vecs, block_rows);
}

// elems: 16 bytes of the output (4: an 8-byte load of bf16), or 1
template <typename T>
int launch_l1(const void* x, void* out, int rows, int hidden, int cluster, int threads, int vecs,
              int elems, int block_rows, cudaStream_t s) {
  auto run = elems == 4 ? launch_l1_n<T, 4> : launch_l1_n<T, 1>;
  return run(x, out, rows, hidden, cluster, threads, vecs, block_rows, s);
}

template <typename T, typename W, int N>
int launch_n(const void* x, const void* w, void* out, int rows, int hidden, float eps,
             int cluster, int threads, int vecs, int block_rows, cudaStream_t s) {
  auto kernel = vecs <= 1   ? rms_norm_kernel<T, W, N, 1>
                : vecs <= 2 ? rms_norm_kernel<T, W, N, 2>
                : vecs <= 4 ? rms_norm_kernel<T, W, N, 4>
                            : rms_norm_kernel<T, W, N, rowr::VMAX>;
  const int blocks = cluster > 1 ? rows * cluster : (rows + block_rows - 1) / block_rows;
  return rowr::launch(kernel, blocks, threads, cluster, s, (const T*)x, (const W*)w, (T*)out,
                      rows, hidden, cluster, vecs, block_rows, eps);
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, int rows, int hidden, float eps, int cluster,
           int threads, int vecs, int elems, int block_rows, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  return elems == N ? launch_n<T, W, N>(x, w, out, rows, hidden, eps, cluster, threads, vecs,
                                        block_rows, s)
                    : launch_n<T, W, 1>(x, w, out, rows, hidden, eps, cluster, threads, vecs,
                                        block_rows, s);
}

}  // namespace rmsnorm

// x [rows, hidden] (bf16 if x_bf16 else f32), w [hidden] (bf16 if w_bf16 else
// f32) -> out [rows, hidden] in x's type, on the wrapper's plan
// (ops/row_reduce.py _row_plan): `cluster` blocks a row (or, with cluster 1,
// `block_rows` rows a block) of `threads` threads, `vecs` vectors a thread of
// `elems` elements (16 bytes of x, or 1).
extern "C" int rms_norm_launch(const void* x, const void* w, void* out, int rows, int hidden,
                               int x_bf16, int w_bf16, float eps, int cluster, int threads,
                               int vecs, int elems, int block_rows, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  auto run = x_bf16 ? (w_bf16 ? rmsnorm::launch<bf16, bf16> : rmsnorm::launch<bf16, float>)
                    : (w_bf16 ? rmsnorm::launch<float, bf16> : rmsnorm::launch<float, float>);
  return run(x, w, out, rows, hidden, eps, cluster, threads, vecs, elems, block_rows, s);
}

// x, r [rows, hidden] (bf16 if x_bf16 else f32), w, b [hidden] (bf16 if
// w_bf16 / b_bf16 else f32), qs, qo [hidden] f32 (mode 1 only) -> out [rows,
// hidden] (int8 in mode 1, else x's type) and added [rows, hidden] in x's
// type.  mode 0: rmsnorm(x + r) * w + b (K6b); 1: the same quantized
// (K6b with a quant scale); 2: rmsnorm(x + r) * (w + 1) (K6c, b unread).
// On the wrapper's plan, as rms_norm_launch's.
extern "C" int add_rms_norm_launch(const void* x, const void* r, const void* w, const void* b,
                                   const void* qs, const void* qo, void* out, void* added,
                                   int rows, int hidden, int x_bf16, int w_bf16, int b_bf16,
                                   int mode, float eps, int cluster, int threads, int vecs,
                                   int elems, int block_rows, void* stream) {
  if (rows == 0) return 0;
  auto run = x_bf16 ? rmsnorm::launch_add_mode<__nv_bfloat16> : rmsnorm::launch_add_mode<float>;
  return run(x, r, w, b, qs, qo, out, added, rows, hidden, w_bf16, b_bf16, mode, eps, cluster,
             threads, vecs, elems, block_rows, (cudaStream_t)stream);
}

// x [rows, hidden] (bf16 if x_bf16 else f32) -> out [rows, hidden] f32, on
// the wrapper's plan, as rms_norm_launch's.
extern "C" int l1_norm_launch(const void* x, void* out, int rows, int hidden, int x_bf16,
                              int cluster, int threads, int vecs, int elems, int block_rows,
                              void* stream) {
  if (rows == 0) return 0;
  auto run = x_bf16 ? rmsnorm::launch_l1<__nv_bfloat16> : rmsnorm::launch_l1<float>;
  return run(x, out, rows, hidden, cluster, threads, vecs, elems, block_rows,
             (cudaStream_t)stream);
}
