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
// the sum and the output written (4 x 2 B an element in bf16).  One block
// of 128 threads per row, two passes: pass 1 forms a = x + r in f32, rounds it to x's type (as the
// TPU kernel's astype), writes it as `added` and sums a^2; pass 2 forms a
// again (bit-equal) and writes a * r * w + b (or a * r * (w + 1)) in f32,
// rounded once to x's type, or quantized to int8: round half to even, then
// clamp to [-128, 127].  The epilogue uses __fmul_rn / __fadd_rn so that nvcc
// contracts no product into an FMA: the plain version rounds each operation,
// and a contracted one would move int8 levels at rounding ties.
//
// l1_norm (K6d): the same block per row; pass 1 sums the row (signed) in f32,
// pass 2 divides each element by that sum in IEEE division (__fdiv_rn, not a
// multiply by the reciprocal), f32 out.
#include "common.cuh"
#include "row_reduce.cuh"

namespace rmsnorm {

constexpr int THREADS = 128;

// N consecutive elements as f32: one 16-byte load for N > 1.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&f)[N]) {
  if constexpr (N == 1) {
    f[0] = p[0];
  } else {
    static_assert(N == 4, "4 floats a 16-byte load");
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
  }
}

template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float (&f)[N]) {
  if constexpr (N == 1) {
    f[0] = __bfloat162float(p[0]);
  } else {
    static_assert(N == 8, "8 bf16 a 16-byte load");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x, f[2 * i + 1] = t.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&f)[N]) {
  if constexpr (N == 1) {
    p[0] = f[0];
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

template <int N>
__device__ __forceinline__ void store_n(__nv_bfloat16* p, const float (&f)[N]) {
  if constexpr (N == 1) {
    p[0] = __float2bfloat16_rn(f[0]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&t);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Sum over the block, in a fixed order; every thread gets the result.
__device__ float block_sum(float v) {
  __shared__ float red[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = sgl::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) s += red[i];
  return s;
}

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

// f32 value of element i of a bf16 or f32 vector (the weight and bias may be
// either type: a uniform branch).
__device__ __forceinline__ float load_any(const void* p, int bf16, int i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// N int8 values, one store for N > 1 (N bytes, aligned by the caller).
template <int N>
__device__ __forceinline__ void store_i8(int8_t* p, const float (&f)[N]) {
  int8_t q[N];
#pragma unroll
  for (int i = 0; i < N; ++i) q[i] = (int8_t)fminf(fmaxf(rintf(f[i]), -128.f), 127.f);
  if constexpr (N == 1) {
    p[0] = q[0];
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(q);
  } else {
    static_assert(N == 8, "4 or 8 int8 a store");
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(q);
  }
}

// N f32 values: float4 stores for N >= 4.
template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[N]) {
  if constexpr (N == 1) {
    p[0] = f[0];
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
}

enum AddMode { kBias = 0, kBiasQuant = 1, kGemma = 2 };

// a = x + r at columns [c, c + N), rounded to T.
template <typename T, int N>
__device__ __forceinline__ void added_n(const T* x, const T* r, int c, float (&a)[N]) {
  float v[N];
  load_n(x + c, a);
  load_n(r + c, v);
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = round_as(a[i] + v[i], x);
}

// x, r, added [rows, hidden] of T; w, b [hidden] (bf16 if w_bf16 / b_bf16,
// else f32); qs, qo [hidden] f32 (kBiasQuant only); out [rows, hidden] of T,
// or int8 in kBiasQuant.  b is unread in kGemma.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
    add_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                        const void* __restrict__ w, const void* __restrict__ b,
                        const float* __restrict__ qs, const float* __restrict__ qo,
                        void* __restrict__ out, T* __restrict__ added, int hidden, int w_bf16,
                        int b_bf16, int mode, float eps) {
  const size_t base = (size_t)blockIdx.x * hidden;
  const T* xr = x + base;
  const T* rr = r + base;
  float ss = 0.f;
  for (int c = threadIdx.x * N; c < hidden; c += THREADS * N) {
    float a[N];
    added_n(xr, rr, c, a);
    store_n(added + base + c, a);   // exact: a already lies on T's grid
#pragma unroll
    for (int i = 0; i < N; ++i) ss += a[i] * a[i];
  }
  const float rs = 1.f / sqrtf(block_sum(ss) / (float)hidden + eps);
  for (int c = threadIdx.x * N; c < hidden; c += THREADS * N) {
    float a[N];
    added_n(xr, rr, c, a);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float wi = load_any(w, w_bf16, c + i);
      float v = __fmul_rn(__fmul_rn(a[i], rs), mode == kGemma ? __fadd_rn(wi, 1.f) : wi);
      if (mode != kGemma) v = __fadd_rn(v, load_any(b, b_bf16, c + i));
      if (mode == kBiasQuant) v = __fadd_rn(__fmul_rn(v, qs[c + i]), qo[c + i]);
      a[i] = v;
    }
    if (mode == kBiasQuant)
      store_i8(static_cast<int8_t*>(out) + base + c, a);
    else
      store_n(static_cast<T*>(out) + base + c, a);
  }
}

// x [rows, hidden] of T -> out [rows, hidden] f32 = x / (signed row sum).
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
    l1_norm_kernel(const T* __restrict__ x, float* __restrict__ out, int hidden) {
  const size_t base = (size_t)blockIdx.x * hidden;
  float sum = 0.f;
  for (int c = threadIdx.x * N; c < hidden; c += THREADS * N) {
    float v[N];
    load_n(x + base + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) sum += v[i];
  }
  const float total = block_sum(sum);
  for (int c = threadIdx.x * N; c < hidden; c += THREADS * N) {
    float v[N];
    load_n(x + base + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __fdiv_rn(v[i], total);
    store_f32(out + base + c, v);
  }
}

__host__ __forceinline__ bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T>
int launch_add(const void* x, const void* r, const void* w, const void* b, const void* qs,
               const void* qo, void* out, void* added, int rows, int hidden, int w_bf16,
               int b_bf16, int mode, float eps, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  const bool vec = hidden % N == 0 && aligned16(x) && aligned16(r) && aligned16(added) &&
                   (uintptr_t)out % 16 == 0;
  if (vec)
    add_rms_norm_kernel<T, N><<<rows, THREADS, 0, s>>>(
        (const T*)x, (const T*)r, w, b, (const float*)qs, (const float*)qo, out, (T*)added,
        hidden, w_bf16, b_bf16, mode, eps);
  else
    add_rms_norm_kernel<T, 1><<<rows, THREADS, 0, s>>>(
        (const T*)x, (const T*)r, w, b, (const float*)qs, (const float*)qo, out, (T*)added,
        hidden, w_bf16, b_bf16, mode, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_l1(const void* x, void* out, int rows, int hidden, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  if (hidden % N == 0 && aligned16(x) && aligned16(out))
    l1_norm_kernel<T, N><<<rows, THREADS, 0, s>>>((const T*)x, (float*)out, hidden);
  else
    l1_norm_kernel<T, 1><<<rows, THREADS, 0, s>>>((const T*)x, (float*)out, hidden);
  return (int)cudaGetLastError();
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
extern "C" int add_rms_norm_launch(const void* x, const void* r, const void* w, const void* b,
                                   const void* qs, const void* qo, void* out, void* added,
                                   int rows, int hidden, int x_bf16, int w_bf16, int b_bf16,
                                   int mode, float eps, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return rmsnorm::launch_add<__nv_bfloat16>(x, r, w, b, qs, qo, out, added, rows, hidden,
                                              w_bf16, b_bf16, mode, eps, s);
  return rmsnorm::launch_add<float>(x, r, w, b, qs, qo, out, added, rows, hidden, w_bf16, b_bf16,
                                    mode, eps, s);
}

// x [rows, hidden] (bf16 if x_bf16 else f32) -> out [rows, hidden] f32.
extern "C" int l1_norm_launch(const void* x, void* out, int rows, int hidden, int x_bf16,
                              void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return x_bf16 ? rmsnorm::launch_l1<__nv_bfloat16>(x, out, rows, hidden, s)
                : rmsnorm::launch_l1<float>(x, out, rows, hidden, s);
}
