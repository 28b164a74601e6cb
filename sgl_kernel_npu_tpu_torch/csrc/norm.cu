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
// Design: one block of 128 threads per row, two passes.  Pass 1 sums x^2 in
// f32 with 16-byte loads (8 bf16 or 4 f32 a load: hidden = 2880 is 360 bf16
// loads, not a power of two, so the threads stride over the row) and reduces
// it over the block in a fixed order; pass 2 re-reads the row (from L1) and
// writes x * (1 / sqrt(mean + eps)) * w in f32, rounded once to x's type.
// Rows whose width or address does not allow 16-byte loads take the same
// passes one element at a time.
//
// add_rms_norm (K6b / K6c) is bound by bytes too: x and the residual read,
// the sum and the output written (4 x 2 B an element in bf16).  The same
// block per row: pass 1 forms a = x + r in f32, rounds it to x's type (as the
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

namespace rmsnorm {

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// x, out [rows, hidden] of T; w [hidden] of W.  N: elements a load (1, or
// 16 bytes' worth).
template <typename T, typename W, int N>
__global__ void __launch_bounds__(THREADS)
    rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
                    int hidden, float eps) {
  const size_t base = (size_t)blockIdx.x * hidden;
  const T* xr = x + base;
  float ss = 0.f;
  for (int c = threadIdx.x * N; c < hidden; c += THREADS * N) {
    float v[N];
    load_n(xr + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) ss += v[i] * v[i];
  }
  const float r = 1.f / sqrtf(block_sum(ss) / (float)hidden + eps);
  for (int c = threadIdx.x * N; c < hidden; c += THREADS * N) {
    float v[N];
    load_n(xr + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = v[i] * r * to_f(w[c + i]);
    store_n(out + base + c, v);
  }
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

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, int rows, int hidden, float eps,
           cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  const bool vec = hidden % N == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec)
    rms_norm_kernel<T, W, N><<<rows, THREADS, 0, s>>>((const T*)x, (const W*)w, (T*)out,
                                                      hidden, eps);
  else
    rms_norm_kernel<T, W, 1><<<rows, THREADS, 0, s>>>((const T*)x, (const W*)w, (T*)out,
                                                      hidden, eps);
  return (int)cudaGetLastError();
}

}  // namespace rmsnorm

// x [rows, hidden] (bf16 if x_bf16 else f32), w [hidden] (bf16 if w_bf16 else
// f32) -> out [rows, hidden] in x's type.
extern "C" int rms_norm_launch(const void* x, const void* w, void* out, int rows, int hidden,
                               int x_bf16, int w_bf16, float eps, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    return w_bf16 ? rmsnorm::launch<bf16, bf16>(x, w, out, rows, hidden, eps, s)
                  : rmsnorm::launch<bf16, float>(x, w, out, rows, hidden, eps, s);
  return w_bf16 ? rmsnorm::launch<float, bf16>(x, w, out, rows, hidden, eps, s)
                : rmsnorm::launch<float, float>(x, w, out, rows, hidden, eps, s);
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
