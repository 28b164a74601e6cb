// rms_norm: RMSNorm over the last dim of [rows, hidden], for Hopper.
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/norm.py:rms_norm
// (_rms_norm_kernel), which normalizes a block of up to 256 whole rows held in
// VMEM.
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
