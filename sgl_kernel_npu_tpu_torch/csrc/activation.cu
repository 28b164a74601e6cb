// swiglu_oai: GPT-OSS's clamped SwiGLU over interleaved gate / up, for Hopper.
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/activation.py:swiglu_oai
// (_swiglu_oai_kernel).  There the wrapper de-interleaves gate_up with XLA
// first (Mosaic rejects stride-2 shape casts), which costs a full extra read
// and write of the input; here the kernel reads the interleaved row itself:
// even lanes are gate, odd lanes up.  Per pair, in f32:
//   gate = min(gate, limit), up = clip(up, -limit, limit),
//   out  = (up + 1) * gate * sigmoid(alpha * gate), rounded once to x's type.
//
// Bound on the H100: bytes (read 2 values, write 1 a pair; a dozen operations).
// GPT-OSS's MoE applies it to all experts' rows: [n x 32, 5760] at n tokens.
//
// Design: a flat grid-stride loop over pairs, 4 pairs a thread with one
// 16-byte load (8 bf16; two for f32) and one 8-byte store (16 for f32);
// inputs whose pair count or address does not allow it go one pair at a time.
#include <algorithm>

#include "common.cuh"

namespace act {

constexpr int THREADS = 256;
constexpr int PAIRS = 4;             // pairs a thread handles at once on the vector path
constexpr int MAX_BLOCKS = 132 * 8;  // 8 blocks of 256 threads on each of the 132 SMs

__device__ __forceinline__ float clamped_glu(float gate, float up, float alpha, float limit) {
  const float g = fminf(gate, limit);
  const float u = fminf(fmaxf(up, -limit), limit);
  return (u + 1.f) * (g * (1.f / (1.f + expf(-g * alpha))));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 2 PAIRS interleaved values -> f32.
__device__ __forceinline__ void load_pairs(const __nv_bfloat16* p, float (&f)[2 * PAIRS]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x, f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load_pairs(const float* p, float (&f)[2 * PAIRS]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void store_outs(__nv_bfloat16* p, const float (&o)[PAIRS]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(o[0], o[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(o[2], o[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
}

__device__ __forceinline__ void store_outs(float* p, const float (&o)[PAIRS]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

// x [pairs x 2] interleaved (gate, up), out [pairs].
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    swiglu_oai_kernel(const T* __restrict__ x, T* __restrict__ out, size_t pairs, float alpha,
                      float limit) {
  const size_t stride = (size_t)gridDim.x * THREADS;
  if constexpr (VEC) {
    for (size_t t = (size_t)blockIdx.x * THREADS + threadIdx.x; t < pairs / PAIRS; t += stride) {
      float f[2 * PAIRS], o[PAIRS];
      load_pairs(x + t * 2 * PAIRS, f);
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) o[i] = clamped_glu(f[2 * i], f[2 * i + 1], alpha, limit);
      store_outs(out + t * PAIRS, o);
    }
  } else {
    for (size_t t = (size_t)blockIdx.x * THREADS + threadIdx.x; t < pairs; t += stride)
      store_f(out + t, clamped_glu(to_f(x[2 * t]), to_f(x[2 * t + 1]), alpha, limit));
  }
}

template <typename T>
int launch(const void* x, void* out, size_t pairs, float alpha, float limit, cudaStream_t s) {
  const bool vec = pairs % PAIRS == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % (PAIRS * sizeof(T)) == 0;
  const size_t work = vec ? pairs / PAIRS : pairs;
  const int blocks = (int)std::min<size_t>((work + THREADS - 1) / THREADS, MAX_BLOCKS);
  if (vec)
    swiglu_oai_kernel<T, true><<<blocks, THREADS, 0, s>>>((const T*)x, (T*)out, pairs, alpha,
                                                          limit);
  else
    swiglu_oai_kernel<T, false><<<blocks, THREADS, 0, s>>>((const T*)x, (T*)out, pairs, alpha,
                                                           limit);
  return (int)cudaGetLastError();
}

}  // namespace act

// gate_up [rows, 2I] interleaved (bf16 if in_bf16 else f32) -> out [rows, I]
// in the same type.
extern "C" int swiglu_oai_launch(const void* x, void* out, int rows, int I, int in_bf16,
                                 float alpha, float limit, void* stream) {
  const size_t pairs = (size_t)rows * I;
  if (pairs == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return in_bf16 ? act::launch<__nv_bfloat16>(x, out, pairs, alpha, limit, s)
                 : act::launch<float>(x, out, pairs, alpha, limit, s);
}
