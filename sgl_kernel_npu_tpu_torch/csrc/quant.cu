// quant_per_token and swiglu_quant: per-row dynamic int8 quantization, alone
// and fused behind SwiGLU, for Hopper.
//
// Replace the TPU kernels sgl_kernel_npu_tpu/ops/quant.py:quant_per_token
// (_quant_kernel) and sgl_kernel_npu_tpu/ops/activation.py:swiglu_quant
// (_swiglu_quant_kernel), which quantize a block of rows held whole in VMEM.
//
// Bound on the H100: bytes, and at the serving path's sizes (8-64 rows of
// 4,096-16,384 values, 0.1-2 MB) really the launch: a call is a few
// microseconds of fixed cost against a bound of well under one.
//
// Design: one block per row, two passes over the row.  Pass 1 takes the row's
// |max| (block reduction in a fixed order: deterministic); pass 2 re-reads the
// row (from L1/L2) and writes round_half_even(v / scale) saturated to int8.
// The division is IEEE division (no fast math), as the plain versions divide:
// a reciprocal multiply would flip values at rounding ties by one level
// (sgl_kernel_npu_tpu/ops/quant.py:wire_quant records the same hazard).
// - quant_per_token: scale = max(amax / 127, 1e-12), and that clamped scale
//   is returned.
// - swiglu_quant: v = silu(gate) * up in f32 over the gate || up halves, rows
//   at or past `total` (a device scalar: the group list's total) are zeros;
//   the returned scale is amax / 127 UNCLAMPED (a zero row returns 0), only
//   the division uses max(scale, 1e-12).  Without quant the activation is
//   written in the input's type and the scales are zeros.
#include "common.cuh"

namespace quant {

constexpr int THREADS = 256;

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int8_t saturate(float v) {
  return (int8_t)fminf(fmaxf(rintf(v), -128.f), 127.f);
}

// Max over the block, in a fixed order; every thread gets the result.
__device__ float block_max(float v) {
  __shared__ float red[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = sgl::warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) m = fmaxf(m, red[i]);
  return m;
}

__device__ __forceinline__ float silu_mul(float gate, float up) {
  return gate * (1.f / (1.f + expf(-gate))) * up;
}

template <typename InT>
__global__ void __launch_bounds__(THREADS)
    quant_per_token_kernel(const InT* __restrict__ x, int hidden, int8_t* __restrict__ q,
                           float* __restrict__ scale) {
  const size_t base = (size_t)blockIdx.x * hidden;
  float m = 0.f;
  for (int c = threadIdx.x; c < hidden; c += THREADS) m = fmaxf(m, fabsf(load_f(x, base + c)));
  const float s = fmaxf(block_max(m) / 127.f, 1e-12f);
  for (int c = threadIdx.x; c < hidden; c += THREADS) q[base + c] = saturate(load_f(x, base + c) / s);
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
}

// x [rows, 2I]; out [rows, I] int8 (QUANT) or InT; scale [rows].
template <typename InT, bool QUANT>
__global__ void __launch_bounds__(THREADS)
    swiglu_quant_kernel(const InT* __restrict__ x, int I, const int* __restrict__ total,
                        void* __restrict__ out, float* __restrict__ scale) {
  const int row = blockIdx.x;
  const bool live = total == nullptr || row < *total;
  const size_t in = (size_t)row * 2 * I, o = (size_t)row * I;
  if (!QUANT) {
    InT* y = static_cast<InT*>(out);
    for (int c = threadIdx.x; c < I; c += THREADS)
      store_f(y, o + c, live ? silu_mul(load_f(x, in + c), load_f(x, in + I + c)) : 0.f);
    if (threadIdx.x == 0) scale[row] = 0.f;
    return;
  }
  int8_t* q = static_cast<int8_t*>(out);
  float m = 0.f;
  if (live)
    for (int c = threadIdx.x; c < I; c += THREADS)
      m = fmaxf(m, fabsf(silu_mul(load_f(x, in + c), load_f(x, in + I + c))));
  const float s = block_max(m) / 127.f;
  const float safe = fmaxf(s, 1e-12f);
  for (int c = threadIdx.x; c < I; c += THREADS)
    q[o + c] = live ? saturate(silu_mul(load_f(x, in + c), load_f(x, in + I + c)) / safe) : 0;
  if (threadIdx.x == 0) scale[row] = s;
}

}  // namespace quant

// x [rows, hidden] (bf16 if in_bf16 else f32) -> q [rows, hidden] int8,
// scale [rows] f32.
extern "C" int quant_per_token_launch(const void* x, int rows, int hidden, int in_bf16, void* q,
                                      void* scale, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16)
    quant::quant_per_token_kernel<<<rows, quant::THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, hidden, (int8_t*)q, (float*)scale);
  else
    quant::quant_per_token_kernel<<<rows, quant::THREADS, 0, s>>>(
        (const float*)x, hidden, (int8_t*)q, (float*)scale);
  return (int)cudaGetLastError();
}

// x [rows, 2I] (bf16 if in_bf16 else f32), total = device int32 row count or
// null (every row live) -> out [rows, I] (int8 if need_quant, else x's type),
// scale [rows] f32.
extern "C" int swiglu_quant_launch(const void* x, int rows, int I, int in_bf16,
                                   const void* total, int need_quant, void* out, void* scale,
                                   void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* tot = (const int*)total;
  float* sc = (float*)scale;
  if (in_bf16) {
    auto xb = (const __nv_bfloat16*)x;
    if (need_quant)
      quant::swiglu_quant_kernel<__nv_bfloat16, true><<<rows, quant::THREADS, 0, s>>>(xb, I, tot, out, sc);
    else
      quant::swiglu_quant_kernel<__nv_bfloat16, false><<<rows, quant::THREADS, 0, s>>>(xb, I, tot, out, sc);
  } else {
    auto xf = (const float*)x;
    if (need_quant)
      quant::swiglu_quant_kernel<float, true><<<rows, quant::THREADS, 0, s>>>(xf, I, tot, out, sc);
    else
      quant::swiglu_quant_kernel<float, false><<<rows, quant::THREADS, 0, s>>>(xf, I, tot, out, sc);
  }
  return (int)cudaGetLastError();
}
