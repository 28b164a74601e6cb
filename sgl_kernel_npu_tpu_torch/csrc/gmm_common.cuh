// Pieces shared by the W8A8 grouped expert GEMMs: the ring GEMMs
// (gmm_ring.cu, K3 / K4) and the tiled grouped GEMM (grouped_matmul.cu, K8a).
#pragma once

#include "common.cuh"

namespace gmm {

// 4 words = 4 consecutive k-rows x 4 columns of int8 -> 4 words = the 4 k
// bytes of each column (the dp4a operand, or the mma B fragment word, of that
// column).
__device__ __forceinline__ void transpose4x4(const uint32_t (&a)[4], uint32_t (&t)[4]) {
  const uint32_t lo01 = __byte_perm(a[0], a[1], 0x5140), lo23 = __byte_perm(a[2], a[3], 0x5140);
  const uint32_t hi01 = __byte_perm(a[0], a[1], 0x7362), hi23 = __byte_perm(a[2], a[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

namespace {   // internal linkage: each translation unit launches its own copy

// Per-row int8 requant of the SwiGLU activation: scale = max(amax / 127, 1e-12),
// h1 = clip(round_half_even(act / scale)).  Rows past the group total -> 0,
// scale 0.  One block per row.
__global__ void swiglu_requant_kernel(const float* __restrict__ act,
                                      const unsigned* __restrict__ amax,
                                      const int* __restrict__ offsets, int groups, int I,
                                      int8_t* __restrict__ h1, float* __restrict__ hs) {
  const int row = blockIdx.x;
  const bool live = row < offsets[groups];
  const float scale = live ? fmaxf(__uint_as_float(amax[row]) / 127.f, 1e-12f) : 0.f;
  for (int c = threadIdx.x; c < I; c += blockDim.x) {
    int8_t v = 0;
    if (live) {
      const float qv = rintf(act[(size_t)row * I + c] / scale);
      v = (int8_t)fminf(fmaxf(qv, -128.f), 127.f);
    }
    h1[(size_t)row * I + c] = v;
  }
  if (threadIdx.x == 0) hs[row] = scale;
}

}  // namespace

}  // namespace gmm
