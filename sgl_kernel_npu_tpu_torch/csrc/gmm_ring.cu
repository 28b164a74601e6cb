// gmm1_ring / gmm2_combine_ring: the W8A8 grouped expert GEMMs of the MoE
// layer, for Hopper.
//
// Replace the TPU kernels sgl_kernel_npu_tpu/ops/gmm_ring.py:gmm1_ring
// (_gmm1_ring_kernel, int8 or float tokens: the in-kernel quant mode) and
// gmm2_combine_ring (_gmm2_combine_ring_kernel).  Those
// run one sequential grid step that streams each live group's weights through
// a manual DMA ring and build the row dispatch and the combine as one-hot MXU
// products.  Here the routing is plain indexing: a block gathers its rows by
// tok_of_row, finds its group's rows from the offsets, and the combine gathers
// each token's top-k rows by dest.
//
// Bound on the H100: bytes.  At decode and prefill-chunk sizes every touched
// expert holds a few rows, so each touched expert's int8 slab (7168 x 4096 for
// GMM1, 2048 x 7168 for GMM2 at DeepSeek-V3 width) must stream from HBM once
// and the int8 operations (2 x rows x K x N) are far below the card's rate.
//
// Design: no tile schedule and no staging of weights in shared memory.  Block
// (group g, column tile of 128 columns per segment), 4 warps.  Lane l owns 4
// consecutive columns of each segment it reads (GMM1: gate columns c..c+3 AND
// up columns I+c..I+c+3, so SwiGLU pairs within the lane; GMM2: c..c+3); warp
// w walks the w-th quarter of the K depth (split-K: 4x the loads in flight of
// one warp walking all of K).  Per step a lane loads one 4-byte word from each
// of 4 consecutive k-rows (a warp reads 128 contiguous bytes of a row),
// transposes the 4 x 4 bytes in registers into dp4a operands and accumulates
// int8 x int8 in int32 exactly for up to 4 rows of the group at once.  The
// quarters meet in shared memory, where warp r sums row r's four partial
// sums (in a fixed order: deterministic) and runs its epilogue.  Weights
// stream from HBM once per 4 rows of a group (a group of at most 4 rows, the
// decode case, reads its weights exactly once; larger groups re-read them,
// mostly from L2).  Epilogues:
// - GMM1: dequant by scale_x[token] x scale_w, SwiGLU on the full-width
//   gate || up packing, the activation to an f32 scratch row and its |max| to
//   a per-row atomicMax (non-negative floats order as unsigned ints, so the
//   result is exact and deterministic); a second pass requantizes each row to
//   int8 (the amax over the row's whole width is known only after every
//   column tile has run).
// - GMM2: dequant by hs[row] x scale_w into an f32 scratch [S, N]; a second
//   pass sums each token's top-k rows with its f32 weights, plus the optional
//   init, in a fixed order (deterministic, no float atomics).
// Rows outside every group read as zeros (h1 = 0, hs = 0; no combine
// contribution).
// GMM1's float-input mode (bf16 or f32 tokens) quantizes in the same kernel,
// each token once a launch: before a pass, the block claims each of its rows'
// tokens with a compare-and-swap on a per-token flag (0 fresh, 1 claimed, 2
// done).  The claimer quantizes the token into the int8 / scale scratch (K5's
// formula: scale max(amax / 127, 1e-12), true division, round half to even,
// saturate, so the result is K5 then the int8 mode's bit for bit) and
// release-stores 2; a block that finds the token claimed spins on an acquire
// load until it is done.  A block quantizes all its claims before it waits,
// so no block waits on one that is not running.  The scratch is read back by
// plain loads ordered after the acquire, never through the read-only path.
#include "gmm_common.cuh"

namespace gmm {

constexpr int WARPS = 4;                 // K quarters, one per warp
constexpr int THREADS = 32 * WARPS;
constexpr int RP = WARPS;                // rows of a group per pass (warp r finishes row r)
constexpr int CPT = 4;                   // columns per lane and segment (one 4-byte word)
constexpr int COLS = 32 * CPT;           // columns of a segment per block
constexpr int MAX_TOPK = 32;

enum Epilogue { kSwiGLU = 0, kDequant = 1 };
enum XIn { kInt8 = 0, kBF16In = 1, kF32In = 2 };   // the tokens' type

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ float load_in(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_in(const float* p, size_t i) { return p[i]; }

// Quantize token t into xq[t] / sx[t] (all threads of the block).
template <class InT>
__device__ void quant_token(const InT* __restrict__ xf, int t, int K, int8_t* xq, float* sx) {
  __shared__ float red[WARPS];
  const size_t base = (size_t)t * K;
  float m = 0.f;
#pragma unroll 8
  for (int c = threadIdx.x; c < K; c += THREADS) m = fmaxf(m, fabsf(load_in(xf, base + c)));
  m = sgl::warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < WARPS; ++i) m = fmaxf(m, red[i]);
  const float s = fmaxf(m / 127.f, 1e-12f);
#pragma unroll 8
  for (int c = threadIdx.x; c < K; c += THREADS)
    xq[base + c] = (int8_t)fminf(fmaxf(rintf(load_in(xf, base + c) / s), -128.f), 127.f);
  if (threadIdx.x == 0) sx[t] = s;
  __syncthreads();                   // red is reused; the stores precede the release
}

// The float-input mode's quant of a pass's rows r0 .. r0 + nr - 1 (all
// threads of the block): thread r claims row r's token; the block quantizes
// the tokens it claimed and releases them, then waits for the others.  On
// return every token of the pass is in xq / sx and visible to the block.
template <class InT>
__device__ void quant_pass(const InT* __restrict__ xf, const int* __restrict__ row_src,
                           int r0, int nr, int n_src, int K, int8_t* xq, float* sx,
                           int* qflag) {
  __shared__ int tok[RP], state[RP];   // state: the flag's value before the claim
  const int r = threadIdx.x;
  if (r < nr) {
    const int t = row_src ? row_src[r0 + r] : r0 + r;
    const bool valid = t >= 0 && t < n_src;
    tok[r] = t;
    state[r] = valid ? atomicCAS(qflag + t, 0, 1) : -1;   // -1: a pad row
  }
  __syncthreads();
  for (int rr = 0; rr < nr; ++rr)
    if (state[rr] == 0) {
      quant_token(xf, tok[rr], K, xq, sx);
      if (threadIdx.x == 0) {
        __threadfence();
        st_release_gpu(qflag + tok[rr], 2);
      }
    }
  if (r < nr && state[r] > 0) {      // claimed elsewhere, or done: acquire it
    while (ld_acquire_gpu(qflag + tok[r]) != 2) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();                   // tok and state are reused by the next pass
}

// A 4-byte word of the int8 rows: the read-only path for int8 tokens; for the
// scratch this launch writes, a plain (coherent) load, ordered after the
// flag's acquire by the block barrier.
template <int XF>
__device__ __forceinline__ int load_x4(const int8_t* p) {
  return XF == kInt8 ? __ldg(reinterpret_cast<const int*>(p))
                     : *reinterpret_cast<const int*>(p);
}

// x [n_src, K] int8 rows (row r reads x[row_src[r]], or x[r] without row_src),
// w [G, K, N] int8, offsets [G + 1].  NSEG segments of seg_width columns each
// (GMM1: gate then up, seg_width = N / 2; GMM2: one of N); lane l's columns
// are c = blockIdx.y * COLS + 4 l of each segment.  K % 4 == 0.  XF != kInt8:
// x and scale_x are scratch that the kernel fills from the float tokens xf
// (qflag [n_src] zeroed).
template <int NSEG, int EPI, int XF = kInt8>
__global__ void __launch_bounds__(THREADS)
    grouped_w8a8_kernel(const int8_t* x, const int* __restrict__ row_src,
                        int n_src, const int8_t* __restrict__ w,
                        const int* __restrict__ offsets, const float* scale_x,
                        const float* __restrict__ scale_w, int K, int N,
                        float* __restrict__ out, unsigned* __restrict__ amax,
                        const void* __restrict__ xf = nullptr, int* qflag = nullptr) {
  __shared__ int part[WARPS][RP][NSEG][CPT][32];   // each quarter's partial sums
  const int g = blockIdx.x;
  const int r_begin = offsets[g], r_end = offsets[g + 1];
  if (r_begin >= r_end) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg_width = N / NSEG;
  const int c = blockIdx.y * COLS + CPT * lane;
  const bool active = c < seg_width;     // inactive lanes still join the shuffles
  const int8_t* wg = w + (size_t)g * K * N + (active ? c : 0);
  const int quarter = (K / 4 + WARPS - 1) / WARPS * 4;
  const int k_lo = min(K, warp * quarter), k_hi = min(K, k_lo + quarter);

  for (int r0 = r_begin; r0 < r_end; r0 += RP) {
    const int nr = min(RP, r_end - r0);
    if (XF == kBF16In)
      quant_pass((const __nv_bfloat16*)xf, row_src, r0, nr, n_src, K, const_cast<int8_t*>(x),
                 const_cast<float*>(scale_x), qflag);
    else if (XF == kF32In)
      quant_pass((const float*)xf, row_src, r0, nr, n_src, K, const_cast<int8_t*>(x),
                 const_cast<float*>(scale_x), qflag);
    const int8_t* xr[RP];
#pragma unroll
    for (int rr = 0; rr < RP; ++rr) {
      int src = -1;
      if (rr < nr) {
        src = row_src ? row_src[r0 + rr] : r0 + rr;
        if (src < 0 || src >= n_src) src = -1;   // pad row: reads as zero
      }
      xr[rr] = src >= 0 ? x + (size_t)src * K : nullptr;
    }
    int acc[RP][NSEG][CPT];
#pragma unroll
    for (int rr = 0; rr < RP; ++rr)
#pragma unroll
      for (int s = 0; s < NSEG; ++s)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[rr][s][j] = 0;

    if (active) {
      // 32 weight words in flight per lane whatever the segment count
#pragma unroll (8 / NSEG)
      for (int k = k_lo; k < k_hi; k += 4) {
        uint32_t wt[NSEG][4];
#pragma unroll
        for (int s = 0; s < NSEG; ++s) {
          uint32_t a[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            a[j] = __ldg(reinterpret_cast<const uint32_t*>(wg + (size_t)(k + j) * N +
                                                           s * seg_width));
          transpose4x4(a, wt[s]);
        }
#pragma unroll
        for (int rr = 0; rr < RP; ++rr) {
          if (xr[rr] == nullptr) continue;
          const int xv = load_x4<XF>(xr[rr] + k);
#pragma unroll
          for (int s = 0; s < NSEG; ++s)
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[rr][s][j] = __dp4a(xv, (int)wt[s][j], acc[rr][s][j]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RP; ++rr)
#pragma unroll
      for (int s = 0; s < NSEG; ++s)
#pragma unroll
        for (int j = 0; j < CPT; ++j) part[warp][rr][s][j][lane] = acc[rr][s][j];
    __syncthreads();

    if (warp < nr) {                      // warp r finishes row r of this pass
      const int rr = warp, row = r0 + rr;
      int src = row_src ? row_src[row] : row;
      const float sx = (src >= 0 && src < n_src) ? scale_x[src] : 0.f;
      int sum[NSEG][CPT];
#pragma unroll
      for (int s = 0; s < NSEG; ++s)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          sum[s][j] = part[0][rr][s][j][lane] + part[1][rr][s][j][lane] +
                      part[2][rr][s][j][lane] + part[3][rr][s][j][lane];
      const float* sw = scale_w + (size_t)g * N + c;
      if (EPI == kSwiGLU) {
        float m = 0.f;
        if (active) {
          float act[CPT];
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const float d0 = (float)sum[0][j] * sx * sw[j];
            const float d1 = (float)sum[NSEG - 1][j] * sx * sw[seg_width + j];
            act[j] = d0 * (1.f / (1.f + expf(-d0))) * d1;
            m = fmaxf(m, fabsf(act[j]));
          }
          *reinterpret_cast<float4*>(out + (size_t)row * seg_width + c) =
              make_float4(act[0], act[1], act[2], act[3]);
        }
        m = sgl::warp_max(m);
        if (lane == 0) atomicMax(amax + row, __float_as_uint(m));
      } else if (active) {
        float d[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) d[j] = (float)sum[0][j] * sx * sw[j];
        *reinterpret_cast<float4*>(out + (size_t)row * N + c) = make_float4(d[0], d[1], d[2], d[3]);
      }
    }
    __syncthreads();                      // part is rewritten by the next pass
  }
}

// out[t] = init[t] + sum_k topw[t, k] * y[dest[t, k]]; dest rows outside every
// group contribute nothing.
__global__ void combine_kernel(const float* __restrict__ y, const int* __restrict__ dest,
                               const float* __restrict__ topw,
                               const float* __restrict__ init,
                               const int* __restrict__ offsets, int groups, int ktop,
                               int N, float* __restrict__ out) {
  __shared__ int d_s[MAX_TOPK];
  __shared__ float w_s[MAX_TOPK];
  const int t = blockIdx.x;
  if (threadIdx.x < ktop) {
    const int total = offsets[groups];
    const int d = dest[(size_t)t * ktop + threadIdx.x];
    d_s[threadIdx.x] = (d >= 0 && d < total) ? d : -1;
    w_s[threadIdx.x] = topw[(size_t)t * ktop + threadIdx.x];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc = init ? init[(size_t)t * N + n] : 0.f;
    for (int k = 0; k < ktop; ++k)
      if (d_s[k] >= 0) acc += w_s[k] * y[(size_t)d_s[k] * N + n];
    out[(size_t)t * N + n] = acc;
  }
}

}  // namespace gmm

// xq [n_tok, K] int8 tokens, tok_of_row [S] int32, w1 [G, K, N] int8 (N = 2I,
// gate || up full width), offsets [G + 1] int32, sx_tok [n_tok] f32, sw [G, N]
// f32; scratch act [S, I] f32 and amax [S] u32; out h1 [S, I] int8, hs [S]
// f32.  With xf (the float-input mode: [n_tok, K] bf16 if xf_bf16, else f32)
// xq and sx_tok are scratch that the kernel fills, each token once, and qflag
// [n_tok] int32 is scratch too.  Needs K % 4 == 0 and I % 4 == 0.
extern "C" int gmm1_ring_launch(const void* xq, const void* tok_of_row, int n_tok,
                                const void* w1, const void* offsets, int groups, int S,
                                int K, int N, const void* sx_tok, const void* sw,
                                void* act, void* amax, void* h1, void* hs, const void* xf,
                                int xf_bf16, void* qflag, void* stream) {
  if (S == 0) return 0;
  if (K % 4 != 0 || N % (2 * gmm::CPT) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int I = N / 2;
  cudaMemsetAsync(amax, 0, sizeof(unsigned) * (size_t)S, s);
  dim3 grid(groups, (I + gmm::COLS - 1) / gmm::COLS);
  const auto launch = [&](auto kernel) {
    kernel<<<grid, gmm::THREADS, 0, s>>>(
        (const int8_t*)xq, (const int*)tok_of_row, n_tok, (const int8_t*)w1,
        (const int*)offsets, (const float*)sx_tok, (const float*)sw, K, N, (float*)act,
        (unsigned*)amax, xf, (int*)qflag);
  };
  if (xf == nullptr) {
    launch(gmm::grouped_w8a8_kernel<2, gmm::kSwiGLU, gmm::kInt8>);
  } else {
    cudaMemsetAsync(qflag, 0, sizeof(int) * (size_t)n_tok, s);
    if (xf_bf16)
      launch(gmm::grouped_w8a8_kernel<2, gmm::kSwiGLU, gmm::kBF16In>);
    else
      launch(gmm::grouped_w8a8_kernel<2, gmm::kSwiGLU, gmm::kF32In>);
  }
  gmm::swiglu_requant_kernel<<<S, 256, 0, s>>>(
      (const float*)act, (const unsigned*)amax, (const int*)offsets, groups, I,
      (int8_t*)h1, (float*)hs);
  return (int)cudaGetLastError();
}

// x [S, K] int8 (GMM1 output), w2 [G, K, N] int8, offsets [G + 1], sx [S] f32,
// sw [G, N] f32, dest / topw [n_tok, ktop], init [n_tok, N] f32 or null;
// scratch y [S, N] f32; out [n_tok, N] f32.  Needs K % 4 == 0, N % 4 == 0
// and ktop <= 32.
extern "C" int gmm2_combine_ring_launch(const void* x, int S, int K, const void* w2,
                                        const void* offsets, int groups, int N,
                                        const void* sx, const void* sw, const void* dest,
                                        const void* topw, const void* init, int n_tok,
                                        int ktop, void* y, void* out, void* stream) {
  if (n_tok == 0) return 0;
  if (K % 4 != 0 || N % gmm::CPT != 0 || ktop > gmm::MAX_TOPK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (S > 0) {
    dim3 grid(groups, (N + gmm::COLS - 1) / gmm::COLS);
    gmm::grouped_w8a8_kernel<1, gmm::kDequant><<<grid, gmm::THREADS, 0, s>>>(
        (const int8_t*)x, nullptr, S, (const int8_t*)w2, (const int*)offsets,
        (const float*)sx, (const float*)sw, K, N, (float*)y, nullptr);
  }
  gmm::combine_kernel<<<n_tok, 256, 0, s>>>(
      (const float*)y, (const int*)dest, (const float*)topw, (const float*)init,
      (const int*)offsets, groups, ktop, N, (float*)out);
  return (int)cudaGetLastError();
}
