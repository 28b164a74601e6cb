// lightning_indexer: the lightning indexer's prefill scores (DeepSeek-V3.2 DSA), Hopper.
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/attention/lightning_indexer.py:
// lightning_indexer_scores_prefill_pallas (_li_prefill_kernel), whose
// (request, q-chunk, key page) grid reads each key page once per q-chunk.
//
// For request b, query row t and key position p of its paged index-key cache:
//   s[b, t, p] = sum_h w[b, t, h] * relu(q[b, t, h, :] . k[p, :])   (f32)
// and -inf where p > lk - lq + t (causal; lk - 1 without causality), p >= lk,
// or t >= lq.  (The TPU kernel also writes -inf on the pages past its
// chunk's causal page; the causal mask already covers them.)
//
// Bound on the H100: operations.  At a 2048-token chunk of 64 heads x 128
// against ~3,000 causal keys the products are ~0.1 TFLOP (bf16 tensor cores,
// ~0.1 ms) against ~70 MB of queries and scores (~0.02 ms).
//
// Design: one block per (key page, tile of 128 / N1 tokens, request), so the
// tile's 128 (token, head) rows of q stay in shared memory while the page's
// keys pass through it 64 at a time.  8 warps: warp w owns 16 rows (16 heads
// of one token) and holds their A fragments (16 x 128, bf16) in registers for
// the whole page; S = Q K^T runs on mma.sync m16n8k16 with f32 accumulation.
// The epilogue stays in registers: relu, times the row's weight, summed over
// the warp's 16 heads by shuffles; the N1 / 16 warps of a token meet in shared
// memory.  A page no row of the tile can see writes -inf and does no product.
#include <math.h>

#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int D = 128;           // index-key width
constexpr int LDK = D + 8;       // smem row stride: rows 16 B apart in banks
constexpr int ROWS = 128;        // (token, head) rows a block
constexpr int KC = 64;           // keys a chunk
constexpr int THREADS = 256;     // 8 warps x 16 rows
constexpr size_t SMEM_BYTES = sizeof(bf16) * (ROWS + KC) * LDK + sizeof(float) * (8 * KC + ROWS);

using sgl::ldsm_x2;
using sgl::ldsm_x4;
using sgl::mma_16816;

// q [B, mq_in, N1, 128] bf16, w [B, mq_in, N1] f32, k [P, 1, page, 128] bf16,
// bt [B, max_pages], lens_q / lens_k [B] -> out [B, mq_out, max_pages * page] f32.
__global__ void __launch_bounds__(THREADS)
    li_prefill_kernel(const bf16* __restrict__ q, const float* __restrict__ w,
                      const bf16* __restrict__ k, const int* __restrict__ bt,
                      const int* __restrict__ lens_q, const int* __restrict__ lens_k,
                      float* __restrict__ out, int mq_in, int mq_out, int n1, int max_pages,
                      int page_size, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                // [ROWS][LDK]
  bf16* ks = qs + ROWS * LDK;                                  // [KC][LDK]
  float* part = reinterpret_cast<float*>(ks + KC * LDK);       // [8 warps][KC] head sums
  float* ws = part + 8 * KC;                                   // [ROWS] weights

  const int pc = blockIdx.x, b = blockIdx.z;
  const int tpb = ROWS / n1;                 // tokens a block
  const int wpt = n1 / 16;                   // warps a token
  const int t0 = blockIdx.y * tpb;
  const int lq = lens_q[b], lk = lens_k[b];
  const size_t width = (size_t)max_pages * page_size;
  const int p0 = pc * page_size;
  float* out0 = out + ((size_t)b * mq_out + t0) * width + p0;  // row t0, this page
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // keys of this page that some live row of the tile sees: [p0, p0 + nk)
  const int t_last = min(t0 + tpb, lq) - 1;
  const int kmax = t_last < t0 ? -1 : min(causal ? lk - lq + t_last : lk - 1, lk - 1);
  const int nk = max(0, min(page_size, kmax - p0 + 1));

  if (nk > 0) {
    for (int i = tid; i < ROWS * D / 8; i += THREADS) {
      const int r = i / (D / 8), c = i % (D / 8), t = t0 + r / n1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < mq_in)
        v = *reinterpret_cast<const uint4*>(q + (((size_t)b * mq_in + t0) * n1 + r) * D + c * 8);
      *reinterpret_cast<uint4*>(qs + r * LDK + c * 8) = v;
    }
    for (int r = tid; r < ROWS; r += THREADS) {
      const int t = t0 + r / n1;
      ws[r] = t < mq_in ? w[((size_t)b * mq_in + t0) * n1 + r] : 0.f;
    }
    __syncthreads();

    const int g = lane >> 2, t4 = lane & 3;
    const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
    const int b_row = lane & 7, b_col = 8 * ((lane >> 3) & 1);
    uint32_t a[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(a[kk], qs + (16 * warp + a_row) * LDK + kk * 16 + a_col);
    const float w0 = ws[16 * warp + g], w1 = ws[16 * warp + g + 8];
    const int phys = bt[(size_t)b * max_pages + pc];
    const bf16* kpage = k + (size_t)phys * page_size * D;

    for (int c0 = 0; c0 < nk; c0 += KC) {
      const int ntiles = (min(KC, nk - c0) + 7) / 8;   // n8 tiles (page_size % 8 == 0)
      const int nck = min(KC, nk - c0);
      __syncthreads();                                 // the last chunk's readers are done
      for (int i = tid; i < ntiles * 8 * (D / 8); i += THREADS) {
        const int key = i / (D / 8), c = i % (D / 8);
        *reinterpret_cast<uint4*>(ks + key * LDK + c * 8) =
            *reinterpret_cast<const uint4*>(kpage + (size_t)(c0 + key) * D + c * 8);
      }
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt) {
        if (nt < ntiles) {                             // warp-uniform
          float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t bf[2];
            ldsm_x2(bf, ks + (nt * 8 + b_row) * LDK + kk * 16 + b_col);
            mma_16816(s, a[kk], bf);
          }
          // rows g, g + 8 (heads), columns 2 t4, 2 t4 + 1 (keys)
          float v0 = fmaxf(s[0], 0.f) * w0 + fmaxf(s[2], 0.f) * w1;
          float v1 = fmaxf(s[1], 0.f) * w0 + fmaxf(s[3], 0.f) * w1;
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            v0 += __shfl_xor_sync(0xffffffffu, v0, o);
            v1 += __shfl_xor_sync(0xffffffffu, v1, o);
          }
          if (g == 0) {
            part[warp * KC + nt * 8 + 2 * t4] = v0;
            part[warp * KC + nt * 8 + 2 * t4 + 1] = v1;
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < tpb * nck; i += THREADS) {
        const int tt = i / nck, c = i % nck, t = t0 + tt;
        if (t >= mq_out) continue;
        float sum = 0.f;
        for (int j = 0; j < wpt; ++j) sum += part[(tt * wpt + j) * KC + c];
        const int p = p0 + c0 + c;
        const bool live = t < lq && p < lk && p <= (causal ? lk - lq + t : lk - 1);
        out0[(size_t)tt * width + c0 + c] = live ? sum : -INFINITY;
      }
    }
  }
  // keys of the page past every row's reach
  for (int i = tid; i < tpb * (page_size - nk); i += THREADS) {
    const int tt = i / (page_size - nk), c = nk + i % (page_size - nk);
    if (t0 + tt < mq_out) out0[(size_t)tt * width + c] = -INFINITY;
  }
}

}  // namespace

// bf16 q [B, mq_in, N1, 128] and f32 w [B, mq_in, N1] (N1 = 16, 32, 64 or 128),
// bf16 k [P, 1, page, 128] (page % 8 == 0), int32 bt [B, max_pages], lens_q /
// lens_k [B] -> f32 out [B, mq_out, max_pages * page]; every element written.
extern "C" int lightning_indexer_prefill_launch(const void* q, const void* w, const void* k,
                                                const void* bt, const void* lens_q,
                                                const void* lens_k, void* out, int batch,
                                                int mq_in, int mq_out, int n1, int max_pages,
                                                int page_size, int causal, void* stream) {
  if (batch == 0 || mq_out == 0 || max_pages == 0) return 0;
  if (n1 < 16 || n1 > ROWS || ROWS % n1 != 0 || page_size % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(li_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  const int tpb = ROWS / n1;
  dim3 grid(max_pages, (mq_out + tpb - 1) / tpb, batch);
  li_prefill_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const float*)w, (const bf16*)k, (const int*)bt, (const int*)lens_q,
      (const int*)lens_k, (float*)out, mq_in, mq_out, n1, max_pages, page_size, causal);
  return (int)cudaGetLastError();
}
