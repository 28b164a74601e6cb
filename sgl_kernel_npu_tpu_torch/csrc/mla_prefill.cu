// mla_prefill: varlen causal MLA prefill over the paged latent cache, Hopper.
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/attention/mla_prefill.py:
// mla_prefill_pallas (_mla_prefill_kernel), whose (batch, q-chunk, kv-page) grid
// holds cq x H rows of f32 accumulator in VMEM (16 MB at 128 heads, cq 64).
//
// Bound on the H100: at a 64-token chunk of 128 heads the operations
// (2 x 1088 flops for every visible key of each of the S x H rows, at the
// bf16 tensor-core rate) and the bytes of q and the output (the cache rows
// are few) are of one order; chip_smoke.py computes which is larger.  The
// products run on the tensor cores through mma.sync (16 rows a block); wgmma
// tiles of 64 rows and TMA loads are later work (PERF.md).
//
// Design: the block body of mla_attention.cuh over the packed queries, no
// host-side scatter to [B, max_q, H, 576]: block (request b, chunk of TQ
// tokens, tile of 16 / TQ heads) reads its rows straight from q [S, H, 576] at
// the request's start offset, walks keys only up to the causal limit of its
// last live token, and writes only live rows (the caller zeroes the output,
// so rows past the request lengths come out as zeros).
#include "mla_attention.cuh"

using bf16 = __nv_bfloat16;

namespace {

template <typename KN>
__global__ void __launch_bounds__(mla::THREADS)
    mla_prefill_kernel(const bf16* __restrict__ q, const KN* __restrict__ kn,
                       const bf16* __restrict__ kr, const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens, const int* __restrict__ ctx_lens,
                       const int* __restrict__ starts, bf16* __restrict__ out, int heads,
                       int max_pages, int page_size, int tq, float sm_scale) {
  const int b = blockIdx.x;
  const int seq = seq_lens[b];
  const int j0 = blockIdx.y * tq;
  if (j0 >= seq) return;
  mla::mla_block(q, kn, kr, block_tables + (size_t)b * max_pages, out, starts[b], j0, seq,
                 ctx_lens[b], heads, blockIdx.z * (mla::ROWS / tq), tq, page_size, sm_scale);
}

template <typename KN>
int launch(const void* q, const void* kn, const void* kr, const void* bt, const void* seq_lens,
           const void* ctx, const void* starts, void* out, int batch, int heads, int max_pages,
           int page_size, int max_q, int tq, float sm_scale, cudaStream_t stream) {
  cudaFuncSetAttribute(mla_prefill_kernel<KN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)mla::SMEM_BYTES);
  const int ht = mla::ROWS / tq;
  dim3 grid(batch, (max_q + tq - 1) / tq, (heads + ht - 1) / ht);
  mla_prefill_kernel<KN><<<grid, mla::THREADS, mla::SMEM_BYTES, stream>>>(
      (const bf16*)q, (const KN*)kn, (const bf16*)kr, (const int*)bt, (const int*)seq_lens,
      (const int*)ctx, (const int*)starts, (bf16*)out, heads, max_pages, page_size, tq,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q [S, H, 576] packed by request, kn [P, 1, page, 512] (bf16, or int8
// levels with kn_int8 = 1), bf16 kr [P, 1, 64, page]; int32 bt [B, max_pages],
// seq_lens / ctx / starts [B] (starts = exclusive cumsum of seq_lens) -> bf16
// out [S, H, 512] (zeroed by the caller).  max_q bounds every seq_len; tq (1,
// 2, 4, 8 or 16) tokens share a block.
extern "C" int mla_prefill_launch(const void* q, const void* kn, const void* kr,
                                  const void* bt, const void* seq_lens, const void* ctx,
                                  const void* starts, void* out, int batch, int heads,
                                  int max_pages, int page_size, int max_q, int tq,
                                  float sm_scale, int kn_int8, void* stream) {
  if (batch == 0 || max_q == 0) return 0;
  if (tq < 1 || mla::ROWS % tq != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return kn_int8 ? launch<int8_t>(q, kn, kr, bt, seq_lens, ctx, starts, out, batch, heads,
                                  max_pages, page_size, max_q, tq, sm_scale, s)
                 : launch<bf16>(q, kn, kr, bt, seq_lens, ctx, starts, out, batch, heads,
                                max_pages, page_size, max_q, tq, sm_scale, s);
}
