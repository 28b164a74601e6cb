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
//
// mla_prefill_block_sparse (DSA) replaces the TPU kernel of the same file:
// mla_prefill_block_sparse (_mla_prefill_pruned_kernel), the same function
// restricted to the pages the lightning indexer selected for each 64-token
// chunk (pos_sel[b, chunk, :], -1 = a dead slot).  Bound: operations, as
// above, over the selected keys only (16 pages of 128 at DeepSeek-V3.2's
// 2048-key budget).  Design: K9a's block and key pipeline; the block's keys
// are the live pages of its chunk's selection, gathered into shared memory
// in their order, walked whole and masked by position (mla_attention.cuh).
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

constexpr int MAX_SEL = 256;   // selected pages a chunk can name

template <typename KN>
__global__ void __launch_bounds__(mla::THREADS)
    mla_prefill_sparse_kernel(const bf16* __restrict__ q, const KN* __restrict__ kn,
                              const bf16* __restrict__ kr, const int* __restrict__ block_tables,
                              const int* __restrict__ seq_lens, const int* __restrict__ ctx_lens,
                              const int* __restrict__ starts, const int* __restrict__ pos_sel,
                              bf16* __restrict__ out, int heads, int max_pages, int page_size,
                              int tq, int cq, int n_chunks, int n_sel, float sm_scale) {
  __shared__ int sel[MAX_SEL];
  __shared__ int n_live;
  const int b = blockIdx.x;
  const int seq = seq_lens[b];
  const int j0 = blockIdx.y * tq;             // tq divides cq: the block is in one chunk
  if (j0 >= seq) return;
  if (threadIdx.x == 0) {                     // the chunk's live slots, in order
    const int* ps = pos_sel + ((size_t)b * n_chunks + j0 / cq) * n_sel;
    int n = 0;
    for (int i = 0; i < n_sel; ++i)
      if (ps[i] >= 0) sel[n++] = ps[i];
    n_live = n;
  }
  __syncthreads();
  mla::mla_block<KN, true>(q, kn, kr, block_tables + (size_t)b * max_pages, out, starts[b], j0,
                           seq, ctx_lens[b], heads, blockIdx.z * (mla::ROWS / tq), tq,
                           page_size, sm_scale, sel, n_live);
}

template <typename KN>
int launch_sparse(const void* q, const void* kn, const void* kr, const void* bt,
                  const void* seq_lens, const void* ctx, const void* starts, const void* pos_sel,
                  void* out, int batch, int heads, int max_pages, int page_size, int max_q,
                  int tq, int cq, int n_chunks, int n_sel, float sm_scale, cudaStream_t stream) {
  cudaFuncSetAttribute(mla_prefill_sparse_kernel<KN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)mla::SMEM_BYTES);
  const int ht = mla::ROWS / tq;
  dim3 grid(batch, (max_q + tq - 1) / tq, (heads + ht - 1) / ht);
  mla_prefill_sparse_kernel<KN><<<grid, mla::THREADS, mla::SMEM_BYTES, stream>>>(
      (const bf16*)q, (const KN*)kn, (const bf16*)kr, (const int*)bt, (const int*)seq_lens,
      (const int*)ctx, (const int*)starts, (const int*)pos_sel, (bf16*)out, heads, max_pages,
      page_size, tq, cq, n_chunks, n_sel, sm_scale);
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

// mla_prefill_launch's operands plus int32 pos_sel [B, n_chunks, n_sel]: the
// pages (positions in the sequence, -1 = dead) that chunk j / cq of request b
// attends; tq divides cq, n_sel <= 256.
extern "C" int mla_prefill_sparse_launch(const void* q, const void* kn, const void* kr,
                                         const void* bt, const void* seq_lens, const void* ctx,
                                         const void* starts, const void* pos_sel, void* out,
                                         int batch, int heads, int max_pages, int page_size,
                                         int max_q, int tq, int cq, int n_chunks, int n_sel,
                                         float sm_scale, int kn_int8, void* stream) {
  if (batch == 0 || max_q == 0) return 0;
  if (tq < 1 || mla::ROWS % tq != 0 || cq % tq != 0 || n_sel > MAX_SEL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return kn_int8
             ? launch_sparse<int8_t>(q, kn, kr, bt, seq_lens, ctx, starts, pos_sel, out, batch,
                                     heads, max_pages, page_size, max_q, tq, cq, n_chunks, n_sel,
                                     sm_scale, s)
             : launch_sparse<bf16>(q, kn, kr, bt, seq_lens, ctx, starts, pos_sel, out, batch,
                                   heads, max_pages, page_size, max_q, tq, cq, n_chunks, n_sel,
                                   sm_scale, s);
}
