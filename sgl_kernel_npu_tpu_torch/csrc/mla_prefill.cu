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
// chunk (pos_sel[b, chunk, :], -1 = a dead slot).  Its block body of its own
// (mla_sparse.cuh: 64 rows of a q-chunk, a TMA key ring, wgmma) says
// what bounds it and what the design does about it.
#include <string.h>

#include "mla_attention.cuh"
#include "mla_sparse.cuh"

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

template <typename KN>
__global__ void __launch_bounds__(mlas::THREADS, 1)
    mla_prefill_sparse_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap kmap,
                              const KN* __restrict__ kn, const bf16* __restrict__ kr,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ seq_lens, const int* __restrict__ ctx_lens,
                              const int* __restrict__ starts, const int* __restrict__ pos_sel,
                              bf16* __restrict__ out, int heads, int max_pages, int page_size,
                              int box_keys, int total_rows, int tq, int hb, int tiles, int cq,
                              int n_chunks, int n_sel, float sm_scale) {
  const int b = blockIdx.z;
  const int seq = seq_lens[b];
  const int chunk = blockIdx.y / tiles;
  const int j0 = chunk * cq + (blockIdx.y % tiles) * tq;   // the block is in one chunk
  if (j0 >= seq) return;
  const int jend = min(min(j0 + tq, (chunk + 1) * cq), seq);
  mlas::sparse_block<KN>(q, &kmap, kn, kr, block_tables + (size_t)b * max_pages,
                         pos_sel + ((size_t)b * n_chunks + chunk) * n_sel, out, starts[b], j0,
                         jend, tq, seq, ctx_lens[b], heads, blockIdx.x * hb, hb, n_sel,
                         page_size, box_keys, total_rows, sm_scale);
}

// The latent cache kn [pages, 1, page, 512] as a TMA map of [pages x page,
// 512] rows, boxes of box_keys rows x 128 bytes, 128-byte swizzle.
template <typename KN>
int latent_map(CUtensorMap* map, const void* kn, int total_rows, int box_keys) {
  const uint64_t dims[2] = {mlas::DN, (uint64_t)total_rows}, strides[1] = {mlas::DN * sizeof(KN)};
  const uint32_t box[2] = {128 / sizeof(KN), (uint32_t)box_keys};
  return wg::tensor_map(map, sizeof(KN) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                             : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                        2, kn, dims, strides, box);
}

template <typename KN>
int launch_sparse(const void* q, const void* kn, const void* kr, const void* bt,
                  const void* seq_lens, const void* ctx, const void* starts, const void* pos_sel,
                  void* out, int batch, int heads, int max_pages, int page_size, int n_pages,
                  int tq, int hb, int tiles, int cq, int n_chunks, int n_sel, float sm_scale,
                  cudaStream_t stream) {
  int box_keys = mlas::KT;                 // the largest divisor of the page that divides 64
  while (page_size % box_keys) box_keys /= 2;
  const int total_rows = n_pages * page_size;
  CUtensorMap kmap;
  if (box_keys >= 8) {
    const int rc = latent_map<KN>(&kmap, kn, total_rows, box_keys);
    if (rc) return rc;
  } else {
    memset(&kmap, 0, sizeof(kmap));        // the cp.async path reads no map
  }
  constexpr int smem = (int)mlas::Smem<KN>::BYTES;
  cudaFuncSetAttribute(mla_prefill_sparse_kernel<KN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // head tiles fastest: the blocks of one q-chunk, which share its pages, run together
  dim3 grid((heads + hb - 1) / hb, n_chunks * tiles, batch);
  mla_prefill_sparse_kernel<KN><<<grid, mlas::THREADS, smem, stream>>>(
      (const bf16*)q, kmap, (const KN*)kn, (const bf16*)kr, (const int*)bt,
      (const int*)seq_lens, (const int*)ctx, (const int*)starts, (const int*)pos_sel,
      (bf16*)out, heads, max_pages, page_size, box_keys, total_rows, tq, hb, tiles, cq,
      n_chunks, n_sel, sm_scale);
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
// attends, n_sel <= 256; n_pages: the caches' pages.  A block holds tq tokens
// x hb heads (tq hb <= 64) of one chunk: token tile t of chunk c starts at
// c cq + t tq (tiles = ceil(cq / tq) a chunk); ops/attention/mla_prefill.
// sparse_tiling.
extern "C" int mla_prefill_sparse_launch(const void* q, const void* kn, const void* kr,
                                         const void* bt, const void* seq_lens, const void* ctx,
                                         const void* starts, const void* pos_sel, void* out,
                                         int batch, int heads, int max_pages, int page_size,
                                         int n_pages, int tq, int hb, int tiles, int cq,
                                         int n_chunks, int n_sel, float sm_scale, int kn_int8,
                                         void* stream) {
  if (batch == 0 || n_chunks == 0) return 0;
  if (tq < 1 || hb < 1 || tq * hb > mlas::M || (long long)tiles * tq < cq ||
      n_sel > mlas::MAX_SEL || n_sel < 0 || page_size < 1 ||
      (long long)n_pages * page_size >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return kn_int8
             ? launch_sparse<int8_t>(q, kn, kr, bt, seq_lens, ctx, starts, pos_sel, out, batch,
                                     heads, max_pages, page_size, n_pages, tq, hb, tiles, cq,
                                     n_chunks, n_sel, sm_scale, s)
             : launch_sparse<bf16>(q, kn, kr, bt, seq_lens, ctx, starts, pos_sel, out, batch,
                                   heads, max_pages, page_size, n_pages, tq, hb, tiles, cq,
                                   n_chunks, n_sel, sm_scale, s);
}
