// mla_prefill: varlen causal MLA prefill over the paged latent cache, Hopper.
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/attention/mla_prefill.py:
// mla_prefill_pallas (_mla_prefill_kernel), whose (batch, q-chunk, kv-page) grid
// holds cq x H rows of f32 accumulator in VMEM (16 MB at 128 heads, cq 64).
//
// Bound on the H100: operations.  At a 2048-token chunk of 128 heads at
// context 4096 the products do 2 x 1088 flops for every visible key of each
// of the S x H rows, ~1.75 TFLOP (1.77 ms at the bf16 tensor-core rate),
// against ~0.6 GB of q, output and cache (chip_smoke.py computes which is
// larger at each shape).
//
// Design: the block body of mla_sparse.cuh on its dense walk (64 rows of one
// request a block, a TMA key ring from a loading warpgroup, wgmma; that file
// says what bounds the body and what its design does about it), over the
// packed queries with no host-side scatter to [B, max_q, H, 576]: block
// (head tile, request b, token tile) reads its rows straight from q [S, H,
// 576] at the request's start offset, walks keys only up to the causal limit
// of its last live token, and writes only live rows (the caller zeroes the
// output, so rows past the request lengths come out as zeros).  Token tiles
// go last first: the longest walks start first.
//
// mla_prefill_block_sparse (DSA) replaces the TPU kernel of the same file:
// mla_prefill_block_sparse (_mla_prefill_pruned_kernel), the same function
// restricted to the pages the lightning indexer selected for each 64-token
// chunk (pos_sel[b, chunk, :], -1 = a dead slot): the same block body on its
// sparse walk.
#include "mla_sparse.cuh"

using bf16 = __nv_bfloat16;

namespace {

template <typename KN>
__global__ void __launch_bounds__(mlas::THREADS, 1)
    mla_prefill_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap kmap,
                       const KN* __restrict__ kn, const bf16* __restrict__ kr,
                       const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
                       const int* __restrict__ ctx_lens, const int* __restrict__ starts,
                       bf16* __restrict__ out, int heads, int max_pages, int page_size,
                       int box_keys, int total_rows, int tq, int hb, float sm_scale) {
  const int b = blockIdx.y;
  const int seq = seq_lens[b];
  const int j0 = (gridDim.z - 1 - blockIdx.z) * tq;   // the longest walks first
  if (j0 >= seq) return;
  mlas::block<KN, true>(q, &kmap, kn, kr, block_tables + (size_t)b * max_pages, nullptr, out,
                        starts[b], j0, min(j0 + tq, seq), tq, seq, ctx_lens[b], heads,
                        blockIdx.x * hb, hb, 0, page_size, box_keys, total_rows, sm_scale);
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
  mlas::block<KN, false>(q, &kmap, kn, kr, block_tables + (size_t)b * max_pages,
                         pos_sel + ((size_t)b * n_chunks + chunk) * n_sel, out, starts[b], j0,
                         jend, tq, seq, ctx_lens[b], heads, blockIdx.x * hb, hb, n_sel,
                         page_size, box_keys, total_rows, sm_scale);
}

template <typename KN>
int launch(const void* q, const void* kn, const void* kr, const void* bt, const void* seq_lens,
           const void* ctx, const void* starts, void* out, int batch, int heads, int max_pages,
           int page_size, int n_pages, int max_q, int tq, int hb, float sm_scale,
           cudaStream_t stream) {
  CUtensorMap kmap;
  int box_keys;
  const int rc = mlas::key_map<KN>(&kmap, kn, page_size, n_pages, &box_keys);
  if (rc) return rc;
  constexpr int smem = (int)mlas::Smem<KN>::BYTES;
  cudaFuncSetAttribute(mla_prefill_kernel<KN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // head tiles fastest: the blocks of one token tile, which share its keys, run together
  dim3 grid((heads + hb - 1) / hb, batch, (max_q + tq - 1) / tq);
  mla_prefill_kernel<KN><<<grid, mlas::THREADS, smem, stream>>>(
      (const bf16*)q, kmap, (const KN*)kn, (const bf16*)kr, (const int*)bt, (const int*)seq_lens,
      (const int*)ctx, (const int*)starts, (bf16*)out, heads, max_pages, page_size, box_keys,
      n_pages * page_size, tq, hb, sm_scale);
  return (int)cudaGetLastError();
}

template <typename KN>
int launch_sparse(const void* q, const void* kn, const void* kr, const void* bt,
                  const void* seq_lens, const void* ctx, const void* starts, const void* pos_sel,
                  void* out, int batch, int heads, int max_pages, int page_size, int n_pages,
                  int tq, int hb, int tiles, int cq, int n_chunks, int n_sel, float sm_scale,
                  cudaStream_t stream) {
  CUtensorMap kmap;
  int box_keys;
  const int rc = mlas::key_map<KN>(&kmap, kn, page_size, n_pages, &box_keys);
  if (rc) return rc;
  constexpr int smem = (int)mlas::Smem<KN>::BYTES;
  cudaFuncSetAttribute(mla_prefill_sparse_kernel<KN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // head tiles fastest: the blocks of one q-chunk, which share its pages, run together
  dim3 grid((heads + hb - 1) / hb, n_chunks * tiles, batch);
  mla_prefill_sparse_kernel<KN><<<grid, mlas::THREADS, smem, stream>>>(
      (const bf16*)q, kmap, (const KN*)kn, (const bf16*)kr, (const int*)bt,
      (const int*)seq_lens, (const int*)ctx, (const int*)starts, (const int*)pos_sel,
      (bf16*)out, heads, max_pages, page_size, box_keys, n_pages * page_size, tq, hb, tiles, cq,
      n_chunks, n_sel, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q [S, H, 576] packed by request, starting 16-byte aligned, kn [P, 1,
// page, 512] (bf16, or int8 levels with kn_int8 = 1) and bf16 kr [P, 1, 64,
// page] (n_pages = P), both 16-byte aligned; int32 bt [B, max_pages],
// seq_lens / ctx / starts [B] (starts = exclusive cumsum of seq_lens) -> bf16
// out [S, H, 512] (zeroed by the caller).  max_q bounds every seq_len; a
// block holds tq tokens x hb heads (tq hb <= 64; ops/attention/mla_prefill.
// sparse_tiling with one chunk of max_q tokens).
extern "C" int mla_prefill_launch(const void* q, const void* kn, const void* kr,
                                  const void* bt, const void* seq_lens, const void* ctx,
                                  const void* starts, void* out, int batch, int heads,
                                  int max_pages, int page_size, int n_pages, int max_q, int tq,
                                  int hb, float sm_scale, int kn_int8, void* stream) {
  if (batch == 0 || max_q == 0) return 0;
  if (tq < 1 || hb < 1 || tq * hb > mlas::M || page_size < 1 ||
      (long long)n_pages * page_size >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return kn_int8 ? launch<int8_t>(q, kn, kr, bt, seq_lens, ctx, starts, out, batch, heads,
                                  max_pages, page_size, n_pages, max_q, tq, hb, sm_scale, s)
                 : launch<bf16>(q, kn, kr, bt, seq_lens, ctx, starts, out, batch, heads,
                                max_pages, page_size, n_pages, max_q, tq, hb, sm_scale, s);
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
