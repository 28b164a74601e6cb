// decode_mla: paged MLA decode attention for Hopper (K2).
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/attention/decode_attention.py:
// decode_mla (_mla_kernel), which walks the whole batch in one sequential grid
// step with a [Hq, 512] f32 accumulator in VMEM.
//
// Bound on the H100: bytes.  Each row's latent + rope rows (1152 B a key in
// bf16, 640 B with the int8 latent) must be read once, with q and the
// output; the products (2 x 1088 flops a key a head) are below the bytes at
// decode batch sizes.  At DeepSeek-V3's 8 rows of 112-716 keys the bound is
// ~2 us, so what a call costs is latency: the launch, the 72 KB Q load,
// the first key chunk's arrival, the walk's chunks one after the other and
// the merge.
//
// Design: the block body of mla_sparse.cuh (64 rows on wgmma, keys by TMA
// from a loading warpgroup, the base-2 online softmax in registers) on its
// dense walk, with the keys of a row cut into splits walked by blocks of
// their own, so that a few short rows still fill the card and each block
// walks few chunks.  Grid (splits, head tiles, rows): a block holds one
// token x 64 heads (all heads below 64: mla_prefill.sparse_tiling), so a
// key crosses L2 twice a row at 128 heads; split s walks keys [s split,
// min((s + 1) split, ctx)) in 64-key chunks (split a multiple of 64, so a
// TMA box never crosses a page of 64 or more keys; smaller pages of 8 keys'
// multiples take boxes of a page, others cp.async), only the last chunk of
// the last split masked by position.  A row of one live split writes its
// output; otherwise each split writes (m, l, O) from its registers to f32
// scratch and the last to arrive merges them in split order (an atomic
// ticket a (row, head tile), reset by the merging block: repeated calls are
// bit-identical).  The split size comes from shapes alone
// (decode_attention.mla_split_size: no host sync).  The int8 fold of
// k_scale (into q_nope as Q lands, into the output) is inside: one launch
// a call.  A row of context 0 writes 0; a pad row (ctx 1, a table of
// zeros) reads key 0 of page 0 and is harmless.
#include "mla_sparse.cuh"

using bf16 = __nv_bfloat16;

namespace {

template <typename KN>
__global__ void __launch_bounds__(mlas::THREADS, 1)
    decode_mla_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap kmap,
                      const KN* __restrict__ kn, const bf16* __restrict__ kr,
                      const int* __restrict__ block_table, const int* __restrict__ ctx_lens,
                      bf16* __restrict__ out, float* __restrict__ part_o,
                      float2* __restrict__ part_ml, int* __restrict__ tickets, int heads, int hb,
                      int max_pages, int page_size, int box_keys, int total_rows, int split,
                      float sm_scale, int fold, float ks) {
  const int s = blockIdx.x, b = blockIdx.z;
  const int ctx = ctx_lens[b];
  const int hi = min(ctx, max_pages * page_size);     // the keys the row sees
  const int n_live = hi > 0 ? (hi + split - 1) / split : 0;
  if (s >= max(n_live, 1)) return;                    // context 0: split 0 writes 0
  mlas::Split sp;
  sp.part_o = part_o;
  sp.part_ml = part_ml;
  sp.ticket = tickets == nullptr ? nullptr : tickets + (size_t)b * gridDim.y + blockIdx.y;
  sp.rows = (size_t)gridDim.z * heads;
  sp.s = s;
  sp.n_live = n_live;
  sp.fold = fold != 0;
  sp.ks = ks;
  const int k_lo = s * split;
  mlas::block<KN, true>(q, &kmap, kn, kr, block_table + (size_t)b * max_pages, nullptr, out,
                        /*tok_base=*/b, /*j0=*/0, /*jend=*/1, /*tq=*/1, /*seq_len=*/1, ctx,
                        heads, blockIdx.y * hb, hb, 0, page_size, box_keys, total_rows, sm_scale,
                        k_lo, max(min(k_lo + split, hi), 0), sp);
}

template <typename KN>
int launch(const void* q, const void* kn, const void* kr, const void* bt, const void* ctx,
           void* out, void* part_o, void* part_ml, void* tickets, int batch, int heads,
           int max_pages, int page_size, int n_pages, int split, int n_splits, float sm_scale,
           int fold, float ks, cudaStream_t stream) {
  CUtensorMap kmap;
  int box_keys;
  const int rc = mlas::key_map<KN>(&kmap, kn, page_size, n_pages, &box_keys);
  if (rc) return rc;
  constexpr int smem = (int)mlas::Smem<KN>::BYTES;
  cudaFuncSetAttribute(decode_mla_kernel<KN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int hb = heads < mlas::M ? heads : mlas::M;
  // the splits of a (row, head tile) fastest: they share its keys' pages and its Q
  dim3 grid(n_splits, (heads + hb - 1) / hb, batch);
  decode_mla_kernel<KN><<<grid, mlas::THREADS, smem, stream>>>(
      (const bf16*)q, kmap, (const KN*)kn, (const bf16*)kr, (const int*)bt, (const int*)ctx,
      (bf16*)out, (float*)part_o, (float2*)part_ml, (int*)tickets, heads, hb, max_pages,
      page_size, box_keys, n_pages * page_size, split, sm_scale, fold, ks);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q [B, H, 576] and kr [P, 1, 64, page], kn [P, 1, page, 512] (bf16, or
// int8 levels with kn_int8 = 1), all three 16-byte aligned (n_pages = P);
// int32 bt [B, max_pages], ctx [B] -> bf16 out [B, H, 512].  Row b's keys
// [0, min(ctx, max_pages page)) in splits of `split` keys (a multiple of 64),
// n_splits of them in the grid (at most 16); with n_splits > 1, f32 part_o
// [n_splits B H 512], part_ml [n_splits B H 2] (any contents) and int32
// tickets [B ceil(H / 64)] (zero, and left zero).  kn_int8: k_scale ks is
// folded in (ks 1 for the levels as they are).
extern "C" int decode_mla_launch(const void* q, const void* kn, const void* kr, const void* bt,
                                 const void* ctx, void* out, void* part_o, void* part_ml,
                                 void* tickets, int batch, int heads, int max_pages,
                                 int page_size, int n_pages, int split, int n_splits,
                                 float sm_scale, int kn_int8, float ks, void* stream) {
  if (batch == 0 || heads == 0) return 0;
  if (split < mlas::KT || split % mlas::KT || n_splits < 1 || n_splits > mlas::MAX_SPLITS ||
      batch > 65535 || page_size < 1 || (long long)n_pages * page_size >= (1ll << 31) ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return kn_int8 ? launch<int8_t>(q, kn, kr, bt, ctx, out, part_o, part_ml, tickets, batch, heads,
                                  max_pages, page_size, n_pages, split, n_splits, sm_scale, 1, ks,
                                  s)
                 : launch<bf16>(q, kn, kr, bt, ctx, out, part_o, part_ml, tickets, batch, heads,
                                max_pages, page_size, n_pages, split, n_splits, sm_scale, 0, 1.f,
                                s);
}
