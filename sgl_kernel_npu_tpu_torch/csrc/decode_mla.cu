// decode_mla: paged MLA decode attention for Hopper.
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/attention/decode_attention.py:
// decode_mla (_mla_kernel), which walks the whole batch in one sequential grid
// step with a [Hq, 512] f32 accumulator in VMEM.
//
// Bound on the H100: bytes.  Each sequence's latent + rope rows (1152 B a key
// in bf16, 640 B with the int8 latent) must be read once; the arithmetic
// (2 x 1088 flops a key a head) is far below the card's rate at decode batch
// sizes.
//
// Design: one block per (sequence, tile of 16 heads) (mla_attention.cuh), so a
// key row staged in shared memory serves 16 heads and the batch spreads over
// B x H/16 blocks (64 at batch 8 x 128 heads, of 132 SMs: the gap a split over
// the keys would close is recorded in PERF.md).  Any page size works: keys are
// addressed one by one through the block table.  A pad row (ctx 1, block
// table of zeros) reads key 0 of page 0 and is harmless.
#include "mla_attention.cuh"

using bf16 = __nv_bfloat16;

namespace {

template <typename KN>
__global__ void __launch_bounds__(mla::THREADS)
    decode_mla_kernel(const bf16* __restrict__ q, const KN* __restrict__ kn,
                      const bf16* __restrict__ kr, const int* __restrict__ block_table,
                      const int* __restrict__ ctx_lens, bf16* __restrict__ out, int heads,
                      int max_pages, int page_size, float sm_scale) {
  const int b = blockIdx.x;
  mla::mla_block(q, kn, kr, block_table + (size_t)b * max_pages, out, /*tok_base=*/b,
                 /*j0=*/0, /*seq_len=*/1, ctx_lens[b], heads, blockIdx.y * mla::ROWS,
                 /*tq=*/1, page_size, sm_scale);
}

template <typename KN>
int launch(const void* q, const void* kn, const void* kr, const void* bt, const void* ctx,
           void* out, int batch, int heads, int max_pages, int page_size, float sm_scale,
           cudaStream_t stream) {
  cudaFuncSetAttribute(decode_mla_kernel<KN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)mla::SMEM_BYTES);
  dim3 grid(batch, (heads + mla::ROWS - 1) / mla::ROWS);
  decode_mla_kernel<KN><<<grid, mla::THREADS, mla::SMEM_BYTES, stream>>>(
      (const bf16*)q, (const KN*)kn, (const bf16*)kr, (const int*)bt, (const int*)ctx,
      (bf16*)out, heads, max_pages, page_size, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q [B, H, 576], kn [P, 1, page, 512] (bf16, or int8 levels with
// kn_int8 = 1), bf16 kr [P, 1, 64, page]; int32 bt [B, max_pages], ctx [B]
// -> bf16 out [B, H, 512].
extern "C" int decode_mla_launch(const void* q, const void* kn, const void* kr,
                                 const void* bt, const void* ctx, void* out, int batch,
                                 int heads, int max_pages, int page_size, float sm_scale,
                                 int kn_int8, void* stream) {
  if (batch == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return kn_int8 ? launch<int8_t>(q, kn, kr, bt, ctx, out, batch, heads, max_pages,
                                  page_size, sm_scale, s)
                 : launch<bf16>(q, kn, kr, bt, ctx, out, batch, heads, max_pages, page_size,
                                sm_scale, s);
}
