// lightning_indexer: the lightning indexer's prefill scores (DeepSeek-V3.2 DSA), Hopper (K10).
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
// against ~3,000 causal keys a token the products are ~0.1 TFLOP (bf16
// tensor cores, ~0.1 ms) against ~70 MB of queries, keys and scores
// (~0.02 ms).  The first design (one block a key page, mma.sync) staged the
// tile's queries again for every page (~1.1 GB through L2 at that shape),
// copied each page synchronously and met the heads' partial sums in shared
// memory: 12.6 % of the bound.
//
// Design: a block owns a tile of 512 / N1 consecutive tokens of one request
// (two computing warpgroups of 256 / N1 tokens x N1 heads = 256 query rows
// each) and walks the keys its tile can see, so its queries land in shared
// memory once (by TMA, 128-byte swizzle) and each key chunk crosses L2 once
// a tile.  A loading warp brings 64-key chunks (16 KB) by TMA into a
// 4-stage ring, a page's boxes at a time (pages of 8 keys' multiples), the
// page looked up from the block table as the chunk is issued.  The product
// takes the keys as wgmma's M: S^T [64 keys, 256 rows] = K_chunk Q_tile^T,
// both K-major in shared memory, 8 steps of m64n256k16 over d = 128 with
// f32 accumulation.  A thread then holds two key rows and, for each of its
// warpgroup's tokens, N1 / 4 of its heads: relu x w (the weights from
// shared memory) summed in the thread, then over the quad by two shuffles,
// with no cross-warp exchange.  The chunk's [tokens, 64] scores go through
// shared memory (double-buffered) for 16-byte stores, masked by position.
// Where the tiles are too few to fill the card (the decode shape: one token
// a request), the key range is also cut into splits of whole chunks, a
// block each (the scores of two keys never meet, so nothing merges); each
// block writes -inf over the part of its range past its tile's reach.  Token
// tiles go last first: the longest causal walks start first.
#include <math.h>

#include "wgmma.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int D = 128;                       // index-key width
constexpr int KC = 64;                       // keys a chunk
constexpr int ROWS = 256;                    // query rows a computing warpgroup
constexpr int STAGES = 4;
constexpr int THREADS = 2 * 128 + 32;        // warpgroups 0, 1 compute, warp 8 loads
constexpr int QBLOCK = ROWS * 128;           // a warpgroup's 64 columns of q: 32 KB
constexpr int KBLOCK = KC * 128;             // a chunk's 64 columns of keys: 8 KB
constexpr int STAGE = 2 * KBLOCK;

// Shared memory, in bytes: Q [warpgroup][column block][256 rows][128 B] and
// the key ring [stage][column block][64 keys][128 B] in TMA's 128-byte
// swizzle; the weights [2 x 256] f32; each warpgroup's two [T][64] f32
// score buffers; the barriers.
template <int T>
struct Smem {
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t RING = Q + 4 * QBLOCK;
  static constexpr uint32_t W = RING + STAGES * STAGE;
  static constexpr uint32_t OUT = W + 2 * ROWS * 4;
  static constexpr uint32_t BARS = OUT + 2 * 2 * T * KC * 4;   // q, full[STAGES], empty[STAGES]
  static constexpr uint32_t BYTES = BARS + (1 + 2 * STAGES) * 8;
};
static_assert(Smem<16>::BYTES <= 232448, "the indexer block's shared memory exceeds 227 KB");

// q [B, mq_in, N1, 128] bf16 (qmap: [B mq_in N1, 128] rows, boxes of 256 rows
// x 64 columns), w [B, mq_in, N1] f32, k [P, 1, page, 128] bf16 (kmap:
// [P page, 128] rows, boxes of box_keys rows x 64 columns), bt [B,
// max_pages], lens_q / lens_k [B] -> out [B, mq_out, width = max_pages
// page] f32.  Block (tile, split, b): tokens t0 .. t0 + 2T of request b
// (tiles counted from the last), key chunks [split cps, (split + 1) cps).
template <int N1>
__global__ void __launch_bounds__(THREADS, 1)
    li_prefill_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap, const float* __restrict__ w,
                      const int* __restrict__ bt, const int* __restrict__ lens_q,
                      const int* __restrict__ lens_k, float* __restrict__ out, int mq_in,
                      int mq_out, int max_pages, int page_size, int box_keys, int total_rows,
                      int cps, int causal) {
  constexpr int T = ROWS / N1;                 // tokens a warpgroup
  using L = Smem<T>;
  extern __shared__ __align__(1024) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem + L::W);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.z;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * 2 * T;   // the longest walks first
  const int lq = lens_q[b], lk = lens_k[b];
  const int width = max_pages * page_size;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // keys some live token of the tile sees: [0, n_walk); this block's chunks
  // [c_lo, c_hi), of which [c_lo, c_end) walked
  const int t_last = min(t0 + 2 * T, lq) - 1;
  const int n_walk = t_last < t0 ? 0
                                 : max(0, min(min(causal ? lk - lq + t_last + 1 : lk, lk), width));
  const int c_lo = blockIdx.y * cps, c_hi = min(c_lo + cps, (width + KC - 1) / KC);
  const int c_end = min(c_hi, (n_walk + KC - 1) / KC);

  if (tid == 0) {
    wg::mbar_init(qbar, 1);
    for (int i = 0; i < STAGES; ++i) {
      wg::mbar_init(&full[i], 1);
      wg::mbar_init(&empty[i], 8);   // each computing warp
    }
  }
  __syncthreads();

  if (warp == 8) {  // the loader: the tile's queries, then the key chunks
    if (c_end <= c_lo) return;
    if (lane == 0) {
      wg::mbar_expect_tx(qbar, 4 * QBLOCK);
      const int row0 = (b * mq_in + t0) * N1;   // rows past the queries read as zeros
      for (int g = 0; g < 2; ++g)
        for (int cb = 0; cb < 2; ++cb)
          wg::tma_load_2d(smem + L::Q + (2 * g + cb) * QBLOCK, &qmap, cb * 64, row0 + g * ROWS,
                          qbar);
      wg::mbar_arrive(qbar);
    }
    const int* bt_row = bt + (size_t)b * max_pages;
    const int boxes = KC / box_keys;
    for (int it = 0, c = c_lo; c < c_end; ++it, ++c) {
      const int st = it % STAGES;
      if (it >= STAGES) wg::mbar_wait(&empty[st], (it / STAGES - 1) & 1);
      if (lane == 0) wg::mbar_expect_tx(&full[st], STAGE);
      __syncwarp();
      if (lane < boxes) {  // a box of box_keys keys of one page (zeros past the walk)
        const int p0 = c * KC + lane * box_keys;
        const int pg = p0 / page_size;
        const int y = p0 < n_walk ? bt_row[pg] * page_size + (p0 - pg * page_size) : total_rows;
        unsigned char* stage = smem + L::RING + st * STAGE + lane * box_keys * 128;
        wg::tma_load_2d(stage, &kmap, 0, y, &full[st]);
        wg::tma_load_2d(stage + KBLOCK, &kmap, 64, y, &full[st]);
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(&full[st]);
    }
    return;
  }

  const int g = warp >> 2, ctid = tid & 127, wq = warp & 3;
  const int gr = lane >> 2, t4 = lane & 3;
  const int tg0 = t0 + g * T;                  // this warpgroup's first token
  float* orow0 = out + ((size_t)b * mq_out + tg0) * width;

  // -inf over this block's range past the walk
  {
    const int f_lo = max(c_lo, c_end) * KC, f_hi = min(c_hi * KC, width);
    const int n4 = max(0, f_hi - f_lo) / 4;
    const float4 ninf = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    for (int i = ctid; i < T * n4; i += 128) {
      const int tt = i / n4, p = f_lo + 4 * (i % n4);
      if (tg0 + tt < mq_out)
        *reinterpret_cast<float4*>(orow0 + (size_t)tt * width + p) = ninf;
    }
  }
  if (c_end <= c_lo) return;

  // the weights of this warpgroup's rows (0 past the queries)
  for (int c = ctid; c < ROWS; c += 128) {
    const int t = tg0 + c / N1;
    ws[g * ROWS + c] = t < mq_in ? w[((size_t)b * mq_in + t) * N1 + c % N1] : 0.f;
  }
  wg::bar_sync(1 + g, 128);
  wg::mbar_wait(qbar, 0);

  const unsigned char* qs = smem + L::Q + 2 * g * QBLOCK;
  const float2* wrow = reinterpret_cast<const float2*>(ws + g * ROWS) + t4;
  float* stage_out = reinterpret_cast<float*>(smem + L::OUT) + g * 2 * T * KC;
  float acc[128];
  for (int it = 0, c = c_lo; c < c_end; ++it, ++c) {
    const int st = it % STAGES;
    const unsigned char* kst = smem + L::RING + st * STAGE;
    wg::mbar_wait(&full[st], (it / STAGES) & 1);
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    wg::fence_operands(acc);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t at = (ks & 3) * 32;
      wg::mma_m64n256k16<0>(acc, wg::desc_sw128(kst + (ks >> 2) * KBLOCK + at, 16, 1024),
                            wg::desc_sw128(qs + (ks >> 2) * QBLOCK + at, 16, 1024));
    }
    wg::commit();
    wg::wait_all();
    wg::fence_operands(acc);
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[st]);

    // relu x w over this thread's heads of each token (columns 8 i + 2 t4,
    // + 1 of rows 16 wq + gr, + 8: token i / (N1 / 8)), then over the quad
    float sum[2][T];
#pragma unroll
    for (int tt = 0; tt < T; ++tt) sum[0][tt] = sum[1][tt] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int tt = i / (N1 / 8);
      const float2 wv = wrow[4 * i];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h][tt] = fmaf(fmaxf(acc[4 * i + 2 * h], 0.f), wv.x, sum[h][tt]);
        sum[h][tt] = fmaf(fmaxf(acc[4 * i + 2 * h + 1], 0.f), wv.y, sum[h][tt]);
      }
    }
    float* so = stage_out + (it & 1) * T * KC;
#pragma unroll
    for (int tt = 0; tt < T; ++tt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = sum[h][tt];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t4 == (tt & 3)) so[tt * KC + 16 * wq + gr + 8 * h] = v;
      }
    wg::bar_sync(1 + g, 128);
    // the chunk's [T, 64] scores out, 16 bytes a store, masked by position
    for (int v = ctid; v < T * (KC / 4); v += 128) {
      const int tt = v / (KC / 4), p = c * KC + 4 * (v % (KC / 4));
      const int t = tg0 + tt;
      if (t >= mq_out || p >= width) continue;
      const float4 x = *reinterpret_cast<const float4*>(so + tt * KC + p - c * KC);
      const int lim = t < lq ? min(lk - 1, causal ? lk - lq + t : lk - 1) : -1;   // p <= lim
      float4 y;
      y.x = p <= lim ? x.x : -INFINITY;
      y.y = p + 1 <= lim ? x.y : -INFINITY;
      y.z = p + 2 <= lim ? x.z : -INFINITY;
      y.w = p + 3 <= lim ? x.w : -INFINITY;
      *reinterpret_cast<float4*>(orow0 + (size_t)tt * width + p) = y;
    }
  }
}

template <int N1>
int launch(const CUtensorMap& qmap, const CUtensorMap& kmap, const void* w, const void* bt,
           const void* lens_q, const void* lens_k, void* out, int batch, int mq_in, int mq_out,
           int max_pages, int page_size, int box_keys, int total_rows, int cps, int splits,
           int causal, cudaStream_t stream) {
  constexpr int smem = (int)Smem<ROWS / N1>::BYTES;
  cudaFuncSetAttribute(li_prefill_kernel<N1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int tb = 2 * ROWS / N1;                // tokens a block
  dim3 grid((mq_out + tb - 1) / tb, splits, batch);
  li_prefill_kernel<N1><<<grid, THREADS, smem, stream>>>(
      qmap, kmap, (const float*)w, (const int*)bt, (const int*)lens_q, (const int*)lens_k,
      (float*)out, mq_in, mq_out, max_pages, page_size, box_keys, total_rows, cps, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q [B, mq_in, N1, 128] and f32 w [B, mq_in, N1] (N1 = 16, 32, 64 or
// 128), bf16 k [P, 1, page, 128] (page % 8 == 0, n_pages = P; q and k
// 16-byte aligned), int32 bt [B, max_pages], lens_q / lens_k [B] -> f32 out
// [B, mq_out, max_pages * page]; every element written.  A block's key range
// is cps chunks of 64 keys, `splits` of them covering the table.
extern "C" int lightning_indexer_prefill_launch(const void* q, const void* w, const void* k,
                                                const void* bt, const void* lens_q,
                                                const void* lens_k, void* out, int batch,
                                                int mq_in, int mq_out, int n1, int max_pages,
                                                int page_size, int n_pages, int cps, int splits,
                                                int causal, void* stream) {
  if (batch == 0 || mq_out == 0 || max_pages == 0) return 0;
  if ((n1 != 16 && n1 != 32 && n1 != 64 && n1 != 128) || page_size % 8 != 0 || cps < 1 ||
      splits < 1 || (long long)cps * splits * KC < (long long)max_pages * page_size ||
      batch > 65535 || splits > 65535 || mq_in < 1 ||
      (long long)batch * mq_in * n1 >= (1ll << 31) || (long long)n_pages * page_size >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  int box_keys = KC;
  while (page_size % box_keys) box_keys /= 2;   // >= 8
  CUtensorMap qmap, kmap;
  const uint64_t q_dims[2] = {D, (uint64_t)batch * mq_in * n1};
  const uint64_t k_dims[2] = {D, (uint64_t)n_pages * page_size};
  const uint64_t strides[1] = {D * 2};
  const uint32_t q_box[2] = {64, ROWS}, k_box[2] = {64, (uint32_t)box_keys};
  int rc = wg::tensor_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, q_dims, strides, q_box);
  if (rc == 0)
    rc = wg::tensor_map(&kmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, k_dims, strides, k_box);
  if (rc != 0) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  const int total_rows = n_pages * page_size;
#define LI_LAUNCH(N)                                                                          \
  launch<N>(qmap, kmap, w, bt, lens_q, lens_k, out, batch, mq_in, mq_out, max_pages, page_size, \
            box_keys, total_rows, cps, splits, causal, s)
  switch (n1) {
    case 16: return LI_LAUNCH(16);
    case 32: return LI_LAUNCH(32);
    case 64: return LI_LAUNCH(64);
    default: return LI_LAUNCH(128);
  }
#undef LI_LAUNCH
}
