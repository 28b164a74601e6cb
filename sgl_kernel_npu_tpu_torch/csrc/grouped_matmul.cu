// grouped_matmul (K8a): the ragged grouped GEMM of the MoE, for Hopper: W8A8
// with a fused epilogue (the MoE above 512 tokens, and its dispatch_p form
// below), bf16 -> f32 / bf16 (the expert-parallel MoE and its training; the
// second half of this file), and grouped_matmul_combine (K8b) at the end.
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/grouped_matmul.py:
// grouped_matmul (_gmm_kernel) in its int8 modes: epilogue "none" (the exact
// int32 sums to f32 / bf16), "dequant" (out = acc x scale_x[row] x scale_w[g,
// col], cast to bf16 or f32), "dequant_swiglu" (the same, then SwiGLU on the
// gate / up packing of pack width tn, to bf16 or f32) and
// "dequant_swiglu_quant" (SwiGLU on the full-width gate || up packing, then a
// per-row int8 requant); each with dispatch_p (the rows taken from an
// unsorted token array by a one-hot [S, n_tok] matrix P), and "none" with
// rhs_contract_last (w [G, N, K]).  The TPU kernel walks a scalar-prefetched
// (group, m-tile) schedule on a sequential grid and adds each k-tile's int32
// partial into an f32 accumulator; with dispatch_p it forms each row tile as
// P @ x on the MXU.
//
// Bound on the H100: bytes, but only by about 2x.  At a 2048-token prefill
// chunk of DeepSeek-V3 (16384 rows of top-8 routing over all 256 experts,
// ~64 rows each) every expert's weights stream once: GMM1 7.5 GB (2.24 ms at
// 3.35 TB/s) against 0.96 T int8 operations (0.49 ms at 1979 TOP/s), GMM2
// 3.8 GB (1.12 ms) against 0.48 T.  ~64 rows make each weight byte worth ~128
// operations: the products run on the tensor cores, s8 x s8 -> s32 (exact
// whatever the order).
//
// Design of the int8 modes (gmm_int8_kernel below).  A tile of 64 rows held
// one stage of weights in registers with a round trip to HBM a stage (43 % of
// the bytes bound at the shape above); here a block keeps several stages of
// weights in flight through TMA and multiplies on wgmma, as the bf16 modes
// do: the int8 ring of gmm_int8_ring.cuh, which the fused MoE (K16b,
// fused_full.cu) runs too.  A block owns one work unit (work item, column
// tile), two blocks an SM; its group is found on the device (no host sync).
// The items past the last one zero the rows past the groups' total (the
// requant pass does it in the dequant_swiglu_quant mode).
// With dispatch_p a prologue finds each row's token from its row of P (the
// column of its nonzero; none: a zero row), and the item loads x[token]: the
// same rows as P @ x for a one-hot or zero P, without the product.  The
// prologue counts the rows of any other P (more than one nonzero, or a value
// other than 1), and the wrapper refuses such a P.
#include <string.h>

#include "gmm_int8_ring.cuh"

namespace k8 {

// Items past the last tile: zero rows [total, S) of the output columns [c0,
// c0 + width) (n_out columns a row), the pad items striding over them, ROWS
// rows an item, NT threads a block.
template <int ROWS, int NT, class OutT>
__device__ void zero_tail(OutT* __restrict__ out, int total, int S, int n_out, int c0,
                          int width, int pad, int n_pad) {
  for (int r = total + pad * ROWS; r < S; r += n_pad * ROWS)
    for (int e = threadIdx.x; e < ROWS * width / 2; e += NT) {
      const int row = r + e / (width / 2), col = c0 + 2 * (e % (width / 2));
      if (row < S && col < n_out) store_pair(out, (size_t)row * n_out + col, 0.f, 0.f);
    }
}

// dispatch_p's prologue: xrow[r] = the column of the nonzero of P's row r (a
// one-hot row's token), -1 for a zero row; a row that is neither (more than
// one nonzero, or a value other than 1) adds one to *bad.  A warp a row.
__device__ __forceinline__ float p_value(int8_t v) { return (float)v; }
__device__ __forceinline__ float p_value(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float p_value(float v) { return v; }

template <class PT>
__global__ void dispatch_rows_kernel(const PT* __restrict__ p, int S, int n_tok,
                                     int* __restrict__ xrow, int* __restrict__ bad) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= S) return;                          // a whole warp leaves together
  const PT* pr = p + (size_t)row * n_tok;
  int first = n_tok, nonzeros = 0;
  bool other = false;
  for (int j = lane; j < n_tok; j += 32) {
    const float v = p_value(pr[j]);
    if (v != 0.f) {
      first = min(first, j);
      ++nonzeros;
      other |= v != 1.f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
    nonzeros += __shfl_xor_sync(0xffffffffu, nonzeros, o);
  }
  other = __any_sync(0xffffffffu, other);
  if (lane == 0) {
    const bool one_hot = nonzeros == 1 && !other;
    xrow[row] = one_hot ? first : -1;
    if (nonzeros != 0 && !one_hot) atomicAdd(bad, 1);
  }
}

// ---------------------------------------------------------------------------
// bf16 rows x bf16 weights -> f32, bf16 or f16: K8a's "none" mode (out[i] =
// x[i] @ w[g(i)], w [G, K, N] with N contiguous) and its "rhs_contract_last"
// mode (out[i] = x[i] @ w[g(i)]^T, w [G, N, K] with K contiguous: the dx of
// gmm_train), either with dispatch_p (the int8 modes' row map).  The
// TPU kernel adds f32 per-k-tile partials of its MXU products (_gmm_kernel,
// grouped_matmul.py:297-302); here the tensor cores accumulate in f32 in
// another order.
//
// Bound on the H100: bytes.  At DeepSeek-V3's training batch (8320 rows of
// top-8 routing over 256 experts, ~33 rows each) each product streams every
// expert's weights once, 7.5 GB (2.24 ms at 3.35 TB/s) against 0.24 T bf16
// operations (0.25 ms at 989 TFLOP/s); at GPT-OSS-20B's 512-token chunk (2048
// rows over 32 experts) a layer's two products read at most 1.59 GB.  A weight
// byte is worth ~33-128 operations, well below the card's ~295 a byte.
//
// Design (Hopper).  A block has to keep several stages of weights in flight
// (a single 64-k stage held in registers, with a round trip to HBM per
// stage, reaches two thirds of the bound at GPT-OSS's shape), and a group's
// weights should stream once however many rows it has.  So a block owns (work
// item, column tile): an item is up to WM = 128 sorted rows of one group,
// aligned to the group's first row (the wrapper's tile offsets of 128-row
// items), so a group of up to 128 rows streams its weights once; a column
// tile is WN = 128 columns; two blocks an SM.  Warp 8 loads a ring of
// WSTAGES stages of 64 k behind full / empty mbarriers, both operands in
// the 128-byte swizzle that wgmma reads: one lane issues the
// weight tile by TMA (none: two boxes of 64 k x 64 columns, an MN-major B;
// rhs_contract_last: one box of 128 columns x 64 k, K-major; neither layout
// transposed in memory; columns and k past the edges read as zeros) and the
// item's x rows as TMA boxes of 64 rows x 64 k (K-major A) where they are
// contiguous; with dispatch_p the warp gathers them by cp.async into the
// same swizzle (a row map TMA cannot follow; k past K as zeros; slower, as
// scripts/probe_gmm_bf16.py measures).
// Warpgroups 0 and 1 each take 64 rows (the second only when the item has
// more than 64) on wgmma m64n128k16 into 64 f32 accumulators a thread, one
// stage's products in flight while the next stage's are issued, and release
// each stage on its empty barrier.  The block's group is found by one
// warp's parallel count over the tile offsets (no host sync).  Rows of the
// item past its group are never written; the items past the last one zero
// the rows past the groups' total.
constexpr int WM = 128;                         // rows of a bf16 work item
constexpr int WN = 128;                         // columns of a bf16 block
constexpr int WK = 64;                          // k of a stage (128 bytes of bf16)
constexpr int WSTAGES = 3;
constexpr int WBLOCKS = 2;                      // blocks an SM
constexpr int WCONSUMERS = 256;                 // warpgroups 0 and 1 compute,
constexpr int WTHREADS = WCONSUMERS + 32;       // warp 8 loads
constexpr uint32_t W_BYTES = WK * WN * 2;       // a stage's weights, 1024-aligned
constexpr uint32_t XBOX = 64 * WK * 2;          // 64 x rows [row][128 bytes]
constexpr uint32_t WSTAGE = W_BYTES + 2 * XBOX;
constexpr uint32_t WSRC_OFF = WSTAGES * WSTAGE;         // [WM] source row (-1 zero)
constexpr uint32_t WITEM_OFF = WSRC_OFF + WM * 4;       // group, first row, rows
constexpr uint32_t WBARS_OFF = WITEM_OFF + 16;          // full[WSTAGES], empty[WSTAGES]
constexpr uint32_t WSMEM = WBARS_OFF + 2 * WSTAGES * 8;
static_assert(WBLOCKS * (WSMEM + 1024) <= 233472,
              "K8a bf16's blocks exceed an SM's shared memory");

// x [S, K] bf16 rows grouped by expert (row r reads x[xrow[r]] where xrow is
// given; else xmap, x as (K, S), boxes of 64 x 64), wmap the weights' tensor
// map (none: [G, K, N] as (N, K, G), boxes of 64 x 64; CL: [G, N, K] as (K,
// N, G), boxes of 64 x 128), offsets / tile_off [G + 1] (row offsets, prefix
// sums of ceil(size / WM)) -> out [S, N] f32, bf16 or f16.
template <bool CL, class OutT>
__global__ void __launch_bounds__(WTHREADS, WBLOCKS)
    gmm_bf16_kernel(const bf16* __restrict__ x, const int* __restrict__ xrow,
                    const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const int* __restrict__ offsets,
                    const int* __restrict__ tile_off, int groups, int S, int K, int N,
                    OutT* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int* src_s = reinterpret_cast<int*>(smem + WSRC_OFF);
  int* item_s = reinterpret_cast<int*>(smem + WITEM_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WBARS_OFF);
  uint64_t* empty = full + WSTAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * WN, item = blockIdx.y;
  const int n_items = tile_off[groups];
  if (item >= n_items) {
    zero_tail<WM, WTHREADS>(out, min(offsets[groups], S), S, N, n0, WN, item - n_items,
                            gridDim.y - n_items);
    return;
  }
  if (warp == 0) {  // the item's group: the count of groups 1 .. G - 1 starting at or before it
    int below = 0;
    for (int i = 1 + lane; i < groups; i += 32) below += tile_off[i] <= item;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(0xffffffffu, below, o);
    if (lane == 0) {
      const int r0 = offsets[below] + (item - tile_off[below]) * WM;
      item_s[0] = below;
      item_s[1] = r0;
      item_s[2] = min(min(r0 + WM, offsets[below + 1]), S) - r0;
    }
  }
  __syncthreads();
  const int g = item_s[0], r0 = item_s[1], rows = item_s[2];
  if (rows <= 0) return;
  const int active = rows > 64 ? 2 : 1;         // computing warpgroups with live rows
  const int nk = (K + WK - 1) / WK;
  if (xrow != nullptr && tid < rows) src_s[tid] = xrow[r0 + tid];
  if (tid == 0)
    for (int i = 0; i < WSTAGES; ++i) {
      wg::mbar_init(&full[i], 2 * 32);          // each producer lane twice
      wg::mbar_init(&empty[i], 4 * active);     // each computing warp once
    }
  __syncthreads();

  if (warp == WCONSUMERS / 32) {  // the producer warp
    for (int it = 0; it < nk; ++it) {
      const int st = it % WSTAGES;
      if (it >= WSTAGES) wg::mbar_wait(&empty[st], (it / WSTAGES - 1) & 1);
      unsigned char* stage = smem + st * WSTAGE;
      unsigned char* xs = stage + W_BYTES;
      const int k0 = it * WK;
      if (lane == 0) {
        wg::mbar_expect_tx(&full[st], W_BYTES + (xrow == nullptr ? active * XBOX : 0));
        if (CL) {
          wg::tma_load_3d(stage, &wmap, k0, n0, g, &full[st]);
        } else {
          wg::tma_load_3d(stage, &wmap, n0, k0, g, &full[st]);
          wg::tma_load_3d(stage + W_BYTES / 2, &wmap, n0 + 64, k0, g, &full[st]);
        }
        if (xrow == nullptr)
          for (int h = 0; h < active; ++h)
            wg::tma_load_2d(xs + h * XBOX, &xmap, k0, r0 + 64 * h, &full[st]);
      }
      if (xrow != nullptr) {  // 4 rows x 8 pieces a copy instruction, swizzled as TMA would
        const int pc = lane & 7, kk = k0 + 8 * pc;
        for (int r = lane >> 3; r < rows; r += 4) {
          const int sr = src_s[r];
          const bool live = sr >= 0 && kk < K;   // K % 8 == 0: a piece is all in or all out
          wg::cp_async16(xs + r * 128 + ((pc ^ (r & 7)) << 4),
                         live ? x + (size_t)sr * K + kk : x, live ? 16 : 0);
        }
      }
      wg::mbar_arrive_cp_async(&full[st]);     // when this lane's x pieces land
      wg::mbar_arrive(&full[st]);
    }
    return;
  }

  const int wgi = tid >> 7;
  if (wgi >= active) return;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int st = it % WSTAGES;
    const unsigned char* stage = smem + st * WSTAGE;
    wg::mbar_wait(&full[st], (it / WSTAGES) & 1);
    if (xrow != nullptr) wg::fence_proxy();    // the x pieces came by cp.async
    const unsigned char* xs = stage + W_BYTES + wgi * XBOX;
    wg::fence_operands(acc);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < WK / 16; ++ks) {
      const uint64_t a = wg::desc_sw128(xs + ks * 32, 16, 1024);
      if (CL)
        wg::mma_m64n128k16<0>(acc, a, wg::desc_sw128(stage + ks * 32, 16, 1024));
      else
        wg::mma_m64n128k16<1>(acc, a, wg::desc_sw128(stage + 16 * ks * 128, W_BYTES / 2, 1024));
    }
    wg::commit();
    wg::wait_one();                            // the previous stage's products are done
    wg::fence_operands(acc);
    __syncwarp();
    if (it > 0 && lane == 0) wg::mbar_arrive(&empty[(it - 1) % WSTAGES]);
  }
  wg::wait_all();
  wg::fence_operands(acc);

  // acc[4 i + 2 h + e]: row 16 (warp % 4) + lane / 4 + 8 h of the warpgroup's
  // 64, column 8 i + 2 (lane % 4) + e of the tile
  const int wq = warp & 3, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * wgi + 16 * wq + g8 + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int i = 0; i < WN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * t4;
      if (col < N)
        store_pair(out, (size_t)(r0 + r) * N + col, acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// int8 rows x int8 weights on s8 wgmma (the int8 modes; the design is in the
// header comment and gmm_int8_ring.cuh): one work unit a block.  x [S, K]
// int8 rows grouped by expert (row r reads x[xrow[r]] where xrow is given;
// else xmap), wmap the weights (int8_ring), offsets / tile_off [G + 1] (row
// offsets, prefix sums of ceil(size / QM)), sx [S] and sw [G, N] (null:
// unscaled, the "none" epilogue).  "dequant": out [S, N]; kSwiGLUOut: out [S,
// N / 2] from the packing of half width ht; kSwiGLU: act [S, N / 2] f32
// scratch and amax [S] (zeroed) for the requant pass.
template <int EPI, bool CL, class OutT>
__global__ void __launch_bounds__(QTHREADS, 2)
    gmm_int8_kernel(const int8_t* __restrict__ x, const int* __restrict__ xrow,
                    const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const int* __restrict__ offsets,
                    const int* __restrict__ tile_off, int groups, int S, int K, int N, int ht,
                    int run, const float* __restrict__ sx, const float* __restrict__ sw,
                    OutT* __restrict__ out, float* __restrict__ act,
                    unsigned* __restrict__ amax) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int* item_s = reinterpret_cast<int*>(smem + QITEM_OFF);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bx = blockIdx.x, item = blockIdx.y;
  const int n_items = tile_off[groups];
  const int n_out = EPI == kDequant ? N : N / 2, width = EPI == kDequant ? QN : QN / 2;
  if (item >= n_items) {
    if (EPI != kSwiGLU)
      zero_tail<QM, QTHREADS>(out, min(offsets[groups], S), S, n_out, bx * width, width,
                              item - n_items, gridDim.y - n_items);
    return;
  }
  if (warp == 0) {  // the item's group: the count of groups 1 .. G - 1 starting at or before it
    int below = 0;
    for (int i = 1 + lane; i < groups; i += 32) below += tile_off[i] <= item;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(0xffffffffu, below, o);
    if (lane == 0) {
      const int r0 = offsets[below] + (item - tile_off[below]) * QM;
      item_s[0] = below;
      item_s[1] = r0;
      item_s[2] = min(min(r0 + QM, offsets[below + 1]), S) - r0;
    }
  }
  if (tid == 0) ring_init(smem);
  __syncthreads();
  const Unit unit{item_s[0], item_s[1], item_s[2], bx};
  if (unit.rows <= 0) return;
  int8_ring<EPI, CL, true>(
      smem, 0, 1, [&](int) { return unit; }, &xmap, &wmap, x, xrow, K, N, ht,
      run, sx, sw,
      [&](int row, int col, float v0, float v1) {
        store_pair(out, (size_t)row * n_out + col, v0, v1);
      },
      act, amax);
}

// ---------------------------------------------------------------------------
// grouped_matmul_combine (K8b): the W8A8 GMM2 with the weighted top-k combine,
// out [n_tok, N] = m_hi @ d + m_lo @ d, d[r] = bf16(acc[r] x sx[r] x sw[g(r),
// :]) over the rows r in a group (rows past the groups' total and the columns
// of m past it weigh 0).
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/grouped_matmul.py:
// grouped_matmul_combine (_gmm_combine_kernel, :746): an n-outer grid whose
// [n_tok, tn] combine accumulator stays in VMEM across the row sweep, so the
// expert output never reaches HBM; the combine weights come as a bf16 hi +
// lo split of the f32 [n_tok, S] mask, two MXU products.
//
// Bound on the H100: bytes, by the live experts' weights (at DeepSeek-V3's
// 512 tokens all 256 experts' w2, 3.76 GB: 1.12 ms); the combine's
// 4 n_tok S N bf16 operations (60 G at 512 tokens, 0.06 ms) are small.
//
// Design: three launches, no host sync.  (0) One block turns the group sizes
// into the row offsets and the prefix sums of 128-row items (in place of ~13
// small PyTorch launches of ~2.5 us each).  (1) combine_rows_kernel: the int8
// ring of gmm_int8_ring.cuh in persistent blocks, two an SM, each walking
// (128-row item, 128-column tile) units blockIdx.x, + gridDim.x, ... (at 8
// to 512 tokens an expert has 1-16 rows, a unit 16 stages of weights: a
// block's loading warps run into its next unit's stages), "dequant" to bf16
// (the rounding JAX applies before its combine products) into a scratch d [S,
// N] (59 MB at 512 tokens: ~35 us of traffic against the weights' 1.12 ms);
// the rows past the total are zeros.  (2) combine_kernel: a block owns 128
// tokens (a warpgroup each 64) x 128 columns and walks the rows of d below
// the total in order, 64 a stage through a 4-stage ring: d's rows as two TMA
// boxes of 64 rows x 64 columns (128-byte swizzle, an MN-major B), the masks'
// 64 tokens x 64 rows as TMA boxes (K-major A) where a mask row's 2 S bytes
// are a multiple of 16 and the stage lies below the total, else gathered by
// the loading warp with 2-byte loads into the same swizzle (any S; columns
// past the total as zeros); bf16 wgmma m64n128k16, the hi then the lo
// product of each 16 rows into one f32 accumulator (the products of two bf16
// values are exact in f32; only the order of the sums differs from the
// TPU's).  Each output value has one owner and a fixed order: no atomics,
// the result does not depend on block order.  Fusing the combine into (1)'s
// epilogue would save only d's round trip, and an output column tile sums
// the rows of every expert, which several blocks hold: atomics or a second
// pass over partials all the same.
// ---------------------------------------------------------------------------

// (0): offsets [G + 1] and tile_off [G + 1] (prefix sums of ceil(size / QM))
// of the group sizes, by one block of OFF_THREADS threads.
constexpr int OFF_THREADS = 1024;

__global__ void __launch_bounds__(OFF_THREADS)
    combine_offsets_kernel(const int* __restrict__ sizes, int groups, int* __restrict__ offsets,
                           int* __restrict__ tile_off) {
  __shared__ int warp_rows[32], warp_items[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (groups + OFF_THREADS - 1) / OFF_THREADS;
  const int g0 = min(tid * per, groups), g1 = min(g0 + per, groups);
  int rows = 0, items = 0;
  for (int g = g0; g < g1; ++g) {
    rows += sizes[g];
    items += (sizes[g] + QM - 1) / QM;
  }
  int r = rows, it = items;                      // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int pr = __shfl_up_sync(0xffffffffu, r, o), pi = __shfl_up_sync(0xffffffffu, it, o);
    if (lane >= o) r += pr, it += pi;
  }
  if (lane == 31) warp_rows[warp] = r, warp_items[warp] = it;
  __syncthreads();
  if (warp == 0) {                               // ... and over the warps
    int wr = warp_rows[lane], wi = warp_items[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int pr = __shfl_up_sync(0xffffffffu, wr, o), pi = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wr += pr, wi += pi;
    }
    warp_rows[lane] = wr, warp_items[lane] = wi;
  }
  __syncthreads();
  int br = r - rows + (warp ? warp_rows[warp - 1] : 0);
  int bi = it - items + (warp ? warp_items[warp - 1] : 0);
  for (int g = g0; g < g1; ++g) {
    offsets[g] = br, tile_off[g] = bi;
    br += sizes[g];
    bi += (sizes[g] + QM - 1) / QM;
  }
  if (tid == OFF_THREADS - 1) offsets[groups] = br, tile_off[groups] = bi;
}

// (1): d = bf16(x @ w[g] x sx[row] x sw[g, col]) for the rows in a group, 0
// past the total.  xmap: x [S, K] int8 as (K, S), boxes of 128 k x 64 rows in
// the 128-byte swizzle; wmap: w [G, K, N] int8 as (N, K, G), boxes of 128 x
// 128 x 1; offsets / tile_off from (0); sx [S], sw [G, N] -> d [S, N] bf16.
__global__ void __launch_bounds__(QTHREADS, 2)
    combine_rows_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, const int* __restrict__ offsets,
                        const int* __restrict__ tile_off, int groups, int S, int K, int N,
                        const float* __restrict__ sx, const float* __restrict__ sw,
                        bf16* __restrict__ d) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x;
  if (tid == 0) ring_init(smem);
  const int total = min(offsets[groups], S), vec = N / 8;   // 8 bf16 a store
  for (size_t i = (size_t)blockIdx.x * QTHREADS + tid; i < (size_t)(S - total) * vec;
       i += (size_t)gridDim.x * QTHREADS)
    *reinterpret_cast<uint4*>(d + (size_t)(total + i / vec) * N + 8 * (i % vec)) =
        make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int ct = (N + QN - 1) / QN, n = tile_off[groups] * ct;
  const int count = n > (int)blockIdx.x ? (n - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  int8_ring<kDequant, false, true>(
      smem, 0, count,
      [&](int j) {
        const int w = blockIdx.x + j * gridDim.x, item = w / ct;
        const int g = find_group(tile_off, groups, item);
        const int r0 = offsets[g] + (item - tile_off[g]) * QM;
        return Unit{g, r0, min(min(r0 + QM, offsets[g + 1]), S) - r0, w % ct};
      },
      &xmap, &wmap, nullptr, nullptr, K, N, N / 2, QN, sx, sw,
      [&](int row, int col, float v0, float v1) { store_pair(d, (size_t)row * N + col, v0, v1); },
      nullptr, nullptr);
}

// (2): the mask products.
constexpr int CM = 128;                         // tokens a block: a computing warpgroup each 64
constexpr int CN = 128;                         // columns a block
constexpr int CK = 64;                          // rows of d (k) a stage: 128 bytes of a mask row
constexpr int CSTAGES = 4;
constexpr int CCONSUMERS = 256;                 // warpgroups 0 and 1 compute,
constexpr int CTHREADS = CCONSUMERS + 32;       // warp 8 loads
constexpr uint32_t C_B = CK * CN * 2;           // d: two boxes of 64 rows x 64 columns
constexpr uint32_t C_A = 64 * CK * 2;           // a mask box: 64 tokens x 64 rows
constexpr uint32_t C_STAGE = C_B + 4 * C_A;     // d, then hi / lo of warpgroup 0, then of 1
constexpr uint32_t C_BARS_OFF = CSTAGES * C_STAGE;      // full[CSTAGES], empty[CSTAGES]
constexpr uint32_t C_SMEM = C_BARS_OFF + 2 * CSTAGES * 8;
static_assert(C_SMEM + 1024 <= 233472, "K8b's combine block exceeds an SM's shared memory");

// hmap / lmap: m_hi / m_lo [n_tok, S] bf16 as (S, n_tok), boxes of 64 x 64 in
// the 128-byte swizzle (tma_a; else unused: the loading warp reads mhi /
// mlo), dmap: d [S, N] as (N, S), boxes of 64 x 64 -> out [n_tok, N].
template <class OutT>
__global__ void __launch_bounds__(CTHREADS, 1)
    combine_kernel(const __grid_constant__ CUtensorMap hmap,
                   const __grid_constant__ CUtensorMap lmap,
                   const __grid_constant__ CUtensorMap dmap, const bf16* __restrict__ mhi,
                   const bf16* __restrict__ mlo, const int* __restrict__ offsets, int groups,
                   int n_tok, int S, int N, int tma_a, OutT* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C_BARS_OFF);
  uint64_t* empty = full + CSTAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * CM, n0 = blockIdx.y * CN;
  const int total = min(offsets[groups], S), nk = (total + CK - 1) / CK;
  const int active = n_tok - t0 > 64 ? 2 : 1;   // computing warpgroups with live tokens
  if (tid == 0)
    for (int i = 0; i < CSTAGES; ++i) {
      wg::mbar_init(&full[i], 32);              // each producer lane once
      wg::mbar_init(&empty[i], 4 * active);     // each computing warp once
    }
  __syncthreads();

  if (warp == CCONSUMERS / 32) {  // the producer warp
    for (int it = 0; it < nk; ++it) {
      const int st = it % CSTAGES, k0 = it * CK;
      if (it >= CSTAGES) wg::mbar_wait(&empty[st], (it / CSTAGES - 1) & 1);
      unsigned char* stage = smem + st * C_STAGE;
      const bool box_a = tma_a && k0 + CK <= total;
      if (lane == 0) {
        wg::mbar_expect_tx(&full[st], C_B + (box_a ? 2 * active * C_A : 0));
        wg::tma_load_2d(stage, &dmap, n0, k0, &full[st]);
        wg::tma_load_2d(stage + C_B / 2, &dmap, n0 + 64, k0, &full[st]);
        if (box_a)
          for (int h = 0; h < active; ++h) {
            wg::tma_load_2d(stage + C_B + 2 * h * C_A, &hmap, k0, t0 + 64 * h, &full[st]);
            wg::tma_load_2d(stage + C_B + (2 * h + 1) * C_A, &lmap, k0, t0 + 64 * h, &full[st]);
          }
      }
      if (!box_a) {  // 16-byte pieces of 8 mask values, swizzled as TMA would; 0 past the edges
        for (int e = lane; e < active * 64 * (CK / 8); e += 32) {
          const int r = e >> 3, pc = e & 7, t = t0 + r, kk = k0 + 8 * pc;
          uint32_t hv[4], lv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            __nv_bfloat162 h2 = __floats2bfloat162_rn(0.f, 0.f), l2 = h2;
            const size_t at = (size_t)t * S + kk + 2 * j;
            if (t < n_tok && kk + 2 * j < total) h2.x = mhi[at], l2.x = mlo[at];
            if (t < n_tok && kk + 2 * j + 1 < total) h2.y = mhi[at + 1], l2.y = mlo[at + 1];
            hv[j] = *reinterpret_cast<uint32_t*>(&h2);
            lv[j] = *reinterpret_cast<uint32_t*>(&l2);
          }
          unsigned char* a =
              stage + C_B + 2 * (r >> 6) * C_A + (r & 63) * 128 + ((pc ^ (r & 7)) << 4);
          *reinterpret_cast<uint4*>(a) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
          *reinterpret_cast<uint4*>(a + C_A) = make_uint4(lv[0], lv[1], lv[2], lv[3]);
        }
        wg::fence_proxy();                      // the products read these stores
      }
      wg::mbar_arrive(&full[st]);
    }
    return;
  }

  const int wgi = tid >> 7;
  if (wgi >= active) return;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int st = it % CSTAGES;
    const unsigned char* stage = smem + st * C_STAGE;
    const unsigned char* ah = stage + C_B + 2 * wgi * C_A;
    wg::mbar_wait(&full[st], (it / CSTAGES) & 1);
    wg::fence_proxy();                          // a stage's masks may come by plain stores
    wg::fence_operands(acc);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < CK / 16; ++ks) {      // 16 rows of d: the hi product, then the lo
      const uint64_t b = wg::desc_sw128(stage + 16 * ks * 128, C_B / 2, 1024);
      wg::mma_m64n128k16<1>(acc, wg::desc_sw128(ah + ks * 32, 16, 1024), b);
      wg::mma_m64n128k16<1>(acc, wg::desc_sw128(ah + C_A + ks * 32, 16, 1024), b);
    }
    wg::commit();
    wg::wait_one();                            // the previous stage's products are done
    wg::fence_operands(acc);
    __syncwarp();
    if (it > 0 && lane == 0) wg::mbar_arrive(&empty[(it - 1) % CSTAGES]);
  }
  wg::wait_all();
  wg::fence_operands(acc);

  // acc[4 i + 2 h + e]: token 16 (warp % 4) + lane / 4 + 8 h of the
  // warpgroup's 64, column 8 i + 2 (lane % 4) + e of the tile
  const int wq = warp & 3, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + 64 * wgi + 16 * wq + g8 + 8 * h;
    if (t >= n_tok) continue;
#pragma unroll
    for (int i = 0; i < CN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * t4;
      if (col < N) store_pair(out, (size_t)t * N + col, acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}

}  // namespace k8

namespace {

enum OutKind { kF32 = 0, kBF16 = 1, kF16 = 2 };

// xrow[S] from the one-hot P [S, n_tok] (p_kind: 0 int8, 1 bf16, 2 f32); *bad
// = the number of rows that are neither one-hot nor zero.
int dispatch_rows(const void* p, int p_kind, int S, int n_tok, int* xrow, int* bad,
                  cudaStream_t s) {
  const dim3 grid((S + 7) / 8), block(256);     // a warp a row
  cudaMemsetAsync(bad, 0, sizeof(int), s);
  if (p_kind == 0)
    k8::dispatch_rows_kernel<<<grid, block, 0, s>>>((const int8_t*)p, S, n_tok, xrow, bad);
  else if (p_kind == 1)
    k8::dispatch_rows_kernel<<<grid, block, 0, s>>>((const __nv_bfloat16*)p, S, n_tok, xrow,
                                                    bad);
  else if (p_kind == 2)
    k8::dispatch_rows_kernel<<<grid, block, 0, s>>>((const float*)p, S, n_tok, xrow, bad);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <int EPI, bool CL, class OutT>
int launch_int8(cudaStream_t s, const void* x, const int* xrow, const void* w, const void* offsets,
                const void* tile_off, int groups, int S, int K, int N, int ht, const void* sx,
                const void* sw, void* out, void* act, void* amax) {
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));             // no k (or no x map): no loads
  memset(&wmap, 0, sizeof(wmap));
  // the SwiGLU halves' boxes: the widest of 64, 32, 16 columns dividing ht
  const int run = EPI == k8::kDequant ? k8::QN : ht % 64 == 0 ? 64 : ht % 32 == 0 ? 32 : 16;
  if (K > 0 && groups > 0) {  // w [G, K, N] as (N, K, G); CL: [G, N, K] as (K, N, G)
    const uint64_t dims[3] = {(uint64_t)(CL ? K : N), (uint64_t)(CL ? N : K), (uint64_t)groups};
    const uint64_t strides[2] = {(uint64_t)(CL ? K : N), (uint64_t)K * N};
    const uint32_t box[3] = {(uint32_t)(CL ? k8::QK : run), (uint32_t)(CL ? k8::QN : k8::QK), 1};
    const int rc = wg::tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w, dims, strides, box,
                                  CL ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc != 0) return rc;
  }
  if (K > 0 && xrow == nullptr) {  // x [S, K] as (K, S), boxes of 128 k x 64 rows
    const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)S}, xstride[1] = {(uint64_t)K};
    const uint32_t xbox[2] = {k8::QK, 64};
    const int rc = wg::tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, xdims, xstride, xbox);
    if (rc != 0) return rc;
  }
  auto kernel = k8::gmm_int8_kernel<EPI, CL, OutT>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k8::QSMEM);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  const int cols = EPI == k8::kDequant ? (N + k8::QN - 1) / k8::QN
                                       : (N / 2 + k8::QN / 2 - 1) / (k8::QN / 2);
  const dim3 grid(cols, (S + k8::QM - 1) / k8::QM + groups + 1);
  kernel<<<grid, k8::QTHREADS, k8::QSMEM, s>>>(
      (const int8_t*)x, xrow, xmap, wmap, (const int*)offsets, (const int*)tile_off, groups, S, K,
      N, ht, run, (const float*)sx, (const float*)sw, (OutT*)out, (float*)act, (unsigned*)amax);
  return 0;
}

// The "dequant" / "none" (CL: rhs_contract_last) and "dequant_swiglu"
// launches by output type.
template <int EPI, bool CL>
int launch_int8_out(int out_kind, cudaStream_t s, const void* x, const int* xrow, const void* w,
                    const void* offsets, const void* tile_off, int groups, int S, int K, int N,
                    int ht, const void* sx, const void* sw, void* out) {
  if (out_kind == kF32)
    return launch_int8<EPI, CL, float>(s, x, xrow, w, offsets, tile_off, groups, S, K, N, ht, sx,
                                       sw, out, nullptr, nullptr);
  if (out_kind == kBF16)
    return launch_int8<EPI, CL, __nv_bfloat16>(s, x, xrow, w, offsets, tile_off, groups, S, K, N,
                                               ht, sx, sw, out, nullptr, nullptr);
  if (out_kind == kF16)
    return launch_int8<EPI, CL, __half>(s, x, xrow, w, offsets, tile_off, groups, S, K, N, ht, sx,
                                        sw, out, nullptr, nullptr);
  return (int)cudaErrorInvalidValue;
}

template <bool CL, class OutT>
int launch_bf16(cudaStream_t s, const void* x, const int* xrow, const void* w,
                const void* offsets, const void* tile_off, int groups, int S, int K, int N,
                void* out) {
  if (K == 0 || groups == 0) {                 // no products: every row is zero
    return (int)cudaMemsetAsync(out, 0, (size_t)S * N * sizeof(OutT), s);
  }
  CUtensorMap wmap, xmap;
  const uint64_t dims[3] = {(uint64_t)(CL ? K : N), (uint64_t)(CL ? N : K), (uint64_t)groups};
  const uint64_t strides[2] = {(uint64_t)(CL ? K : N) * 2, (uint64_t)K * N * 2};
  const uint32_t box[3] = {64, CL ? k8::WN : k8::WK, 1};
  int rc = wg::tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, dims, strides, box);
  if (rc != 0) return rc;
  if (xrow == nullptr) {  // x [S, K] as (K, S), boxes of 64 k x 64 rows
    const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)S}, xstride[1] = {(uint64_t)K * 2};
    const uint32_t xbox[2] = {64, 64};
    rc = wg::tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstride, xbox);
    if (rc != 0) return rc;
  } else {
    memset(&xmap, 0, sizeof(xmap));           // the gather reads no map
  }
  cudaFuncSetAttribute(k8::gmm_bf16_kernel<CL, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)k8::WSMEM);
  cudaFuncSetAttribute(k8::gmm_bf16_kernel<CL, OutT>,
                       cudaFuncAttributePreferredSharedMemoryCarveout, 100);   // two blocks an SM
  const dim3 grid((N + k8::WN - 1) / k8::WN, (S + k8::WM - 1) / k8::WM + groups + 1);
  k8::gmm_bf16_kernel<CL, OutT><<<grid, k8::WTHREADS, k8::WSMEM, s>>>(
      (const __nv_bfloat16*)x, xrow, xmap, wmap, (const int*)offsets, (const int*)tile_off,
      groups, S, K, N, (OutT*)out);
  return 0;
}

template <bool CL>
int launch_bf16_out(int out_kind, cudaStream_t s, const void* x, const int* xrow, const void* w,
                    const void* offsets, const void* tile_off, int groups, int S, int K, int N,
                    void* out) {
  if (out_kind == kF32)
    return launch_bf16<CL, float>(s, x, xrow, w, offsets, tile_off, groups, S, K, N, out);
  if (out_kind == kBF16)
    return launch_bf16<CL, __nv_bfloat16>(s, x, xrow, w, offsets, tile_off, groups, S, K, N,
                                          out);
  if (out_kind == kF16)
    return launch_bf16<CL, __half>(s, x, xrow, w, offsets, tile_off, groups, S, K, N, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K8a's int8 modes.  x [S, K] int8 (with p: the unsorted tokens [n_tok, K],
// p [S, n_tok] one-hot of kind p_kind, xrow [S] int32 scratch, bad [1] int32
// out: P's rows that are neither one-hot nor zero), w [G, K, N] int8
// (contract_last: [G, N, K], epi 0 and no scales only), x and w 16-byte
// aligned (TMA), offsets / tile_off [G + 1] int32 (row offsets; prefix sums
// of ceil(group size / 128)), sx [S] and sw [G, N] f32 (both null: "none").
// epi 0 ("dequant" / "none"): out [S, N] of out_kind (0 f32, 1 bf16, 2 f16);
// epi 2 ("dequant_swiglu"): out [S, N / 2] of out_kind from the packing of
// half width ht; epi 1 ("dequant_swiglu_quant", ht = N / 2): scratch act [S, N
// / 2] f32 and amax [S] u32, out h1 [S, N / 2] int8 and hs [S] f32.  Needs K %
// 16 == 0 and N % 16 == 0; the SwiGLU modes ht % 16 == 0 and N % (2 ht) == 0.
extern "C" int grouped_matmul_int8_launch(const void* x, const void* w, const void* offsets,
                                          const void* tile_off, int groups, int S, int K, int N,
                                          int ht, int epi, int contract_last, int out_kind,
                                          const void* sx, const void* sw, const void* p,
                                          int n_tok, int p_kind, void* xrow, void* bad,
                                          void* out, void* act, void* amax, void* hs,
                                          void* stream) {
  if (S == 0 || N == 0) return 0;
  const bool swiglu = epi != 0;
  if (epi < 0 || epi > 2 || K % 16 != 0 || N % 16 != 0 ||
      (swiglu && (ht % 16 != 0 || N % (2 * ht) != 0)) || (epi == 1 && 2 * ht != N) ||
      (contract_last && (epi != 0 || sx != nullptr || sw != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p != nullptr) {
    const int rc = dispatch_rows(p, p_kind, S, n_tok, (int*)xrow, (int*)bad, s);
    if (rc != 0) return rc;
  }
  const int* xr = p != nullptr ? (const int*)xrow : nullptr;
  int rc = 0;
  if (epi == 0 && contract_last) {
    rc = launch_int8_out<k8::kDequant, true>(out_kind, s, x, xr, w, offsets, tile_off, groups, S,
                                             K, N, ht, sx, sw, out);
  } else if (epi == 0) {
    rc = launch_int8_out<k8::kDequant, false>(out_kind, s, x, xr, w, offsets, tile_off, groups, S,
                                              K, N, ht, sx, sw, out);
  } else if (epi == 2) {
    rc = launch_int8_out<k8::kSwiGLUOut, false>(out_kind, s, x, xr, w, offsets, tile_off, groups,
                                                S, K, N, ht, sx, sw, out);
  } else {
    cudaMemsetAsync(amax, 0, sizeof(unsigned) * (size_t)S, s);
    rc = launch_int8<k8::kSwiGLU, false, float>(s, x, xr, w, offsets, tile_off, groups, S, K, N,
                                                ht, sx, sw, nullptr, act, amax);
    if (rc == 0)
      gmm::swiglu_requant_kernel<<<S, 256, 0, s>>>((const float*)act, (const unsigned*)amax,
                                                    (const int*)offsets, groups, N / 2,
                                                    (int8_t*)out, (float*)hs);
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// K8a's bf16 modes.  x [S, K] bf16 (with p: [n_tok, K], p, xrow and bad as above),
// w [G, K, N] bf16 (contract_last: [G, N, K]) starting 16-byte aligned (TMA),
// offsets [G + 1] as above, tile_off [G + 1] the prefix sums of ceil(size /
// 128): the bf16 work items of k8::WM rows -> out [S, N] of out_kind, rows
// past the groups' total zero.  Needs K % 8 == 0 and N % 8 == 0.
extern "C" int grouped_matmul_bf16_launch(const void* x, const void* w, const void* offsets,
                                          const void* tile_off, int groups, int S, int K, int N,
                                          int contract_last, int out_kind, const void* p,
                                          int n_tok, int p_kind, void* xrow, void* bad,
                                          void* out, void* stream) {
  if (S == 0 || N == 0) return 0;
  if (K % 8 != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p != nullptr) {
    const int rc = dispatch_rows(p, p_kind, S, n_tok, (int*)xrow, (int*)bad, s);
    if (rc != 0) return rc;
  }
  const int* xr = p != nullptr ? (const int*)xrow : nullptr;
  const int rc = contract_last ? launch_bf16_out<true>(out_kind, s, x, xr, w, offsets, tile_off,
                                                       groups, S, K, N, out)
                               : launch_bf16_out<false>(out_kind, s, x, xr, w, offsets, tile_off,
                                                        groups, S, K, N, out);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// K8b.  x [S, K] int8 (GMM1 output), w [G, K, N] int8 (both 16-byte
// aligned: TMA), sizes [G] int32 (the group sizes), sx [S] f32, sw [G, N]
// f32, m_hi / m_lo [n_tok, S] bf16; scratch offs [2 (G + 1)] int32 and d [S,
// N] bf16 -> out [n_tok, N] of out_kind.  Needs K % 16 == 0 and N % 16 == 0.
extern "C" int grouped_matmul_combine_launch(const void* x, const void* w, const void* sizes,
                                             int groups, int S, int K, int N, const void* sx,
                                             const void* sw, const void* mhi, const void* mlo,
                                             int n_tok, int out_kind, void* offs, void* d,
                                             void* out, void* stream) {
  if (n_tok == 0 || N == 0) return 0;
  if (K % 16 != 0 || N % 16 != 0 || out_kind < kF32 || out_kind > kF16 || groups < 0 ||
      (uintptr_t)x % 16 != 0 || (uintptr_t)w % 16 != 0 || (uintptr_t)d % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* offsets = (int*)offs;
  int* tile_off = offsets + groups + 1;
  k8::combine_offsets_kernel<<<1, k8::OFF_THREADS, 0, s>>>((const int*)sizes, groups, offsets,
                                                           tile_off);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(k8::combine_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)k8::QSMEM);
    cudaFuncSetAttribute(k8::combine_rows_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         100);
  }
  if (S > 0) {
    CUtensorMap xmap, wmap;
    memset(&xmap, 0, sizeof(xmap));           // no k: no loads
    memset(&wmap, 0, sizeof(wmap));
    if (K > 0 && groups > 0) {
      // x [S, K] as (K, S), boxes of 128 k x 64 rows; w [G, K, N] as (N, K, G)
      const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)S}, xstride[1] = {(uint64_t)K};
      const uint32_t xbox[2] = {k8::QK, 64};
      int rc = wg::tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, xdims, xstride, xbox);
      const uint64_t wdims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)groups};
      const uint64_t wstride[2] = {(uint64_t)N, (uint64_t)K * N};
      const uint32_t wbox[3] = {k8::QN, k8::QK, 1};
      if (rc == 0)
        rc = wg::tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w, wdims, wstride, wbox,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
      if (rc != 0) return rc;
    }
    // units: at most (S / 128 + G) items x the column tiles
    const long long units =
        ((long long)(S + k8::QM - 1) / k8::QM + groups) * ((N + k8::QN - 1) / k8::QN);
    const int blocks = (int)(units < 2LL * sms ? units : 2LL * sms);
    k8::combine_rows_kernel<<<blocks, k8::QTHREADS, k8::QSMEM, s>>>(
        xmap, wmap, offsets, tile_off, groups, S, K, N, (const float*)sx, (const float*)sw,
        (__nv_bfloat16*)d);
  }
  // the masks by TMA where a row's 2 S bytes and both bases are 16-byte aligned
  const int tma_a = S % 8 == 0 && (uintptr_t)mhi % 16 == 0 && (uintptr_t)mlo % 16 == 0;
  CUtensorMap hmap, lmap, dmap;
  memset(&hmap, 0, sizeof(hmap));
  memset(&lmap, 0, sizeof(lmap));
  memset(&dmap, 0, sizeof(dmap));
  if (S > 0) {
    const uint32_t box[2] = {64, 64};
    const uint64_t ddims[2] = {(uint64_t)N, (uint64_t)S}, dstride[1] = {(uint64_t)N * 2};
    int rc = wg::tensor_map(&dmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, d, ddims, dstride, box);
    if (rc == 0 && tma_a) {
      const uint64_t mdims[2] = {(uint64_t)S, (uint64_t)n_tok}, mstride[1] = {(uint64_t)S * 2};
      rc = wg::tensor_map(&hmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, mhi, mdims, mstride, box);
      if (rc == 0)
        rc = wg::tensor_map(&lmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, mlo, mdims, mstride, box);
    }
    if (rc != 0) return rc;
  }
  const dim3 grid((n_tok + k8::CM - 1) / k8::CM, (N + k8::CN - 1) / k8::CN);
  const auto* hi = (const __nv_bfloat16*)mhi;
  const auto* lo = (const __nv_bfloat16*)mlo;
  auto launch = [&](auto kernel, auto* o) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k8::C_SMEM);
    kernel<<<grid, k8::CTHREADS, k8::C_SMEM, s>>>(hmap, lmap, dmap, hi, lo, offsets, groups, n_tok,
                                                  S, N, tma_a, o);
  };
  if (out_kind == kF32)
    launch(k8::combine_kernel<float>, (float*)out);
  else if (out_kind == kBF16)
    launch(k8::combine_kernel<__nv_bfloat16>, (__nv_bfloat16*)out);
  else
    launch(k8::combine_kernel<__half>, (__half*)out);
  return (int)cudaGetLastError();
}
