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
// unsorted token array by a one-hot [S, n_tok] matrix P).  The TPU kernel
// walks a scalar-prefetched (group, m-tile) schedule on a sequential grid and
// adds each k-tile's int32 partial into an f32 accumulator; with dispatch_p
// it forms each row tile as P @ x on the MXU.
//
// Bound on the H100: bytes, but only by about 2x.  At a 2048-token prefill
// chunk of DeepSeek-V3 (16384 rows of top-8 routing over all 256 experts,
// ~64 rows each) every expert's weights stream once: GMM1 7.5 GB (2.24 ms at
// 3.35 TB/s) against 0.96 T int8 operations (0.49 ms at 1979 TOP/s), GMM2
// 3.8 GB (1.12 ms) against 0.48 T.  ~64 rows make each weight byte worth ~128
// operations, too many for dp4a (the ring kernels' design, ~15x below the
// tensor-core rate), so the products run on the tensor cores as
// mma.sync.m16n8k32 s8 -> s32 (exact whatever the order).
//
// Design.  A block owns (work item, column tile).  The work items are each
// group's m-tiles of 64 sorted rows, aligned to the group's first row, so a
// group of up to 64 rows reads its weights once; the block finds its group by a
// binary search over the device prefix sum of tiles per group (no host sync).
// The grid is sized for the worst case, cdiv(S, 64) + G + 1 items; the items
// past the last tile zero the rows past the groups' total (the requant pass
// does it in the dequant_swiglu_quant mode).  A column tile is 128 columns:
// 128 consecutive ones ("dequant", "none"), or 64 gate columns and the 64
// matching up columns (the SwiGLU modes: in a packing of width tn, output
// column j pairs gate column (j / (tn/2)) tn + j % (tn/2) with the up column
// tn/2 further, gmm_tile.cuh gate_col), so that SwiGLU pairs within a thread.
// With dispatch_p a prologue finds each row's token from its row of P (the
// column of its nonzero; none: a zero row), and the tile loads x[token]: the
// same rows as P @ x for a one-hot or zero P, without the product.  The
// prologue counts the rows of any other P (more than one nonzero, or a value
// other than 1), and the wrapper refuses such a P.
// Per stage of 128 bytes of K the 256 threads stage the x tile (64 rows, k
// contiguous: A fragments by ldmatrix) and the weight tile in shared memory.
// The weights are [G, K, N] with N contiguous (the layout the ring GEMMs read:
// no transposed copy), and the mma's B operand wants 4 consecutive k bytes of
// one column in a register, so a thread loads 4 k-rows x 4 columns, transposes
// the bytes in registers (__byte_perm) and stores the 4 words with one
// conflict-free 16-byte store.  The next stage's global loads are in flight in
// registers while the current stage computes (3 blocks an SM).  8 warps, each
// 32 rows x 32 columns (2 x 4 mma tiles).  Epilogues keep JAX's order: the
// int32 sum (exact; JAX sums k-tile partials in f32) to f32, x scale_x[row], x
// scale_w[g, col], then SwiGLU in f32 and the output cast; or, requantized,
// the activation to an f32 scratch and its |max| to a per-row atomicMax on
// the float bits (non-negative floats order as unsigned ints: exact and
// deterministic), and a second pass requantizes each row (gmm_common.cuh, the
// ring GEMM1's pass).  A block never reads or writes rows of its tile outside
// its group.  The tile itself is in gmm_tile.cuh, shared with the fused MoE
// (K16b, fused_full.cu) and the fused dispatch + GEMM1 (K16a,
// fused_kernel.cu).
#include "gmm_tile.cuh"

namespace k8 {

// Items past the last tile: zero rows [total, S) of the output columns [c0,
// c0 + width) (n_out columns a row), the pad items striding over them.
template <class OutT>
__device__ void zero_tail(OutT* __restrict__ out, int total, int S, int n_out, int c0,
                          int width, int pad, int n_pad) {
  for (int r = total + pad * BM; r < S; r += n_pad * BM)
    for (int e = threadIdx.x; e < BM * width / 2; e += THREADS) {
      const int row = r + e / (width / 2), col = c0 + 2 * (e % (width / 2));
      if (row < S && col < n_out) store_pair(out, (size_t)row * n_out + col, 0.f, 0.f);
    }
}

// x [S, K] int8 rows grouped by expert (row r reads x[xrow[r]] where xrow is
// given), w [G, K, N] int8, offsets / tile_off [G + 1] (row offsets, prefix
// sums of ceil(size / BM)), sx [S] and sw [G, N] (null: unscaled, the "none"
// epilogue).  "dequant": out [S, N]; kSwiGLUOut: out [S, N / 2] from the
// packing of half width ht; kSwiGLU: act [S, N / 2] f32 scratch and amax [S]
// (zeroed) for the requant pass.  3 blocks an SM (80 registers, a few bytes
// of spill): the loop waits on its global loads, and a third resident block
// keeps more of them in flight (~10 % faster than 2 on the H100; PERF.md).
template <int EPI, class OutT>
__global__ void __launch_bounds__(THREADS, 3)
    gmm_kernel(const int8_t* __restrict__ x, const int* __restrict__ xrow,
               const int8_t* __restrict__ w, const int* __restrict__ offsets,
               const int* __restrict__ tile_off, int groups, int S, int K, int N, int ht,
               const float* __restrict__ sx, const float* __restrict__ sw,
               OutT* __restrict__ out, float* __restrict__ act, unsigned* __restrict__ amax) {
  __shared__ TileSmem sm;
  const int bx = blockIdx.x, item = blockIdx.y;
  const int n_items = tile_off[groups];
  const int n_out = EPI == kDequant ? N : N / 2, width = EPI == kDequant ? BN : HALF;
  if (item >= n_items) {
    if (EPI != kSwiGLU)
      zero_tail(out, min(offsets[groups], S), S, n_out, bx * width, width, item - n_items,
                gridDim.y - n_items);
    return;
  }
  const int g = find_group(tile_off, groups, item);
  const int r0 = offsets[g] + (item - tile_off[g]) * BM;
  const int r1 = min(min(r0 + BM, offsets[g + 1]), S);
  int8_tile<EPI, true>(
      sm, x, xrow, w + (size_t)g * K * N, r0, r1, K, N, ht, bx, sx,
      sw ? sw + (size_t)g * N : nullptr,
      [&](int row, int col, float v0, float v1) {
        store_pair(out, (size_t)row * n_out + col, v0, v1);
      },
      act, amax);
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

inline dim3 grid(int S, int groups, int col_tiles) {
  return dim3(col_tiles, (S + BM - 1) / BM + groups + 1);
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
// byte is worth ~33-64 operations, well below the card's ~295 a byte: the
// products run on mma.sync.m16n8k16 (bf16 in, f32 accumulate) and the design
// is the int8 modes' (above): 64-row work items aligned to each group's first
// row, the group found by a binary search, 128-column tiles, the grid sized
// for the worst case and the items past the last tile zeroing the rows past
// the groups' total.  One template flag picks the weight layout: "none" stages
// the [BK k][128 n] tile as stored and takes the B fragments by
// ldmatrix.trans, "rhs_contract_last" stages the [128 n][BK k] tile as stored
// and takes them by plain ldmatrix; neither transposes the weights in memory.
// Each stage is 64 k: 16-byte global loads (x rows and weight rows contiguous),
// held in registers while the current stage computes; rows strided 16 bytes
// past a multiple of 128 keep ldmatrix free of bank conflicts.  8 warps, each
// 32 rows x 32 columns (2 x 4 mma tiles).
constexpr int FBK = 64;                         // k elements per stage
constexpr int FLDA = FBK + 8;                   // x tile row stride (elements)
constexpr int FLDB_N = BN + 8;                  // [k][n] weight tile row stride
constexpr int FLDB_K = FBK + 8;                 // [n][k] weight tile row stride
constexpr int F_A_LOADS = BM * FBK / 8 / THREADS;  // 16-byte x loads a thread per stage
constexpr int F_B_LOADS = FBK * BN / 8 / THREADS;  // 16-byte weight loads a thread per stage

// x [S, K] bf16 rows grouped by expert (row r reads x[xrow[r]] where xrow is
// given), w [G, K, N] (or [G, N, K] with CL) bf16, offsets / tile_off [G + 1]
// as above -> out [S, N] f32, bf16 or f16.
template <bool CL, class OutT>
__global__ void __launch_bounds__(THREADS, 2)
    gmm_bf16_kernel(const bf16* __restrict__ x, const int* __restrict__ xrow,
                    const bf16* __restrict__ w, const int* __restrict__ offsets,
                    const int* __restrict__ tile_off, int groups, int S, int K, int N,
                    OutT* __restrict__ out) {
  __shared__ __align__(16) bf16 as[BM * FLDA];
  __shared__ __align__(16) bf16 bs[CL ? BN * FLDB_K : FBK * FLDB_N];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int bx = blockIdx.x, item = blockIdx.y;
  const int n_items = tile_off[groups];
  if (item >= n_items) {
    zero_tail(out, min(offsets[groups], S), S, N, bx * BN, BN, item - n_items,
              gridDim.y - n_items);
    return;
  }
  const int g = find_group(tile_off, groups, item);
  const int r0 = offsets[g] + (item - tile_off[g]) * BM;
  const int r1 = min(min(r0 + BM, offsets[g + 1]), S);
  const bf16* wg = w + (size_t)g * K * N;
  const int n0 = bx * BN;

  const bf16* xsrc[F_A_LOADS];                   // the x rows this thread stages
#pragma unroll
  for (int i = 0; i < F_A_LOADS; ++i) {
    const int row = r0 + (tid + i * THREADS) / (FBK / 8);
    const int src = row < r1 ? (xrow ? xrow[row] : row) : -1;
    xsrc[i] = src >= 0 ? x + (size_t)src * K : nullptr;
  }
  uint4 xa[F_A_LOADS], wb[F_B_LOADS];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int i = 0; i < F_A_LOADS; ++i) {
      const int kk = k0 + 8 * ((tid + i * THREADS) % (FBK / 8));
      xa[i] = (xsrc[i] != nullptr && kk < K) ? __ldg(reinterpret_cast<const uint4*>(xsrc[i] + kk))
                                             : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < F_B_LOADS; ++i) {
      const int c = tid + i * THREADS;
      // K % 8 == 0 and N % 8 == 0: 8 consecutive elements are all in or all out
      const int nn = CL ? n0 + c / (FBK / 8) : n0 + 8 * (c % (BN / 8));
      const int kk = CL ? k0 + 8 * (c % (FBK / 8)) : k0 + c / (BN / 8);
      const bf16* src = CL ? wg + (size_t)nn * K + kk : wg + (size_t)kk * N + nn;
      wb[i] = (nn < N && kk < K) ? __ldg(reinterpret_cast<const uint4*>(src))
                                 : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][nj][r] = 0.f;

  load_stage(0);
  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int i = 0; i < F_A_LOADS; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(as + (c / (FBK / 8)) * FLDA + 8 * (c % (FBK / 8))) = xa[i];
    }
#pragma unroll
    for (int i = 0; i < F_B_LOADS; ++i) {
      const int c = tid + i * THREADS;
      bf16* dst = CL ? bs + (c / (FBK / 8)) * FLDB_K + 8 * (c % (FBK / 8))
                     : bs + (c / (BN / 8)) * FLDB_N + 8 * (c % (BN / 8));
      *reinterpret_cast<uint4*>(dst) = wb[i];
    }
    __syncthreads();
    if (k0 + FBK < K) load_stage(k0 + FBK);

    const int steps = min(FBK, K - k0 + 15) / 16;   // zero-filled k past K adds nothing
#pragma unroll
    for (int s = 0; s < FBK / 16; ++s) {
      if (s >= steps) break;
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        sgl::ldsm_x4(a[mi], as + (32 * wm + 16 * mi + (lane & 15)) * FLDA + 16 * s + 8 * (lane >> 4));
#pragma unroll
      for (int p = 0; p < 2; ++p) {             // n8 tiles 2p and 2p + 1 of the warp's 4
        const int nc = 32 * wn + 16 * p;
        uint32_t r[4];
        if (CL)
          sgl::ldsm_x4(r, bs + (nc + (lane & 7) + 8 * (lane >> 4)) * FLDB_K + 16 * s
                              + 8 * ((lane >> 3) & 1));
        else
          sgl::ldsm_x4_trans(r, bs + (16 * s + (lane & 15)) * FLDB_N + nc + 8 * (lane >> 4));
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) sgl::mma_16816(acc[mi][nj], a[mi], b[nj]);
    }
    __syncthreads();
  }

  // C fragment: rows g8 / g8 + 8 of each m16 tile, columns 2 tq, 2 tq + 1
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 32 * wm + 16 * mi + g8 + 8 * h;
      if (row >= r1) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = n0 + 32 * wn + 8 * nj + 2 * tq;
        if (col < N) store_pair(out, (size_t)row * N + col, acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
    }
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
// Design: two passes.  (1) K8a's "dequant" tile writes d in bf16 (the
// rounding JAX applies before its combine products) to a scratch [S, N]
// (59 MB at 512 tokens: ~35 us of traffic against the weights' 1.12 ms).
// (2) A bf16 GEMM of the two masks against d: a block owns 64 tokens x 128
// columns and walks every row of d below the total in order, 64 rows a stage,
// hi then lo products into one f32 accumulator on mma.sync.m16n8k16 (the
// products of two bf16 values are exact in f32; only the order of the sums
// differs from the TPU's).  Each output value has one owner and a fixed
// order: no atomics, the result does not depend on block order.  The masks
// are staged element by element (any S); d's rows by 16-byte loads.
// ---------------------------------------------------------------------------
constexpr int CLDA = FBK + 8;                   // mask tile row stride (elements)

template <class OutT>
__global__ void __launch_bounds__(THREADS, 2)
    combine_kernel(const bf16* __restrict__ mhi, const bf16* __restrict__ mlo,
                   const bf16* __restrict__ d, const int* __restrict__ offsets, int groups,
                   int n_tok, int S, int N, OutT* __restrict__ out) {
  __shared__ __align__(16) bf16 ahi[BM * CLDA];
  __shared__ __align__(16) bf16 alo[BM * CLDA];
  __shared__ __align__(16) bf16 bs[FBK * FLDB_N];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int n0 = blockIdx.x * BN, t0 = blockIdx.y * BM;
  const int total = min(offsets[groups], S);
  const bf16 zero = __float2bfloat16_rn(0.f);

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][nj][r] = 0.f;

  for (int k0 = 0; k0 < total; k0 += FBK) {
    for (int e = tid; e < BM * FBK; e += THREADS) {
      const int t = t0 + e / FBK, k = k0 + e % FBK;
      const bool in = t < n_tok && k < total;
      const size_t at = (size_t)t * S + k;
      ahi[(e / FBK) * CLDA + e % FBK] = in ? mhi[at] : zero;
      alo[(e / FBK) * CLDA + e % FBK] = in ? mlo[at] : zero;
    }
#pragma unroll
    for (int i = 0; i < F_B_LOADS; ++i) {
      const int c = tid + i * THREADS;
      const int kk = k0 + c / (BN / 8), nn = n0 + 8 * (c % (BN / 8));
      *reinterpret_cast<uint4*>(bs + (c / (BN / 8)) * FLDB_N + 8 * (c % (BN / 8))) =
          (kk < total && nn < N) ? __ldg(reinterpret_cast<const uint4*>(d + (size_t)kk * N + nn))
                                 : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    const int steps = min(FBK, total - k0 + 15) / 16;
#pragma unroll
    for (int s = 0; s < FBK / 16; ++s) {
      if (s >= steps) break;
      uint32_t b[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        sgl::ldsm_x4_trans(r, bs + (16 * s + (lane & 15)) * FLDB_N + 32 * wn + 16 * p
                                  + 8 * (lane >> 4));
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int part = 0; part < 2; ++part) {    // the hi products, then the lo ones
        const bf16* as = part ? alo : ahi;
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          sgl::ldsm_x4(a[mi], as + (32 * wm + 16 * mi + (lane & 15)) * CLDA + 16 * s
                                  + 8 * (lane >> 4));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) sgl::mma_16816(acc[mi][nj], a[mi], b[nj]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + 32 * wm + 16 * mi + g8 + 8 * h;
      if (t >= n_tok) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = n0 + 32 * wn + 8 * nj + 2 * tq;
        if (col < N) store_pair(out, (size_t)t * N + col, acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
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

template <int EPI, class OutT>
void launch_int8(dim3 grid, cudaStream_t s, const void* x, const int* xrow, const void* w,
                 const void* offsets, const void* tile_off, int groups, int S, int K, int N,
                 int ht, const void* sx, const void* sw, void* out, void* act, void* amax) {
  k8::gmm_kernel<EPI, OutT><<<grid, k8::THREADS, 0, s>>>(
      (const int8_t*)x, xrow, (const int8_t*)w, (const int*)offsets, (const int*)tile_off,
      groups, S, K, N, ht, (const float*)sx, (const float*)sw, (OutT*)out, (float*)act,
      (unsigned*)amax);
}

// The "dequant" / "none" and "dequant_swiglu" launches by output type.
template <int EPI>
int launch_int8_out(int out_kind, dim3 grid, cudaStream_t s, const void* x, const int* xrow,
                    const void* w, const void* offsets, const void* tile_off, int groups, int S,
                    int K, int N, int ht, const void* sx, const void* sw, void* out) {
  if (out_kind == kF32)
    launch_int8<EPI, float>(grid, s, x, xrow, w, offsets, tile_off, groups, S, K, N, ht, sx, sw,
                            out, nullptr, nullptr);
  else if (out_kind == kBF16)
    launch_int8<EPI, __nv_bfloat16>(grid, s, x, xrow, w, offsets, tile_off, groups, S, K, N, ht,
                                    sx, sw, out, nullptr, nullptr);
  else if (out_kind == kF16)
    launch_int8<EPI, __half>(grid, s, x, xrow, w, offsets, tile_off, groups, S, K, N, ht, sx,
                             sw, out, nullptr, nullptr);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <bool CL, class OutT>
void launch_bf16(dim3 grid, cudaStream_t s, const void* x, const int* xrow, const void* w,
                 const void* offsets, const void* tile_off, int groups, int S, int K, int N,
                 void* out) {
  k8::gmm_bf16_kernel<CL, OutT><<<grid, k8::THREADS, 0, s>>>(
      (const __nv_bfloat16*)x, xrow, (const __nv_bfloat16*)w, (const int*)offsets,
      (const int*)tile_off, groups, S, K, N, (OutT*)out);
}

template <bool CL>
int launch_bf16_out(int out_kind, dim3 grid, cudaStream_t s, const void* x, const int* xrow,
                    const void* w, const void* offsets, const void* tile_off, int groups, int S,
                    int K, int N, void* out) {
  if (out_kind == kF32)
    launch_bf16<CL, float>(grid, s, x, xrow, w, offsets, tile_off, groups, S, K, N, out);
  else if (out_kind == kBF16)
    launch_bf16<CL, __nv_bfloat16>(grid, s, x, xrow, w, offsets, tile_off, groups, S, K, N, out);
  else if (out_kind == kF16)
    launch_bf16<CL, __half>(grid, s, x, xrow, w, offsets, tile_off, groups, S, K, N, out);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// K8a's int8 modes.  x [S, K] int8 (with p: the unsorted tokens [n_tok, K],
// p [S, n_tok] one-hot of kind p_kind, xrow [S] int32 scratch, bad [1] int32
// out: P's rows that are neither one-hot nor zero), w [G, K, N]
// int8, offsets / tile_off [G + 1] int32 (row offsets; prefix sums of
// ceil(group size / 64)), sx [S] and sw [G, N] f32 (both null: "none").
// epi 0 ("dequant" / "none"): out [S, N] of out_kind (0 f32, 1 bf16, 2 f16);
// epi 2 ("dequant_swiglu"): out [S, N / 2] of out_kind from the packing of
// half width ht; epi 1 ("dequant_swiglu_quant", ht = N / 2): scratch act [S, N
// / 2] f32 and amax [S] u32, out h1 [S, N / 2] int8 and hs [S] f32.  Needs K %
// 16 == 0 and N % 16 == 0; the SwiGLU modes ht % 16 == 0 and N % (2 ht) == 0.
extern "C" int grouped_matmul_int8_launch(const void* x, const void* w, const void* offsets,
                                          const void* tile_off, int groups, int S, int K, int N,
                                          int ht, int epi, int out_kind, const void* sx,
                                          const void* sw, const void* p, int n_tok, int p_kind,
                                          void* xrow, void* bad, void* out, void* act, void* amax,
                                          void* hs, void* stream) {
  if (S == 0 || N == 0) return 0;
  const bool swiglu = epi != 0;
  if (epi < 0 || epi > 2 || K % 16 != 0 || N % 16 != 0 ||
      (swiglu && (ht % 16 != 0 || N % (2 * ht) != 0)) || (epi == 1 && 2 * ht != N))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (p != nullptr) {
    const int rc = dispatch_rows(p, p_kind, S, n_tok, (int*)xrow, (int*)bad, s);
    if (rc != 0) return rc;
  }
  const int* xr = p != nullptr ? (const int*)xrow : nullptr;
  const int cols = swiglu ? (N / 2 + k8::HALF - 1) / k8::HALF : (N + k8::BN - 1) / k8::BN;
  const dim3 grid = k8::grid(S, groups, cols);
  int rc = 0;
  if (epi == 0) {
    rc = launch_int8_out<k8::kDequant>(out_kind, grid, s, x, xr, w, offsets, tile_off, groups, S,
                                       K, N, ht, sx, sw, out);
  } else if (epi == 2) {
    rc = launch_int8_out<k8::kSwiGLUOut>(out_kind, grid, s, x, xr, w, offsets, tile_off, groups,
                                         S, K, N, ht, sx, sw, out);
  } else {
    cudaMemsetAsync(amax, 0, sizeof(unsigned) * (size_t)S, s);
    launch_int8<k8::kSwiGLU, float>(grid, s, x, xr, w, offsets, tile_off, groups, S, K, N, ht,
                                    sx, sw, nullptr, act, amax);
    gmm::swiglu_requant_kernel<<<S, 256, 0, s>>>((const float*)act, (const unsigned*)amax,
                                                  (const int*)offsets, groups, N / 2,
                                                  (int8_t*)out, (float*)hs);
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// K8a's bf16 modes.  x [S, K] bf16 (with p: [n_tok, K], p, xrow and bad as above),
// w [G, K, N] bf16 (contract_last: [G, N, K]), offsets / tile_off as above ->
// out [S, N] of out_kind, rows past the groups' total zero.  Needs K % 8 == 0
// and N % 8 == 0.
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
  const dim3 grid = k8::grid(S, groups, (N + k8::BN - 1) / k8::BN);
  const int rc = contract_last
                     ? launch_bf16_out<true>(out_kind, grid, s, x, xr, w, offsets, tile_off,
                                             groups, S, K, N, out)
                     : launch_bf16_out<false>(out_kind, grid, s, x, xr, w, offsets, tile_off,
                                              groups, S, K, N, out);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// K8b.  x [S, K] int8 (GMM1 output), w [G, K, N] int8, offsets / tile_off as
// above, sx [S] f32, sw [G, N] f32, m_hi / m_lo [n_tok, S] bf16; scratch d [S,
// N] bf16 -> out [n_tok, N] of out_kind.  Needs K % 16 == 0 and N % 16 == 0.
extern "C" int grouped_matmul_combine_launch(const void* x, const void* w, const void* offsets,
                                             const void* tile_off, int groups, int S, int K,
                                             int N, const void* sx, const void* sw,
                                             const void* mhi, const void* mlo, int n_tok,
                                             int out_kind, void* d, void* out, void* stream) {
  if (n_tok == 0 || N == 0) return 0;
  if (K % 16 != 0 || N % 16 != 0 || out_kind < kF32 || out_kind > kF16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (S > 0)
    launch_int8<k8::kDequant, __nv_bfloat16>(k8::grid(S, groups, (N + k8::BN - 1) / k8::BN), s,
                                             x, nullptr, w, offsets, tile_off, groups, S, K, N,
                                             N / 2, sx, sw, d, nullptr, nullptr);
  const dim3 grid((N + k8::BN - 1) / k8::BN, (n_tok + k8::BM - 1) / k8::BM);
  const auto* hi = (const __nv_bfloat16*)mhi;
  const auto* lo = (const __nv_bfloat16*)mlo;
  const auto* dd = (const __nv_bfloat16*)d;
  const int* off = (const int*)offsets;
  if (out_kind == kF32)
    k8::combine_kernel<<<grid, k8::THREADS, 0, s>>>(hi, lo, dd, off, groups, n_tok, S, N,
                                                    (float*)out);
  else if (out_kind == kBF16)
    k8::combine_kernel<<<grid, k8::THREADS, 0, s>>>(hi, lo, dd, off, groups, n_tok, S, N,
                                                    (__nv_bfloat16*)out);
  else
    k8::combine_kernel<<<grid, k8::THREADS, 0, s>>>(hi, lo, dd, off, groups, n_tok, S, N,
                                                    (__half*)out);
  return (int)cudaGetLastError();
}
