// grouped_matmul (K8a): the ragged grouped GEMM of the MoE, for Hopper: W8A8
// with a fused epilogue (the MoE above 512 tokens), and bf16 -> f32 (the
// expert-parallel MoE and its training; the second half of this file).
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/grouped_matmul.py:
// grouped_matmul (_gmm_kernel) in its int8 modes: epilogue "dequant" (out =
// acc x scale_x[row] x scale_w[g, col], cast to bf16) and
// "dequant_swiglu_quant" (SwiGLU on the full-width gate || up packing, then a
// per-row int8 requant).  The TPU kernel walks a scalar-prefetched
// (group, m-tile) schedule on a sequential grid and adds each k-tile's int32
// partial into an f32 accumulator.
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
// The grid is sized for the worst case, cdiv(S, 64) + G + 1 items; in "dequant"
// mode the items past the last tile zero the rows past the groups' total (the
// requant pass does it in the other mode).  A column tile is 128 columns: 128
// consecutive ones ("dequant"), or 64 gate columns and the 64 matching up
// columns (gate j at j, up j at I + j), so that SwiGLU pairs within a thread.
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
// scale_w[g, col], then the output cast; or SwiGLU in f32 with the activation
// to an f32 scratch and its |max| to a per-row atomicMax on the float bits
// (non-negative floats order as unsigned ints: exact and deterministic), and a
// second pass requantizes each row (gmm_common.cuh, the ring GEMM1's pass).  A
// block never reads or writes rows of its tile outside its group.  The tile
// itself is in gmm_tile.cuh, shared with the fused MoE (K16b, fused_full.cu).
#include "gmm_tile.cuh"

namespace k8 {

// Items past the last tile ("dequant"): zero rows [total, S) of this column
// tile, the pad items striding over them.
__device__ void zero_tail(bf16* __restrict__ out, int total, int S, int N, int bx, int pad,
                          int n_pad) {
  for (int r = total + pad * BM; r < S; r += n_pad * BM)
    for (int e = threadIdx.x; e < BM * BN / 2; e += THREADS) {
      const int row = r + e / (BN / 2), col = global_col<kDequant>(bx, 2 * (e % (BN / 2)), N);
      if (row < S && col >= 0) store_pair(out, (size_t)row * N + col, 0.f, 0.f);
    }
}

// x [S, K] int8 rows grouped by expert, w [G, K, N] int8, offsets / tile_off
// [G + 1] (row offsets, prefix sums of ceil(size / BM)), sx [S], sw [G, N].
// "dequant": out [S, N]; SwiGLU: act [S, N / 2] f32 scratch and amax [S]
// (zeroed) for the requant pass.  3 blocks an SM (80 registers, a few bytes
// of spill): the loop waits on its global loads, and a third resident block
// keeps more of them in flight (~10 % faster than 2 on the H100; PERF.md).
template <int EPI>
__global__ void __launch_bounds__(THREADS, 3)
    gmm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const int* __restrict__ offsets, const int* __restrict__ tile_off, int groups,
               int S, int K, int N, const float* __restrict__ sx,
               const float* __restrict__ sw, bf16* __restrict__ out, float* __restrict__ act,
               unsigned* __restrict__ amax) {
  __shared__ TileSmem sm;
  const int bx = blockIdx.x, item = blockIdx.y;
  const int n_items = tile_off[groups];
  if (item >= n_items) {
    if (EPI == kDequant)
      zero_tail(out, min(offsets[groups], S), S, N, bx, item - n_items, gridDim.y - n_items);
    return;
  }
  const int g = find_group(tile_off, groups, item);
  const int r0 = offsets[g] + (item - tile_off[g]) * BM;
  const int r1 = min(min(r0 + BM, offsets[g + 1]), S);
  int8_tile<EPI, true>(
      sm, x, w + (size_t)g * K * N, r0, r1, K, N, bx, sx, sw + (size_t)g * N,
      [&](int row, int col, float v0, float v1) {
        store_pair(out, (size_t)row * N + col, v0, v1);
      },
      act, amax);
}

inline dim3 grid(int S, int groups, int col_tiles) {
  return dim3(col_tiles, (S + BM - 1) / BM + groups + 1);
}

// ---------------------------------------------------------------------------
// bf16 rows x bf16 weights -> f32: K8a's "none" mode (out[i] = x[i] @ w[g(i)],
// w [G, K, N] with N contiguous) and its "rhs_contract_last" mode (out[i] =
// x[i] @ w[g(i)]^T, w [G, N, K] with K contiguous: the dx of gmm_train).  The
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

// Items past the last tile: zero rows [total, S) of this column tile (f32).
__device__ void zero_tail_f32(float* __restrict__ out, int total, int S, int N, int bx, int pad,
                              int n_pad) {
  for (int r = total + pad * BM; r < S; r += n_pad * BM)
    for (int e = threadIdx.x; e < BM * BN / 4; e += THREADS) {
      const int row = r + e / (BN / 4), col = bx * BN + 4 * (e % (BN / 4));
      if (row < S && col < N)
        *reinterpret_cast<float4*>(out + (size_t)row * N + col) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// x [S, K] bf16 rows grouped by expert, w [G, K, N] (or [G, N, K] with CL)
// bf16, offsets / tile_off [G + 1] as above -> out [S, N] f32.
template <bool CL>
__global__ void __launch_bounds__(THREADS, 2)
    gmm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const int* __restrict__ offsets, const int* __restrict__ tile_off,
                    int groups, int S, int K, int N, float* __restrict__ out) {
  __shared__ __align__(16) bf16 as[BM * FLDA];
  __shared__ __align__(16) bf16 bs[CL ? BN * FLDB_K : FBK * FLDB_N];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int bx = blockIdx.x, item = blockIdx.y;
  const int n_items = tile_off[groups];
  if (item >= n_items) {
    zero_tail_f32(out, min(offsets[groups], S), S, N, bx, item - n_items, gridDim.y - n_items);
    return;
  }
  const int g = find_group(tile_off, groups, item);
  const int r0 = offsets[g] + (item - tile_off[g]) * BM;
  const int r1 = min(min(r0 + BM, offsets[g + 1]), S);
  const bf16* wg = w + (size_t)g * K * N;
  const int n0 = bx * BN;

  uint4 xa[F_A_LOADS], wb[F_B_LOADS];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int i = 0; i < F_A_LOADS; ++i) {
      const int c = tid + i * THREADS, row = r0 + c / (FBK / 8), kk = k0 + 8 * (c % (FBK / 8));
      xa[i] = (row < r1 && kk < K) ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * K + kk))
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

}  // namespace k8

// x [S, K] int8, w [G, K, N] int8, offsets / tile_off [G + 1] int32 (row
// offsets; prefix sums of ceil(group size / 64)), sx [S] f32, sw [G, N] f32 ->
// out [S, N] bf16.  Needs K % 16 == 0, N % 16 == 0.
extern "C" int grouped_matmul_dequant_launch(const void* x, const void* w, const void* offsets,
                                             const void* tile_off, int groups, int S, int K,
                                             int N, const void* sx, const void* sw, void* out,
                                             void* stream) {
  if (S == 0 || N == 0) return 0;
  if (K % 16 != 0 || N % 16 != 0) return (int)cudaErrorInvalidValue;
  k8::gmm_kernel<k8::kDequant>
      <<<k8::grid(S, groups, (N + k8::BN - 1) / k8::BN), k8::THREADS, 0, (cudaStream_t)stream>>>(
          (const int8_t*)x, (const int8_t*)w, (const int*)offsets, (const int*)tile_off, groups,
          S, K, N, (const float*)sx, (const float*)sw, (__nv_bfloat16*)out, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// As above with N = 2I (gate || up at full width); scratch act [S, I] f32 and
// amax [S] u32; out h1 [S, I] int8 and hs [S] f32.  Needs K % 16 == 0 and
// I % 16 == 0.
extern "C" int grouped_matmul_swiglu_quant_launch(const void* x, const void* w,
                                                  const void* offsets, const void* tile_off,
                                                  int groups, int S, int K, int N,
                                                  const void* sx, const void* sw, void* act,
                                                  void* amax, void* h1, void* hs,
                                                  void* stream) {
  if (S == 0 || N == 0) return 0;
  if (K % 16 != 0 || N % 32 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int I = N / 2;
  cudaMemsetAsync(amax, 0, sizeof(unsigned) * (size_t)S, s);
  k8::gmm_kernel<k8::kSwiGLU><<<k8::grid(S, groups, (I + k8::HALF - 1) / k8::HALF),
                                       k8::THREADS, 0, s>>>(
      (const int8_t*)x, (const int8_t*)w, (const int*)offsets, (const int*)tile_off, groups, S,
      K, N, (const float*)sx, (const float*)sw, nullptr, (float*)act, (unsigned*)amax);
  gmm::swiglu_requant_kernel<<<S, 256, 0, s>>>((const float*)act, (const unsigned*)amax,
                                                (const int*)offsets, groups, I, (int8_t*)h1,
                                                (float*)hs);
  return (int)cudaGetLastError();
}

// x [S, K] bf16, w [G, K, N] bf16 (contract_last: [G, N, K]), offsets /
// tile_off [G + 1] int32 (row offsets; prefix sums of ceil(group size / 64))
// -> out [S, N] f32, rows past the groups' total zero.  Needs K % 8 == 0 and
// N % 8 == 0.
extern "C" int grouped_matmul_bf16_launch(const void* x, const void* w, const void* offsets,
                                          const void* tile_off, int groups, int S, int K, int N,
                                          int contract_last, void* out, void* stream) {
  if (S == 0 || N == 0) return 0;
  if (K % 8 != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid = k8::grid(S, groups, (N + k8::BN - 1) / k8::BN);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xp = (const __nv_bfloat16*)x;
  const auto* wp = (const __nv_bfloat16*)w;
  if (contract_last)
    k8::gmm_bf16_kernel<true><<<grid, k8::THREADS, 0, s>>>(
        xp, wp, (const int*)offsets, (const int*)tile_off, groups, S, K, N, (float*)out);
  else
    k8::gmm_bf16_kernel<false><<<grid, k8::THREADS, 0, s>>>(
        xp, wp, (const int*)offsets, (const int*)tile_off, groups, S, K, N, (float*)out);
  return (int)cudaGetLastError();
}
