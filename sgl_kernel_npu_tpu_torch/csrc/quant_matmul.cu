// quant_matmul: the W8A8 GEMM of the fused MLA prologue and the dense W8A8
// projections, for Hopper.
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/ops/matmul.py:quant_matmul
// (_quant_matmul_kernel): out[m, n] = float(sum_k x[m, k] * w[n, k] + bias[n])
// * descale[n], int8 x [M, K], int8 w [N, K] (K contiguous), int32 bias and
// f32 descale per output channel, f32 or bf16 out.  The TPU kernel tiles
// (M, N, K) through VMEM with a sequential K grid axis carrying an int32
// accumulator in scratch.
//
// Bound on the H100: bytes at decode (M = 1-16: every weight byte is used
// by at most 16 rows, far below the ~600 int8 operations per byte at which
// the tensor cores would limit; each call streams the N x K int8 weights,
// 15-117 MB at DeepSeek-V3 width, 4-35 us at 3.35 TB/s), operations in a
// long prefill chunk (2048 rows: wdqkv and wuq are 217 G int8 operations,
// 0.11 ms at 1,979 TOP/s).
//
// Decode design (M <= 16): read each weight byte once.  A block owns 8
// output channels and 16 warps (K of 4096 bytes or more) or 8 split its K
// range (split-K inside the block: more loads in flight than one warp
// walking all of K, and enough blocks for 132 SMs: 264 for wdqkv's 2112
// channels).  Per 64-byte step of K a lane
// loads 16 bytes of one weight row (8 rows x 64 bytes, the row-major B
// fragment of mma.sync m16n8k32 s8 read straight from HBM) and 16 bytes of
// each of two x rows (x stays in L2); 4 steps' loads are issued before their
// products.  The products run on mma.sync.m16n8k32 int8 -> int32: exact
// whatever the order.  Since the sum over k is exact in any order, the k
// slots of one mma are mapped to the lane's own 16 loaded bytes (lane t of a
// row group holds k = 16 t .. 16 t + 15 of the step; mma 1 takes bytes 0-7,
// mma 2 bytes 8-15), so A and B fragments come straight out of 16-byte loads
// with no shuffles.  The warps' int32 partial sums meet in shared memory in
// a fixed order (a row group of 8 rows skips the absent upper half of the A
// tile).
//
// Prefill design (M > 16, Hopper): a block owns 128 rows x BN channels, so
// at 2048 rows every weight byte crosses L2 16 times, and consecutive blocks
// share a weight tile (row tiles vary fastest).  Warp 8 loads a ring of
// stages of 128 bytes of K behind full / empty mbarriers: x rows as TMA
// boxes of 64 rows (the second only where the tile has more than 64 rows)
// and the weight tile as one box of BN rows, both K-major in the 128-byte
// swizzle that 8-bit wgmma requires (x [M, K] and w [N, K] are K-contiguous
// as they lie); rows, channels and k past the edges read as zeros.
// Warpgroups 0 and 1 each take 64 rows on wgmma m64nBNk32 s8 -> s32 (one
// stage's products in flight while the next stage's are issued).  Tiles
// (picked by their time on the H100 among widths of 64, 128 and 256
// channels, 3 to 12 stages and split-K across blocks): up to 64 rows 64
// channels, one block an SM with 8 stages in flight (wo at a 64-row chunk is
// a stream of its 117 MB of weights over 112 blocks); above, 128 channels and
// 3 stages where that gives the card's 2 x 132 block slots their work (wdqkv
// and wuq at 2048 rows), else 64 and 4 stages, two blocks an SM.  The
// epilogue stores pairs of channels.
//
// Both keep the TPU kernel's epilogue order: acc + bias in int32, then f32,
// then x descale (round to nearest), then the cast to the output type.
// Rows past M and channels past N store nothing.
#include "common.cuh"
#include "wgmma.cuh"

namespace qmm {

constexpr int KSTEP = 64;                // bytes of K per warp step (4 lanes x 16 B per row)
constexpr int DEPTH = 4;                 // steps whose loads are in flight before their products

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 load16(const int8_t* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void store_out(float* out, size_t i, float v) { out[i] = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* out, size_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

// x [M, K] (M <= 16), w [N, K], bias [N] or null, descale [N], out [M, N];
// K % 16 == 0.  Grid: ceil(N / 8) blocks of 8 channels, one m16 x n8 tile.
// LOW8: M <= 8, the upper half of the A tile (rows 8-15) is known to be zero.
template <int WARPS, bool LOW8, typename OutT>
__global__ void __launch_bounds__(32 * WARPS)
    quant_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const int* __restrict__ bias, const float* __restrict__ descale,
                        int M, int N, int K, OutT* __restrict__ out) {
  __shared__ int part[WARPS][4][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group (row / column) and lane in group
  const int n0 = blockIdx.x * 8;
  const int steps = (K + KSTEP - 1) / KSTEP;
  const int per_warp = (steps + WARPS - 1) / WARPS;
  const int k_lo = min(K, warp * per_warp * KSTEP);
  const int k_hi = min(K, k_lo + per_warp * KSTEP);

  const bool w_ok = n0 + g < N;
  const int8_t* wr = w + (size_t)(w_ok ? n0 + g : 0) * K + 16 * t;
  const int8_t* xr[2];
  bool x_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 8 * h + g;
    x_ok[h] = m < M && !(LOW8 && h == 1);
    xr[h] = x + (size_t)(x_ok[h] ? m : 0) * K + 16 * t;
  }

  int acc[4] = {0, 0, 0, 0};
  for (int k = k_lo; k < k_hi; k += DEPTH * KSTEP) {
    uint4 wv[DEPTH], xv[DEPTH][2];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int kk = k + d * KSTEP;
      // K % 16 == 0: a lane's 16-byte chunk is all in or all out
      const bool k_ok = kk < k_hi && kk + 16 * t < K;
      wv[d] = load16(wr + kk, k_ok && w_ok);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xv[d][h] = (LOW8 && h == 1) ? make_uint4(0, 0, 0, 0) : load16(xr[h] + kk, k_ok && x_ok[h]);
    }
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      // A: rows g / g + 8; k slots 4t..4t+3 and 16+4t.. <- the lane's bytes 0-7, then 8-15
      const uint4 &a0 = xv[d][0], &a1 = xv[d][1], &b = wv[d];
      mma_s8(acc, a0.x, a1.x, a0.y, a1.y, b.x, b.y);
      mma_s8(acc, a0.z, a1.z, a0.w, a1.w, b.z, b.w);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) part[warp][r][lane] = acc[r];
  __syncthreads();

  // epilogue: warp w finishes fragment registers r = w, w + WARPS, ...
  for (int r = warp; r < 4; r += WARPS) {
    const int m = g + 8 * (r >> 1), n = n0 + 2 * t + (r & 1);
    if (m < M && n < N) {
      int sum = 0;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) sum += part[q][r][lane];
      if (bias) sum += bias[n];
      store_out(out, (size_t)m * N + n, __int2float_rn(sum) * descale[n]);
    }
  }
}

template <int WARPS, bool LOW8, typename OutT>
void run(const void* x, const void* w, const void* bias, const void* descale, int M, int N,
         int K, void* out, cudaStream_t s) {
  quant_matmul_kernel<WARPS, LOW8, OutT><<<(N + 7) / 8, 32 * WARPS, 0, s>>>(
      (const int8_t*)x, (const int8_t*)w, (const int*)bias, (const float*)descale, M, N, K,
      (OutT*)out);
}

// ---------------------------------------------------------------------------
// prefill rows (M > 16): wgmma s8 fed by TMA
// ---------------------------------------------------------------------------

constexpr int PM = 128;                  // rows a block: two computing warpgroups of 64
constexpr int PK = 128;                  // bytes of K a stage (a 128-byte swizzled row)
constexpr int PCONSUMERS = 256;          // warpgroups 0 and 1 compute,
constexpr int PTHREADS = PCONSUMERS + 32;   // warp 8 loads

// A stage: MROWS x rows (boxes of 64), then BN weight rows, 128 bytes each.
// Up to 64 rows (MROWS 64): 8 stages, one block an SM; above, 3 or 4 stages,
// two blocks an SM.
template <int BN, int MROWS>
struct PSmem {
  static constexpr int STAGES = MROWS == 64 ? 8 : BN == 128 ? 3 : 4;
  static constexpr int BLOCKS = MROWS == 64 ? 1 : 2;
  static constexpr uint32_t X = MROWS * PK;
  static constexpr uint32_t STAGE = X + BN * PK;
  static constexpr uint32_t BARS = STAGES * STAGE;
  static constexpr uint32_t BYTES = BARS + 2 * STAGES * 8;
};

template <int N>
struct Acc;
template <>
struct Acc<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a, uint64_t b) {
    wg::mma_s8_m64n64k32(d, a, b);
  }
};
template <>
struct Acc<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b) {
    wg::mma_s8_m64n128k32(d, a, b);
  }
};

__device__ __forceinline__ void store_pair(float* out, size_t i, float a, float b) {
  *reinterpret_cast<float2*>(out + i) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* out, size_t i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(a, b);
}

// xmap: x [M, K] as (K, M), boxes of 128 k x 64 rows; wmap: w [N, K] as (K,
// N), boxes of 128 k x BN channels.  Grid: (ceil(M / 128), ceil(N / BN)).
template <int BN, int MROWS, typename OutT>
__global__ void __launch_bounds__(PTHREADS, PSmem<BN, MROWS>::BLOCKS)
    prefill_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, const int* __restrict__ bias,
                   const float* __restrict__ descale, int M, int N, int K,
                   OutT* __restrict__ out) {
  using L = PSmem<BN, MROWS>;
  constexpr int S = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * PM, n0 = blockIdx.y * BN;
  const int active = M - m0 > 64 ? 2 : 1;   // computing warpgroups with live rows
  const int nk = (K + PK - 1) / PK;
  if (tid == 0)
    for (int i = 0; i < S; ++i) {
      wg::mbar_init(&full[i], 1);
      wg::mbar_init(&empty[i], 4 * active);   // each computing warp once
    }
  __syncthreads();

  if (warp == PCONSUMERS / 32) {   // the loading warp: one lane issues the boxes
    if (lane == 0)
      for (int it = 0; it < nk; ++it) {
        const int st = it % S;
        if (it >= S) wg::mbar_wait(&empty[st], (it / S - 1) & 1);
        unsigned char* stage = smem + st * L::STAGE;
        wg::mbar_expect_tx(&full[st], active * 64 * PK + BN * PK);
        for (int h = 0; h < active; ++h)
          wg::tma_load_2d(stage + h * 64 * PK, &xmap, it * PK, m0 + 64 * h, &full[st]);
        wg::tma_load_2d(stage + L::X, &wmap, it * PK, n0, &full[st]);
        wg::mbar_arrive(&full[st]);
      }
    return;
  }

  const int wgi = tid >> 7;
  if (wgi >= active) return;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int it = 0; it < nk; ++it) {
    const int st = it % S;
    const unsigned char* stage = smem + st * L::STAGE;
    wg::mbar_wait(&full[st], (it / S) & 1);
    wg::fence_operands(acc);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < PK / 32; ++ks)
      Acc<BN>::mma(acc, wg::desc_sw128(stage + wgi * 64 * PK + ks * 32, 16, 1024),
                   wg::desc_sw128(stage + L::X + ks * 32, 16, 1024));
    wg::commit();
    wg::wait_one();                            // the previous stage's products are done
    wg::fence_operands(acc);
    __syncwarp();
    if (it > 0 && lane == 0) wg::mbar_arrive(&empty[(it - 1) % S]);
  }
  wg::wait_all();
  wg::fence_operands(acc);

  // acc[4 i + 2 h + e]: row 16 (warp % 4) + lane / 4 + 8 h of the warpgroup's
  // 64, channel 8 i + 2 (lane % 4) + e of the tile; pairs of channels stored
  // together where N is even (both in or both out)
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int n = n0 + 8 * i + 2 * t4;
    if (n >= N) continue;
    const bool two = n + 1 < N;
    const float ds0 = descale[n], ds1 = two ? descale[n + 1] : 0.f;
    const int b0 = bias ? bias[n] : 0, b1 = bias && two ? bias[n + 1] : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wgi + 16 * (warp & 3) + g + 8 * h;
      if (m >= M) continue;
      const float v0 = __int2float_rn(acc[4 * i + 2 * h] + b0) * ds0;
      const float v1 = __int2float_rn(acc[4 * i + 2 * h + 1] + b1) * ds1;
      if (pairs) {
        store_pair(out, (size_t)m * N + n, v0, v1);
      } else {
        store_out(out, (size_t)m * N + n, v0);
        if (two) store_out(out, (size_t)m * N + n + 1, v1);
      }
    }
  }
}

template <int BN, int MROWS, typename OutT>
int run_prefill(const void* x, const void* w, const void* bias, const void* descale, int M,
                int N, int K, void* out, cudaStream_t s) {
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)M}, wdims[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t stride[1] = {(uint64_t)K};
  const uint32_t xbox[2] = {PK, 64}, wbox[2] = {PK, BN};
  int rc = wg::tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, xdims, stride, xbox);
  if (rc == 0) rc = wg::tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims, stride, wbox);
  if (rc != 0) return rc;
  constexpr int smem = (int)PSmem<BN, MROWS>::BYTES;
  auto kernel = prefill_kernel<BN, MROWS, OutT>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  const dim3 grid((M + PM - 1) / PM, (N + BN - 1) / BN);
  kernel<<<grid, PTHREADS, smem, s>>>(xmap, wmap, (const int*)bias, (const float*)descale, M, N,
                                      K, (OutT*)out);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(const void* x, const void* w, const void* bias, const void* descale, int M, int N,
           int K, void* out, cudaStream_t s) {
  if (M <= 16) {
    // 16 warps split a long K (wdqkv, wo, the shared gate || up), 8 a short one
    const bool deep = K >= 4096;
    if (M <= 8 && deep) run<16, true, OutT>(x, w, bias, descale, M, N, K, out, s);
    else if (M <= 8) run<8, true, OutT>(x, w, bias, descale, M, N, K, out, s);
    else if (deep) run<16, false, OutT>(x, w, bias, descale, M, N, K, out, s);
    else run<8, false, OutT>(x, w, bias, descale, M, N, K, out, s);
  } else if (M <= 64) {
    return run_prefill<64, 64, OutT>(x, w, bias, descale, M, N, K, out, s);
  } else {
    // 128-wide tiles where they give two blocks an SM their work, else 64
    const int tiles = (M + PM - 1) / PM * ((N + 127) / 128);
    return tiles >= 2 * 132 ? run_prefill<128, 128, OutT>(x, w, bias, descale, M, N, K, out, s)
                            : run_prefill<64, 128, OutT>(x, w, bias, descale, M, N, K, out, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace qmm

// x [M, K] int8, w [N, K] int8, bias [N] int32 or null, descale [N] f32;
// out [M, N] f32 (out_bf16 = 0) or bf16 (out_bf16 = 1).  Needs K % 16 == 0
// and 16-byte aligned x and w (TMA's row strides and base).
extern "C" int quant_matmul_launch(const void* x, const void* w, const void* bias,
                                   const void* descale, int M, int N, int K, int out_bf16,
                                   void* out, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return out_bf16 ? qmm::launch<__nv_bfloat16>(x, w, bias, descale, M, N, K, out, s)
                  : qmm::launch<float>(x, w, bias, descale, M, N, K, out, s);
}
