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
// Bound on the H100: bytes.  At the serving path's rows (M = 1-8 at decode,
// 64 in a prefill chunk) every weight byte is used by at most 64 rows, far
// below the ~1,000 int8 operations per byte at which the tensor cores would
// limit: each call is a stream of the N x K int8 weights from HBM (15-117 MB
// at DeepSeek-V3 width, 4-35 us at 3.35 TB/s).
//
// Design: read each weight byte once, whatever M is.  A block owns 8 * NT
// output channels (NT n8 tiles) and WARPS warps split its K range (split-K
// inside the block: more loads in flight than one warp walking all of K, and
// enough blocks for 132 SMs: 264 for wdqkv's 2112 channels at decode).  Per
// 64-byte step of K a lane loads 16 bytes of one weight row (8 rows x 64
// bytes per n8 tile, the row-major B fragment of mma.sync m16n8k32 s8 read
// straight from HBM) and 16 bytes of each of two x rows per m16 tile (x is
// at most 1 MB and stays in L2); DEPTH steps' loads are issued before their
// products.  The products run on the tensor cores as mma.sync.m16n8k32 int8
// -> int32: exact whatever the order.  Since the sum over k is exact in any
// order, the k slots of one mma are mapped to the lane's own 16 loaded bytes
// (lane t of a row group holds k = 16 t .. 16 t + 15 of the step; mma 1 takes
// bytes 0-7, mma 2 bytes 8-15), so A and B fragments come straight out of
// 16-byte loads with no shuffles.  The warps' int32 partial sums meet in
// shared memory in a fixed order, and the epilogue keeps the TPU kernel's
// order: acc + bias in int32, then f32, then x descale (round to nearest),
// then the cast to the output type.  Rows past M and channels past N (the
// ragged edges) read zeros and store nothing.  Configurations (picked among
// tile shapes by their time on the H100): up to 16 rows (decode) one m16 tile, 8 channels
// and 8 warps a block, 4 steps in flight (a row group of 8 rows skips the
// absent upper half of the A tile); above 16 rows, 32 channels and 4 warps a
// block, 2 steps in flight, and passes of 64 rows, each re-streaming the
// weights.  Each block of a pass still reads all of its rows of x from L2,
// which bounds the 64-row case (see PERF.md).
#include "common.cuh"

namespace qmm {

constexpr int KSTEP = 64;                // bytes of K per warp step (4 lanes x 16 B per row)
constexpr int MAX_MT = 4;                // m16 tiles per pass (64 rows)

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

// x [M, K], w [N, K], bias [N] or null, descale [N], out [M, N]; K % 16 == 0.
// Grid: (ceil(N / (8 NT)), passes of 16 MT rows).  LOW8: M <= 8, the upper
// half of the A tile (rows 8-15) is known to be zero.
template <int MT, int NT, int WARPS, int DEPTH, bool LOW8, typename OutT>
__global__ void __launch_bounds__(32 * WARPS)
    quant_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const int* __restrict__ bias, const float* __restrict__ descale,
                        int M, int N, int K, OutT* __restrict__ out) {
  __shared__ int part[WARPS][MT][NT][4][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group (row / column) and lane in group
  const int n0 = blockIdx.x * 8 * NT;
  const int m0 = blockIdx.y * 16 * MT;
  const int steps = (K + KSTEP - 1) / KSTEP;
  const int per_warp = (steps + WARPS - 1) / WARPS;
  const int k_lo = min(K, warp * per_warp * KSTEP);
  const int k_hi = min(K, k_lo + per_warp * KSTEP);

  const int8_t* wr[NT];
  bool w_ok[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + 8 * j + g;
    w_ok[j] = n < N;
    wr[j] = w + (size_t)(w_ok[j] ? n : 0) * K + 16 * t;
  }
  const int8_t* xr[MT][2];
  bool x_ok[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * i + 8 * h + g;
      x_ok[i][h] = m < M && !(LOW8 && h == 1);
      xr[i][h] = x + (size_t)(x_ok[i][h] ? m : 0) * K + 16 * t;
    }

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k = k_lo; k < k_hi; k += DEPTH * KSTEP) {
    uint4 wv[DEPTH][NT], xv[DEPTH][MT][2];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int kk = k + d * KSTEP;
      // K % 16 == 0: a lane's 16-byte chunk is all in or all out
      const bool k_ok = kk < k_hi && kk + 16 * t < K;
#pragma unroll
      for (int j = 0; j < NT; ++j) wv[d][j] = load16(wr[j] + kk, k_ok && w_ok[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          xv[d][i][h] = (LOW8 && h == 1) ? make_uint4(0, 0, 0, 0)
                                         : load16(xr[i][h] + kk, k_ok && x_ok[i][h]);
    }
#pragma unroll
    for (int d = 0; d < DEPTH; ++d)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // A: rows g / g + 8; k slots 4t..4t+3 and 16+4t.. <- the lane's bytes 0-7, then 8-15
          const uint4 &a0 = xv[d][i][0], &a1 = xv[d][i][1], &b = wv[d][j];
          mma_s8(acc[i][j], a0.x, a1.x, a0.y, a1.y, b.x, b.y);
          mma_s8(acc[i][j], a0.z, a1.z, a0.w, a1.w, b.z, b.w);
        }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[warp][i][j][r][lane] = acc[i][j][r];
  __syncthreads();

  // epilogue: warp w finishes fragment registers r = w, w + WARPS, ...
  constexpr int REGS = MT * NT * 4;
  for (int idx = warp; idx < REGS; idx += WARPS) {
    const int i = idx / (NT * 4), j = (idx / 4) % NT, r = idx % 4;
    const int m = m0 + 16 * i + g + 8 * (r >> 1);
    const int n = n0 + 8 * j + 2 * t + (r & 1);
    if (m < M && n < N) {
      int s = 0;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) s += part[q][i][j][r][lane];
      if (bias) s += bias[n];
      store_out(out, (size_t)m * N + n, __int2float_rn(s) * descale[n]);
    }
  }
}

template <int MT, int NT, int WARPS, int DEPTH, bool LOW8, typename OutT>
void run(const void* x, const void* w, const void* bias, const void* descale, int M, int N,
         int K, void* out, cudaStream_t s) {
  dim3 grid((N + 8 * NT - 1) / (8 * NT), (M + 16 * MT - 1) / (16 * MT));
  quant_matmul_kernel<MT, NT, WARPS, DEPTH, LOW8, OutT><<<grid, 32 * WARPS, 0, s>>>(
      (const int8_t*)x, (const int8_t*)w, (const int*)bias, (const float*)descale, M, N, K,
      (OutT*)out);
}

template <typename OutT>
int launch(const void* x, const void* w, const void* bias, const void* descale, int M, int N,
           int K, void* out, cudaStream_t s) {
  if (M <= 8) run<1, 1, 8, 4, true, OutT>(x, w, bias, descale, M, N, K, out, s);
  else if (M <= 16) run<1, 1, 8, 4, false, OutT>(x, w, bias, descale, M, N, K, out, s);
  else if (M <= 32) run<2, 4, 4, 2, false, OutT>(x, w, bias, descale, M, N, K, out, s);
  else if (M <= 48) run<3, 4, 4, 2, false, OutT>(x, w, bias, descale, M, N, K, out, s);
  else run<MAX_MT, 4, 4, 2, false, OutT>(x, w, bias, descale, M, N, K, out, s);
  return (int)cudaGetLastError();
}

}  // namespace qmm

// x [M, K] int8, w [N, K] int8, bias [N] int32 or null, descale [N] f32;
// out [M, N] f32 (out_bf16 = 0) or bf16 (out_bf16 = 1).  Needs K % 16 == 0
// and 16-byte aligned x and w.
extern "C" int quant_matmul_launch(const void* x, const void* w, const void* bias,
                                   const void* descale, int M, int N, int K, int out_bf16,
                                   void* out, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return out_bf16 ? qmm::launch<__nv_bfloat16>(x, w, bias, descale, M, N, K, out, s)
                  : qmm::launch<float>(x, w, bias, descale, M, N, K, out, s);
}
