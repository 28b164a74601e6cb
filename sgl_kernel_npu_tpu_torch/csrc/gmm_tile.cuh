// The W8A8 tile of the grouped expert GEMMs on mma.sync.m16n8k32 (s8 x s8 ->
// s32), shared by the first pass of grouped_matmul_combine (K8b,
// grouped_matmul.cu's dequant_rows_kernel) and the fused dispatch + GEMM1
// (K16a, fused_kernel.cu).  K8a's int8 modes and the fused MoE (K16b) run the
// int8 ring of gmm_int8_ring.cuh with the same column tiles and epilogues.
// The design: 64 sorted rows of one group x one column tile of 128 columns
// ("dequant") or 64 gate and the 64 matching up columns (SwiGLU), 256
// threads, 8 warps of 32 rows x 32 columns, 128 bytes of K a stage, the next
// stage's global loads in registers while the current one computes, weight
// bytes transposed in registers for the B fragments.
#pragma once

#include "gmm_common.cuh"

namespace k8 {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;                          // sorted rows per work item (4 m16 tiles)
constexpr int BN = 128;                         // columns per block (16 n8 tiles)
constexpr int HALF = BN / 2;                    // gate | up halves in SwiGLU mode
constexpr int BK = 128;                         // k bytes per stage (4 mma k32 steps)
constexpr int KQ = BK / 4;                      // k quads per stage
constexpr int THREADS = 256;                    // 8 warps: 2 (rows) x 4 (columns)
constexpr int WARPS = THREADS / 32;
constexpr int LDA = BK + 16;                    // x tile row stride, bytes
constexpr int LDB = BN + 8;                     // weight tile row stride (one row a k quad), words
constexpr int A_CHUNKS = BM * BK / 16 / THREADS;  // 16-byte x loads a thread per stage
constexpr int B_UNITS = KQ / WARPS;             // 4 k-rows x 4 columns a thread per stage

// kDequant: acc x sx[row] x sw[col] (each scale 1 where its pointer is null);
// kSwiGLU: SwiGLU of the dequantized gate / up pair to an f32 scratch and the
// row's |max| (the requant follows in another pass); kSwiGLUOut: the same
// SwiGLU stored through the output functor (K8a's float "dequant_swiglu").
enum Epilogue { kDequant = 0, kSwiGLU = 1, kSwiGLUOut = 2 };

// The staged x and weight tiles of one block.
struct TileSmem {
  __align__(16) int8_t as[BM * LDA];
  __align__(16) uint32_t bs[KQ * LDB];
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void store_pair(float* out, size_t i, float a, float b) {
  *reinterpret_cast<float2*>(out + i) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* out, size_t i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(__half* out, size_t i, float a, float b) {
  *reinterpret_cast<__half2*>(out + i) = __floats2half2_rn(a, b);
}

// The gate column of SwiGLU output column j when gate / up are packed in
// slabs of 2 ht columns, [gate ht | up ht] each (pack_gmm1_weights with tn =
// 2 ht; ht = N / 2 is the full-width packing); its up column is ht further.
__device__ __forceinline__ int gate_col(int j, int ht) { return (j / ht) * 2 * ht + j % ht; }

// Global column of column c (0 .. BN) of column tile bx, or -1 past the edge.
// N % 16 == 0 (ht % 16 == 0 in the SwiGLU modes): 4 aligned columns are all
// in or all out, and never straddle a gate / up slab.
template <int EPI>
__device__ __forceinline__ int global_col(int bx, int c, int N, int ht) {
  if (EPI == kDequant) {
    const int col = bx * BN + c;
    return col < N ? col : -1;
  }
  const int j = bx * HALF + c % HALF;
  return j < N / 2 ? gate_col(j, ht) + (c / HALF) * ht : -1;
}

// The n8 tile (of 16) that warp column wn holds in its slot nj: the gate
// tiles 2 wn, 2 wn + 1 and the matching up tiles 8 + 2 wn, 9 + 2 wn.
__device__ __forceinline__ int warp_tile(int wn, int nj) {
  return (nj < 2 ? 0 : 8) + 2 * wn + (nj & 1);
}

// The group of work item ``item``: tile_off[g] <= item < tile_off[g + 1], by a
// binary search over the device prefix sum of tiles (no host sync).
__device__ __forceinline__ int find_group(const int* __restrict__ tile_off, int groups,
                                          int item) {
  int lo = 0, hi = groups;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_off[mid] <= item) lo = mid;
    else hi = mid;
  }
  return lo;
}

// x rows: __ldg (read-only for the kernel: K8a) or ld.global.cg (written by
// other blocks or peers while the kernel runs: K16a's window).
template <bool RO, class T>
__device__ __forceinline__ T load_x(const T* p) {
  if (RO) return __ldg(p);
  return __ldcg(p);
}

// One tile: rows [r0, r1) of group g's rows (x [., K] int8, r0 its first;
// row r reads x[xrow[r]] where xrow is given, a zero row where that is < 0)
// times column tile bx of wg = w[g] ([K, N] int8), sx [rows] and swg = sw[g]
// [N] scales (null: 1).  "dequant": out(row, col, v, v') stores the pair of
// columns (col, col + 1) of acc x sx[row] x swg[col]; the SwiGLU modes pair
// gate and up by slabs of 2 ht columns (gate_col), and kSwiGLU writes act
// [rows, N / 2] f32 and the per-row |max| into amax (u32 float bits, zeroed
// before), kSwiGLUOut stores the pair of output columns (j, j + 1) through
// out.  Every thread of the block calls it (it syncs the block).
template <int EPI, bool RO, class Out>
__device__ __forceinline__ void int8_tile(TileSmem& sm, const int8_t* __restrict__ x,
                                          const int* __restrict__ xrow,
                                          const int8_t* __restrict__ wg, int r0, int r1, int K,
                                          int N, int ht, int bx, const float* __restrict__ sx,
                                          const float* __restrict__ swg, Out out,
                                          float* __restrict__ act,
                                          unsigned* __restrict__ amax) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tq = lane & 3;       // mma fragment row / column pair
  const int wm = warp & 1, wn = warp >> 1;
  const int bcol = global_col<EPI>(bx, 4 * lane, N, ht);   // this thread's 4 weight columns

  // the x rows this thread stages (the same rows at every k stage)
  const int8_t* xsrc[A_CHUNKS];
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int row = r0 + (tid + i * THREADS) / (BK / 16);
    const int src = row < r1 ? (xrow ? xrow[row] : row) : -1;
    xsrc[i] = src >= 0 ? x + (size_t)src * K : nullptr;
  }
  uint4 xa[A_CHUNKS];
  uint32_t wb[B_UNITS][4];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int kk = k0 + 16 * ((tid + i * THREADS) % (BK / 16));
      xa[i] = (xsrc[i] != nullptr && kk < K)
                  ? load_x<RO>(reinterpret_cast<const uint4*>(xsrc[i] + kk))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int v = 0; v < B_UNITS; ++v) {
      const int k = k0 + 4 * (warp * B_UNITS + v);
      uint32_t a[4] = {0u, 0u, 0u, 0u};
      if (bcol >= 0 && k < K) {                  // K % 16 == 0: 4 k-rows all in or all out
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a[j] = __ldg(reinterpret_cast<const uint32_t*>(wg + (size_t)(k + j) * N + bcol));
      }
      gmm::transpose4x4(a, wb[v]);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][nj][r] = 0;

  // ldmatrix lane address of the A tiles: rows 0-15, k bytes 0 / 16 of a step
  const int a_row = 32 * wm + (lane & 7) + 8 * ((lane >> 3) & 1), a_k = 16 * (lane >> 4);
  load_stage(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(sm.as + (c / (BK / 16)) * LDA + 16 * (c % (BK / 16))) = xa[i];
    }
#pragma unroll
    for (int v = 0; v < B_UNITS; ++v)
      *reinterpret_cast<uint4*>(sm.bs + (warp * B_UNITS + v) * LDB + 4 * lane) =
          make_uint4(wb[v][0], wb[v][1], wb[v][2], wb[v][3]);
    __syncthreads();
    if (k0 + BK < K) load_stage(k0 + BK);

    const int steps = min(BK, K - k0 + 31) / 32;   // zero-filled bytes past K add nothing
#pragma unroll
    for (int s = 0; s < BK / 32; ++s) {
      if (s >= steps) break;
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], sm.as + (a_row + 16 * mi) * LDA + 32 * s + a_k);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = 8 * warp_tile(wn, nj) + g8;
        const uint32_t b0 = sm.bs[(8 * s + tq) * LDB + col];
        const uint32_t b1 = sm.bs[(8 * s + 4 + tq) * LDB + col];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][nj], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

  // C fragment: rows g8 / g8 + 8 of each m16 tile, columns 2 tq, 2 tq + 1
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 32 * wm + 16 * mi + g8 + 8 * h;
      const bool live = row < r1;
      const float sxr = live ? (sx ? load_x<RO>(sx + row) : 1.f) : 0.f;
      if (EPI == kDequant) {
        if (!live) continue;
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int col = global_col<kDequant>(bx, 8 * warp_tile(wn, nj) + 2 * tq, N, ht);
          if (col < 0) continue;
          const float sw0 = swg ? swg[col] : 1.f, sw1 = swg ? swg[col + 1] : 1.f;
          out(row, col, __int2float_rn(acc[mi][nj][2 * h]) * sxr * sw0,
              __int2float_rn(acc[mi][nj][2 * h + 1]) * sxr * sw1);
        }
      } else {
        const int I = N / 2;
        float m = 0.f;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {       // gate slot jj pairs with up slot 2 + jj
          const int j = bx * HALF + 8 * (2 * wn + jj) + 2 * tq;
          if (!live || j >= I) continue;
          const int gc = gate_col(j, ht);      // j and j + 1 share a slab (ht even)
          float a2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d0 = __int2float_rn(acc[mi][jj][2 * h + e]) * sxr * swg[gc + e];
            const float d1 = __int2float_rn(acc[mi][2 + jj][2 * h + e]) * sxr * swg[gc + ht + e];
            a2[e] = d0 * (1.f / (1.f + expf(-d0))) * d1;
            m = fmaxf(m, fabsf(a2[e]));
          }
          if (EPI == kSwiGLU) store_pair(act, (size_t)row * I + j, a2[0], a2[1]);
          else out(row, j, a2[0], a2[1]);
        }
        if (EPI == kSwiGLU) {
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          if (tq == 0 && live) atomicMax(amax + row, __float_as_uint(m));
        }
      }
    }
}

}  // namespace k8
