// The constants and mma.sync helpers of the 16-row MLA body on which K2
// (decode_mla), K9a and K9b first ran: 16 query rows a block on
// mma.sync.m16n8k16 (f32 accumulate), 8 warps, 32-key chunks staged in
// shared memory with the 576-deep score tile split over the warps
// (mma_abt), P V over 64 output columns a warp (mma_ab).  Its only users
// now are mla_train.cu's K14b and K14c, which run a body of their own of
// that design over dense keys; K2, K9a and K9b run the Hopper body of
// mla_sparse.cuh.
//
// Layouts are the JAX package's: q [tokens, H, 512 + 64] (absorbed nope ||
// rope), the keys' latent 512 and rope 64; rows in shared memory padded to
// LD so that rows 16 B apart fall in distinct banks.
#pragma once

#include "common.cuh"

namespace mla {

using bf16 = __nv_bfloat16;

constexpr int DN = 512;                  // latent (nope) width, also V width
constexpr int DR = 64;                   // rope width
constexpr int DQ = DN + DR;
constexpr int LD = DQ + 8;               // smem row stride: rows 16 B apart in banks
constexpr int ROWS = 16;                 // query rows per block (the mma M)
constexpr int KT = 32;                   // keys per staged chunk (= warp size)
constexpr int LDP = KT + 8;              // smem row stride of P
constexpr int THREADS = 256;             // 8 warps
constexpr float NEG = -1e30f;

using sgl::ldsm_x2;
using sgl::ldsm_x2_trans;
using sgl::ldsm_x4;
using sgl::mma_16816;

// s[16 x 8] += A[16, d0 : d0 + 16 N] . B[8, d0 : d0 + 16 N]^T, A and B row-major in
// shared memory (row strides lda, ldb): the score tile of 8 keys (B's rows) over a
// depth range.  s holds the mma fragment: rows g and g + 8, columns 2 t4 and + 1.
template <int N>
__device__ __forceinline__ void mma_abt(float (&s)[4], const bf16* a, int lda, const bf16* b,
                                        int ldb, int d0, int lane) {
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = lane & 7, b_col = 8 * ((lane >> 3) & 1);
#pragma unroll 6
  for (int kk = 0; kk < N; ++kk) {
    uint32_t af[4], bf[2];
    ldsm_x4(af, a + a_row * lda + d0 + kk * 16 + a_col);
    ldsm_x2(bf, b + b_row * ldb + d0 + kk * 16 + b_col);
    mma_16816(s, af, bf);
  }
}

// o[nt] += A[16, 0 : 16 KSTEPS] . B[0 : 16 KSTEPS, col0 + 8 nt : + 8] for nt < NT, A and B
// row-major in shared memory (B's rows are the depth, read transposed by ldmatrix).
template <int KSTEPS, int NT>
__device__ __forceinline__ void mma_ab(float (&o)[NT][4], const bf16* a, int lda, const bf16* b,
                                       int ldb, int col0, int lane) {
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + a_row * lda + kk * 16 + a_col);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bf[2];
      ldsm_x2_trans(bf, b + (kk * 16 + b_row) * ldb + col0 + nt * 8);
      mma_16816(o[nt], af, bf);
    }
  }
}

}  // namespace mla
