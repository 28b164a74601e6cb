// Paged MLA attention over the latent cache: the 16-row block body of K2
// (decode_mla, decode_mla.cu).  Its constants and mma.sync helpers also
// serve mla_train.cu's K14b and K14c, which run a body of their own of the
// same design.  K9a and K9b run the Hopper body of mla_sparse.cuh.
//
// Layouts are the JAX package's: q [tokens, H, 512 + 64] (absorbed nope || rope),
// latent cache kn [pages, 1, page, 512], rope cache transposed
// kr [pages, 1, 64, page], block table [B, max_pages]; q, kr and the output
// bf16, the latent bf16 or int8 (the int8_nzcache levels round(k / k_scale):
// the wrapper folds k_scale into q_nope and the output, as the JAX wrappers
// do, so the kernel only reads levels).  V aliases K_nope.
//
// One block owns ROWS = 16 query rows: TQ consecutive tokens of one request x
// 16 / TQ heads, which is one m16 tile of the bf16 tensor-core product
// mma.sync.m16n8k16 (f32 accumulate).  The block walks the request's keys in
// chunks of KT = 32 (any page size: each key finds its page through the block
// table).  Each chunk's latent ++ rope rows are staged in shared memory ONCE
// for all 16 rows; the next chunk's global loads are in flight in registers
// while the current chunk computes.  Per chunk:
//   S = Q K^T   8 warps: warp w takes keys 8 (w % 4) .. + 8 over half of the
//               576-deep product (w / 4); the two halves meet in shared memory,
//   softmax     online (m, l) per row in f32; P rounded to bf16 (as the TPU
//               kernel feeds its PV product),
//   O += P V    warp w owns output columns 64 w .. 64 w + 64 (8 n-tiles), the
//               [16, 512] f32 accumulator spread over the warps' registers.
// Keys past the block's last causal position are never read.  An int8 latent
// is loaded 8 levels (8 bytes) at a time, half the bytes of bf16, and widened
// to bf16 as it is stored to shared memory: levels in [-128, 127] are exact in
// bf16, so the mma path is the same for both.
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
constexpr size_t SMEM_BYTES = sizeof(bf16) * (ROWS * LD + KT * LD + ROWS * LDP) +
                              sizeof(float) * (2 * ROWS * KT + 3 * ROWS);

constexpr int VEC = 8;                                  // latent values in one load
constexpr int NV = KT * DN / VEC / THREADS;              // latent loads a thread per chunk
constexpr int NR = KT * DR / THREADS;                    // rope values a thread per chunk

// VEC latent values as loaded from the cache: 16 bytes of bf16, 8 of int8.
template <typename KN>
using Chunk = sgl::Vec8<KN>;
using sgl::widen;

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

// Issue the global loads of keys [k0, k0 + KT) into registers: every load of
// a thread is independent of the others, so they are all in flight at once.
template <typename KN, typename V = typename Chunk<KN>::type>
__device__ __forceinline__ void load_chunk(const KN* __restrict__ kn,
                                           const bf16* __restrict__ kr,
                                           const int* __restrict__ bt_row, int k0, int kend,
                                           int page_size, V (&v)[NV], bf16 (&r)[NR]) {
#pragma unroll
  for (int it = 0; it < NV; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int t = e / (DN / VEC), c = e % (DN / VEC), key = k0 + t;
    V val{};
    if (key < kend) {
      const int pg = bt_row[key / page_size], off = key % page_size;
      val = *reinterpret_cast<const V*>(kn + ((size_t)pg * page_size + off) * DN + c * VEC);
    }
    v[it] = val;
  }
#pragma unroll
  for (int it = 0; it < NR; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int t = e % KT, rr = e / KT, key = k0 + t;
    bf16 val = __float2bfloat16(0.f);
    if (key < kend) {
      const int pg = bt_row[key / page_size], off = key % page_size;
      val = kr[((size_t)pg * DR + rr) * page_size + off];
    }
    r[it] = val;
  }
}

// Registers of load_chunk -> the key rows [KT][LD] (latent ++ rope) in smem.
template <typename V>
__device__ __forceinline__ void store_chunk(bf16* ks, const V (&v)[NV], const bf16 (&r)[NR]) {
#pragma unroll
  for (int it = 0; it < NV; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int t = e / (DN / VEC), c = e % (DN / VEC);
    *reinterpret_cast<uint4*>(ks + t * LD + c * VEC) = widen(v[it]);
  }
#pragma unroll
  for (int it = 0; it < NR; ++it) {
    const int e = threadIdx.x + it * THREADS;
    ks[(e % KT) * LD + DN + e / KT] = r[it];
  }
}

// Rows r of the block: token j = j0 + r / (ROWS / tq) of the request, head
// h0 + r % (ROWS / tq).  Token j sits at packed index tok_base + j and sees
// cache positions <= ctx - seq_len + j.  Rows past seq_len or past the head
// count are dead: they read nothing and write nothing.
template <typename KN>
__device__ __forceinline__ void mla_block(
    const bf16* __restrict__ q, const KN* __restrict__ kn, const bf16* __restrict__ kr,
    const int* __restrict__ bt_row, bf16* __restrict__ out, int tok_base, int j0,
    int seq_len, int ctx, int heads, int h0, int tq, int page_size, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);          // [ROWS][LD]
  bf16* ks = qs + ROWS * LD;                              // [KT][LD]
  bf16* pb = ks + KT * LD;                                // [ROWS][LDP] probabilities
  float* ss = reinterpret_cast<float*>(pb + ROWS * LDP);  // [2][ROWS][KT] score halves
  float* m_s = ss + 2 * ROWS * KT;                        // [ROWS] running max
  float* l_s = m_s + ROWS;                                // [ROWS] running denominator
  float* a_s = l_s + ROWS;                                // [ROWS] this chunk's rescale

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;     // mma fragment row / column pair
  const int ht = ROWS / tq;

  for (int i = tid; i < ROWS * DQ / VEC; i += THREADS) {
    const int r = i / (DQ / VEC), c = i % (DQ / VEC);
    const int j = j0 + r / ht, h = h0 + r % ht;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (j < seq_len && h < heads)
      v = *reinterpret_cast<const uint4*>(q + ((size_t)(tok_base + j) * heads + h) * DQ + c * VEC);
    *reinterpret_cast<uint4*>(qs + r * LD + c * VEC) = v;
  }
  if (tid < ROWS) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  // exclusive key bound: the causal limit of the block's last live token
  const int kend = ctx - seq_len + min(j0 + tq, seq_len);
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  const int s_keys = 8 * (warp & 3), s_half = warp >> 2;  // this warp's S tile

  typename Chunk<KN>::type kv_next[NV];
  bf16 kr_next[NR];
  if (kend > 0) load_chunk(kn, kr, bt_row, 0, kend, page_size, kv_next, kr_next);
  for (int k0 = 0; k0 < kend; k0 += KT) {
    // the chunk loaded into registers last iteration goes to shared memory;
    // the next chunk's loads are issued before this chunk's arithmetic
    store_chunk(ks, kv_next, kr_next);
    __syncthreads();
    if (k0 + KT < kend)
      load_chunk(kn, kr, bt_row, k0 + KT, kend, page_size, kv_next, kr_next);

    // S half-products: keys s_keys .. + 8, depth [288 s_half, 288 s_half + 288)
    {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      mma_abt<DQ / 32>(s, qs, LD, ks + s_keys * LD, LD, s_half * (DQ / 2), lane);
      float* sh = ss + s_half * ROWS * KT;
      sh[g * KT + s_keys + 2 * t4] = s[0];
      sh[g * KT + s_keys + 2 * t4 + 1] = s[1];
      sh[(g + 8) * KT + s_keys + 2 * t4] = s[2];
      sh[(g + 8) * KT + s_keys + 2 * t4 + 1] = s[3];
    }
    __syncthreads();

    // online softmax: warp w takes rows w and w + 8; lane = key of the chunk
    for (int r = warp; r < ROWS; r += THREADS / 32) {
      const int j = j0 + r / ht, h = h0 + r % ht, key = k0 + lane;
      const bool ok = key < kend && j < seq_len && h < heads && key <= ctx - seq_len + j;
      const float s = ok ? (ss[r * KT + lane] + ss[ROWS * KT + r * KT + lane]) * sm_scale : NEG;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, sgl::warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;     // a masked key weighs 0
      const bf16 pq = __float2bfloat16(p);
      pb[r * LDP + lane] = pq;
      const float sum = sgl::warp_sum(__bfloat162float(pq));
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P V over this warp's 64 output columns
    const float al0 = a_s[g], al1 = a_s[g + 8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      o[nt][0] *= al0;
      o[nt][1] *= al0;
      o[nt][2] *= al1;
      o[nt][3] *= al1;
    }
    mma_ab<KT / 16, 8>(o, pb, LDP, ks, LD, warp * 64, lane);
    __syncthreads();
  }

  // rows g and g + 8 of the tile, columns 64 warp + 8 nt + 2 t4 (+1)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half;
    const int j = j0 + r / ht, h = h0 + r % ht;
    if (j < seq_len && h < heads) {
      const float l = l_s[r];
      const float inv = l > 0.f ? 1.f / l : 0.f;
      bf16* orow = out + ((size_t)(tok_base + j) * heads + h) * DN + warp * 64 + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) =
            __floats2bfloat162_rn(o[nt][2 * half] * inv, o[nt][2 * half + 1] * inv);
    }
  }
}

}  // namespace mla
