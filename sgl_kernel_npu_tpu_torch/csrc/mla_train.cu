// mla_train: dense causal MLA flash attention for training, forward and backward, Hopper.
//
// Replaces the TPU kernels of sgl_kernel_npu_tpu/ops/attention/mla_train.py:
//   K14a _fwd_kernel    (launched by _flash_fwd at :222): the output and its LSE;
//   K14b _bwd_dq_kernel (launched by _flash_bwd at :277): dQ_lat, dQ_pe;
//   K14c _bwd_dk_kernel (launched by _flash_bwd at :294): dK_lat, dK_pe.
// Queries q_lat [B, S, H, 512] || q_pe [B, S, H, 64] attend to the keys of their
// own batch row, k_lat [B, S, 512] || k_pe [B, S, 64], token t to keys 0 .. t;
// V aliases k_lat, so dK_lat collects the dK and the dV terms.  All bf16, with
// the LSE and delta = rowsum(dO o O) in f32 [B, S, H].  A row is (token, head),
// token-major: flat row f = (b S + t) H + h indexes q, dO and the statistics.
//
// Bound on the H100: operations.  Per live (row, key) pair the forward does
// 2 (576 + 512) flops, dQ 2 (576 + 512 + 576), dK 2 (576 + 512 + 576 + 512),
// all at the bf16 tensor-core rate; the bytes (q, dO and out once) are of the
// same order at S = 520, H = 128 (chip_smoke.py computes which is larger).
// The products run on the tensor cores through mma.sync.m16n8k16 with f32
// accumulation; wgmma tiles of 64 rows, a TMA ring and keys shared by more
// rows are later work (PERF.md, ROADMAP).
//
// Design.  K14a and K14b take the block of mla_attention.cuh (K9a's): 16 query
// rows a block, 8 warps, each 32-key chunk staged once in shared memory for
// all 16 rows (the next chunk's loads in flight in registers while this one
// computes), the 576-deep score tile split over the warps (mma_abt), keys
// walked only up to the block's last causal token.  Where K9a reads a paged
// cache, these read the dense rows k_lat[b, j], k_pe[b, j] (row-major rope).
//   K14a: online softmax in f32; P is rounded to bf16 for the PV product, the
//         denominator sums the unrounded P (the TPU kernel's probs.astype);
//         out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//   K14b: S = Q K^T, P = exp(S - lse) (0 on dead keys), dP = dO K_lat^T,
//         dS = P (dP - delta) sm_scale rounded to bf16, dQ += dS K over the
//         [16, 576] f32 accumulator (72 columns a warp); rounded once.
//   K14c: a block owns 32 keys of one batch row, one group of heads and one
//         piece of at most `piece` tokens at or after its first key, and walks
//         their rows 16 a step (the group's heads of those tokens).  It
//         recomputes S, P and dP as K14b, and adds dS^T Q and P^T dO (P rounded
//         to bf16) into a [32, 576] f32 accumulator (both 16-key halves, 72
//         columns a warp), the transposed operands written transposed into
//         shared memory.  One block per key chunk would be 34 blocks on 132
//         SMs at S = 520, the first walking 520 tokens and the last 8: at 128
//         heads the heads split into 8 groups of 16 and the tokens into pieces
//         of 128, 720 blocks of at most 128 steps.  Each (group, piece) writes
//         f32 partials that a second pass sums in a fixed order and rounds
//         once.
#include "mla_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mla::DN;
using mla::DQ;
using mla::DR;
using mla::KT;
using mla::LD;
using mla::LDP;
using mla::NEG;
using mla::ROWS;
using mla::THREADS;

constexpr int LDO = DN + 8;              // smem row stride of a dO tile
constexpr int LDT = ROWS + 8;            // smem row stride of a transposed [key][row] tile
constexpr int CV = DQ / 8;               // 16-byte pieces of a q or key row: 64 latent + 8 rope
constexpr int NKV = KT * CV / THREADS;   // pieces of a key chunk a thread loads: 9
constexpr int COLS = DQ / 8;             // accumulator columns a warp owns in K14b / K14c: 72
constexpr int NT = COLS / 8;             // their n-tiles: 9

constexpr size_t FWD_SMEM = mla::SMEM_BYTES;
constexpr size_t DQ_SMEM = sizeof(bf16) * (ROWS * LD + ROWS * LDO + KT * LD + ROWS * LDP) +
                           sizeof(float) * (4 * ROWS * KT + 2 * ROWS);
constexpr size_t DK_SMEM = sizeof(bf16) * (KT * LD + ROWS * LD + ROWS * LDO + 2 * KT * LDT) +
                           sizeof(float) * (4 * ROWS * KT + 2 * ROWS);

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

// Keys [k0, k0 + KT) of one batch row (kl, kp at the row's first key) into
// registers: piece e is key e / CV, 16 bytes at column 8 (e % CV) of latent ||
// rope.  Keys at or past kend load as zeros (a dead key's P is 0, and 0 times
// stale shared memory could be NaN).
__device__ __forceinline__ void load_keys(const bf16* __restrict__ kl, const bf16* __restrict__ kp,
                                          int k0, int kend, uint4 (&v)[NKV]) {
#pragma unroll
  for (int it = 0; it < NKV; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int key = k0 + e / CV, c = e % CV;
    uint4 val = zero4();
    if (key < kend)
      val = c < DN / 8 ? *reinterpret_cast<const uint4*>(kl + (size_t)key * DN + c * 8)
                       : *reinterpret_cast<const uint4*>(kp + (size_t)key * DR + (c - DN / 8) * 8);
    v[it] = val;
  }
}

__device__ __forceinline__ void store_keys(bf16* ks, const uint4 (&v)[NKV]) {
#pragma unroll
  for (int it = 0; it < NKV; ++it) {
    const int e = threadIdx.x + it * THREADS;
    *reinterpret_cast<uint4*>(ks + (e / CV) * LD + (e % CV) * 8) = v[it];
  }
}

// The Q tile [ROWS][LD] (latent || rope) of flat rows rows[r] and, given dos,
// their dO tile [ROWS][LDO]; a dead row (-1) is zeros.
__device__ __forceinline__ void load_rows(bf16* qs, bf16* dos, const int* rows,
                                          const bf16* __restrict__ ql, const bf16* __restrict__ qp,
                                          const bf16* __restrict__ dout) {
  for (int i = threadIdx.x; i < ROWS * CV; i += THREADS) {
    const int r = i / CV, c = i % CV, f = rows[r];
    uint4 v = zero4();
    if (f >= 0)
      v = c < DN / 8 ? *reinterpret_cast<const uint4*>(ql + (size_t)f * DN + c * 8)
                     : *reinterpret_cast<const uint4*>(qp + (size_t)f * DR + (c - DN / 8) * 8);
    *reinterpret_cast<uint4*>(qs + r * LD + c * 8) = v;
  }
  if (dos == nullptr) return;
  for (int i = threadIdx.x; i < ROWS * DN / 8; i += THREADS) {
    const int r = i / (DN / 8), c = i % (DN / 8), f = rows[r];
    uint4 v = zero4();
    if (f >= 0) v = *reinterpret_cast<const uint4*>(dout + (size_t)f * DN + c * 8);
    *reinterpret_cast<uint4*>(dos + r * LDO + c * 8) = v;
  }
}

// A warp's score tile: keys 8 (warp % 4) .. + 8 over half (warp / 4) of the
// 576-deep Q K^T into ss[half][ROWS][KT]; with dos also its half of the 512-deep
// dO K_lat^T into dps[half][ROWS][KT].
__device__ __forceinline__ void score_tiles(float* ss, float* dps, const bf16* qs,
                                            const bf16* dos, const bf16* ks, int warp, int lane) {
  const int s_keys = 8 * (warp & 3), half = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mla::mma_abt<DQ / 32>(s, qs, LD, ks + s_keys * LD, LD, half * (DQ / 2), lane);
  float* sh = ss + half * ROWS * KT;
  sh[g * KT + s_keys + 2 * t4] = s[0];
  sh[g * KT + s_keys + 2 * t4 + 1] = s[1];
  sh[(g + 8) * KT + s_keys + 2 * t4] = s[2];
  sh[(g + 8) * KT + s_keys + 2 * t4 + 1] = s[3];
  if (dos == nullptr) return;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mla::mma_abt<DN / 32>(d, dos, LDO, ks + s_keys * LD, LD, half * (DN / 2), lane);
  float* dh = dps + half * ROWS * KT;
  dh[g * KT + s_keys + 2 * t4] = d[0];
  dh[g * KT + s_keys + 2 * t4 + 1] = d[1];
  dh[(g + 8) * KT + s_keys + 2 * t4] = d[2];
  dh[(g + 8) * KT + s_keys + 2 * t4 + 1] = d[3];
}

// P and dS of row r, key column c of a chunk starting at k0 (0 where the key is
// dead for the row: past its token, or a dead row whose token is -1).
struct PdS {
  float p, ds;
};
__device__ __forceinline__ PdS p_ds(const float* ss, const float* dps, int r, int c, int key,
                                    int tok, float lse, float delta, float sm_scale) {
  if (key > tok) return {0.f, 0.f};
  const float s = (ss[r * KT + c] + ss[ROWS * KT + r * KT + c]) * sm_scale;
  const float p = expf(s - lse);
  const float dp = dps[r * KT + c] + dps[ROWS * KT + r * KT + c];
  return {p, p * (dp - delta) * sm_scale};
}

// Flat rows f0 .. f0 + 15 of batch b: rows_s (flat index over the batch, -1
// dead) and tok_s (token, -1 dead).
__device__ __forceinline__ void dense_rows(int* rows_s, int* tok_s, int b, int f0, int seq,
                                           int heads) {
  if (threadIdx.x < ROWS) {
    const int f = f0 + threadIdx.x, n = seq * heads;
    rows_s[threadIdx.x] = f < n ? b * n + f : -1;
    tok_s[threadIdx.x] = f < n ? f / heads : -1;
  }
}

// ---------------------------------------------------------------------------
// K14a: forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    mla_train_fwd_kernel(const bf16* __restrict__ ql, const bf16* __restrict__ qp,
                         const bf16* __restrict__ kl, const bf16* __restrict__ kp,
                         bf16* __restrict__ out, float* __restrict__ lse, int seq, int heads,
                         float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);          // [ROWS][LD]
  bf16* ks = qs + ROWS * LD;                              // [KT][LD]
  bf16* pb = ks + KT * LD;                                // [ROWS][LDP]
  float* ss = reinterpret_cast<float*>(pb + ROWS * LDP);  // [2][ROWS][KT]
  float* m_s = ss + 2 * ROWS * KT;
  float* l_s = m_s + ROWS;
  float* a_s = l_s + ROWS;
  __shared__ int rows_s[ROWS], tok_s[ROWS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y;
  const int f0 = (gridDim.x - 1 - blockIdx.x) * ROWS;    // the longest rows first
  dense_rows(rows_s, tok_s, b, f0, seq, heads);
  if (tid < ROWS) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  load_rows(qs, nullptr, rows_s, ql, qp, nullptr);
  const int kend = (min(f0 + ROWS, seq * heads) - 1) / heads + 1;
  const bf16* klb = kl + (size_t)b * seq * DN;
  const bf16* kpb = kp + (size_t)b * seq * DR;

  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  uint4 kv[NKV];
  load_keys(klb, kpb, 0, kend, kv);
  for (int k0 = 0; k0 < kend; k0 += KT) {
    store_keys(ks, kv);
    __syncthreads();
    if (k0 + KT < kend) load_keys(klb, kpb, k0 + KT, kend, kv);
    score_tiles(ss, nullptr, qs, nullptr, ks, warp, lane);
    __syncthreads();

    // online softmax: warp w takes rows w and w + 8, lane = key of the chunk
    for (int r = warp; r < ROWS; r += THREADS / 32) {
      const bool live = k0 + lane <= tok_s[r];
      const float s = live ? (ss[r * KT + lane] + ss[ROWS * KT + r * KT + lane]) * sm_scale : NEG;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, sgl::warp_max(s));
      const float p = live ? expf(s - m_new) : 0.f;
      pb[r * LDP + lane] = __float2bfloat16(p);
      const float sum = sgl::warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    const float al0 = a_s[g], al1 = a_s[g + 8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      o[nt][0] *= al0;
      o[nt][1] *= al0;
      o[nt][2] *= al1;
      o[nt][3] *= al1;
    }
    mla::mma_ab<KT / 16, 8>(o, pb, LDP, ks, LD, warp * 64, lane);
    __syncthreads();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half, f = rows_s[r];
    if (f < 0) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    bf16* orow = out + (size_t)f * DN + warp * 64 + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) =
          __floats2bfloat162_rn(o[nt][2 * half] / l, o[nt][2 * half + 1] / l);
  }
  if (tid < ROWS && rows_s[tid] >= 0) lse[rows_s[tid]] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

// ---------------------------------------------------------------------------
// K14b: dQ
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    mla_train_dq_kernel(const bf16* __restrict__ ql, const bf16* __restrict__ qp,
                        const bf16* __restrict__ kl, const bf16* __restrict__ kp,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dql,
                        bf16* __restrict__ dqp, int seq, int heads, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);           // [ROWS][LD]
  bf16* dos = qs + ROWS * LD;                              // [ROWS][LDO]
  bf16* ks = dos + ROWS * LDO;                             // [KT][LD]
  bf16* dsb = ks + KT * LD;                                // [ROWS][LDP]
  float* ss = reinterpret_cast<float*>(dsb + ROWS * LDP);  // [2][ROWS][KT]
  float* dps = ss + 2 * ROWS * KT;                         // [2][ROWS][KT]
  float* lse_s = dps + 2 * ROWS * KT;
  float* dl_s = lse_s + ROWS;
  __shared__ int rows_s[ROWS], tok_s[ROWS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y;
  const int f0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  dense_rows(rows_s, tok_s, b, f0, seq, heads);
  __syncthreads();
  if (tid < ROWS) {
    const int f = rows_s[tid];
    lse_s[tid] = f >= 0 ? lse[f] : 0.f;
    dl_s[tid] = f >= 0 ? delta[f] : 0.f;
  }
  load_rows(qs, dos, rows_s, ql, qp, dout);
  const int kend = (min(f0 + ROWS, seq * heads) - 1) / heads + 1;
  const bf16* klb = kl + (size_t)b * seq * DN;
  const bf16* kpb = kp + (size_t)b * seq * DR;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  uint4 kv[NKV];
  load_keys(klb, kpb, 0, kend, kv);
  for (int k0 = 0; k0 < kend; k0 += KT) {
    store_keys(ks, kv);
    __syncthreads();
    if (k0 + KT < kend) load_keys(klb, kpb, k0 + KT, kend, kv);
    score_tiles(ss, dps, qs, dos, ks, warp, lane);
    __syncthreads();
    for (int i = tid; i < ROWS * KT; i += THREADS) {
      const int r = i / KT, c = i % KT;
      const PdS v = p_ds(ss, dps, r, c, k0 + c, tok_s[r], lse_s[r], dl_s[r], sm_scale);
      dsb[r * LDP + c] = __float2bfloat16(v.ds);
    }
    __syncthreads();
    mla::mma_ab<KT / 16, NT>(acc, dsb, LDP, ks, LD, warp * COLS, lane);
    __syncthreads();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int f = rows_s[g + 8 * half];
    if (f < 0) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = warp * COLS + nt * 8 + 2 * t4;
      bf16* dst = col < DN ? dql + (size_t)f * DN + col : dqp + (size_t)f * DR + col - DN;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K14c: dK (dK_lat collects dK and dV), f32 partials a group of heads, then a sum
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    mla_train_dk_kernel(const bf16* __restrict__ ql, const bf16* __restrict__ qp,
                        const bf16* __restrict__ kl, const bf16* __restrict__ kp,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ part, int batch,
                        int seq, int heads, int group, int piece, int pieces, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);            // [KT][LD]
  bf16* qs = ks + KT * LD;                                  // [ROWS][LD]
  bf16* dos = qs + ROWS * LD;                               // [ROWS][LDO]
  bf16* dst = dos + ROWS * LDO;                             // dS^T [KT][LDT]
  bf16* pt = dst + KT * LDT;                                // P^T [KT][LDT]
  float* ss = reinterpret_cast<float*>(pt + KT * LDT);      // [2][ROWS][KT]
  float* dps = ss + 2 * ROWS * KT;                          // [2][ROWS][KT]
  float* lse_s = dps + 2 * ROWS * KT;
  float* dl_s = lse_s + ROWS;
  __shared__ int rows_s[ROWS], tok_s[ROWS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int hg = blockIdx.x, b = blockIdx.z / pieces, pc = blockIdx.z % pieces;
  const int k0 = blockIdx.y * KT, kend = min(k0 + KT, seq);
  const int t_lo = k0 + pc * piece, t_hi = min(seq, t_lo + piece);
  if (t_lo >= seq) return;                                  // the chunk has fewer pieces
  {
    uint4 kv[NKV];
    load_keys(kl + (size_t)b * seq * DN, kp + (size_t)b * seq * DR, k0, kend, kv);
    store_keys(ks, kv);
  }
  // the rows: tokens t_lo .. t_hi - 1, heads hg * group .. + group, token-major
  const int n_rows = (t_hi - t_lo) * group;

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[m][nt][0] = acc[m][nt][1] = acc[m][nt][2] = acc[m][nt][3] = 0.f;
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = a_row;

  for (int i0 = 0; i0 < n_rows; i0 += ROWS) {
    if (tid < ROWS) {
      const int i = i0 + tid;
      const bool live = i < n_rows;
      const int t = t_lo + i / group, h = hg * group + i % group;
      const int f = live ? (b * seq + t) * heads + h : -1;
      rows_s[tid] = f;
      tok_s[tid] = live ? t : -1;
      lse_s[tid] = live ? lse[f] : 0.f;
      dl_s[tid] = live ? delta[f] : 0.f;
    }
    __syncthreads();
    load_rows(qs, dos, rows_s, ql, qp, dout);
    __syncthreads();
    score_tiles(ss, dps, qs, dos, ks, warp, lane);
    __syncthreads();
    for (int i = tid; i < ROWS * KT; i += THREADS) {
      const int r = i / KT, c = i % KT;
      const PdS v = p_ds(ss, dps, r, c, k0 + c, tok_s[r], lse_s[r], dl_s[r], sm_scale);
      pt[c * LDT + r] = __float2bfloat16(v.p);
      dst[c * LDT + r] = __float2bfloat16(v.ds);
    }
    __syncthreads();
    // dK[keys, :] += dS^T Q (576 columns) + P^T dO (the 512 latent columns)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      uint32_t a_ds[4], a_p[4];
      sgl::ldsm_x4(a_ds, dst + (16 * m + a_row) * LDT + a_col);
      sgl::ldsm_x4(a_p, pt + (16 * m + a_row) * LDT + a_col);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = warp * COLS + nt * 8;
        uint32_t bq[2];
        sgl::ldsm_x2_trans(bq, qs + b_row * LD + col);
        sgl::mma_16816(acc[m][nt], a_ds, bq);
        if (col < DN) {
          uint32_t bo[2];
          sgl::ldsm_x2_trans(bo, dos + b_row * LDO + col);
          sgl::mma_16816(acc[m][nt], a_p, bo);
        }
      }
    }
    __syncthreads();
  }

  float* pb = part + ((size_t)(hg * pieces + pc) * batch + b) * seq * DQ;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = k0 + 16 * m + g + 8 * half;
      if (key >= kend) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(pb + (size_t)key * DQ + warp * COLS + nt * 8 + 2 * t4) =
            make_float2(acc[m][nt][2 * half], acc[m][nt][2 * half + 1]);
    }
}

// dK = the partials of the groups and of the pieces that exist for the key's
// chunk, summed in (group, piece) order, rounded once.
__global__ void mla_train_dk_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dkl,
                                        bf16* __restrict__ dkp, int batch, int seq, int groups,
                                        int piece, int pieces) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)batch * seq * DQ;
  if (i >= n) return;
  const size_t key = i / DQ;                                   // b * seq + position
  const int c = (int)(i % DQ), k0 = (int)(key % seq) / KT * KT;
  const int live = (seq - k0 + piece - 1) / piece;
  float s = 0.f;
  for (int hg = 0; hg < groups; ++hg)
    for (int pc = 0; pc < live; ++pc) s += part[(size_t)(hg * pieces + pc) * n + i];
  if (c < DN)
    dkl[key * DN + c] = __float2bfloat16(s);
  else
    dkp[key * DR + c - DN] = __float2bfloat16(s);
}

}  // namespace

// bf16 q_lat [B, S, H, 512], q_pe [B, S, H, 64], k_lat [B, S, 512], k_pe [B, S, 64]
// -> bf16 out [B, S, H, 512] and f32 lse [B, S, H].
extern "C" int mla_train_fwd_launch(const void* q_lat, const void* q_pe, const void* k_lat,
                                    const void* k_pe, void* out, void* lse, int batch, int seq,
                                    int heads, float sm_scale, void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return 0;
  cudaFuncSetAttribute(mla_train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)FWD_SMEM);
  dim3 grid((seq * heads + ROWS - 1) / ROWS, batch);
  mla_train_fwd_kernel<<<grid, THREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q_lat, (const bf16*)q_pe, (const bf16*)k_lat, (const bf16*)k_pe, (bf16*)out,
      (float*)lse, seq, heads, sm_scale);
  return (int)cudaGetLastError();
}

// K14a's operands plus bf16 dout (like q_lat) and f32 lse, delta [B, S, H] ->
// bf16 dq_lat, dq_pe (like q_lat, q_pe).
extern "C" int mla_train_bwd_dq_launch(const void* q_lat, const void* q_pe, const void* k_lat,
                                       const void* k_pe, const void* dout, const void* lse,
                                       const void* delta, void* dq_lat, void* dq_pe, int batch,
                                       int seq, int heads, float sm_scale, void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return 0;
  cudaFuncSetAttribute(mla_train_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)DQ_SMEM);
  dim3 grid((seq * heads + ROWS - 1) / ROWS, batch);
  mla_train_dq_kernel<<<grid, THREADS, DQ_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q_lat, (const bf16*)q_pe, (const bf16*)k_lat, (const bf16*)k_pe,
      (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dq_lat, (bf16*)dq_pe, seq,
      heads, sm_scale);
  return (int)cudaGetLastError();
}

// K14b's inputs, f32 scratch part [groups x pieces, B, S, 576] -> bf16 dk_lat
// [B, S, 512], dk_pe [B, S, 64]; the heads split into `groups` groups (groups
// divides H), a key chunk's tokens into pieces of `piece` tokens (pieces =
// ceil(S / piece)).
extern "C" int mla_train_bwd_dk_launch(const void* q_lat, const void* q_pe, const void* k_lat,
                                       const void* k_pe, const void* dout, const void* lse,
                                       const void* delta, void* part, void* dk_lat, void* dk_pe,
                                       int batch, int seq, int heads, int groups, int piece,
                                       float sm_scale, void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return 0;
  if (groups < 1 || heads % groups != 0 || piece < 1) return (int)cudaErrorInvalidValue;
  const int pieces = (seq + piece - 1) / piece;
  cudaStream_t s = (cudaStream_t)stream;
  cudaFuncSetAttribute(mla_train_dk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)DK_SMEM);
  dim3 grid(groups, (seq + KT - 1) / KT, batch * pieces);
  mla_train_dk_kernel<<<grid, THREADS, DK_SMEM, s>>>(
      (const bf16*)q_lat, (const bf16*)q_pe, (const bf16*)k_lat, (const bf16*)k_pe,
      (const bf16*)dout, (const float*)lse, (const float*)delta, (float*)part, batch, seq, heads,
      heads / groups, piece, pieces, sm_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)batch * seq * DQ;
  mla_train_dk_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)part, (bf16*)dk_lat, (bf16*)dk_pe, batch, seq, groups, piece, pieces);
  return (int)cudaGetLastError();
}
