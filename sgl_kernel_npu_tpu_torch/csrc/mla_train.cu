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
//
// K14a runs on the Hopper body of K9b (mla_sparse.cuh), a second body on the
// same wgmma.cuh helpers with dense keys in place of selected pages.  The
// 16-row block of K14b and K14c (below) would send every key through L2 once
// per 16 rows (~2.5 GB at B 2 x S 520 x 128 heads), stage the keys through
// the computing threads' registers, split the 576-deep Q K^T across warps
// with partial sums in shared memory and run the softmax row by row; here:
//   K14a: a block owns 64 consecutive flat rows of one batch row (64 heads of
//         one token at H = 128; at fewer heads the rows span tokens, each
//         masking keys past its own) and walks keys 0 .. its last row's token
//         in 64-key chunks, the longest walks launched first.  Warpgroup 0
//         loads (one thread issues TMA boxes of 64 keys x 128 bytes: the
//         latent k_lat [B, S, 512] as 8 boxes, the rope k_pe [B, S, 64] as
//         one, both K-major for S, 3D maps so keys past the batch row read as
//         zeros) into a two-stage ring behind full / empty mbarriers;
//         warpgroups 1 and 2 compute (setmaxnreg 40 / 232).  Q [64, 576]
//         comes first, as 9 boxes of 64 rows (K-major A), and stays in
//         shared memory; S on wgmma m64n32k16 over the whole depth
//         (warpgroup g: keys 32 g .. 32 g + 31); an online base-2 softmax in
//         registers (sm_scale log2 e folded into the scores, ex2), masked keys
//         weighing 0, the row maxima swapped through shared memory; P rounded
//         to bf16 for PV while the denominator sums the unrounded P (the TPU
//         kernel's probs.astype); O += P V on m64n256k16 (V = the latent
//         chunk, MN-major; warpgroup g: columns 256 g .. 256 g + 255).
//         out = acc / max(l, 1e-30), rounded once; lse = m + log(max(l,
//         1e-30)) in natural-log units from the base-2 running max and sum.
//         Shared memory: Q 72 KB, two stages of 72 KB, P 8 KB: one block an
//         SM.  ops/attention/mla_train.mla_flash_fwd_tiled_plain mirrors this
//         walk on the CPU.
//
// Design of K14b and K14c: the 16-row block of mla_attention.cuh (on which
// K2 first ran, over its paged cache): 16 query rows a block, 8 warps, each
// 32-key chunk staged once in shared memory for all 16 rows (the next
// chunk's loads in flight in registers while this one computes), the
// 576-deep score tile split over the warps (mma_abt) on mma.sync.m16n8k16
// with f32 accumulation, keys walked only up to the block's last causal
// token, over the dense rows k_lat[b, j], k_pe[b, j] (row-major rope).
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
#include "wgmma.cuh"

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
// K14a: forward, on the Hopper body of K9b (mla_sparse.cuh) for dense keys
// ---------------------------------------------------------------------------

namespace k14a {

constexpr int M = 64;                    // flat rows a block
constexpr int PRODUCERS = 128;           // warpgroup 0 loads,
constexpr int CONSUMERS = 256;           // warpgroups 1 and 2 compute
constexpr int NTHREADS = PRODUCERS + CONSUMERS;
constexpr int CHUNK = 64;                // keys a staged chunk
constexpr int BOX = CHUNK * 128;         // bytes of a TMA box: 64 keys x 128 bytes
constexpr int LAT_BOXES = DN / 64;       // a chunk's latent: 8 boxes of 64 columns
constexpr uint32_t STAGE = (LAT_BOXES + 1) * BOX;   // + the rope box: 72 KB
constexpr uint32_t Q_OFF = 0;                       // 9 boxes of [64 rows][128 bytes]: 72 KB
constexpr uint32_t STAGES_OFF = Q_OFF + STAGE;
constexpr uint32_t P_OFF = STAGES_OFF + 2 * STAGE;  // [8][64][8] bf16
constexpr uint32_t RED_OFF = P_OFF + M * CHUNK * 2; // [2][64] f32 row exchange
constexpr uint32_t BARS_OFF = RED_OFF + 2 * M * 4;  // full[2], empty[2], q
constexpr uint32_t SMEM = BARS_OFF + 5 * 8;
static_assert(SMEM <= 232448, "K14a's shared memory exceeds a block's 227 KB");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Block j of a 1D grid: batch row j % B, flat rows f0 .. f0 + 63 of it with
// the longest walks first (the last rows' blocks launch first).  The rows
// come from the tensor maps ql_map [B S H, 512] and qp_map [B S H, 64] (rows
// past the batch row are dead: read, never written), the keys from kl_map
// [B, S, 512] and kp_map [B, S, 64] (3D, so keys past the batch row's end
// read as zeros), 64 keys a chunk.
__global__ void __launch_bounds__(NTHREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap ql_map,
               const __grid_constant__ CUtensorMap qp_map,
               const __grid_constant__ CUtensorMap kl_map,
               const __grid_constant__ CUtensorMap kp_map, bf16* __restrict__ out,
               float* __restrict__ lse, int batch, int seq, int heads, float sm_scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + RED_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BARS_OFF);
  uint64_t* empty = full + 2;
  uint64_t* qbar = full + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = seq * heads, b = blockIdx.x % batch;
  const int f0 = ((n + M - 1) / M - 1 - (int)(blockIdx.x / batch)) * M;
  const int kend = (min(f0 + M, n) - 1) / heads + 1;  // keys 0 .. the last row's token

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      wg::mbar_init(&full[i], 1);
      wg::mbar_init(&empty[i], CONSUMERS / 32);
    }
    wg::mbar_init(qbar, 1);
  }
  __syncthreads();
  const int row0 = b * n + f0;                        // the block's first flat row

  if (warp < PRODUCERS / 32) {  // the producer: one thread issues the boxes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      wg::mbar_expect_tx(qbar, STAGE);
#pragma unroll
      for (int cb = 0; cb < LAT_BOXES; ++cb)
        wg::tma_load_2d(smem + Q_OFF + cb * BOX, &ql_map, cb * 64, row0, qbar);
      wg::tma_load_2d(smem + Q_OFF + LAT_BOXES * BOX, &qp_map, 0, row0, qbar);
      wg::mbar_arrive(qbar);
      for (int it = 0, k0 = 0; k0 < kend; ++it, k0 += CHUNK) {
        const int st = it & 1;
        if (it >= 2) wg::mbar_wait(&empty[st], ((it >> 1) - 1) & 1);
        unsigned char* stage = smem + STAGES_OFF + st * STAGE;
        wg::mbar_expect_tx(&full[st], STAGE);
#pragma unroll
        for (int cb = 0; cb < LAT_BOXES; ++cb)
          wg::tma_load_3d(stage + cb * BOX, &kl_map, cb * 64, k0, b, &full[st]);
        wg::tma_load_3d(stage + LAT_BOXES * BOX, &kp_map, 0, k0, b, &full[st]);
        wg::mbar_arrive(&full[st]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int ctid = tid - PRODUCERS, wgi = ctid >> 7, wq = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  wg::mbar_wait(qbar, 0);

  // this thread's rows (r0, r0 + 8): their tokens (-1: dead, past the batch row)
  const int r0 = 16 * wq + g;
  int tok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + r0 + 8 * h;
    tok[h] = f < n ? f / heads : -1;
  }
  const float scale2 = sm_scale * LOG2E;
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  for (int it = 0, k0 = 0; k0 < kend; ++it, k0 += CHUNK) {
    const int st = it & 1;
    const unsigned char* stage = smem + STAGES_OFF + st * STAGE;
    wg::mbar_wait(&full[st], (it >> 1) & 1);

    // S: rows x this warpgroup's 32 keys, over the latent then the rope (both K-major)
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    wg::fence_operands(s);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < DQ / 16; ++ks) {  // 36 steps: 32 over the latent, 4 over the rope
      const uint32_t at = (ks >> 2) * BOX + (ks & 3) * 32;
      wg::mma_m64n32k16<0>(s, wg::desc_sw128(smem + Q_OFF + at, 16, 1024),
                           wg::desc_sw128(stage + at + 32 * wgi * 128, 16, 1024));
    }
    wg::commit();
    wg::wait_all();
    wg::fence_operands(s);

    // causal masks (key <= the row's token), row maxima swapped between the
    // warpgroups, P (rounded to bf16 for PV) and the denominators of the
    // unrounded P.  s[i]: row r0 + 8 ((i / 2) % 2), key 8 (i / 4) + 2 t4 + i % 2
    // of this warpgroup's 32.
    unsigned ok = 0;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int h = (i >> 1) & 1;
      const int kpos = k0 + 32 * wgi + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (kpos <= tok[h]) ok |= 1u << i;
      s[i] = kpos <= tok[h] ? s[i] * scale2 : NEG;
      mx[h] = fmaxf(mx[h], s[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (t4 == 0) red[wgi * M + r0 + 8 * h] = mx[h];
    }
    wg::bar_sync(1, CONSUMERS);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], fmaxf(red[r0 + 8 * h], red[M + r0 + 8 * h]));
      alpha[h] = ex2(m_run[h] - m_new);
      m_run[h] = m_new;
    }
    bf16* pw = reinterpret_cast<bf16*>(smem + P_OFF);
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int h = (i >> 1) & 1;
      const float p0 = (ok >> i) & 1 ? ex2(s[i] - m_run[h]) : 0.f;
      const float p1 = (ok >> (i + 1)) & 1 ? ex2(s[i + 1] - m_run[h]) : 0.f;
      sum[h] += p0 + p1;
      // P [key / 8][row][key % 8]: keys 32 wgi + 8 (i / 4) + 2 t4, + 1
      *reinterpret_cast<__nv_bfloat162*>(pw + ((4 * wgi + (i >> 2)) * M + r0 + 8 * h) * 8 +
                                         2 * t4) = __floats2bfloat162_rn(p0, p1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] *= alpha[(i >> 1) & 1];
    wg::fence_proxy();
    wg::bar_sync(1, CONSUMERS);  // both warpgroups' P

    // O += P V over this warpgroup's 256 columns (V = the latent chunk, MN-major)
    wg::fence_operands(o);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < CHUNK / 16; ++ks)
      wg::mma_m64n256k16<1>(o, wg::desc(smem + P_OFF + ks * 2 * M * 16, M * 16, 128),
                            wg::desc_sw128(stage + 4 * wgi * BOX + 16 * ks * 128, BOX, 1024));
    wg::commit();
    wg::wait_all();
    wg::fence_operands(o);
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[st]);
  }

  // the denominators of both warpgroups' keys; live rows out, and their LSE
  // in natural-log units
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (t4 == 0) red[wgi * M + r0 + 8 * h] = l_run[h];
  wg::bar_sync(1, CONSUMERS);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (tok[h] < 0) continue;
    const int r = r0 + 8 * h;
    const float l = fmaxf(red[r] + red[M + r], 1e-30f);
    bf16* orow = out + (size_t)(row0 + r) * DN + 256 * wgi + 2 * t4;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2 * h] / l, o[4 * i + 2 * h + 1] / l);
    if (wgi == 0 && t4 == 0) lse[row0 + r] = (m_run[h] + log2f(l)) * LN2;
  }
}

}  // namespace k14a

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
// -> bf16 out [B, S, H, 512] and f32 lse [B, S, H].  The four operands start
// 16-byte aligned (TMA).
extern "C" int mla_train_fwd_launch(const void* q_lat, const void* q_pe, const void* k_lat,
                                    const void* k_pe, void* out, void* lse, int batch, int seq,
                                    int heads, float sm_scale, void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return 0;
  CUtensorMap ql_map, qp_map, kl_map, kp_map;
  const uint64_t rows = (uint64_t)batch * seq * heads;
  const uint64_t ql_dims[2] = {DN, rows}, ql_stride[1] = {DN * 2};
  const uint64_t qp_dims[2] = {DR, rows}, qp_stride[1] = {DR * 2};
  const uint64_t kl_dims[3] = {DN, (uint64_t)seq, (uint64_t)batch};
  const uint64_t kl_strides[2] = {DN * 2, (uint64_t)seq * DN * 2};
  const uint64_t kp_dims[3] = {DR, (uint64_t)seq, (uint64_t)batch};
  const uint64_t kp_strides[2] = {DR * 2, (uint64_t)seq * DR * 2};
  const uint32_t box[3] = {64, 64, 1};              // 64 columns x 64 rows (keys)
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int rc = wg::tensor_map(&ql_map, BF16, 2, q_lat, ql_dims, ql_stride, box);
  if (rc == 0) rc = wg::tensor_map(&qp_map, BF16, 2, q_pe, qp_dims, qp_stride, box);
  if (rc == 0) rc = wg::tensor_map(&kl_map, BF16, 3, k_lat, kl_dims, kl_strides, box);
  if (rc == 0) rc = wg::tensor_map(&kp_map, BF16, 3, k_pe, kp_dims, kp_strides, box);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(k14a::fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)k14a::SMEM);
  const unsigned blocks = (unsigned)((seq * heads + k14a::M - 1) / k14a::M) * batch;
  k14a::fwd_kernel<<<blocks, k14a::NTHREADS, k14a::SMEM, (cudaStream_t)stream>>>(
      ql_map, qp_map, kl_map, kp_map, (bf16*)out, (float*)lse, batch, seq, heads, sm_scale);
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
