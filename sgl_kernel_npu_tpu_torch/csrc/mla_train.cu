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
// The three kernels share one body, that of K9b (mla_sparse.cuh) on the
// wgmma.cuh helpers: three warpgroups, warpgroup 0 loading (one thread issues
// TMA boxes of 64 columns x 128 bytes in the 128-byte swizzle into a
// two-stage ring behind full / empty mbarriers), warpgroups 1 and 2
// computing (setmaxnreg 40 / 232), the products on wgmma with f32
// accumulators in registers, P in base 2 (sm_scale log2 e folded into the
// scores, ex2), masked keys weighing 0.  One block an SM (~225 KB of shared
// memory).  A 16-row body of warp-level products ran K14b / K14c first: it
// sent every key through L2 once per 16 rows, staged it through the
// computing threads' registers and wrote P^T / dS^T element by element.
//   K14a: a block owns 64 consecutive flat rows of one batch row (64 heads of
//         one token at H = 128; at fewer heads the rows span tokens, each
//         masking keys past its own) and walks keys 0 .. its last row's token
//         in 64-key chunks, the longest walks launched first.  The keys come
//         as 8 latent boxes and one rope box (3D maps [B, S, .], so keys past
//         the batch row read as zeros), K-major for S.  Q [64, 576] comes
//         first (9 boxes, K-major A) and stays; S on wgmma m64n32k16 over the
//         whole depth (warpgroup g: keys 32 g .. 32 g + 31); an online
//         softmax in registers, the row maxima swapped through shared memory;
//         P rounded to bf16 for PV while the denominator sums the unrounded P
//         (the TPU kernel's probs.astype); O += P V on m64n256k16 (V = the
//         latent chunk, MN-major; warpgroup g: columns 256 g .. + 255).
//         out = acc / max(l, 1e-30), rounded once; lse = m + log(max(l,
//         1e-30)) in natural-log units.  Q 72 KB, two stages of 72 KB, P 8
//         KB.  ops/attention/mla_train.mla_flash_fwd_tiled_plain mirrors it.
//   K14b: K14a's rows and walk, with dO [64, 512] resident beside Q (64 KB)
//         and 32-key chunks (two stages of 36 KB).  Warpgroup 1 computes S =
//         Q K^T (m64n32k16, 576 deep), warpgroup 2 dP = dO K_lat^T (512 deep)
//         at the same time and hands it over through shared memory (8 KB f32,
//         each thread's fragment where its twin reads it); warpgroup 1 forms
//         P = 2^(S sm_scale log2 e - lse log2 e) (0 on dead keys) and dS = P
//         (dP - delta) sm_scale, rounded to bf16 into shared memory as an A
//         operand; then dQ += dS K (the key chunk MN-major): warpgroup 1
//         columns 0 .. 255 (m64n256k16), warpgroup 2 columns 256 .. 511 and
//         the rope 512 .. 575 (m64n256k16 + m64n64k16), which evens their
//         tensor work (S + 256 columns against dP + 320).  dQ is rounded once.
//         One launch; the keys cross L2 once per 64 rows.
//         ops/attention/mla_train.mla_flash_bwd_dq_tiled_plain mirrors it.
//   K14c: the keys are wgmma's M.  Key chunk c (64 keys) of a batch row is
//         seen by its flat rows 64 c H .. S H - 1, tiles of 32 rows from tile
//         2 H c on.  Every chunk re-reads those Q / dO rows (Σ_c (S - 64 c) H
//         rows of 2176 bytes: 1.3 GB at B 2 x S 520 x 128 heads, far past the
//         L2), so the rows are cut into bands of 2 H / u tiles (every chunk
//         starts on a band's edge), and a block owns one item: a band
//         against one chunk that sees it.  Items run band after band, so the
//         chunks of one band walk its tiles side by side and the L2 serves
//         all but the first (u from the wrapper: at least 4 items an SM).
//         The key chunk [64, 576] is resident (9 boxes, 72 KB), each tile's
//         Q [32, 576] and dO [32, 512] arrive by TMA into a ring of two 68 KB
//         stages.  Warpgroup 1 computes S^T = K Q^T, warpgroup 2 dP^T = K_lat
//         dO^T (m64n32k16; both operands K-major), handed over as in K14b;
//         warpgroup 1 forms P^T and dS^T (the tile's LSE and delta read per
//         column) and stores both rounded to bf16 as A operands: the
//         accumulator's [key][row] layout is the A layout, so no element
//         moves across threads.  Then dK += dS^T Q and dK_lat += P^T dO with
//         the same tiles read MN-major: warpgroup 1 columns 0 .. 255,
//         warpgroup 2 256 .. 511 and the rope (S^T + 2 x 256 columns against
//         dP^T + 2 x 256 + 64).  Each item writes its f32 [64, 576] partial to
//         its own slot; a second kernel adds a chunk's partials in band order
//         and rounds once.  Two launches, no atomics: the sums' order is
//         fixed by the shapes and u.
//         ops/attention/mla_train.mla_flash_bwd_dk_tiled_plain mirrors it.
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int DN = 512;                  // latent (nope) width, also V's
constexpr int DR = 64;                   // rope width
constexpr int DQ = DN + DR;
constexpr float NEG = -1e30f;
constexpr int PRODUCERS = 128;           // warpgroup 0 loads,
constexpr int CONSUMERS = 256;           // warpgroups 1 and 2 compute
constexpr int NTHREADS = PRODUCERS + CONSUMERS;
constexpr int LAT_BOXES = DN / 64;       // a row's latent: 8 boxes of 64 columns
constexpr int BOXES = LAT_BOXES + 1;     // + the rope box
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// K14a: forward
// ---------------------------------------------------------------------------

namespace k14a {

constexpr int M = 64;                    // flat rows a block
constexpr int CHUNK = 64;                // keys a staged chunk
constexpr int BOX = CHUNK * 128;         // bytes of a TMA box: 64 keys x 128 bytes
constexpr uint32_t STAGE = (LAT_BOXES + 1) * BOX;   // + the rope box: 72 KB
constexpr uint32_t Q_OFF = 0;                       // 9 boxes of [64 rows][128 bytes]: 72 KB
constexpr uint32_t STAGES_OFF = Q_OFF + STAGE;
constexpr uint32_t P_OFF = STAGES_OFF + 2 * STAGE;  // [8][64][8] bf16
constexpr uint32_t RED_OFF = P_OFF + M * CHUNK * 2; // [2][64] f32 row exchange
constexpr uint32_t BARS_OFF = RED_OFF + 2 * M * 4;  // full[2], empty[2], q
constexpr uint32_t SMEM = BARS_OFF + 5 * 8;
static_assert(SMEM <= 232448, "K14a's shared memory exceeds a block's 227 KB");

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

namespace k14b {

constexpr int M = 64;                    // flat rows a block
constexpr int KC = 32;                   // keys a staged chunk
constexpr int QBOX = M * 128;            // a box of Q or dO: 64 rows x 128 bytes
constexpr int KBOX = KC * 128;           // a box of keys: 32 keys x 128 bytes
constexpr uint32_t Q_OFF = 0;                              // 9 boxes: 72 KB
constexpr uint32_t DO_OFF = Q_OFF + BOXES * QBOX;          // 8 boxes: 64 KB
constexpr uint32_t STAGE = BOXES * KBOX;                   // a key chunk: 36 KB
constexpr uint32_t STAGES_OFF = DO_OFF + LAT_BOXES * QBOX;
constexpr uint32_t DS_OFF = STAGES_OFF + 2 * STAGE;        // dS bf16 [4][64][8]
constexpr uint32_t XP_OFF = DS_OFF + M * KC * 2;           // dP f32 [8][128] float2
constexpr uint32_t BARS_OFF = XP_OFF + M * KC * 4;         // full[2], empty[2], q
constexpr uint32_t SMEM = BARS_OFF + 5 * 8;
static_assert(SMEM <= 232448, "K14b's shared memory exceeds a block's 227 KB");

// The consumers' shared state: the stage ring and this thread's two rows.
struct Rows {
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  int kend, lane, c128, r0;
  int tok[2];                            // the rows' tokens (-1: dead)
};

// Warpgroup 1: S, P, dS, and dQ columns 0 .. 255.
__device__ __forceinline__ void dq_scores(const Rows& w, const float (&lse2)[2],
                                          const float (&dl)[2], float scale2, float sm_scale,
                                          bf16* __restrict__ dql, size_t row0) {
  unsigned char* smem = w.smem;
  const int t4 = w.lane & 3;
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  for (int it = 0, k0 = 0; k0 < w.kend; ++it, k0 += KC) {
    const int st = it & 1;
    const unsigned char* stage = smem + STAGES_OFF + st * STAGE;
    wg::mbar_wait(&w.full[st], (it >> 1) & 1);
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    wg::fence_operands(s);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < DQ / 16; ++ks) {   // 36 steps: 32 over the latent, 4 over the rope
      const uint32_t c = (ks & 3) * 32;
      wg::mma_m64n32k16<0>(s, wg::desc_sw128(smem + Q_OFF + (ks >> 2) * QBOX + c, 16, 1024),
                           wg::desc_sw128(stage + (ks >> 2) * KBOX + c, 16, 1024));
    }
    wg::commit();
    wg::wait_all();
    wg::fence_operands(s);
    wg::bar_sync(1, CONSUMERS);            // dP handed over
    // s[i]: row r0 + 8 h (h = (i / 2) % 2), key k0 + 8 (i / 4) + 2 t4 + i % 2
    const float2* xp = reinterpret_cast<const float2*>(smem + XP_OFF);
    bf16* ds = reinterpret_cast<bf16*>(smem + DS_OFF);
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int h = (i >> 1) & 1, key = k0 + 8 * (i >> 2) + 2 * t4;
      const float2 dp = xp[(i >> 1) * 128 + w.c128];
      const float p0 = key <= w.tok[h] ? ex2(s[i] * scale2 - lse2[h]) : 0.f;
      const float p1 = key + 1 <= w.tok[h] ? ex2(s[i + 1] * scale2 - lse2[h]) : 0.f;
      // dS [key / 8][row][key % 8]: an A operand of 64 rows x 32 keys
      *reinterpret_cast<__nv_bfloat162*>(ds + ((i >> 2) * M + w.r0 + 8 * h) * 8 + 2 * t4) =
          __floats2bfloat162_rn(p0 * (dp.x - dl[h]) * sm_scale, p1 * (dp.y - dl[h]) * sm_scale);
    }
    wg::fence_proxy();
    wg::bar_sync(1, CONSUMERS);            // dS in shared memory
    wg::fence_operands(o);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
      wg::mma_m64n256k16<1>(o, wg::desc(smem + DS_OFF + ks * 2 * M * 16, M * 16, 128),
                            wg::desc_sw128(stage + 16 * ks * 128, KBOX, 1024));
    wg::commit();
    wg::wait_all();
    wg::fence_operands(o);
    __syncwarp();
    if (w.lane == 0) wg::mbar_arrive(&w.empty[st]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (w.tok[h] < 0) continue;
    bf16* orow = dql + (row0 + w.r0 + 8 * h) * DN + 2 * t4;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2 * h], o[4 * i + 2 * h + 1]);
  }
}

// Warpgroup 2: dP, and dQ columns 256 .. 511 and the rope.
__device__ __forceinline__ void dq_grads(const Rows& w, bf16* __restrict__ dql,
                                         bf16* __restrict__ dqp, size_t row0) {
  unsigned char* smem = w.smem;
  const int t4 = w.lane & 3;
  float o[128], orope[32];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) orope[i] = 0.f;
  for (int it = 0, k0 = 0; k0 < w.kend; ++it, k0 += KC) {
    const int st = it & 1;
    const unsigned char* stage = smem + STAGES_OFF + st * STAGE;
    wg::mbar_wait(&w.full[st], (it >> 1) & 1);
    float dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dp[i] = 0.f;
    wg::fence_operands(dp);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < DN / 16; ++ks) {   // 32 steps over the latent
      const uint32_t c = (ks & 3) * 32;
      wg::mma_m64n32k16<0>(dp, wg::desc_sw128(smem + DO_OFF + (ks >> 2) * QBOX + c, 16, 1024),
                           wg::desc_sw128(stage + (ks >> 2) * KBOX + c, 16, 1024));
    }
    wg::commit();
    wg::wait_all();
    wg::fence_operands(dp);
    float2* xp = reinterpret_cast<float2*>(smem + XP_OFF);
#pragma unroll
    for (int i = 0; i < 16; i += 2) xp[(i >> 1) * 128 + w.c128] = make_float2(dp[i], dp[i + 1]);
    wg::bar_sync(1, CONSUMERS);            // dP handed over
    wg::bar_sync(1, CONSUMERS);            // dS in shared memory
    wg::fence_operands(o);
    wg::fence_operands(orope);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const uint64_t a = wg::desc(smem + DS_OFF + ks * 2 * M * 16, M * 16, 128);
      wg::mma_m64n256k16<1>(o, a, wg::desc_sw128(stage + 4 * KBOX + 16 * ks * 128, KBOX, 1024));
      wg::mma_m64n64k16<1>(orope, a,
                           wg::desc_sw128(stage + LAT_BOXES * KBOX + 16 * ks * 128, KBOX, 1024));
    }
    wg::commit();
    wg::wait_all();
    wg::fence_operands(o);
    wg::fence_operands(orope);
    __syncwarp();
    if (w.lane == 0) wg::mbar_arrive(&w.empty[st]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (w.tok[h] < 0) continue;
    const size_t f = row0 + w.r0 + 8 * h;
    bf16* orow = dql + f * DN + 256 + 2 * t4;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2 * h], o[4 * i + 2 * h + 1]);
    bf16* prow = dqp + f * DR + 2 * t4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(prow + 8 * i) =
          __floats2bfloat162_rn(orope[4 * i + 2 * h], orope[4 * i + 2 * h + 1]);
  }
}

// Block j of a 1D grid: batch row j % B, flat rows f0 .. f0 + 63 of it, the
// longest walks first (K14a's rows).  Q and dO from ql_map / qp_map / do_map
// (2D [B S H, .], boxes of 64 rows), keys from kl_map / kp_map (3D [B, S, .],
// boxes of 32 keys).
__global__ void __launch_bounds__(NTHREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap ql_map,
              const __grid_constant__ CUtensorMap qp_map,
              const __grid_constant__ CUtensorMap do_map,
              const __grid_constant__ CUtensorMap kl_map,
              const __grid_constant__ CUtensorMap kp_map, const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dql, bf16* __restrict__ dqp,
              int batch, int seq, int heads, float sm_scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
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
      wg::mbar_expect_tx(qbar, (BOXES + LAT_BOXES) * QBOX);
#pragma unroll
      for (int cb = 0; cb < LAT_BOXES; ++cb) {
        wg::tma_load_2d(smem + Q_OFF + cb * QBOX, &ql_map, cb * 64, row0, qbar);
        wg::tma_load_2d(smem + DO_OFF + cb * QBOX, &do_map, cb * 64, row0, qbar);
      }
      wg::tma_load_2d(smem + Q_OFF + LAT_BOXES * QBOX, &qp_map, 0, row0, qbar);
      wg::mbar_arrive(qbar);
      for (int it = 0, k0 = 0; k0 < kend; ++it, k0 += KC) {
        const int st = it & 1;
        if (it >= 2) wg::mbar_wait(&empty[st], ((it >> 1) - 1) & 1);
        unsigned char* stage = smem + STAGES_OFF + st * STAGE;
        wg::mbar_expect_tx(&full[st], STAGE);
#pragma unroll
        for (int cb = 0; cb < LAT_BOXES; ++cb)
          wg::tma_load_3d(stage + cb * KBOX, &kl_map, cb * 64, k0, b, &full[st]);
        wg::tma_load_3d(stage + LAT_BOXES * KBOX, &kp_map, 0, k0, b, &full[st]);
        wg::mbar_arrive(&full[st]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int ctid = tid - PRODUCERS, wgi = ctid >> 7;
  Rows w{smem, full, empty, kend, lane, ctid & 127, 16 * (warp & 3) + (lane >> 2), {-1, -1}};
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + w.r0 + 8 * h;
    const bool live = f < n;
    w.tok[h] = live ? f / heads : -1;
    lse2[h] = live ? lse[row0 + w.r0 + 8 * h] * LOG2E : 0.f;
    dl[h] = live ? delta[row0 + w.r0 + 8 * h] : 0.f;
  }
  wg::mbar_wait(qbar, 0);
  if (wgi == 0)
    dq_scores(w, lse2, dl, sm_scale * LOG2E, sm_scale, dql, row0);
  else
    dq_grads(w, dql, dqp, row0);
}

}  // namespace k14b

// ---------------------------------------------------------------------------
// K14c: dK (dK_lat collects dK and dV): f32 partials a (block, key chunk), then a sum
// ---------------------------------------------------------------------------

namespace k14c {

constexpr int KC = 64;                   // keys a chunk (wgmma's M)
constexpr int RT = 32;                   // flat rows a tile
constexpr int KBOX = KC * 128;           // a box of keys: 64 keys x 128 bytes
constexpr int RBOX = RT * 128;           // a box of Q or dO: 32 rows x 128 bytes
constexpr uint32_t K_OFF = 0;                              // 9 boxes: 72 KB
constexpr uint32_t STAGE = (BOXES + LAT_BOXES) * RBOX;     // Q 9 boxes, dO 8: 68 KB
constexpr uint32_t STAGES_OFF = K_OFF + BOXES * KBOX;
constexpr uint32_t PT_OFF = STAGES_OFF + 2 * STAGE;        // P^T bf16 [4][64][8]
constexpr uint32_t DST_OFF = PT_OFF + KC * RT * 2;         // dS^T bf16 [4][64][8]
constexpr uint32_t XP_OFF = DST_OFF + KC * RT * 2;         // dP^T f32 [8][128] float2
constexpr uint32_t BARS_OFF = XP_OFF + KC * RT * 4;        // full[2], empty[2], kfull
constexpr uint32_t SMEM = BARS_OFF + 5 * 8;
static_assert(SMEM <= 232448, "K14c's shared memory exceeds a block's 227 KB");

// The items of a batch row.  Its flat rows form tiles of 32 (ts =
// cdiv(S H, 32) of them); key chunk c is seen by tiles 2 H c .. ts - 1.  The
// tiles are cut into bands of L = 2 H / u tiles (u divides 2 H, so every
// chunk starts on a band's edge); band j is seen by chunks 0 .. j / u, and
// item (j, c) is chunk c against band j's tiles.  Items are numbered band
// after band, chunk after chunk: band j's first item is
// first(j) = u q (q + 1) / 2 + r (q + 1) for j = q u + r.
struct Plan {
  int heads, u, band, nb;                // band = L tiles, nb = cdiv(ts, L) bands
  int ts, items;                         // tiles and items of a batch row
  __host__ __device__ Plan(int s, int h, int u_)
      : heads(h), u(u_), band(2 * h / u_), nb(0), ts((s * h + RT - 1) / RT) {
    nb = (ts + band - 1) / band;
    items = first(nb);
  }
  __host__ __device__ int first(int j) const {
    const int q = j / u, r = j % u;
    return u * q * (q + 1) / 2 + r * (q + 1);
  }
};

struct Walk {
  unsigned char* smem;
  uint64_t *full, *empty, *kfull;
  const float* lse;
  const float* delta;
  float* part;                            // this item's [64][576] f32 partial
  int b, c, t0, t1;                       // batch row, key chunk, tiles [t0, t1)
  int n, heads, lane, c128, r0;
};

// The accumulator's [64 keys][N / 2] f32 piece at column col0 into the partial.
template <int N>
__device__ __forceinline__ void flush(const Walk& w, const float (&acc)[N], int col0) {
  float* base = w.part + col0 + 2 * (w.lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = base + (size_t)(w.r0 + 8 * h) * DQ;
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      *reinterpret_cast<float2*>(row + 8 * i) = make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
}

// Warpgroup 1: S^T, P^T, dS^T, and dK columns 0 .. 255.
__device__ __forceinline__ void dk_scores(const Walk& w, float scale2, float sm_scale) {
  unsigned char* smem = w.smem;
  const int t4 = w.lane & 3, key = KC * w.c + w.r0;   // this thread's keys: key, key + 8
  const size_t g0 = (size_t)w.b * w.n;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  wg::mbar_wait(w.kfull, 0);
  for (int t = w.t0, it = 0; t < w.t1; ++t, ++it) {
    // this thread's 8 rows of the tile: 8 (e / 2) + 2 t4 + e % 2
    int tok[8];
    float lse2[8], dl[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int f = RT * t + 8 * (e >> 1) + 2 * t4 + (e & 1);
      const bool live = f < w.n;
      tok[e] = live ? f / w.heads : -1;
      lse2[e] = live ? w.lse[g0 + f] * LOG2E : 0.f;
      dl[e] = live ? w.delta[g0 + f] : 0.f;
    }
    const int st = it & 1;
    const unsigned char* stage = smem + STAGES_OFF + st * STAGE;
    wg::mbar_wait(&w.full[st], (it >> 1) & 1);
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    wg::fence_operands(s);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < DQ / 16; ++ks) {   // 36 steps: 32 over the latent, 4 over the rope
      const uint32_t c = (ks & 3) * 32;
      wg::mma_m64n32k16<0>(s, wg::desc_sw128(smem + K_OFF + (ks >> 2) * KBOX + c, 16, 1024),
                           wg::desc_sw128(stage + (ks >> 2) * RBOX + c, 16, 1024));
    }
    wg::commit();
    wg::wait_all();
    wg::fence_operands(s);
    wg::bar_sync(1, CONSUMERS);            // dP^T handed over
    // s[i]: key + 8 h (h = (i / 2) % 2), row 8 (i / 4) + 2 t4 + i % 2
    const float2* xp = reinterpret_cast<const float2*>(smem + XP_OFF);
    bf16* pt = reinterpret_cast<bf16*>(smem + PT_OFF);
    bf16* dst = reinterpret_cast<bf16*>(smem + DST_OFF);
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int h = (i >> 1) & 1, e = 2 * (i >> 2);
      const float2 dp = xp[(i >> 1) * 128 + w.c128];
      const float p0 = key + 8 * h <= tok[e] ? ex2(s[i] * scale2 - lse2[e]) : 0.f;
      const float p1 = key + 8 * h <= tok[e + 1] ? ex2(s[i + 1] * scale2 - lse2[e + 1]) : 0.f;
      // [row / 8][key][row % 8]: A operands of 64 keys x 32 rows
      const int at = ((i >> 2) * KC + w.r0 + 8 * h) * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(pt + at) = __floats2bfloat162_rn(p0, p1);
      *reinterpret_cast<__nv_bfloat162*>(dst + at) = __floats2bfloat162_rn(
          p0 * (dp.x - dl[e]) * sm_scale, p1 * (dp.y - dl[e + 1]) * sm_scale);
    }
    wg::fence_proxy();
    wg::bar_sync(1, CONSUMERS);            // P^T, dS^T in shared memory
    wg::fence_operands(acc);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < RT / 16; ++ks) {
      wg::mma_m64n256k16<1>(acc, wg::desc(smem + DST_OFF + ks * 2 * KC * 16, KC * 16, 128),
                            wg::desc_sw128(stage + 16 * ks * 128, RBOX, 1024));
      wg::mma_m64n256k16<1>(acc, wg::desc(smem + PT_OFF + ks * 2 * KC * 16, KC * 16, 128),
                            wg::desc_sw128(stage + BOXES * RBOX + 16 * ks * 128, RBOX, 1024));
    }
    wg::commit();
    wg::wait_all();
    wg::fence_operands(acc);
    __syncwarp();
    if (w.lane == 0) wg::mbar_arrive(&w.empty[st]);
  }
  flush(w, acc, 0);
}

// Warpgroup 2: dP^T, and dK columns 256 .. 511 and the rope.
__device__ __forceinline__ void dk_grads(const Walk& w) {
  unsigned char* smem = w.smem;
  float acc[128], arope[32];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) arope[i] = 0.f;
  wg::mbar_wait(w.kfull, 0);
  for (int t = w.t0, it = 0; t < w.t1; ++t, ++it) {
    const int st = it & 1;
    const unsigned char* stage = smem + STAGES_OFF + st * STAGE;
    wg::mbar_wait(&w.full[st], (it >> 1) & 1);
    float dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dp[i] = 0.f;
    wg::fence_operands(dp);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < DN / 16; ++ks) {   // 32 steps over the latent
      const uint32_t c = (ks & 3) * 32;
      wg::mma_m64n32k16<0>(dp, wg::desc_sw128(smem + K_OFF + (ks >> 2) * KBOX + c, 16, 1024),
                           wg::desc_sw128(stage + (BOXES + (ks >> 2)) * RBOX + c, 16, 1024));
    }
    wg::commit();
    wg::wait_all();
    wg::fence_operands(dp);
    float2* xp = reinterpret_cast<float2*>(smem + XP_OFF);
#pragma unroll
    for (int i = 0; i < 16; i += 2) xp[(i >> 1) * 128 + w.c128] = make_float2(dp[i], dp[i + 1]);
    wg::bar_sync(1, CONSUMERS);            // dP^T handed over
    wg::bar_sync(1, CONSUMERS);            // P^T, dS^T in shared memory
    wg::fence_operands(acc);
    wg::fence_operands(arope);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < RT / 16; ++ks) {
      const uint64_t ds = wg::desc(smem + DST_OFF + ks * 2 * KC * 16, KC * 16, 128);
      const uint64_t pt = wg::desc(smem + PT_OFF + ks * 2 * KC * 16, KC * 16, 128);
      wg::mma_m64n256k16<1>(acc, ds, wg::desc_sw128(stage + 4 * RBOX + 16 * ks * 128, RBOX, 1024));
      wg::mma_m64n64k16<1>(arope, ds,
                           wg::desc_sw128(stage + LAT_BOXES * RBOX + 16 * ks * 128, RBOX, 1024));
      wg::mma_m64n256k16<1>(acc, pt, wg::desc_sw128(stage + (BOXES + 4) * RBOX + 16 * ks * 128,
                                                    RBOX, 1024));
    }
    wg::commit();
    wg::wait_all();
    wg::fence_operands(acc);
    wg::fence_operands(arope);
    __syncwarp();
    if (w.lane == 0) wg::mbar_arrive(&w.empty[st]);
  }
  flush(w, acc, 256);
  flush(w, arope, DN);
}

// Block i of a 1D grid is item i % items of batch row i / items (Plan); it
// writes its f32 partial to part[i].  Q and dO tiles from ql_map / qp_map /
// do_map (2D [B S H, .], boxes of 32 rows; rows past the batch row are dead:
// read, never used), the key chunk from kl_map / kp_map (3D [B, S, .], boxes
// of 64 keys).
__global__ void __launch_bounds__(NTHREADS, 1)
    dk_kernel(const __grid_constant__ CUtensorMap ql_map,
              const __grid_constant__ CUtensorMap qp_map,
              const __grid_constant__ CUtensorMap do_map,
              const __grid_constant__ CUtensorMap kl_map,
              const __grid_constant__ CUtensorMap kp_map, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ part, int seq, int heads,
              int u, float sm_scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BARS_OFF);
  uint64_t* empty = full + 2;
  uint64_t* kfull = full + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Plan pl(seq, heads, u);
  const int b = blockIdx.x / pl.items, p = blockIdx.x % pl.items;
  int q = 0;                                          // the item's band j = q u + r, chunk c
  while (u * (q + 1) * (q + 2) / 2 <= p) ++q;
  const int r = (p - u * q * (q + 1) / 2) / (q + 1), c = (p - u * q * (q + 1) / 2) % (q + 1);
  const int j = q * u + r, t0 = j * pl.band, t1 = min(t0 + pl.band, pl.ts);
  const int n = seq * heads;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      wg::mbar_init(&full[i], 1);
      wg::mbar_init(&empty[i], CONSUMERS / 32);
    }
    wg::mbar_init(kfull, 1);
  }
  __syncthreads();

  if (warp < PRODUCERS / 32) {  // the producer: one thread issues the boxes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      wg::mbar_expect_tx(kfull, BOXES * KBOX);
#pragma unroll
      for (int cb = 0; cb < LAT_BOXES; ++cb)
        wg::tma_load_3d(smem + K_OFF + cb * KBOX, &kl_map, cb * 64, KC * c, b, kfull);
      wg::tma_load_3d(smem + K_OFF + LAT_BOXES * KBOX, &kp_map, 0, KC * c, b, kfull);
      wg::mbar_arrive(kfull);
      for (int t = t0, it = 0; t < t1; ++t, ++it) {
        const int st = it & 1;
        if (it >= 2) wg::mbar_wait(&empty[st], ((it >> 1) - 1) & 1);
        unsigned char* stage = smem + STAGES_OFF + st * STAGE;
        const int row = b * n + RT * t;
        wg::mbar_expect_tx(&full[st], STAGE);
#pragma unroll
        for (int cb = 0; cb < LAT_BOXES; ++cb) {
          wg::tma_load_2d(stage + cb * RBOX, &ql_map, cb * 64, row, &full[st]);
          wg::tma_load_2d(stage + (BOXES + cb) * RBOX, &do_map, cb * 64, row, &full[st]);
        }
        wg::tma_load_2d(stage + LAT_BOXES * RBOX, &qp_map, 0, row, &full[st]);
        wg::mbar_arrive(&full[st]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int ctid = tid - PRODUCERS, wgi = ctid >> 7;
  const Walk w{smem, full, empty, kfull, lse, delta, part + (size_t)blockIdx.x * KC * DQ,
               b, c, t0, t1, n, heads, lane, ctid & 127, 16 * (warp & 3) + (lane >> 2)};
  if (wgi == 0)
    dk_scores(w, sm_scale * LOG2E, sm_scale);
  else
    dk_grads(w);
}

// dK = the partials of the key's chunk c against bands u c .. nb - 1, added
// in band order, rounded once: one thread an element of [B, S, 576].
__global__ void dk_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dkl,
                              bf16* __restrict__ dkp, int batch, int seq, int heads, int u) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)batch * seq * DQ) return;
  const Plan pl(seq, heads, u);
  const size_t key = i / DQ;                                 // b S + t
  const int col = (int)(i % DQ), b = (int)(key / seq), t = (int)(key % seq), c = t / KC;
  const float* src = part + ((size_t)b * pl.items + c) * KC * DQ + (size_t)(t % KC) * DQ + col;
  float s = 0.f;
  for (int j = u * c; j < pl.nb; ++j) s += src[(size_t)pl.first(j) * KC * DQ];
  if (col < DN)
    dkl[key * DN + col] = __float2bfloat16(s);
  else
    dkp[key * DR + col - DN] = __float2bfloat16(s);
}

}  // namespace k14c

}  // namespace

namespace {

constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// Maps of the rows q_lat / dout [B S H, 512] and q_pe [B S H, 64] in boxes of
// `rows` rows, and of the keys k_lat [B, S, 512], k_pe [B, S, 64] (3D: keys
// past a batch row read as zeros) in boxes of `keys` keys; 64 columns a box,
// the 128-byte swizzle.  0 or a CUDA error.
int row_maps(CUtensorMap* ql, CUtensorMap* qp, CUtensorMap* dm, const void* q_lat,
             const void* q_pe, const void* dout, uint64_t rows_total, uint32_t rows) {
  const uint64_t ql_dims[2] = {DN, rows_total}, ql_stride[1] = {DN * 2};
  const uint64_t qp_dims[2] = {DR, rows_total}, qp_stride[1] = {DR * 2};
  const uint32_t box[2] = {64, rows};
  int rc = wg::tensor_map(ql, BF16, 2, q_lat, ql_dims, ql_stride, box);
  if (rc == 0) rc = wg::tensor_map(qp, BF16, 2, q_pe, qp_dims, qp_stride, box);
  if (rc == 0 && dm != nullptr) rc = wg::tensor_map(dm, BF16, 2, dout, ql_dims, ql_stride, box);
  return rc;
}

int key_maps(CUtensorMap* kl, CUtensorMap* kp, const void* k_lat, const void* k_pe, int batch,
             int seq, uint32_t keys) {
  const uint64_t kl_dims[3] = {DN, (uint64_t)seq, (uint64_t)batch};
  const uint64_t kl_strides[2] = {DN * 2, (uint64_t)seq * DN * 2};
  const uint64_t kp_dims[3] = {DR, (uint64_t)seq, (uint64_t)batch};
  const uint64_t kp_strides[2] = {DR * 2, (uint64_t)seq * DR * 2};
  const uint32_t box[3] = {64, keys, 1};
  int rc = wg::tensor_map(kl, BF16, 3, k_lat, kl_dims, kl_strides, box);
  if (rc == 0) rc = wg::tensor_map(kp, BF16, 3, k_pe, kp_dims, kp_strides, box);
  return rc;
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
  int rc = row_maps(&ql_map, &qp_map, nullptr, q_lat, q_pe, nullptr,
                    (uint64_t)batch * seq * heads, k14a::M);
  if (rc == 0) rc = key_maps(&kl_map, &kp_map, k_lat, k_pe, batch, seq, k14a::CHUNK);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(k14a::fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)k14a::SMEM);
  const unsigned blocks = (unsigned)((seq * heads + k14a::M - 1) / k14a::M) * batch;
  k14a::fwd_kernel<<<blocks, NTHREADS, k14a::SMEM, (cudaStream_t)stream>>>(
      ql_map, qp_map, kl_map, kp_map, (bf16*)out, (float*)lse, batch, seq, heads, sm_scale);
  return (int)cudaGetLastError();
}

// K14a's operands plus bf16 dout (like q_lat) and f32 lse, delta [B, S, H] ->
// bf16 dq_lat, dq_pe (like q_lat, q_pe).  dout starts 16-byte aligned too.
extern "C" int mla_train_bwd_dq_launch(const void* q_lat, const void* q_pe, const void* k_lat,
                                       const void* k_pe, const void* dout, const void* lse,
                                       const void* delta, void* dq_lat, void* dq_pe, int batch,
                                       int seq, int heads, float sm_scale, void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return 0;
  CUtensorMap ql_map, qp_map, do_map, kl_map, kp_map;
  int rc = row_maps(&ql_map, &qp_map, &do_map, q_lat, q_pe, dout,
                    (uint64_t)batch * seq * heads, k14b::M);
  if (rc == 0) rc = key_maps(&kl_map, &kp_map, k_lat, k_pe, batch, seq, k14b::KC);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(k14b::dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)k14b::SMEM);
  const unsigned blocks = (unsigned)((seq * heads + k14b::M - 1) / k14b::M) * batch;
  k14b::dq_kernel<<<blocks, NTHREADS, k14b::SMEM, (cudaStream_t)stream>>>(
      ql_map, qp_map, do_map, kl_map, kp_map, (const float*)lse, (const float*)delta,
      (bf16*)dq_lat, (bf16*)dq_pe, batch, seq, heads, sm_scale);
  return (int)cudaGetLastError();
}

// K14b's inputs, f32 scratch part [B items, 64, 576] -> bf16 dk_lat [B, S,
// 512], dk_pe [B, S, 64]; u (dividing 2 H; ops/attention/mla_train.dk_bands)
// cuts a batch row's tiles into bands of 2 H / u tiles, one item a (band,
// key chunk) that sees it (k14c::Plan).
extern "C" int mla_train_bwd_dk_launch(const void* q_lat, const void* q_pe, const void* k_lat,
                                       const void* k_pe, const void* dout, const void* lse,
                                       const void* delta, void* part, void* dk_lat, void* dk_pe,
                                       int batch, int seq, int heads, int u, float sm_scale,
                                       void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return 0;
  if (u < 1 || (2 * heads) % u != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap ql_map, qp_map, do_map, kl_map, kp_map;
  int rc = row_maps(&ql_map, &qp_map, &do_map, q_lat, q_pe, dout,
                    (uint64_t)batch * seq * heads, k14c::RT);
  if (rc == 0) rc = key_maps(&kl_map, &kp_map, k_lat, k_pe, batch, seq, k14c::KC);
  if (rc != 0) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  cudaFuncSetAttribute(k14c::dk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)k14c::SMEM);
  const k14c::Plan pl(seq, heads, u);
  k14c::dk_kernel<<<(unsigned)(batch * pl.items), NTHREADS, k14c::SMEM, s>>>(
      ql_map, qp_map, do_map, kl_map, kp_map, (const float*)lse, (const float*)delta,
      (float*)part, seq, heads, u, sm_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)batch * seq * DQ;
  k14c::dk_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)part, (bf16*)dk_lat, (bf16*)dk_pe, batch, seq, heads, u);
  return (int)cudaGetLastError();
}
