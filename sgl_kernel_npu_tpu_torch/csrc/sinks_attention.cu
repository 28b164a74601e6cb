// Attention over a paged GQA KV cache, for Hopper: decode with per-head sink
// logits or without (sinks_decode) and varlen causal prefill with sinks or
// without (sinks_prefill).
//
// Replace the TPU kernels (sgl_kernel_npu_tpu/ops/attention/):
//   sinks_attention.py attention_sinks (K12a, _sinks_kernel: grid (token,
//     page), every kv head a step), attention_sinks_packed (K12b,
//     _sinks_packed_kernel over the packed cache) and
//     attention_sinks_prefill_pallas (K12d, _sinks_prefill_kernel: grid
//     (request, kv head, q-chunk, page) over queries scattered to a dense
//     [B, max_q] layout);
//   sinks_flat.py sinks_packed_flat_call (K12c: K12b's function as a flat walk
//     over 8-page super-blocks with a DMA ring);
//   decode_attention.py decode_gqa (K11a, _gqa_kernel: grid (batch, kv head,
//     page)) and decode_gqa_high_performance (K11b, _gqa_flat_kernel: K11a's
//     function as a flat page walk with a DMA ring).
// K11a is K12a without a sink and window; K11b and K12c are TPU schedules of
// K11a's and K12b's functions: all five are sinks_decode.
//
// Layouts are the JAX package's: q [tokens, Hq * D] (q head h reads kv head
// h / G, G = Hq / Hkv; decode_gqa's [B, Hq, D] is the same memory), block
// tables [B, max_pages], sinks [Hq] or null, out [tokens, Hq * D] bf16.
// The caches are bf16 or int8, K and V alike; kv head h's key t on page p
// lies at
//   ((p * Hkv / hpr + h / hpr) * page + t) * hpr * D + (h % hpr) * D:
// hpr = 1 is the plain layout [P, Hkv, page, D], hpr = 2 the packed one
// [P, Hkv / 2, page, 2 D] (pack_kv_sinks: heads 2j and 2j + 1 side by side in
// a row).  The TPU packs to fill its 128 lanes at D = 64 and zero-interleaves
// the queries to match, doubling their work; a contiguous row on the H100 has
// no lane padding, so the packed layout reads the bytes of the plain one and
// is taken by strides, each q head reading only its own kv head.  An int8
// cache holds levels round(x / scale).  Both kernels fold k_scale into q and
// v_scale into the output themselves, with the two roundings of the JAX
// wrappers' fold (q: bf16(f32(q) k_scale); out: bf16(f32(bf16(o)) v_scale)).
// Levels widen to bf16 exactly.
//
// The sink joins the softmax denominator only:
//   m_fin = max(m, sink),  out = acc e^(m - m_fin) / (l e^(m - m_fin) + e^(sink - m_fin));
// without sinks out = acc / max(l, 1e-30).  Each window holds exactly
// `window` keys: a decode token sees positions [ctx - window, ctx), a prefill
// token at qpos sees (qpos - window, qpos]; window 0 is full attention.
//
// Masked scores are the finite -1e30, never -inf: while a row's running max
// is still -1e30, -inf - -inf would be NaN.  Here a masked key weighs 0.  The
// TPU prefill kernel weighs it exp(-1e30 - -1e30) = 1 until the row's first
// live key wipes the sum (alpha = 0); every live row sees its own key, so the
// two agree.  A prefill row past its request's seq_len is dead: the wrapper
// zero-fills the output and the kernel writes live rows only (the TPU kernel
// writes 0 there).
//
// Bound on the H100: decode by bytes (a key is 2 x D x 2 B = 256 B a kv head
// at D = 64 in bf16, half that in int8, read once for the G heads that share
// it); prefill at a 512-row chunk by operations (4 D flops a visible (row,
// key) pair).
//
// Decode design (flash-decoding): one block per (token, kv head, 64 heads of
// the group, split).  A row's keys [lo, hi) (lo the window start, hi its
// context) are cut into splits of `split` keys from lo; the wrapper sizes
// the split from shapes alone (no host sync), so that a decode step's live
// blocks cover the SMs, and a block whose split lies past its row's keys
// exits at once.  A block streams its split in chunks of 64 keys through a
// cp.async ring of 2 to 4 chunks in shared memory (int8 stays int8 there; each
// (D, row tiles) instance takes as many as fit, asserted at compile time).  Its 4
// warps share each chunk: the group's q heads are the rows of mma.sync
// m16n8k16 tiles (bf16 in, f32 accumulate; G < 16 pads the tile, a group
// above 16 takes 2 or 4 tiles, every key read once), Q held as A fragments
// for the whole walk (at D = 256 read from shared memory at each product:
// O alone takes 128 registers a thread there), and each warp takes a slice
// of the chunk's keys with an online softmax of its own; P is rounded to bf16 for P V, the
// denominator takes the f32 P.  The warps' (m, l, o) combine in shared
// memory.  A row of one split writes its output; otherwise each split
// writes its (m, l, o) to scratch and the last to arrive, found by an atomic
// ticket on a per-(row, kv head) counter that it resets, merges them in
// split order (deterministic) and writes the output.  The sink logit joins
// the denominator at the merge; a row with no key writes exactly 0.
//
// Prefill design (Hopper, wgmma.cuh's helpers, as K9b's and K14a's bodies):
// a block owns 64 query rows of one request and kv head, the flat rows f =
// j G + h (token j, head h of the group) from f = r0: a staged chunk of keys
// serves every head of its kv head, at G < 64 a block's rows span tokens and
// each masks its own keys, at G > 64 a token's heads span blocks.  The blocks
// of a request's last rows (the longest walks) launch first; at Llama-3.1-8B's
// group of 4 a 512-row chunk is 256 blocks, two an SM (64-row blocks rather
// than 128 rows on two warpgroups: the 256 blocks fill the 132 SMs in one
// wave).  Warp 4 loads 64-key chunks into a ring of 3 stages of bf16 tiles
// behind full / empty mbarriers: whole pages (a kv head's page is page x D
// contiguous; the packed layout the same rows at a stride of 2 D, one 3D
// tensor map covers both) as TMA boxes into the 128-byte swizzle that wgmma
// reads; pages TMA cannot take (not 8, 16, 32 or a multiple of 64 keys; D =
// 32, whose rows are 64 bytes) by 16-byte cp.async into the same layout.  An
// int8 cache takes a loading warpgroup in its place (setmaxnreg 80, the
// computing one 176): each of its threads copies its own 16-byte pieces of
// levels (half the bytes of bf16) by cp.async 1-3 chunks ahead into a second
// ring, their page-table entries read a copy earlier still (read at the copy,
// their latency stalled the ring), and widens
// the same pieces once a chunk into the bf16 ring, so no thread waits on
// another's copies (off the computing warpgroup's path; the int-to-float unit
// would take 16 values a clock an SM, so widen8 builds them on the integer
// and FMA pipes).  Warpgroup 0 holds Q [64, D] in shared memory for
// the walk (D = 32 padded to 64 with zeros; an int8 cache's k_scale folded
// in as it is loaded) and per chunk: S = Q K^T on wgmma m64n64k16; the
// causal and window masks (none on a chunk that every row of the block sees
// whole); the online softmax in base 2 in registers (scale log2 e fused with
// the running max into one FMA, ex2; a row's 4 lanes reduce by shuffles);
// P rounded to bf16 into the A registers of O += P V (m64nDk16 with A from
// registers, V MN-major; P through shared memory measured slower) while the
// denominator sums the unrounded P; the next chunk's S is issued before this
// chunk's P V, so the two products overlap (not at D = 256, bf16 only: O
// [64, 256] is 128 f32 registers a thread, one block an SM, and S waits for
// its own chunk); then the stage is released.  The
// keys walked run from the block's first row's window start to its last
// live row's causal end (the TPU kernel's page range, at key granularity;
// chunks aligned to 64 keys); V rows past the end are zero.  The output is
// rounded to bf16 once, then (int8) scaled by v_scale and rounded again.
// Queries are read in their packed rows (the JAX wrapper's dense scatter and
// gather are a TPU grid artefact); a request's first row is the sum of the
// seq_lens before it, summed by each block.  ops/attention/sinks_attention.
// attention_sinks_prefill_tiled_plain mirrors this walk on the CPU.
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace sinks {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 2^x on the special-function unit (scores are kept in log2 units: exp(x) =
// 2^(x log2 e), the factor folded into the softmax scale)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

namespace dec {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KT = 64;               // keys a staged chunk
constexpr int HEADS = 64;            // q heads a block at most: 4 row tiles of 16
constexpr int MAX_SPLITS = 32;       // splits of a row at most: the merge takes one a lane
constexpr int SMEM_2 = 113 * 1024;   // shared memory a block when two share an SM
// a block's dynamic shared memory at most: the H100's 227 KB less room for
// the static `last`
constexpr int SMEM_MAX = 227 * 1024 - 64;

// Shared memory of a block, in bytes: the block's q rows as bf16 [16 RT][D +
// 8], then the ring of STAGES (K, V) chunks, [KT][ROW] each in the cache's
// type, rows padded by 16 bytes (the fragment reads of 8 rows hit distinct
// banks).  After the walk the ring holds the warps' (m, l, o), then the
// merge's weights.
template <int D, typename T, int RT>
struct Smem {
  static constexpr int QLD = D + 8;                         // bf16 a q row
  static constexpr int ROW = D * (int)sizeof(T) + 16;       // bytes a staged key row
  static constexpr int CHUNK = KT * ROW;                    // a K or V chunk
  static constexpr int OLD = D + 4;                         // f32 a row of a warp's o
  static constexpr int Q = 16 * RT * QLD * 2;
  // chunks in the ring: 4 (a 256-key split in flight at once) where two
  // blocks still fit an SM, else 3 (bf16 at D = 128; D = 256 up to 32 heads
  // a block), else 2 (D = 256 at 64 heads: 3 would take 236,544 B)
  static constexpr int STAGES = Q + 4 * 2 * CHUNK <= SMEM_2     ? 4
                                : Q + 3 * 2 * CHUNK <= SMEM_MAX ? 3
                                                                : 2;
  static constexpr int RING = STAGES * 2 * CHUNK;
  static constexpr int COMBINE = WARPS * 16 * (2 + OLD) * 4;
  static constexpr int MERGE = 16 * RT * (MAX_SPLITS + 2) * 4;
  static constexpr int TAIL = COMBINE > MERGE ? COMBINE : MERGE;
  static constexpr int BYTES = Q + (RING > TAIL ? RING : TAIL);
  static_assert(BYTES <= SMEM_MAX, "decode: a block's shared memory past the H100's limit");
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The B fragment of S = Q K^T for keys key0 .. key0 + 7 of a staged chunk and
// dimensions 16 kk .. 16 kk + 15: ldmatrix from bf16 rows, or two pairs of
// int8 levels widened to bf16 (exact) in the same layout.
template <typename T, int ROW>
__device__ __forceinline__ void k_frag(uint32_t (&b)[2], const unsigned char* ks, int key0,
                                       int kk, int lane) {
  if constexpr (std::is_same_v<T, bf16>) {
    sgl::ldsm_x2(b, reinterpret_cast<const bf16*>(ks + (key0 + (lane & 7)) * ROW) + kk * 16 +
                        8 * ((lane >> 3) & 1));
  } else {
    const unsigned char* p = ks + (key0 + (lane >> 2)) * ROW + kk * 16 + 2 * (lane & 3);
    const uint32_t w0 = *reinterpret_cast<const uint16_t*>(p);
    const uint32_t w1 = *reinterpret_cast<const uint16_t*>(p + 8);
    b[0] = pack_bf16((float)(int8_t)(w0 & 0xffu), (float)(int8_t)(w0 >> 8));
    b[1] = pack_bf16((float)(int8_t)(w1 & 0xffu), (float)(int8_t)(w1 >> 8));
  }
}

// The B fragment of O += P V for keys key0 .. key0 + 15 and output columns
// n0 .. n0 + 7 (the transposed read of V's rows).
template <typename T, int ROW>
__device__ __forceinline__ void v_frag(uint32_t (&b)[2], const unsigned char* vs, int key0,
                                       int n0, int lane) {
  if constexpr (std::is_same_v<T, bf16>) {
    sgl::ldsm_x2_trans(b, reinterpret_cast<const bf16*>(
                              vs + (key0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ROW) + n0);
  } else {
    const signed char* p = reinterpret_cast<const signed char*>(vs) +
                           (key0 + 2 * (lane & 3)) * ROW + n0 + (lane >> 2);
    b[0] = pack_bf16((float)p[0], (float)p[ROW]);
    b[1] = pack_bf16((float)p[8 * ROW], (float)p[9 * ROW]);
  }
}

// Block (kv head kvh and its heads h0 .. h0 + 63, token tok, split s) walks
// keys [lo + s split, min(lo + (s + 1) split, hi)) of the token's row; see
// the file's head for the design.
template <int D, typename T, int RT>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const bf16* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                  const void* __restrict__ sinks, int sinks_bf16,
                  const float* __restrict__ k_scale, float k_scale_val, int k_scale_step,
                  const float* __restrict__ v_scale, float v_scale_val, int v_scale_step,
                  const int* __restrict__ block_tables, const int* __restrict__ ctx_lens,
                  bf16* __restrict__ out, float* __restrict__ part_o,
                  float2* __restrict__ part_ml, int* __restrict__ tickets, int hkv, int hpr,
                  int group, int page_size, int max_pages, int window, int split,
                  int n_splits, float scale) {
  using L = Smem<D, T, RT>;
  constexpr bool INT8 = std::is_same_v<T, int8_t>;
  constexpr int NS = WARPS / RT;                  // warps (key slices) a row tile
  constexpr int KW = KT / NS;                     // keys a warp a chunk
  constexpr int P16 = D * (int)sizeof(T) / 16;    // 16-byte pieces a key row
  static_assert(KW % 16 == 0 && (KT * P16) % THREADS == 0, "decode tiling");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + L::Q;

  const int zb = gridDim.x / hkv;
  const int kvh = blockIdx.x / zb, h0 = (blockIdx.x % zb) * HEADS;
  const int tok = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nh = min(group - h0, HEADS);
  const size_t head0 = (size_t)tok * hkv * group + kvh * group + h0;   // the block's first head
  const int* bt_row = block_tables + (size_t)tok * max_pages;
  // Thread t copies piece t % P16 of keys t / P16 + KSTEP i of each chunk;
  // pages[] holds their page-table entries, read a step before the copies
  constexpr int NIT = KT * P16 / THREADS, KSTEP = THREADS / P16;
  const int pj = tid / P16, pp = tid % P16;
  const bool pow2 = (page_size & (page_size - 1)) == 0;
  const int shift = __ffs(page_size) - 1;
  auto page_of = [&](int key) { return pow2 ? key >> shift : key / page_size; };
  int pages[NIT];
  const int ctx = ctx_lens[tok];
  const int hi = min(ctx, max_pages * page_size);
  const int lo = window > 0 ? max(ctx - window, 0) : 0;
  const int n_live = lo < hi ? (hi - lo + split - 1) / split : 0;
  if (n_live == 0) {                     // no key to see: exactly 0, from split 0
    if (s == 0)
      for (int i = tid; i < nh * D; i += THREADS) out[head0 * D + i] = __float2bfloat16_rn(0.f);
    return;
  }
  if (s >= n_live) return;
  const int k_begin = lo + s * split, k_end = min(k_begin + split, hi);
  const int n_chunks = (k_end - k_begin + KT - 1) / KT;
  const size_t page_stride = (size_t)hkv * page_size * D;   // elements a page, all kv heads
  const int row_stride = hpr * D;
  const int head_off = (kvh / hpr) * page_size * row_stride + (kvh % hpr) * D;

  // chunk c's K and V rows -> ring stage c % L::STAGES by 16-byte cp.async (keys
  // past the split land as zeros); one commit group a call, empty past the
  // end.  A chunk's page-table entries are read a step before its copies are
  // issued, so their latency overlaps the products rather than the issue.
  auto lookup = [&](int c) {
#pragma unroll
    for (int it = 0; it < NIT; ++it) {
      const int key = k_begin + c * KT + pj + it * KSTEP;
      pages[it] = c < n_chunks && key < k_end ? bt_row[page_of(key)] : 0;
    }
  };
  auto copy = [&](int c) {
    if (c < n_chunks) {
      const int k0 = k_begin + c * KT;
      unsigned char* kd = ring + (c % L::STAGES) * 2 * L::CHUNK + pj * L::ROW + pp * 16;
      unsigned char* vd = kd + L::CHUNK;
#pragma unroll
      for (int it = 0; it < NIT; ++it) {
        const int key = k0 + pj + it * KSTEP;
        const bool live = key < k_end;
        const size_t at = (size_t)pages[it] * page_stride +
                          (head_off + (key - page_of(key) * page_size) * row_stride +
                           pp * (16 / (int)sizeof(T)));
        wg::cp_async16(kd + it * KSTEP * L::ROW, live ? kc + at : kc, live ? 16 : 0);
        wg::cp_async16(vd + it * KSTEP * L::ROW, live ? vc + at : vc, live ? 16 : 0);
      }
    }
    wg::cp_async_commit();
  };
  lookup(0);
#pragma unroll
  for (int c = 0; c < L::STAGES - 1; ++c) {
    copy(c);
    lookup(c + 1);
  }

  // the block's q rows as bf16 (an int8 cache: k_scale folded, rounded to
  // bf16 as the wrappers' fold rounds), rows past its heads 0
  const float ksc = INT8 ? (k_scale != nullptr ? k_scale[kvh * k_scale_step] : k_scale_val) : 1.f;
#pragma unroll
  for (int i = tid; i < 16 * RT * D; i += THREADS) {
    const int r = i / D, c = i % D;
    bf16 v = __float2bfloat16_rn(0.f);
    if (r < nh) {
      v = q[(head0 + r) * D + c];
      if constexpr (INT8) v = __float2bfloat16_rn(__bfloat162float(v) * ksc);
    }
    qs[r * L::QLD + c] = v;
  }
  __syncthreads();
  const int rt = warp % RT, sl = warp / RT;       // the warp's row tile and key slice
  const int g = lane >> 2, t4 = lane & 3;         // mma fragment row / column pair
  // its Q tile as A fragments, held for the walk up to D = 128; at D = 256
  // they would take 64 more registers a thread beside O's 128, so each S
  // product reads them from shared memory
  constexpr bool QREG = D <= 128;
  const bf16* qrow = qs + (16 * rt + (lane & 7) + 8 * ((lane >> 3) & 1)) * L::QLD + 8 * (lane >> 4);
  uint32_t qa[QREG ? D / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) sgl::ldsm_x4(qa[kk], qrow + kk * 16);
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  const int kw0 = sl * KW;                        // the warp's first key of a chunk
  const float scale2 = scale * LOG2E;
  for (int c = 0; c < n_chunks; ++c) {
    copy(c + L::STAGES - 1);
    lookup(c + L::STAGES);
    cp_async_wait<L::STAGES - 1>();
    __syncthreads();
    const unsigned char* kst = ring + (c % L::STAGES) * 2 * L::CHUNK;
    const unsigned char* vst = kst + L::CHUNK;
    const int kpos = k_begin + c * KT + kw0;      // position of the warp's first key

    // S = Q K^T, even and odd depth steps in two accumulators (half the
    // chain of dependent products)
    float sc[KW / 8][4], sd[KW / 8][4];
#pragma unroll
    for (int nt = 0; nt < KW / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = sd[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4];
      if constexpr (!QREG) sgl::ldsm_x4(qf, qrow + kk * 16);
#pragma unroll
      for (int nt = 0; nt < KW / 8; ++nt) {
        uint32_t b[2];
        k_frag<T, L::ROW>(b, kst, kw0 + nt * 8, kk, lane);
        if constexpr (QREG)
          sgl::mma_16816(kk % 2 ? sd[nt] : sc[nt], qa[kk], b);
        else
          sgl::mma_16816(kk % 2 ? sd[nt] : sc[nt], qf, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < KW / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] += sd[nt][e];
    }

    // keys past the split weigh 0; the online softmax of rows g (hr 0) and
    // g + 8 (hr 1) in log2 units, a row's 4 lanes reduced by shuffles
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = NEG;
#pragma unroll
      for (int nt = 0; nt < KW / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = sc[nt][2 * hr + e];
          v = kpos + nt * 8 + 2 * t4 + e < k_end ? v * scale2 : NEG;
          mx = fmaxf(mx, v);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < KW / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = sc[nt][2 * hr + e];
          v = kpos + nt * 8 + 2 * t4 + e < k_end ? ex2(v - m_new) : 0.f;
          sum += v;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[hr] = ex2(m[hr] - m_new);
      l[hr] = l[hr] * alpha[hr] + sum;
      m[hr] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 (the denominator took the f32 P): the S
    // accumulators of key tiles 2 kk and 2 kk + 1 are the A fragment of 16 keys
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t b[2];
        v_frag<T, L::ROW>(b, vst, kw0 + kk * 16, nt * 8, lane);
        sgl::mma_16816(o[nt], a, b);
      }
    }
    __syncthreads();
  }
  wg::cp_async_wait_all();   // the empty groups past the end

  // the warps' (m, l, o) -> shared memory; each row tile's key slices combined
  // in slice order
  float* cm = reinterpret_cast<float*>(ring);   // [WARPS][16] m
  float* cl = cm + WARPS * 16;                   // [WARPS][16] l
  float* co = cl + WARPS * 16;                   // [WARPS][16][OLD] o
  if (t4 == 0) {
    cm[warp * 16 + g] = m[0];
    cm[warp * 16 + g + 8] = m[1];
    cl[warp * 16 + g] = l[0];
    cl[warp * 16 + g + 8] = l[1];
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    *reinterpret_cast<float2*>(co + (warp * 16 + g) * L::OLD + nt * 8 + 2 * t4) =
        make_float2(o[nt][0], o[nt][1]);
    *reinterpret_cast<float2*>(co + (warp * 16 + g + 8) * L::OLD + nt * 8 + 2 * t4) =
        make_float2(o[nt][2], o[nt][3]);
  }
  __syncthreads();

  // the output of head h0 + r from its merged (m, l, o) (m in log2 units):
  // the sink joins the denominator here; an int8 cache's v_scale folds into
  // the bf16 value as the wrappers' fold did
  const float vsc = INT8 ? (v_scale != nullptr ? v_scale[kvh * v_scale_step] : v_scale_val) : 1.f;
  auto finish = [&](float mm, float ll, float oo, int r) {
    float e = 1.f, denom;
    if (sinks != nullptr) {
      const int h = kvh * group + h0 + r;
      const float sink = LOG2E * (sinks_bf16 ? __bfloat162float(static_cast<const bf16*>(sinks)[h])
                                             : static_cast<const float*>(sinks)[h]);
      const float m_fin = fmaxf(mm, sink);
      e = ex2(mm - m_fin);
      denom = ll * e + ex2(sink - m_fin);
    } else {
      denom = fmaxf(ll, 1e-30f);
    }
    const bf16 res = __float2bfloat16_rn(oo * e / denom);
    return INT8 ? __float2bfloat16_rn(__bfloat162float(res) * vsc) : res;
  };

  for (int i = tid; i < nh * D; i += THREADS) {
    const int r = i / D, d = i % D, t = r / 16, lr = r % 16;
    float mm = NEG;
#pragma unroll
    for (int j = 0; j < NS; ++j) mm = fmaxf(mm, cm[(t + RT * j) * 16 + lr]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int w = (t + RT * j) * 16 + lr;
      const float e = ex2(cm[w] - mm);
      ll += cl[w] * e;
      oo += co[w * L::OLD + d] * e;
    }
    if (n_live == 1) {
      out[(head0 + r) * D + d] = finish(mm, ll, oo, r);
    } else {
      const size_t at = (head0 + r) * n_splits + s;
      part_o[at * D + d] = oo;
      if (d == 0) part_ml[at] = make_float2(mm, ll);
    }
  }
  if (n_live == 1) return;

  // several splits: the last to arrive (an atomic ticket on the row's
  // counter, which it resets) merges them all in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(tickets + (size_t)tok * gridDim.x + blockIdx.x, 1);
    last = prev == n_live - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a row's splits one a lane: their max, weights and weighted l (a fixed
  // shuffle order)
  float* wsm = reinterpret_cast<float*>(ring);   // [16 RT][MAX_SPLITS + 2]: w, then m and l
  for (int r = warp; r < nh; r += WARPS) {
    const size_t at = (head0 + r) * n_splits;
    const float2 ml = lane < n_live ? __ldcg(part_ml + at + lane) : make_float2(NEG, 0.f);
    const float mm = sgl::warp_max(ml.x);
    const float w = lane < n_live ? ex2(ml.x - mm) : 0.f;
    const float ll = sgl::warp_sum(ml.y * w);
    wsm[r * (MAX_SPLITS + 2) + lane] = w;
    if (lane == 0) {
      wsm[r * (MAX_SPLITS + 2) + MAX_SPLITS] = mm;
      wsm[r * (MAX_SPLITS + 2) + MAX_SPLITS + 1] = ll;
    }
  }
  __syncthreads();
  for (int i = tid; i < nh * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const float* wr = wsm + r * (MAX_SPLITS + 2);   // 0 past the row's splits
    const float* src = part_o + (head0 + r) * n_splits * D + d;
    float part[MAX_SPLITS];   // all of them in flight at once, then summed in order
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) part[j] = j < n_live ? __ldcg(src + (size_t)j * D) : 0.f;
    float oo = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) oo += wr[j] * part[j];
    out[(head0 + r) * D + d] = finish(wr[MAX_SPLITS], wr[MAX_SPLITS + 1], oo, r);
  }
  if (tid == 0) tickets[(size_t)tok * gridDim.x + blockIdx.x] = 0;
}

}  // namespace dec

// ---------------------------------------------------------------------------
// prefill
// ---------------------------------------------------------------------------

namespace pre {

constexpr int M = 64;                      // query rows a block: one computing warpgroup
constexpr int KC = 64;                     // keys a staged chunk
constexpr int CONSUMERS = 128;             // warpgroup 0 computes, warp 4 loads
constexpr int TILE = M * 128;              // [64][64] bf16 in the 128-byte swizzle: 8 KB

// Shared memory of a block, in bytes: Q as NB tiles of 64 columns; the ring
// of STAGES (K, V) chunks as bf16 tiles (NB swizzled tiles each); for an int8
// cache a second ring of STAGES8 chunks of levels (each thread's pieces at
// 16 e); the full / empty barriers.  Two blocks fit an SM.
template <int D, typename T>
struct Smem {
  static constexpr bool INT8 = std::is_same_v<T, int8_t>;
  static constexpr int DP = D < 64 ? 64 : D;               // tile width: D = 32 pads with zeros
  static constexpr int NB = DP / 64;
  // D = 256 (bf16 only): Q's 32 KB and three 64 KB stages, one block an SM
  static constexpr int MIN_BLOCKS = D == 256 ? 1 : 2;
  static constexpr int STAGES = INT8 && D == 128 ? 2 : 3;
  static constexpr int STAGES8 = INT8 ? (D == 128 ? 2 : 4) : 0;
  static constexpr int WIDENERS = INT8 ? 128 : 0;          // warpgroup 1 widens levels
  static constexpr int THREADS = CONSUMERS + (INT8 ? WIDENERS : 32);
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t RING = Q + NB * TILE;
  static constexpr uint32_t KV = NB * TILE;                // a stage's K, then its V
  static constexpr uint32_t STAGE = 2 * KV;
  static constexpr uint32_t LEVELS = RING + STAGES * STAGE;
  static constexpr uint32_t KV8 = KC * D;                  // a chunk's K levels, then its V
  static constexpr uint32_t BARS = LEVELS + STAGES8 * 2 * KV8;
  static constexpr uint32_t BYTES = BARS + 2 * STAGES * 8;
  static_assert(BYTES <= 227 * 1024, "prefill: a block's shared memory past the H100's limit");
  static_assert(!(INT8 && D == 256), "prefill: no int8 instance at D = 256");
};

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 int8 levels -> 8 bf16, exactly, on the integer and FMA pipes (the
// int-to-float conversion unit takes 16 a clock an SM, too few for a chunk a
// walk step): a level v's byte with its sign bit flipped, v + 128, placed as
// the mantissa of 2^23 (0x4B0000xx), is 2^23 + 128 + v in f32; subtracting
// 2^23 + 128 leaves v exactly, and v's f32 has at most 8 significant bits,
// so its upper half is its bf16.
__device__ __forceinline__ uint4 widen8(uint2 v) {
  const uint32_t w[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = w[i >> 1], j = 2 * (i & 1);
    const float lo = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7650u + j)) - 8388736.f;
    const float hi = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7651u + j)) - 8388736.f;
    o[i] = __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// 8 bf16 times s in f32, rounded back to bf16 (the wrappers' fold of k_scale into q)
__device__ __forceinline__ uint4 scale8(uint4 v, float s) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    w[i] = pack_bf16(f.x * s, f.y * s);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Block (kv head blockIdx.x, flat rows r0 .. r0 + 63 of request blockIdx.z,
// r0 = 64 (gridDim.y - 1 - blockIdx.y): the longest walks first); see the
// file's head for the design.  TMA: the loading warp takes whole pages (or
// 64-key pieces of one) as boxes of kmap / vmap ([P Hkv / hpr, page, hpr D]:
// bf16 boxes of 64 columns in the 128-byte swizzle, int8 boxes of D packed
// bytes); otherwise 16-byte cp.async into the same layouts.
template <int D, typename T, bool TMA>
__global__ void __launch_bounds__(Smem<D, T>::THREADS, Smem<D, T>::MIN_BLOCKS)
    prefill_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ q,
                   const T* __restrict__ kc, const T* __restrict__ vc,
                   const void* __restrict__ sinks, int sinks_bf16,
                   const float* __restrict__ k_scale, float k_scale_val, int k_scale_step,
                   const float* __restrict__ v_scale, float v_scale_val, int v_scale_step,
                   const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
                   const int* __restrict__ ctx_lens, bf16* __restrict__ out, int rows, int hkv,
                   int hpr, int group, int page_size, int max_pages, int window, float scale) {
  using L = Smem<D, T>;
  constexpr int DP = L::DP, NB = L::NB, STAGES = L::STAGES, STAGES8 = L::STAGES8;
  constexpr bool INT8 = L::INT8;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x, b = blockIdx.z, hq = hkv * group;
  int start = 0;   // the request's first packed row: the new tokens of the requests before it
  for (int i = lane; i < b; i += 32) start += seq_lens[i];
  start = warp_sum_int(start);
  if (b == (int)gridDim.z - 1) {   // the blocks past the requests zero the rows past them
    const size_t lo = (size_t)start * hq * D, n = (size_t)rows * hq * D;
    const size_t step = (size_t)gridDim.x * gridDim.y * blockDim.x * 8;
    for (size_t i = lo + ((size_t)(blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + tid) * 8;
         i < n; i += step)
      *reinterpret_cast<uint4*>(out + i) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int r0 = (gridDim.y - 1 - blockIdx.y) * M;
  const int seq_len = seq_lens[b];
  if (r0 >= seq_len * group) return;
  const int pos0 = ctx_lens[b] - seq_len;
  // keys walked: the first row's window start .. the last live row's causal
  // end, in chunks of KC aligned to KC (the pages' boxes)
  const int j_first = r0 / group, j_last = min((r0 + M - 1) / group, seq_len - 1);
  const int k_lo = window > 0 ? max(pos0 + j_first - window + 1, 0) : 0;
  const int k_hi = min(pos0 + j_last + 1, max_pages * page_size);
  const int c_begin = k_lo & ~(KC - 1);
  const int n_chunks = k_hi > c_begin ? (k_hi - c_begin + KC - 1) / KC : 0;
  const int* bt_row = block_tables + (size_t)b * max_pages;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      wg::mbar_init(&full[i], INT8 ? L::WIDENERS : 2 * 32);   // each widening lane once, or
                                                              // each loading lane twice
      wg::mbar_init(&empty[i], CONSUMERS / 32);       // each computing warp once
    }
  }
  __syncthreads();

  if constexpr (INT8) if (warp >= CONSUMERS / 32) {  // the widening warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n");
    const int wl = tid - CONSUMERS;
    const int kvrow = kvh / hpr, col0 = (kvh % hpr) * D;
    const size_t row = (size_t)hpr * D;   // levels a key row
    // the ring zero once: columns past D (D = 32) stay zero, and 0 x Q's
    // zero columns must not meet a stale NaN
    for (int i = wl; i < STAGES * (int)L::STAGE / 16; i += L::WIDENERS)
      reinterpret_cast<uint4*>(smem + L::RING)[i] = make_uint4(0u, 0u, 0u, 0u);
    // thread wl takes pieces e = wl + WIDENERS p of a chunk's K and of its V:
    // 16 levels of key e / P16 at column 16 (e % P16), copied by cp.async
    // STAGES8 - 1 chunks ahead into the levels' ring (zeros past the walk)
    // and widened by the same thread, so that no other thread waits on them
    // The page-table entries of a chunk's pieces are read a copy ahead, so
    // that their latency does not stall the copies.
    constexpr int P16 = D / 16, NP = KC * P16 / L::WIDENERS;
    const bool pow2 = (page_size & (page_size - 1)) == 0;
    const int shift = __ffs(page_size) - 1;
    int pages[NP];
    auto lookup = [&](int it) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int key = c_begin + it * KC + (wl + L::WIDENERS * p) / P16;
        pages[p] = it < n_chunks && key < k_hi ? bt_row[pow2 ? key >> shift : key / page_size] : 0;
      }
    };
    auto copy = [&](int it) {
      unsigned char* k8 = smem + L::LEVELS + (it % STAGES8) * 2 * L::KV8;
      const int c0 = c_begin + it * KC;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int e = wl + L::WIDENERS * p, key = c0 + e / P16;
        const bool live = it < n_chunks && key < k_hi;
        const int in_page = pow2 ? key & (page_size - 1) : key % page_size;
        const size_t at = (((size_t)pages[p] * (hkv / hpr) + kvrow) * page_size + in_page) * row +
                          col0 + (e % P16) * 16;
        wg::cp_async16(k8 + e * 16, live ? kc + at : kc, live ? 16 : 0);
        wg::cp_async16(k8 + L::KV8 + e * 16, live ? vc + at : vc, live ? 16 : 0);
      }
      wg::cp_async_commit();
      lookup(it + 1);
    };
    lookup(0);
#pragma unroll
    for (int it = 0; it < STAGES8 - 1; ++it) copy(it);
    for (int it = 0; it < n_chunks; ++it) {
      copy(it + STAGES8 - 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES8 - 1) : "memory");   // chunk it landed
      const int st = it % STAGES;
      if (it >= STAGES) wg::mbar_wait(&empty[st], (it / STAGES - 1) & 1);
      unsigned char* ks = smem + L::RING + st * L::STAGE;
      unsigned char* vs = ks + L::KV;
      const unsigned char* k8 = smem + L::LEVELS + (it % STAGES8) * 2 * L::KV8;
      // the chunk's levels widened to bf16 (exact) into the tiles' swizzle:
      // a piece's two 16-byte halves, the upper one first where its 64
      // columns are the odd tile, so that each store of 8 lanes (a row of
      // each tile) hits 8 distinct bank groups
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int e = wl + L::WIDENERS * p, kk = e / P16, col = (e % P16) * 16;
        const int p8 = (col % 64) / 8, odd = (col / 64) & 1;
        const uint4 kl = *reinterpret_cast<const uint4*>(k8 + e * 16);
        const uint4 vl = *reinterpret_cast<const uint4*>(k8 + L::KV8 + e * 16);
        unsigned char* kd = ks + (col / 64) * TILE + kk * 128;
        unsigned char* vd = vs + (col / 64) * TILE + kk * 128;
        const uint4 k0 = widen8(make_uint2(kl.x, kl.y)), k1 = widen8(make_uint2(kl.z, kl.w));
        const uint4 v0 = widen8(make_uint2(vl.x, vl.y)), v1 = widen8(make_uint2(vl.z, vl.w));
        *reinterpret_cast<uint4*>(kd + (((p8 + odd) ^ (kk & 7)) << 4)) = odd ? k1 : k0;
        *reinterpret_cast<uint4*>(kd + (((p8 + 1 - odd) ^ (kk & 7)) << 4)) = odd ? k0 : k1;
        *reinterpret_cast<uint4*>(vd + (((p8 + odd) ^ (kk & 7)) << 4)) = odd ? v1 : v0;
        *reinterpret_cast<uint4*>(vd + (((p8 + 1 - odd) ^ (kk & 7)) << 4)) = odd ? v0 : v1;
      }
      wg::mbar_arrive(&full[st]);   // the computing threads fence the proxies
    }
    wg::cp_async_wait_all();   // the empty groups past the end
    return;
  }
  if (warp >= CONSUMERS / 32) {  // the loading warp
    const int kvrow = kvh / hpr, col0 = (kvh % hpr) * D;
    const size_t row = (size_t)hpr * D;   // elements a key row
    for (int it = 0; it < n_chunks; ++it) {
      const int st = it % STAGES;
      if (it >= STAGES) wg::mbar_wait(&empty[st], (it / STAGES - 1) & 1);
      unsigned char* ks = smem + L::RING + st * L::STAGE;
      unsigned char* vs = ks + L::KV;
      const int c0 = c_begin + it * KC, nk = min(KC, k_hi - c0);
      if constexpr (TMA) {
        // lane i: the boxes of keys c0 + i bk .. (a page, or KC keys of one),
        // 64 columns each; boxes past the walk's end are not loaded
        const int bk = min(page_size, KC), nseg = (nk + bk - 1) / bk;
        if (lane == 0) wg::mbar_expect_tx(&full[st], nseg * bk * D * 2 * 2);
        __syncwarp();
        if (lane < nseg) {
          const int key = c0 + lane * bk, y = key % page_size;
          const int z = bt_row[key / page_size] * (hkv / hpr) + kvrow;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            wg::tma_load_3d(ks + nb * TILE + lane * bk * 128, &kmap, col0 + 64 * nb, y, z,
                            &full[st]);
            wg::tma_load_3d(vs + nb * TILE + lane * bk * 128, &vmap, col0 + 64 * nb, y, z,
                            &full[st]);
          }
        }
      } else {
        // 16-byte pieces into the tiles' swizzle (columns past D and keys
        // past the walk as zeros)
        for (int e = lane; e < KC * DP / 8; e += 32) {
          const int kk = e / (DP / 8), pc = e % (DP / 8), key = c0 + kk;
          const bool live = key < k_hi && pc * 8 < D;
          size_t at = 0;
          if (live)
            at = (((size_t)bt_row[key / page_size] * (hkv / hpr) + kvrow) * page_size +
                  key % page_size) * row + col0 + pc * 8;
          const int dst = (pc / 8) * TILE + kk * 128 + (((pc % 8) ^ (kk & 7)) << 4);
          wg::cp_async16(ks + dst, kc + at, live ? 16 : 0);
          wg::cp_async16(vs + dst, vc + at, live ? 16 : 0);
        }
      }
      wg::mbar_arrive_cp_async(&full[st]);   // once this lane's pieces land
      wg::mbar_arrive(&full[st]);
    }
    return;
  }

  if constexpr (INT8) asm volatile("setmaxnreg.inc.sync.aligned.u32 176;\n");

  // Q: flat row r -> (token j = (r0 + r) / group, head (r0 + r) % group) as
  // bf16 (an int8 cache: k_scale folded and rounded to bf16 as the wrappers'
  // fold rounds); dead rows and columns past D zero
  const float ksc = INT8 ? (k_scale != nullptr ? k_scale[kvh * k_scale_step] : k_scale_val) : 1.f;
  const float vsc = INT8 ? (v_scale != nullptr ? v_scale[kvh * v_scale_step] : v_scale_val) : 1.f;
  for (int i = tid; i < M * NB * 8; i += CONSUMERS) {
    const int r = i / (NB * 8), pc = i % (NB * 8), f = r0 + r, j = f / group;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (j < seq_len && pc * 8 < D) {
      v = *reinterpret_cast<const uint4*>(
          q + ((size_t)(start + j) * hq + kvh * group + f % group) * D + pc * 8);
      if constexpr (INT8) v = scale8(v, ksc);
    }
    *reinterpret_cast<uint4*>(smem + L::Q + (pc / 8) * TILE + r * 128 +
                              (((pc % 8) ^ (r & 7)) << 4)) = v;
  }
  wg::fence_proxy();
  wg::bar_sync(1, CONSUMERS);

  // this thread's rows r and r + 8 (r = 16 warp + lane / 4) of the accumulators
  const int g = lane >> 2, t4 = lane & 3;
  int qpos[2], tok[2], head[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = r0 + 16 * warp + g + 8 * h, j = f / group;
    live[h] = j < seq_len;
    qpos[h] = pos0 + j;
    tok[h] = start + j;
    head[h] = f % group;
  }
  const float scale2 = scale * LOG2E;
  const unsigned char* qs = smem + L::Q;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};
  // keys every row of the block sees (its chunks need no mask): all rows
  // live, keys in [see_lo, see_hi]
  const bool all_live = r0 + M <= seq_len * group;
  const int see_hi = min(pos0 + j_first, k_hi - 1);
  const int see_lo = window > 0 ? pos0 + j_last - window + 1 : 0;
  auto stage = [&](int it) { return smem + L::RING + (it % STAGES) * L::STAGE; };
  // chunk it landed; with bf16 boxes its V rows past the walk's end are made
  // zero (a box's tail past k_hi, or stale): their P is 0, and 0 x a
  // non-finite value would not be
  auto ready = [&](int it) {
    wg::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    if constexpr (INT8) wg::fence_proxy();   // the widened tiles came by ordinary stores
    if constexpr (!INT8 && TMA) {
      const int nk = min(KC, k_hi - (c_begin + it * KC));
      if (nk < KC) {
        unsigned char* vs = stage(it) + L::KV;
        for (int i = tid; i < (KC - nk) * NB * 8; i += CONSUMERS) {
          const int kk = nk + i / (NB * 8), pc = i % (NB * 8);
          *reinterpret_cast<uint4*>(vs + (pc / 8) * TILE + kk * 128 + (pc % 8) * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        wg::fence_proxy();
        wg::bar_sync(1, CONSUMERS);
      }
    }
  };
  // S = Q K^T of chunk it: 64 rows x its 64 keys (both K-major), issued
  auto scores = [&](float (&acc)[32], int it) {
    const unsigned char* ks = stage(it);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    wg::fence_operands(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t at = (kk >> 2) * TILE + (kk & 3) * 32;
      wg::mma_m64n64k16<0>(acc, wg::desc_sw128(qs + at, 16, 1024),
                           wg::desc_sw128(ks + at, 16, 1024));
    }
    wg::commit();
  };

  // up to D = 128 the next chunk's S is issued before this chunk's P V; at
  // D = 256 O takes 128 registers a thread and S is issued in its own step
  // (a second S would spill)
  constexpr bool OVERLAP = D <= 128;
  float s[32], s_next[OVERLAP ? 32 : 1];
  if constexpr (OVERLAP) {
    if (n_chunks > 0) {
      ready(0);
      scores(s, 0);
      wg::wait_all();
      wg::fence_operands(s);
    }
  }
  for (int it = 0; it < n_chunks; ++it) {
    const int c0 = c_begin + it * KC;
    if constexpr (!OVERLAP) {
      ready(it);
      scores(s, it);
      wg::wait_all();
      wg::fence_operands(s);
    }
    // causal and window masks (none on a chunk every row sees whole), the
    // online softmax in log2 units (scale log2 e folded into one FMA; a row's
    // 4 lanes reduce by shuffles); P rounded to bf16 as the A fragments of
    // P V, the denominators of the unrounded P.  s[i]: row r + 8 ((i / 2) %
    // 2), key c0 + 8 (i / 4) + 2 t4 + i % 2
    uint32_t ok = 0xffffffffu;
    float mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};   // -inf
    if (all_live && c0 >= see_lo && c0 + KC - 1 <= see_hi) {
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    } else {
      ok = 0u;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1, key = c0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const bool valid = live[h] && key <= qpos[h] && key < k_hi &&
                           (window <= 0 || key > qpos[h] - window);
        ok |= (uint32_t)valid << i;
        if (valid) mx[h] = fmaxf(mx[h], s[i]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h] * scale2);
      alpha[h] = ex2(m_run[h] - m_new);
      m_run[h] = m_new;
    }
    uint32_t pa[KC / 16][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      const float p0 = (ok >> i) & 1u ? ex2(fmaf(s[i], scale2, -m_run[h])) : 0.f;
      const float p1 = (ok >> (i + 1)) & 1u ? ex2(fmaf(s[i + 1], scale2, -m_run[h])) : 0.f;
      sum[h] += p0 + p1;
      pa[i >> 3][(i >> 1) & 3] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + sum[h];
    }

    // the next chunk's S, issued before this chunk's P V so that the two
    // products overlap
    if constexpr (OVERLAP) {
      if (it + 1 < n_chunks) {
        ready(it + 1);
        scores(s_next, it + 1);
      }
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V: P from registers, V the chunk's rows (MN-major)
    const unsigned char* vs = stage(it) + L::KV;
    wg::fence_operands(o);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      const uint64_t vd = wg::desc_sw128(vs + 16 * kk * 128, TILE, 1024);
      if constexpr (DP == 64)
        wg::mma_rs_m64n64k16<1>(o, pa[kk], vd);
      else if constexpr (DP == 128)
        wg::mma_rs_m64n128k16<1>(o, pa[kk], vd);
      else
        wg::mma_rs_m64n256k16<1>(o, pa[kk], vd);
    }
    wg::commit();
    wg::wait_all();
    wg::fence_operands(o);
    if constexpr (OVERLAP) wg::fence_operands(s_next);
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[it % STAGES]);
    if constexpr (OVERLAP) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = s_next[i];
    }
  }

  // live rows out: the sink joins the denominator; an int8 cache's v_scale
  // folds into the bf16 value as the wrappers' fold did
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const int hh = kvh * group + head[h];
    float e = 1.f, denom;
    if (sinks != nullptr) {
      const float sink = LOG2E * (sinks_bf16 ? __bfloat162float(static_cast<const bf16*>(sinks)[hh])
                                             : static_cast<const float*>(sinks)[hh]);
      const float m_fin = fmaxf(m_run[h], sink);
      e = ex2(m_run[h] - m_fin);
      denom = fmaxf(l_run[h] * e + ex2(sink - m_fin), 1e-30f);
    } else {
      denom = fmaxf(l_run[h], 1e-30f);
    }
    bf16* orow = out + ((size_t)tok[h] * hq + hh) * D + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      float2 v = make_float2(o[4 * i + 2 * h] * e / denom, o[4 * i + 2 * h + 1] * e / denom);
      if constexpr (INT8) {
        v = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
        v = make_float2(v.x * vsc, v.y * vsc);
      }
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = __floats2bfloat162_rn(v.x, v.y);
    }
  }
}

}  // namespace pre


// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
struct Type {
  using type = T;
};

// f(std::integral_constant<int, D>, Type<T>) for the head width and cache
// element type given; an unbuilt width is an invalid value.
template <typename F>
int by_width_and_type(int head_dim, int kv_int8, F&& f) {
  switch (head_dim) {
    case 32:
      return kv_int8 ? f(std::integral_constant<int, 32>{}, Type<int8_t>{})
                     : f(std::integral_constant<int, 32>{}, Type<bf16>{});
    case 64:
      return kv_int8 ? f(std::integral_constant<int, 64>{}, Type<int8_t>{})
                     : f(std::integral_constant<int, 64>{}, Type<bf16>{});
    case 128:
      return kv_int8 ? f(std::integral_constant<int, 128>{}, Type<int8_t>{})
                     : f(std::integral_constant<int, 128>{}, Type<bf16>{});
    case 256:   // bf16 caches only (Qwen3-Next's attention layers)
      return kv_int8 ? (int)cudaErrorInvalidValue
                     : f(std::integral_constant<int, 256>{}, Type<bf16>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sinks

// bf16 q [tokens, Hkv * group * D]; bf16 or int8 caches (kv_int8) in the
// layout of heads_per_row (1: [P, Hkv, page, D]; 2: packed [P, Hkv / 2,
// page, 2 D]); sinks [Hkv * group] f32 or bf16 (sinks_bf16) or null (no sink
// logit); an int8 cache's k_scale / v_scale as f32 pointers indexed kv head x
// step (step 0: one scale), or null and the value given; int32 bt [tokens,
// max_pages], ctx [tokens] -> bf16 out [tokens, Hkv * group * D].  D 32, 64 or
// 128, or 256 with bf16 caches; any group.  Each row's keys in splits of `split` from its window start,
// n_splits of them at most (<= dec::MAX_SPLITS); with n_splits > 1, part_o
// [tokens * Hq * n_splits * D] and part_ml [tokens * Hq * n_splits] f32
// scratch and tickets [tokens * Hkv * ceil(group / 64)] int32, zero at the
// start and left zero.
extern "C" int sinks_decode_launch(const void* q, const void* kc, const void* vc,
                                   const void* sinks, int sinks_bf16, const void* k_scale,
                                   float k_scale_val, int k_scale_step, const void* v_scale,
                                   float v_scale_val, int v_scale_step, const void* bt,
                                   const void* ctx, void* out, void* part_o, void* part_ml,
                                   void* tickets, int tokens, int hkv, int heads_per_row,
                                   int group, int head_dim, int kv_int8, int page_size,
                                   int max_pages, int window, int split, int n_splits,
                                   float scale, void* stream) {
  if (tokens == 0) return 0;
  if (group < 1 || (heads_per_row != 1 && heads_per_row != 2) || hkv % heads_per_row ||
      split < 1 || n_splits < 1 || n_splits > sinks::dec::MAX_SPLITS || tokens > 65535 ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int zb = (group + sinks::dec::HEADS - 1) / sinks::dec::HEADS;
  const int per = group < sinks::dec::HEADS ? group : sinks::dec::HEADS;
  const int rt = per <= 16 ? 1 : per <= 32 ? 2 : 4;
  const dim3 grid(hkv * zb, tokens, n_splits);
  return sinks::by_width_and_type(head_dim, kv_int8, [&](auto dim, auto type) {
    constexpr int D = decltype(dim)::value;
    using T = typename decltype(type)::type;
    auto launch = [&](auto row_tiles) {
      constexpr int RT = decltype(row_tiles)::value;
      constexpr int smem = sinks::dec::Smem<D, T, RT>::BYTES;
      auto kernel = sinks::dec::decode_kernel<D, T, RT>;
      const cudaError_t attr =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (attr != cudaSuccess) return (int)attr;
      kernel<<<grid, sinks::dec::THREADS, smem, s>>>(
          (const __nv_bfloat16*)q, (const T*)kc, (const T*)vc, sinks, sinks_bf16,
          (const float*)k_scale, k_scale_val, k_scale_step, (const float*)v_scale, v_scale_val,
          v_scale_step, (const int*)bt, (const int*)ctx, (__nv_bfloat16*)out, (float*)part_o,
          (float2*)part_ml, (int*)tickets, hkv, heads_per_row, group, page_size, max_pages,
          window, split, n_splits, scale);
      return (int)cudaGetLastError();
    };
    if (rt == 1) return launch(std::integral_constant<int, 1>{});
    if (rt == 2) return launch(std::integral_constant<int, 2>{});
    return launch(std::integral_constant<int, 4>{});
  });
}

// bf16 q [S, Hkv * group * D] packed by request (request b's rows follow
// those of requests 0 .. b - 1); caches as sinks_decode_launch's, num_pages
// of them, starting 16-byte aligned; sinks [Hkv * group] f32 or bf16
// (sinks_bf16) or null; an int8 cache's scales as sinks_decode_launch's;
// int32 bt [B, max_pages], seq_lens, ctx [B] -> bf16 out [S = rows, Hkv *
// group * D], the rows past the requests zero.  D 32, 64 or 128, or 256 with
// bf16 caches (one block an SM: Q and three stages take 229,424 B), any group;
// max_q bounds every seq_len.  Pages of 8, 16, 32, 64 or a multiple of 64
// keys go by TMA (but bf16 at D = 32: its 64-byte rows), others by cp.async.
extern "C" int sinks_prefill_launch(const void* q, const void* kc, const void* vc,
                                    const void* sinks, int sinks_bf16, const void* k_scale,
                                    float k_scale_val, int k_scale_step, const void* v_scale,
                                    float v_scale_val, int v_scale_step, const void* bt,
                                    const void* seq_lens, const void* ctx, void* out, int rows,
                                    int bsz, int hkv, int heads_per_row, int group, int head_dim,
                                    int kv_int8, int page_size, int max_pages, int num_pages,
                                    int window, int max_q, float scale, void* stream) {
  if (rows == 0) return 0;
  if (group < 1 || (heads_per_row != 1 && heads_per_row != 2) || hkv % heads_per_row ||
      page_size < 1 || bsz > 65534)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long flat = (long long)max_q * group;
  // the last z slice zeroes the rows past the requests
  const dim3 grid(hkv, (unsigned)max(1LL, (flat + sinks::pre::M - 1) / sinks::pre::M), bsz + 1);
  const bool box_page = page_size % 64 == 0 || page_size == 8 || page_size == 16 ||
                        page_size == 32;
  return sinks::by_width_and_type(head_dim, kv_int8, [&](auto dim, auto type) {
    constexpr int D = decltype(dim)::value;
    using T = typename decltype(type)::type;
    constexpr bool INT8 = std::is_same_v<T, int8_t>;
    CUtensorMap kmap, vmap;
    const bool tma = box_page && !INT8 && D >= 64;
    if (tma) {
      // [P Hkv / hpr, page, hpr D] bf16; boxes of 64 columns x min(page, 64) keys
      const uint64_t dims[3] = {(uint64_t)heads_per_row * D, (uint64_t)page_size,
                                (uint64_t)num_pages * (hkv / heads_per_row)};
      const uint64_t strides[2] = {(uint64_t)heads_per_row * D * 2,
                                   (uint64_t)page_size * heads_per_row * D * 2};
      const uint32_t box[3] = {64, (uint32_t)(page_size < 64 ? page_size : 64), 1};
      int rc = wg::tensor_map(&kmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, kc, dims, strides, box);
      if (rc == 0)
        rc = wg::tensor_map(&vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, vc, dims, strides, box);
      if (rc != 0) return rc;
    } else {
      memset(&kmap, 0, sizeof(kmap));   // the cp.async path and int8 read no map
      memset(&vmap, 0, sizeof(vmap));
    }
    auto launch = [&](auto use_tma) {
      constexpr bool TMA = decltype(use_tma)::value;
      constexpr int smem = (int)sinks::pre::Smem<D, T>::BYTES;
      auto kernel = sinks::pre::prefill_kernel<D, T, TMA>;
      const cudaError_t attr =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (attr != cudaSuccess) return (int)attr;
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
      kernel<<<grid, sinks::pre::Smem<D, T>::THREADS, smem, s>>>(
          kmap, vmap, (const __nv_bfloat16*)q, (const T*)kc, (const T*)vc, sinks, sinks_bf16,
          (const float*)k_scale, k_scale_val, k_scale_step, (const float*)v_scale, v_scale_val,
          v_scale_step, (const int*)bt, (const int*)seq_lens, (const int*)ctx,
          (__nv_bfloat16*)out, rows, hkv, heads_per_row, group, page_size, max_pages, window,
          scale);
      return (int)cudaGetLastError();
    };
    if constexpr (INT8)
      return launch(std::false_type{});   // its widening warpgroup reads the cache itself
    else
      return tma ? launch(std::true_type{}) : launch(std::false_type{});
  });
}
