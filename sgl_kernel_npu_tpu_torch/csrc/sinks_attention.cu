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
// cache holds levels round(x / scale).  The decode kernel folds k_scale into
// q and v_scale into the output itself, with the two roundings of the JAX
// wrappers' fold (q: bf16(f32(q) k_scale); out: bf16(f32(bf16(o)) v_scale));
// the prefill kernel reads levels, its wrapper folds the scales.  Levels
// widen to bf16 exactly.
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
// cp.async ring of 3 or 4 chunks in shared memory (int8 stays int8 there).  Its 4
// warps share each chunk: the group's q heads are the rows of mma.sync
// m16n8k16 tiles (bf16 in, f32 accumulate; G < 16 pads the tile, a group
// above 16 takes 2 or 4 tiles, every key read once), Q held as A fragments
// for the whole walk, and each warp takes a slice of the chunk's keys with
// an online softmax of its own; P is rounded to bf16 for P V, the
// denominator takes the f32 P.  The warps' (m, l, o) combine in shared
// memory.  A row of one split writes its output; otherwise each split
// writes its (m, l, o) to scratch and the last to arrive, found by an atomic
// ticket on a per-(row, kv head) counter that it resets, merges them in
// split order (deterministic) and writes the output.  The sink logit joins
// the denominator at the merge; a row with no key writes exactly 0.
//
// Prefill design: one block per (request, kv head, TQ tokens) of 128 query
// rows (token, head in group): 16 tokens x 8 heads at G = 8.  Warp w owns rows
// 16 w .. 16 w + 15, one m16 tile of mma.sync.m16n8k16 (bf16 in, f32
// accumulate), in a flash-attention-2 loop: per 64-key chunk S = Q K^T from Q
// fragments held in registers for the whole walk, the masks and the online
// softmax on the accumulators (a row's 4 lanes reduce by shuffles), and P,
// rounded to bf16 as the TPU kernel feeds its PV product, re-packed in
// registers as the A fragments of O += P V.  The keys walked run from the
// block's first row's window start to its last live row's causal end: the
// TPU kernel's page range, at key granularity.  Queries are read in their
// packed rows (the JAX wrapper's dense scatter and gather are a TPU grid
// artefact).
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace sinks {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int KT = 64;         // keys a staged chunk
constexpr int PROWS = 128;     // prefill query rows a block: 16 a warp
constexpr int VEC = 8;         // cache values a load
constexpr float NEG = -1e30f;

template <int D>
constexpr int NLD = KT * D / VEC / THREADS;   // loads a thread a chunk, K and V each

// Keys [k0, k0 + KT) of kv head kvh -> registers, zeros at or past kend:
// thread e of the block loads piece e % (D / VEC) of key e / (D / VEC).
template <int D, typename T, typename V>
__device__ __forceinline__ void load_kv(const T* __restrict__ kc, const T* __restrict__ vc,
                                        const int* __restrict__ bt_row, int k0, int kend, int kvh,
                                        int hkv, int hpr, int page_size, V (&kr)[NLD<D>],
                                        V (&vr)[NLD<D>]) {
  constexpr int VPR = D / VEC;
  const size_t row = (size_t)hpr * D;
#pragma unroll
  for (int it = 0; it < NLD<D>; ++it) {
    const int e = threadIdx.x + it * THREADS, key = k0 + e / VPR;
    V kv{}, vv{};
    if (key < kend) {
      const size_t at =
          (((size_t)bt_row[key / page_size] * (hkv / hpr) + kvh / hpr) * page_size +
           key % page_size) * row + (kvh % hpr) * D + (e % VPR) * VEC;
      kv = *reinterpret_cast<const V*>(kc + at);
      vv = *reinterpret_cast<const V*>(vc + at);
    }
    kr[it] = kv;
    vr[it] = vv;
  }
}

// Registers of load_kv -> the chunk's K and V rows in shared memory as bf16,
// rows D + 8 apart (16-byte reads of 8 consecutive rows hit distinct banks).
template <int D, typename V>
__device__ __forceinline__ void store_kv(bf16* ks, bf16* vs, const V (&kr)[NLD<D>],
                                         const V (&vr)[NLD<D>]) {
  constexpr int VPR = D / VEC, LD = D + 8;
#pragma unroll
  for (int it = 0; it < NLD<D>; ++it) {
    const int e = threadIdx.x + it * THREADS, off = (e / VPR) * LD + (e % VPR) * VEC;
    *reinterpret_cast<uint4*>(ks + off) = sgl::widen(kr[it]);
    *reinterpret_cast<uint4*>(vs + off) = sgl::widen(vr[it]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
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
  // blocks still fit an SM, else 3 (bf16 at D = 128)
  static constexpr int STAGES = Q + 4 * 2 * CHUNK <= SMEM_2 ? 4 : 3;
  static constexpr int RING = STAGES * 2 * CHUNK;
  static constexpr int COMBINE = WARPS * 16 * (2 + OLD) * 4;
  static constexpr int MERGE = 16 * RT * (MAX_SPLITS + 2) * 4;
  static constexpr int TAIL = COMBINE > MERGE ? COMBINE : MERGE;
  static constexpr int BYTES = Q + (RING > TAIL ? RING : TAIL);
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (scores are kept in log2 units: exp(x) =
// 2^(x log2 e), the factor folded into the softmax scale)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
  uint32_t qa[D / 16][4];                         // its Q tile as A fragments, for the walk
  {
    const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sgl::ldsm_x4(qa[kk], qs + (16 * rt + a_row) * L::QLD + kk * 16 + a_col);
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
#pragma unroll
      for (int nt = 0; nt < KW / 8; ++nt) {
        uint32_t b[2];
        k_frag<T, L::ROW>(b, kst, kw0 + nt * 8, kk, lane);
        sgl::mma_16816(kk % 2 ? sd[nt] : sc[nt], qa[kk], b);
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

template <int D>
constexpr size_t prefill_smem() {
  return sizeof(bf16) * (PROWS + 2 * KT) * (D + 8);
}

// gp: the group rounded up to a power of two; a block takes PROWS / gp
// tokens x gp heads (heads past the group are dead rows).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
    sinks_prefill_kernel(const bf16* __restrict__ q, const T* __restrict__ kc,
                         const T* __restrict__ vc, const float* __restrict__ sinks,
                         const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
                         const int* __restrict__ ctx_lens, const int* __restrict__ starts,
                         bf16* __restrict__ out, int hkv, int hpr, int group, int gp,
                         int page_size, int max_pages, int window, float scale) {
  using V = typename sgl::Vec8<T>::type;
  constexpr int LD = D + 8, QPR = D / 8, NT = D / 8;   // QPR: 16-byte q pieces a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [PROWS][LD]
  bf16* ks = qs + PROWS * LD;                     // [KT][LD]
  bf16* vs = ks + KT * LD;                        // [KT][LD]

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int tq = PROWS / gp, j0 = blockIdx.x * tq;
  const int seq_len = seq_lens[b];
  if (j0 >= seq_len) return;
  const int tok_base = starts[b], hq = hkv * group;
  const int pos0 = ctx_lens[b] - seq_len;    // position of the request's new token 0
  const int* bt_row = block_tables + (size_t)b * max_pages;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row / column pair

  for (int i = threadIdx.x; i < PROWS * QPR; i += THREADS) {
    const int r = i / QPR, j = j0 + r / gp, hg = r % gp;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (j < seq_len && hg < group)
      v = *reinterpret_cast<const uint4*>(
          q + ((size_t)(tok_base + j) * hq + kvh * group + hg) * D + (i % QPR) * 8);
    *reinterpret_cast<uint4*>(qs + r * LD + (i % QPR) * 8) = v;
  }
  // keys walked: the first row's window start .. the last live row's causal end
  const int k_lo = window > 0 ? max(pos0 + j0 - window + 1, 0) : 0;
  const int k_hi = pos0 + min(j0 + tq, seq_len);
  // this lane's rows g and g + 8 of the warp's tile
  int qpos[2], tok[2], head[2];
  bool live[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = 16 * warp + g + 8 * hr, j = j0 + r / gp;
    head[hr] = r % gp;
    live[hr] = j < seq_len && head[hr] < group;
    qpos[hr] = pos0 + j;
    tok[hr] = tok_base + j;
  }

  V kr[NLD<D>], vr[NLD<D>];
  load_kv<D>(kc, vc, bt_row, k_lo, k_hi, kvh, hkv, hpr, page_size, kr, vr);
  __syncthreads();
  uint32_t qa[D / 16][4];   // the warp's Q tile as A fragments, for the whole walk
  {
    const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sgl::ldsm_x4(qa[kk], qs + (16 * warp + a_row) * LD + kk * 16 + a_col);
  }
  const int b_row = lane & 7, b_col = 8 * ((lane >> 3) & 1);

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += KT) {
    store_kv<D>(ks, vs, kr, vr);
    __syncthreads();
    if (k0 + KT < k_hi)
      load_kv<D>(kc, vc, bt_row, k0 + KT, k_hi, kvh, hkv, hpr, page_size, kr, vr);

    // S = Q K^T over the chunk's 8 tiles of 8 keys
    float s[KT / 8][4];
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        uint32_t bf[2];
        sgl::ldsm_x2(bf, ks + (nt * 8 + b_row) * LD + kk * 16 + b_col);
        sgl::mma_16816(s[nt], qa[kk], bf);
      }
    }

    // causal and window masks; online softmax of rows g (hr 0) and g + 8 (hr 1)
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      uint32_t ok = 0u;
      float mx = NEG;
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + nt * 8 + 2 * t4 + e;
          const bool valid = live[hr] && key <= qpos[hr] && (window <= 0 || key > qpos[hr] - window);
          float& v = s[nt][2 * hr + e];
          v = valid ? v * scale : NEG;
          ok |= (uint32_t)valid << (2 * nt + e);
          mx = fmaxf(mx, v);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = s[nt][2 * hr + e];
          v = (ok >> (2 * nt + e)) & 1u ? expf(v - m_new) : 0.f;
          sum += v;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[hr] = expf(m[hr] - m_new);
      l[hr] = l[hr] * alpha[hr] + sum;
      m[hr] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // O += P V: the S accumulators of key tiles 2 kk and 2 kk + 1 are the A
    // fragment of keys 16 kk .. 16 kk + 15
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bf[2];
        sgl::ldsm_x2_trans(bf, vs + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + nt * 8);
        sgl::mma_16816(o[nt], a, bf);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (!live[hr]) continue;
    const int h = kvh * group + head[hr];
    float e = 1.f, denom;
    if (sinks != nullptr) {
      const float sink = sinks[h];
      const float m_fin = fmaxf(m[hr], sink);
      e = expf(m[hr] - m_fin);
      denom = fmaxf(l[hr] * e + expf(sink - m_fin), 1e-30f);
    } else {
      denom = fmaxf(l[hr], 1e-30f);
    }
    bf16* orow = out + ((size_t)tok[hr] * hq + h) * D + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) = __floats2bfloat162_rn(
          o[nt][2 * hr] * e / denom, o[nt][2 * hr + 1] * e / denom);
  }
}

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
// 128; any group.  Each row's keys in splits of `split` from its window start,
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
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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

// bf16 q [S, Hkv * group * D] packed by request (request b's rows start at
// starts[b]); caches as sinks_decode_launch's; f32 sinks [Hkv * group] or
// null; int32 bt [B, max_pages], seq_lens, ctx, starts [B] -> bf16 out
// [S, Hkv * group * D], live rows written (the caller zero-fills).  D 32, 64
// or 128, group <= 128; max_q bounds every seq_len.
extern "C" int sinks_prefill_launch(const void* q, const void* kc, const void* vc,
                                    const void* sinks, const void* bt, const void* seq_lens,
                                    const void* ctx, const void* starts, void* out, int bsz,
                                    int hkv, int heads_per_row, int group, int head_dim,
                                    int kv_int8, int page_size, int max_pages, int window,
                                    int max_q, float scale, void* stream) {
  if (bsz == 0 || max_q == 0) return 0;
  int gp = 1;
  while (gp < group) gp *= 2;
  if (group < 1 || gp > sinks::PROWS || (heads_per_row != 1 && heads_per_row != 2) ||
      hkv % heads_per_row)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tq = sinks::PROWS / gp;
  const dim3 grid((max_q + tq - 1) / tq, hkv, bsz);
  return sinks::by_width_and_type(head_dim, kv_int8, [&](auto dim, auto type) {
    constexpr int D = decltype(dim)::value;
    using T = typename decltype(type)::type;
    constexpr size_t smem = sinks::prefill_smem<D>();
    cudaFuncSetAttribute(sinks::sinks_prefill_kernel<D, T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    sinks::sinks_prefill_kernel<D, T><<<grid, sinks::THREADS, smem, s>>>(
        (const __nv_bfloat16*)q, (const T*)kc, (const T*)vc, (const float*)sinks,
        (const int*)bt, (const int*)seq_lens, (const int*)ctx, (const int*)starts,
        (__nv_bfloat16*)out, hkv, heads_per_row, group, gp, page_size, max_pages, window, scale);
    return (int)cudaGetLastError();
  });
}
