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
// tables [B, max_pages], sinks [Hq] f32 or null, out [tokens, Hq * D] bf16.
// The caches are bf16 or int8, K and V alike; kv head h's key t on page p
// lies at
//   ((p * Hkv / hpr + h / hpr) * page + t) * hpr * D + (h % hpr) * D:
// hpr = 1 is the plain layout [P, Hkv, page, D], hpr = 2 the packed one
// [P, Hkv / 2, page, 2 D] (pack_kv_sinks: heads 2j and 2j + 1 side by side in
// a row).  The TPU packs to fill its 128 lanes at D = 64 and zero-interleaves
// the queries to match, doubling their work; a contiguous row on the H100 has
// no lane padding, so the packed layout reads the bytes of the plain one and
// is taken by strides, each q head reading only its own kv head.  An int8
// cache holds levels round(x / scale): the wrappers fold k_scale into q and
// v_scale into the output, as the JAX wrappers do, so the kernels read plain
// levels, 8 bytes a load, widened to bf16 in shared memory (exact).
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
// Decode design: one block per (token, kv head, 8 heads of the group).  Its
// q heads, one a warp, share each chunk of 64 keys staged in shared memory (K
// and V rows by 8-value loads through the block table; the next chunk's loads
// are in flight in registers while the current one computes).  Lane i scores
// keys i and i + 32 of the chunk with an f32 dot product, the warp keeps the
// online softmax, and each lane accumulates D / 32 output columns of P V.
// Only keys [lo, ctx) are read: a sliding layer reads `window` keys, not its
// context.  A group above 8 takes more blocks, each reading the keys again.
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

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
    sinks_decode_kernel(const bf16* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const float* __restrict__ sinks,
                        const int* __restrict__ block_tables, const int* __restrict__ ctx_lens,
                        bf16* __restrict__ out, int hkv, int hpr, int group, int page_size,
                        int max_pages, int window, float scale) {
  using V = typename sgl::Vec8<T>::type;
  constexpr int LD = D + 8, DPL = D / 32;   // output columns a lane
  __shared__ __align__(16) bf16 ks[KT * LD];
  __shared__ __align__(16) bf16 vs[KT * LD];
  __shared__ float qs[WARPS * D];
  __shared__ float ps[WARPS * KT];

  const int tok = blockIdx.x, kvh = blockIdx.y, g0 = blockIdx.z * WARPS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nh = min(WARPS, group - g0);            // the block's q heads
  const int hq = hkv * group, h = kvh * group + g0 + warp;
  const int ctx = ctx_lens[tok];
  const int lo = window > 0 ? max(ctx - window, 0) : 0;
  const int* bt_row = block_tables + (size_t)tok * max_pages;
  const bool active = warp < nh;
  for (int i = threadIdx.x; i < nh * D; i += THREADS)
    qs[i] = __bfloat162float(q[((size_t)tok * hq + kvh * group + g0) * D + i]);
  const float* qrow = qs + warp * D;

  float m = NEG, l = 0.f, o[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) o[c] = 0.f;
  V kr[NLD<D>], vr[NLD<D>];
  if (lo < ctx) load_kv<D>(kc, vc, bt_row, lo, ctx, kvh, hkv, hpr, page_size, kr, vr);
  for (int k0 = lo; k0 < ctx; k0 += KT) {
    store_kv<D>(ks, vs, kr, vr);
    __syncthreads();
    if (k0 + KT < ctx)
      load_kv<D>(kc, vc, bt_row, k0 + KT, ctx, kvh, hkv, hpr, page_size, kr, vr);
    if (active) {
      float s[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = lane + 32 * i;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const uint4 u = *reinterpret_cast<const uint4*>(ks + j * LD + c * 8);
          const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[x]));
            dot += qrow[c * 8 + 2 * x] * kf.x + qrow[c * 8 + 2 * x + 1] * kf.y;
          }
        }
        s[i] = k0 + j < ctx ? dot * scale : NEG;
      }
      const float m_new = fmaxf(m, sgl::warp_max(fmaxf(s[0], s[1])));
      float p[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) p[i] = k0 + lane + 32 * i < ctx ? expf(s[i] - m_new) : 0.f;
      const float alpha = expf(m - m_new);
      l = l * alpha + sgl::warp_sum(p[0] + p[1]);
      m = m_new;
      // P V takes P rounded to bf16, the denominator the f32 P (as the TPU kernel)
      ps[warp * KT + lane] = __bfloat162float(__float2bfloat16_rn(p[0]));
      ps[warp * KT + lane + 32] = __bfloat162float(__float2bfloat16_rn(p[1]));
      __syncwarp();
#pragma unroll
      for (int c = 0; c < DPL; ++c) o[c] *= alpha;
      for (int j = 0; j < KT; ++j) {
        const float pj = ps[warp * KT + j];
        const bf16* vrow = vs + j * LD + lane * DPL;
        if constexpr (DPL % 2 == 0) {
          const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(vrow);
#pragma unroll
          for (int c = 0; c < DPL / 2; ++c) {
            const float2 vf = __bfloat1622float2(v2[c]);
            o[2 * c] += pj * vf.x;
            o[2 * c + 1] += pj * vf.y;
          }
        } else {
#pragma unroll
          for (int c = 0; c < DPL; ++c) o[c] += pj * __bfloat162float(vrow[c]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  float e = 1.f, denom;
  if (sinks != nullptr) {
    const float sink = sinks[h];
    const float m_fin = fmaxf(m, sink);
    e = expf(m - m_fin);
    denom = l * e + expf(sink - m_fin);
  } else {
    denom = fmaxf(l, 1e-30f);
  }
  bf16* orow = out + ((size_t)tok * hq + h) * D + lane * DPL;
  if constexpr (DPL % 2 == 0) {
#pragma unroll
    for (int c = 0; c < DPL / 2; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 2 * c) =
          __floats2bfloat162_rn(o[2 * c] * e / denom, o[2 * c + 1] * e / denom);
  } else {
#pragma unroll
    for (int c = 0; c < DPL; ++c) orow[c] = __float2bfloat16_rn(o[c] * e / denom);
  }
}

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
// page, 2 D]); f32 sinks [Hkv * group] or null (no sink logit); int32 bt
// [tokens, max_pages], ctx [tokens] -> bf16 out [tokens, Hkv * group * D].
// D 32, 64 or 128; any group.
extern "C" int sinks_decode_launch(const void* q, const void* kc, const void* vc,
                                   const void* sinks, const void* bt, const void* ctx, void* out,
                                   int tokens, int hkv, int heads_per_row, int group,
                                   int head_dim, int kv_int8, int page_size, int max_pages,
                                   int window, float scale, void* stream) {
  if (tokens == 0) return 0;
  if (group < 1 || (heads_per_row != 1 && heads_per_row != 2) || hkv % heads_per_row)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(tokens, hkv, (group + sinks::WARPS - 1) / sinks::WARPS);
  return sinks::by_width_and_type(head_dim, kv_int8, [&](auto dim, auto type) {
    constexpr int D = decltype(dim)::value;
    using T = typename decltype(type)::type;
    sinks::sinks_decode_kernel<D, T><<<grid, sinks::THREADS, 0, s>>>(
        (const __nv_bfloat16*)q, (const T*)kc, (const T*)vc, (const float*)sinks,
        (const int*)bt, (const int*)ctx, (__nv_bfloat16*)out, hkv, heads_per_row, group,
        page_size, max_pages, window, scale);
    return (int)cudaGetLastError();
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
