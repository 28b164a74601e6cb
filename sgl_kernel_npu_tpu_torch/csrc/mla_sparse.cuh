// The Hopper block body of MLA attention over the paged latent cache: 64
// query rows a block on warpgroup products (wgmma) fed by TMA (wgmma.cuh),
// shared by K9a (mla_prefill, the dense causal walk), K9b
// (mla_prefill_block_sparse, DeepSeek-V3.2 DSA: the pages the indexer
// selected for each q-chunk) and K2 (decode_mla, decode_mla.cu: the dense
// walk over one split of a decode row's keys, with a split epilogue and the
// int8 fold, struct Split).  They differ only in their key walk and
// epilogue.
//
// What bounds it.  A 2048-token chunk of 128 heads at context 4096 does
// ~1.7 TFLOP dense (K9a: 1.77 ms at the bf16 tensor-core rate) or ~1.2 TFLOP
// over 16 selected pages of 128 a q-chunk (K9b: 1.14 ms), for ~0.3 GB of
// distinct bytes: operations bound both.  The 16-row mma.sync body of
// mla_attention.cuh, on which both kernels ran first, re-streamed every
// key once per 16 rows (~39 GB through L2 at K9b's shape), widened int8
// levels once per 16 rows, and ran the softmax row by row on warp shuffles.
// Here the keys cross L2 once a block (~9.7 GB bf16, ~5.4 GB int8, at 64 rows
// a block): a first design whose computing threads issued the ring's 16-byte
// cp.async stalled on them, so TMA boxes from a loading warpgroup carry
// them, off the critical path.  What is left between this body and the
// bound: the softmax, masks and barriers run between the products, not
// beside them (two stages leave no room to start the next chunk's S first).
//
// Design.  A block owns 64 rows of one request (K9b: of one q-chunk, whose
// rows all see the same selected pages), tokens x heads as the wrapper's
// sparse_tiling gives them: 1 token x 64 heads at H = 128, 8 tokens x 8
// heads at H = 8 (rows past the tokens or the head count are dead), so each
// staged key chunk serves all 64 rows: a quarter of the 16-row body's key
// traffic.
//   Keys: the walk's key i is, on the dense walk, position i of the request
//     (keys 0 .. the causal end of the block's last live row), on the sparse
//     walk offset i % page of the selected page sel[i / page] (the
//     selection's order; kend = whole pages).  Its cache page comes from the
//     block table: each of the first 64 loading threads looks up one key of
//     the next chunk a chunk ahead (the lookup's latency hides behind a
//     chunk) and parks its (page, offset) in a two-chunk ring in shared
//     memory for the chunk's copies (a walk at context 32768 and page 16
//     names 2048 pages: no block-wide table copy fits).
//   Loads (warpgroup 0, 40 registers a thread by setmaxnreg): chunks of
//     KT = 64 keys in a ring of two stages, each stage's full / empty
//     mbarriers between it and the consumers.  One thread issues the latent
//     as TMA boxes of up to 64 keys of one page x 128 bytes, landing in the
//     128-byte swizzle that wgmma reads (keys past the walk: rows past the
//     cache, which TMA fills with zeros); the warpgroup copies the rope
//     [pages, 1, 64, page] (8 keys contiguous a dimension, an MN-major
//     operand) by cp.async.  A page size not a multiple of 8 takes 16-byte
//     cp.async pieces into the same swizzle, and the rope element by element.
//     An int8 latent lands as int8 (half the bytes) and is widened to bf16
//     once a chunk into one shared buffer, exactly (levels are bf16 integers).
//   S = Q K^T (warpgroups 1, 2, 232 registers): warpgroup g takes keys 32 g ..
//     32 g + 32 of the chunk over the full depth (32 steps m64n32k16 on the
//     latent, 4 on the rope), Q [64, 576] resident in shared memory.
//   Softmax: online, in registers (f32, base 2); the two warpgroups swap
//     their row maxima through shared memory; P rounded to bf16 into shared
//     memory.  Key positions: the dense walk's are the keys themselves, and
//     only a chunk past the block's first live row's causal end is masked;
//     the sparse walk's come from (slot, offset) counters advanced a chunk at
//     a time (a division by the page size in the loop was a large share of
//     the first design's time).
//   O += P V: warpgroup g owns output columns 256 g .. 256 g + 256 (4 steps
//     m64n256k16, V = the latent chunk, MN-major), a 64 x 256 f32
//     accumulator of 128 registers a thread; each keeps the denominator of
//     its own keys, summed at the end.
// Shared memory: Q 72 KB, two stages of 72 KB (int8: 40 KB, and the 64 KB
// widened latent), P 8 KB, the selection 1 KB, the keys' pages 1 KB:
// 226.5 KB, one block an SM.
//
// Semantics.  Dense (JAX's _mla_prefill_kernel): token j sees positions <=
// ctx - seq_len + j; a masked key weighs 0; a box of bf16 keys past the walk
// is zeroed before P V (the cache there may hold anything).  Sparse (JAX's
// _mla_prefill_pruned_kernel): whole selected pages are walked, masked by
// position; a masked key scores -1e30 and, while the row's running max is
// still -1e30, weighs 1, so a row that sees none of its pages gets the mean
// of the latents it walked.  Both: P is rounded to bf16 before the PV
// product and the denominator sums the rounded P; dead rows write nothing
// (the caller zeroes the output).
#pragma once

#include <cuda.h>
#include <string.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace mlas {

using bf16 = __nv_bfloat16;

constexpr int DN = 512;                  // latent (nope) width, also V width
constexpr int DR = 64;                   // rope width
constexpr int DQ = DN + DR;
constexpr int M = 64;                    // query rows a block
constexpr int KT = 64;                   // keys a staged chunk
constexpr int PRODUCERS = 128;           // warpgroup 0 loads,
constexpr int CONSUMERS = 256;           // warpgroups 1 and 2 compute
constexpr int THREADS = PRODUCERS + CONSUMERS;
constexpr int MAX_SEL = 256;             // selected pages a chunk can name
constexpr int BOX = 8192;                // bytes of a latent box: 64 keys x 128 bytes
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit alone (exp2f adds a subnormal fix-up
// around it): the probabilities are rounded to bf16 next.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// K2's epilogue (decode_mla.cu; K9a and K9b pass the default: write the
// output, no fold).  A decode row's keys are cut into splits, one block each:
// with more than one live split, each block writes its rows' un-normalised
// O [DN] f32 and (m in log2 units, l) to part_o [n_splits][rows][DN] /
// part_ml [n_splits][rows] (rows: the batch's rows x heads), and the last
// block of the (row, head tile) to arrive (an atomic ticket, which it
// resets) merges them in split order.
// fold: the int8 cache's k_scale ks, folded into q_nope as Q lands (f32
// product rounded to bf16, the rope x 1) and into the output (the bf16 value
// x ks, rounded again): the two roundings of decode_attention.fold_q_scale
// / unfold_out_scale.
constexpr int MAX_SPLITS = 16;           // splits of a decode row at most
struct Split {
  float* part_o = nullptr;
  float2* part_ml = nullptr;
  int* ticket = nullptr;
  size_t rows = 0;
  int s = 0, n_live = 1;                 // this block's split, the row's live ones
  bool fold = false;
  float ks = 1.f;
};

// 8 bf16 q values (a 16-byte piece) x ks in f32, each rounded back to bf16.
__device__ __forceinline__ uint4 fold8(uint4 v, float ks) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const __nv_bfloat162 y = __floats2bfloat162_rn(__low2float(x) * ks, __high2float(x) * ks);
    w[i] = *reinterpret_cast<const uint32_t*>(&y);
  }
  return v;
}

// Two output values: o / l (as o x inv) rounded to bf16, then the fold's
// second rounding.
__device__ __forceinline__ __nv_bfloat162 out2(float a, float b, float inv, const Split& sp) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a * inv, b * inv);
  if (sp.fold) v = __floats2bfloat162_rn(__low2float(v) * sp.ks, __high2float(v) * sp.ks);
  return v;
}

// The latent cache kn [pages, 1, page, 512] as a TMA map of [pages x page,
// 512] rows, boxes of box_keys rows x 128 bytes, 128-byte swizzle: box_keys
// the largest divisor of the page that divides 64; under 8 the cp.async
// path reads no map (zeroed).  0 or a CUDA error.
template <typename KN>
inline int key_map(CUtensorMap* kmap, const void* kn, int page_size, int n_pages,
                   int* box_keys) {
  *box_keys = KT;
  while (page_size % *box_keys) *box_keys /= 2;
  if (*box_keys < 8) {
    memset(kmap, 0, sizeof(*kmap));
    return 0;
  }
  const uint64_t dims[2] = {DN, (uint64_t)n_pages * page_size}, strides[1] = {DN * sizeof(KN)};
  const uint32_t box[2] = {128 / sizeof(KN), (uint32_t)*box_keys};
  return wg::tensor_map(kmap, sizeof(KN) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                              : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                        2, kn, dims, strides, box);
}

// Shared memory, in bytes, every latent region 1024-aligned.  Q [72][64][8]
// (depth / 8, row, depth % 8) is wgmma's layout without swizzle; a stage's
// latent is TMA's 128-byte swizzle, [column block][64 keys][128 bytes] (bf16:
// 8 blocks of 64 columns; int8: 4 of 128 levels, widened into WIDE, 8 blocks
// of bf16); a stage's rope is [8][64][8] (key / 8, dimension, key % 8).
// KEYS [2][2][KT]: each chunk's keys' cache pages (-1: past the walk) and
// offsets in the page.
template <typename KN>
struct Smem {
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t RAW = KT * DN * sizeof(KN);       // a stage's latent
  static constexpr uint32_t STAGE = RAW + KT * DR * 2;        // + its rope
  static constexpr uint32_t STAGES = Q + M * DQ * 2;
  static constexpr uint32_t WIDE = STAGES + 2 * STAGE;        // int8: the latent as bf16
  static constexpr uint32_t P = WIDE + (sizeof(KN) == 1 ? KT * DN * 2 : 0);
  static constexpr uint32_t SEL = P + M * KT * 2;             // [MAX_SEL] page positions
  static constexpr uint32_t KEYS = SEL + MAX_SEL * 4;         // [2][2][KT] page, offset
  static constexpr uint32_t RED = KEYS + 2 * 2 * KT * 4;      // [2][M] f32 row exchange
  static constexpr uint32_t BARS = RED + 2 * M * 4;           // full[2], empty[2]
  static constexpr uint32_t NLIVE = BARS + 4 * 8;             // live slots; K2's last split
  static constexpr uint32_t MERGE = NLIVE + 16;               // K2's merge: 3 bulk barriers
  static constexpr uint32_t BYTES = MERGE + 3 * 8;
};
static_assert(Smem<bf16>::BYTES <= 232448 && Smem<int8_t>::BYTES <= 232448,
              "the MLA prefill block's shared memory exceeds a block's 227 KB");

// The producer warpgroup's copies of a chunk of KT keys into a stage: key r
// of the chunk is offset koff[r] of cache page kpg[r] (kpg -1: past the
// walk, zeros).  Thread 0: the latent, a TMA box of box_keys keys (they
// share a page: box_keys divides the page and 64, and chunks start at
// multiples of 64) x 64 columns (int8: 128 levels) at a time, rows past the
// cache (total_rows) for dead boxes, which TMA fills with zeros; a box under
// 8 keys (a page size not a multiple of 8): every thread, 16-byte cp.async
// pieces into the same swizzled layout.  Every thread (warp w, lane l): the
// rope of key groups 2 w, 2 w + 1 at dimensions l, l + 32, by cp.async (a
// page size not a multiple of 8: element by element).
template <typename KN>
__device__ __forceinline__ void produce_chunk(unsigned char* stage, const void* kmap,
                                              const KN* __restrict__ kn,
                                              const bf16* __restrict__ kr, const int* kpg,
                                              const int* koff, int page_size, int box_keys,
                                              int total_rows, uint64_t* full, int w, int lane) {
  constexpr int BLOCKS = DN * (int)sizeof(KN) / 128;   // 128-byte column blocks of a key
  if (box_keys >= 8) {
    if (w == 0 && lane == 0) {
      wg::mbar_expect_tx(full, KT * DN * sizeof(KN));
      for (int r = 0; r < KT; r += box_keys) {
        const int y = kpg[r] >= 0 ? kpg[r] * page_size + koff[r] : total_rows;
#pragma unroll
        for (int cb = 0; cb < BLOCKS; ++cb)
          wg::tma_load_2d(stage + cb * BOX + r * 128, kmap, cb * 128 / (int)sizeof(KN), y, full);
      }
    }
  } else {  // pages of fewer than 8 keys' multiple: 16-byte pieces, swizzled as TMA would
#pragma unroll 1
    for (int i = 0; i < 2; ++i) {
      const int key = (lane & 7) + 8 * (2 * w + i);
      const bool live = kpg[key] >= 0;
      const char* src = reinterpret_cast<const char*>(kn);
      if (live) src += ((size_t)kpg[key] * page_size + koff[key]) * DN * sizeof(KN);
#pragma unroll
      for (int j = 0; j < BLOCKS * 2; ++j) {
        const int pc = (lane >> 3) + 4 * j;     // piece of the key's row: block pc / 8
        wg::cp_async16(stage + (pc >> 3) * BOX + key * 128 + (((pc & 7) ^ (key & 7)) * 16),
                       src + (live ? pc * 16 : 0), live ? 16 : 0);
      }
    }
  }
  bf16* rope = reinterpret_cast<bf16*>(stage + Smem<KN>::RAW);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int g = 2 * w + i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = lane + 32 * h;
      bf16* dst = rope + (g * DR + d) * 8;
      if (page_size % 8 == 0) {
        const bool live8 = kpg[8 * g] >= 0;
        const bf16* src8 = kr;
        if (live8) src8 += ((size_t)kpg[8 * g] * DR + d) * page_size + koff[8 * g];
        wg::cp_async16(dst, src8, live8 ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = 8 * g + e;
          dst[e] = kpg[k] >= 0 ? kr[((size_t)kpg[k] * DR + d) * page_size + koff[k]]
                               : __float2bfloat16(0.f);
        }
      }
    }
  }
}

// 4 int8 levels (a word) -> 4 bf16, exact: each byte (flipped to v + 128)
// becomes the float 2^23 + v + 128, less 2^23 + 128, whose upper half is v's
// bf16.
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650u + k)) - 8388736.0f;
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u));
}

// A stage's int8 latent -> the bf16 latent (the layout of a bf16 stage), by
// the consumer threads: piece q of key k holds levels 16 q .. 16 q + 15 (block
// q / 8, piece q % 8 of its row), which become two pieces of bf16 row k.
__device__ __forceinline__ void widen_chunk(const unsigned char* raw, unsigned char* wide) {
#pragma unroll
  for (int i = 0; i < KT * DN / 16 / CONSUMERS; ++i) {
    const int p = threadIdx.x - PRODUCERS + CONSUMERS * i, key = p & 63, q = p >> 6;
    const int sw = key & 7, c = q & 7, cb = 2 * (q >> 3) + (c >> 2), pc = 2 * (c & 3);
    const uint4 v = *reinterpret_cast<const uint4*>(raw + (q >> 3) * BOX + key * 128 +
                                                    ((c ^ sw) * 16));
    const uint2 a = widen4(v.x), b = widen4(v.y), cc = widen4(v.z), d = widen4(v.w);
    unsigned char* row = wide + cb * BOX + key * 128;
    *reinterpret_cast<uint4*>(row + ((pc ^ sw) * 16)) = make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(row + (((pc + 1) ^ sw) * 16)) = make_uint4(cc.x, cc.y, d.x, d.y);
  }
}

// The block: request b's tokens [j0, jend) (at most tq) x heads [h0, h0 +
// hb), row r = token j0 + r / hb, head h0 + r % hb.  Token j sits at packed
// index tok_base + j and sees positions <= ctx - seq_len + j.  DENSE: the
// keys are positions k_lo .. ctx - seq_len + jend of the request (bt_row its
// block table; k_lo a multiple of KT), at most up to k_hi; else the n_sel
// slots pos_sel_c of its q-chunk (positions of pages, -1 dead), walked whole
// (k_lo 0).  sp: K2's split epilogue and int8 fold (struct Split).
// Warpgroup 0 loads (40 registers a thread), warpgroups 1 and 2 compute
// (232): full[s] completes when stage s has landed, empty[s] when the
// consumers are done with it.  kmap: the latent
// cache as [total_rows = pages x page, 512] (TMA, boxes of box_keys rows).
template <typename KN, bool DENSE>
__device__ __forceinline__ void block(
    const bf16* __restrict__ q, const void* kmap, const KN* __restrict__ kn,
    const bf16* __restrict__ kr, const int* __restrict__ bt_row,
    const int* __restrict__ pos_sel_c, bf16* __restrict__ out, int tok_base, int j0, int jend,
    int tq, int seq_len, int ctx, int heads, int h0, int hb, int n_sel, int page_size,
    int box_keys, int total_rows, float sm_scale, int k_lo = 0, int k_hi = 0x7fffffff,
    Split sp = Split()) {
  using L = Smem<KN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  int* sel = reinterpret_cast<int*>(smem + L::SEL);
  int* keys = reinterpret_cast<int*>(smem + L::KEYS);
  float* red = reinterpret_cast<float*>(smem + L::RED);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + 2;
  int* n_live_s = reinterpret_cast<int*>(smem + L::NLIVE);
  const bf16* pb = reinterpret_cast<const bf16*>(smem + L::P);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (warp == 0) {  // the sparse walk's live slots, in order; the barriers
    int n = 0;
    if (!DENSE)
      for (int base = 0; base < n_sel; base += 32) {
        const int v = base + lane < n_sel ? pos_sel_c[base + lane] : -1;
        const unsigned live = __ballot_sync(0xffffffffu, v >= 0);
        if (v >= 0) sel[n + __popc(live & ((1u << lane) - 1u))] = v;
        n += __popc(live);
      }
    if (lane == 0) {
      *n_live_s = n;
      for (int i = 0; i < 2; ++i) {
        wg::mbar_init(&full[i], 2 * PRODUCERS);   // each producer thread twice
        wg::mbar_init(&empty[i], CONSUMERS / 32);
      }
    }
  }
  __syncthreads();
  // the walk's keys [k_lo, kend): to the causal end of the block's last live
  // row (or k_hi), or the selected pages
  const int n_live = *n_live_s;
  const int kend = min(DENSE ? ctx - seq_len + jend : n_live * page_size, k_hi);

  if (warp < PRODUCERS / 32) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    // thread tid < KT: the cache page and offset of key tid of the next chunk
    auto lookup = [&](int kg, int& pg, int& off) {
      pg = -1;
      off = 0;
      if (kg < kend) {
        const int slot = kg / page_size;
        off = kg - slot * page_size;
        pg = bt_row[DENSE ? slot : sel[slot]];
      }
    };
    int pg = -1, off = 0;
    if (tid < KT) lookup(k_lo + tid, pg, off);
    for (int it = 0, k0 = k_lo; k0 < kend; ++it, k0 += KT) {
      const int st = it & 1;
      int* kpg = keys + st * 2 * KT;
      if (it >= 2) wg::mbar_wait(&empty[st], ((it >> 1) - 1) & 1);
      if (tid < KT) {
        kpg[tid] = pg;
        kpg[KT + tid] = off;
        lookup(k0 + KT + tid, pg, off);         // a chunk ahead
      }
      wg::bar_sync(2, PRODUCERS);
      produce_chunk<KN>(smem + L::STAGES + st * L::STAGE, kmap, kn, kr, kpg, kpg + KT,
                        page_size, box_keys, total_rows, &full[st], warp, lane);
      wg::mbar_arrive_cp_async(&full[st]);     // when its rope copies land
      wg::mbar_arrive(&full[st]);              // its plain stores (a page size not 8 k)
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int ctid = tid - PRODUCERS, wgi = ctid >> 7, wq = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  auto row_live = [&](int r) {
    const int j = j0 + r / hb, h = h0 + r % hb;
    return r < tq * hb && j < jend && h < heads;
  };
  // the global row of block row r: out's [.., 512] and the split scratch's
  auto row_at = [&](int r) { return (size_t)(tok_base + j0 + r / hb) * heads + h0 + r % hb; };
  if (sp.fold) {  // K2's int8 fold: q_nope x ks, rounded to bf16; a thread's loads all in flight
    constexpr int NP = M * DQ / 8 / CONSUMERS;
    static_assert(NP * CONSUMERS == M * DQ / 8, "Q pieces a consumer thread");
    uint4 v[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = ctid + i * CONSUMERS, r = p & 63, c = p >> 6;
      v[i] = row_live(r) ? *reinterpret_cast<const uint4*>(q + row_at(r) * DQ + c * 8)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = ctid + i * CONSUMERS, r = p & 63, c = p >> 6;
      *reinterpret_cast<uint4*>(smem + L::Q + (c * M + r) * 16) = c < DN / 8 ? fold8(v[i], sp.ks)
                                                                             : v[i];
    }
  } else {
    for (int p = ctid; p < M * DQ / 8; p += CONSUMERS) {  // Q: row p % 64, piece p / 64
      const int r = p & 63, c = p >> 6;
      const bool live = row_live(r);
      const bf16* src = q;
      if (live) src += row_at(r) * DQ + c * 8;
      wg::cp_async16(smem + L::Q + (c * M + r) * 16, src, live ? 16 : 0);
    }
  }
  wg::cp_async_commit();
  wg::cp_async_wait_all();
  wg::fence_proxy();
  wg::bar_sync(1, CONSUMERS);

  // this thread's rows (r0, r0 + 8) of the accumulators
  const int r0 = 16 * wq + g;
  bool live[2];
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    live[h] = row_live(r);
    qpos[h] = ctx - seq_len + j0 + r / hb;
  }
  // the dense walk: keys up to the first row's causal end are unmasked
  const int open_end = ctx - seq_len + j0 + 1;
  // this thread's keys c < 8 of every chunk, kk(c) = 32 wgi + 8 (c / 2) + 2
  // t4 + c % 2; the sparse walk's as (selected slot, offset in the page),
  // advanced a chunk at a time
  int slot[8], off[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int kk = 32 * wgi + 8 * (c >> 1) + 2 * t4 + (c & 1);
    slot[c] = DENSE ? kk : kk / page_size;
    off[c] = DENSE ? 0 : kk % page_size;
  }
  const float scale2 = sm_scale * LOG2E;
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  for (int it = 0, k0 = k_lo; k0 < kend; ++it, k0 += KT) {
    const int st = it & 1;
    unsigned char* stage = smem + L::STAGES + st * L::STAGE;
    wg::mbar_wait(&full[st], (it >> 1) & 1);
    wg::fence_proxy();
    unsigned char* lat = stage;
    if constexpr (sizeof(KN) == 1) {
      if (it > 0) wg::bar_sync(1, CONSUMERS);  // both warpgroups are done with the last chunk
      widen_chunk(stage, smem + L::WIDE);
      wg::fence_proxy();
      wg::bar_sync(1, CONSUMERS);
      lat = smem + L::WIDE;
    }
    const unsigned char* rope = stage + L::RAW;

    // S: rows x this warpgroup's 32 keys, over the latent then the rope
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    wg::fence_operands(s);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < DN / 16; ++ks)
      wg::mma_m64n32k16<0>(s, wg::desc(smem + L::Q + ks * 2 * M * 16, M * 16, 128),
                           wg::desc_sw128(lat + (ks >> 2) * BOX + 32 * wgi * 128 + (ks & 3) * 32,
                                          16, 1024));
#pragma unroll
    for (int ks = 0; ks < DR / 16; ++ks)
      wg::mma_m64n32k16<1>(s, wg::desc(smem + L::Q + (DN / 8 + ks * 2) * M * 16, M * 16, 128),
                           wg::desc(rope + (4 * wgi * DR + 16 * ks) * 16, 128, DR * 16));
    wg::commit();
    wg::wait_all();
    wg::fence_operands(s);
    if constexpr (sizeof(KN) == 1) {  // int8: the stage's latent was widened, its rope read
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(&empty[st]);
    }
    if constexpr (DENSE && sizeof(KN) == 2) {
      // the chunk past the walk's end: its TMA boxes brought cache rows past
      // kend; P V reads the rows of this warpgroup's columns, zeroed here
      const int kv = kend - k0;
      for (int p = ctid & 127; p < (KT - kv) * 32; p += 128) {
        const int row = kv + (p >> 5), pc = p & 31;
        *reinterpret_cast<uint4*>(lat + (4 * wgi + (pc >> 3)) * BOX + row * 128 +
                                  (pc & 7) * 16) = make_uint4(0u, 0u, 0u, 0u);
      }
    }

    // masks, row maxima (swapped between the warpgroups), P, denominators
    bool walked[8];
    int kpos[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      walked[c] = DENSE || slot[c] < n_live;
      kpos[c] = DENSE ? k0 + slot[c] : walked[c] ? sel[slot[c]] * page_size + off[c] : 0;
    }
    const bool open = DENSE && k0 + KT <= open_end;   // every key <= every live row's end
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int h = (i >> 1) & 1, c = 2 * (i >> 2) + (i & 1);
      const bool ok = walked[c] && live[h] && (open || kpos[c] <= qpos[h]);
      s[i] = ok ? s[i] * scale2 : NEG;
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
    bf16* pw = reinterpret_cast<bf16*>(smem + L::P);
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int h = (i >> 1) & 1, c = 2 * (i >> 2);
      float p0, p1;
      if (DENSE) {  // a masked key weighs 0
        p0 = live[h] && (open || kpos[c] <= qpos[h]) ? ex2(s[i] - m_run[h]) : 0.f;
        p1 = live[h] && (open || kpos[c + 1] <= qpos[h]) ? ex2(s[i + 1] - m_run[h]) : 0.f;
      } else {  // a masked key of the walk weighs 2^(NEG - m): 1 while m is NEG
        p0 = walked[c] ? ex2(s[i] - m_run[h]) : 0.f;
        p1 = walked[c + 1] ? ex2(s[i + 1] - m_run[h]) : 0.f;
      }
      const __nv_bfloat162 pq = __floats2bfloat162_rn(p0, p1);
      sum[h] += __low2float(pq) + __high2float(pq);
      // P [key / 8][row][key % 8]: keys 32 wgi + 8 (i / 4) + 2 t4, + 1
      *reinterpret_cast<__nv_bfloat162*>(
          pw + ((4 * wgi + (i >> 2)) * M + r0 + 8 * h) * 8 + 2 * t4) = pq;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] *= alpha[(i >> 1) & 1];
    if (!DENSE) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {  // the next chunk's keys
        off[c] += KT;
        while (off[c] >= page_size) {
          off[c] -= page_size;
          ++slot[c];
        }
      }
    }
    wg::fence_proxy();
    wg::bar_sync(1, CONSUMERS);  // both warpgroups' P

    // O += P V over this warpgroup's 256 columns
    wg::fence_operands(o);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < KT / 16; ++ks)
      wg::mma_m64n256k16<1>(o, wg::desc(pb + ks * 2 * M * 8, M * 16, 128),
                            wg::desc_sw128(lat + 4 * wgi * BOX + 16 * ks * 128, BOX, 1024));
    wg::commit();
    wg::wait_all();
    wg::fence_operands(o);
    if constexpr (sizeof(KN) == 2) {
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(&empty[st]);
    }
  }

  // the denominators of both warpgroups' keys
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (t4 == 0) red[wgi * M + r0 + 8 * h] = l_run[h];
  wg::bar_sync(1, CONSUMERS);
  if (sp.part_o == nullptr || sp.n_live <= 1) {  // live rows out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live[h]) continue;
      const int r = r0 + 8 * h;
      const float l = red[r] + red[M + r];
      const float inv = l > 0.f ? 1.f / l : 0.f;
      bf16* orow = out + row_at(r) * DN + 256 * wgi + 2 * t4;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
            out2(o[4 * i + 2 * h], o[4 * i + 2 * h + 1], inv, sp);
    }
    return;
  }

  // a split of a row of several: (m, l, O) straight from the registers to
  // the scratch, then the ticket
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const int r = r0 + 8 * h;
    const size_t at = sp.s * sp.rows + row_at(r);
    float* po = sp.part_o + at * DN + 256 * wgi + 2 * t4;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      *reinterpret_cast<float2*>(po + 8 * i) = make_float2(o[4 * i + 2 * h], o[4 * i + 2 * h + 1]);
    if (wgi == 0 && t4 == 0) sp.part_ml[at] = make_float2(m_run[h], red[r] + red[M + r]);
  }
  __threadfence();
  wg::bar_sync(1, CONSUMERS);
  int* last = n_live_s + 1;
  if (ctid == 0) *last = atomicAdd(sp.ticket, 1) == sp.n_live - 1;
  wg::bar_sync(1, CONSUMERS);
  if (!*last) return;
  __threadfence();
  wg::fence_proxy_global();   // the other splits' scratch, read by the bulk copies

  // The last to arrive merges the row's splits in split order.  Its live
  // rows (K2: one token, heads h0 .. h0 + nrows) are consecutive in each
  // split's scratch, so a split comes in as pieces of 32 rows (64 KB) by the
  // bulk copy engine into a ring of three buffers where Q and the stages
  // were (rows one at a time through registers were bound by the L2's
  // latency).  First a thread a row: the splits' max, weights and 1 / l.
  const int nrows = min(hb, heads - h0);
  const size_t base = row_at(0);
  float* wsm = reinterpret_cast<float*>(smem + L::P);   // [M][MAX_SPLITS + 1]
  uint64_t* mb = reinterpret_cast<uint64_t*>(smem + L::MERGE);
  if (ctid < nrows) {
    float2 ml[MAX_SPLITS];
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j)
      ml[j] = j < sp.n_live ? __ldcg(sp.part_ml + j * sp.rows + base + ctid)
                            : make_float2(NEG, 0.f);
    float mm = NEG, ll = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) mm = fmaxf(mm, ml[j].x);
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      const float w = j < sp.n_live ? ex2(ml[j].x - mm) : 0.f;
      wsm[ctid * (MAX_SPLITS + 1) + j] = w;
      ll += ml[j].y * w;
    }
    wsm[ctid * (MAX_SPLITS + 1) + MAX_SPLITS] = ll > 0.f ? 1.f / ll : 0.f;
  }
  constexpr int PIECE = 32, BUF = PIECE * DN * 4;
  static_assert(3 * BUF <= L::P, "K2's merge ring overlaps the P tile");
  const int halves = (nrows + PIECE - 1) / PIECE, pieces = sp.n_live * halves;
  auto issue = [&](int p) {   // piece p: split p / halves, rows 32 (p % halves) ..
    const int hf = p % halves, k = p % 3;
    const int bytes = min(PIECE, nrows - PIECE * hf) * DN * 4;
    wg::mbar_expect_tx(&mb[k], bytes);
    wg::bulk_load(smem + k * BUF, sp.part_o + ((p / halves) * sp.rows + base + PIECE * hf) * DN,
                  bytes, &mb[k]);
    wg::mbar_arrive(&mb[k]);
  };
  if (ctid == 0) {
    for (int k = 0; k < 3; ++k) wg::mbar_init(&mb[k], 1);
    wg::fence_proxy();
    for (int p = 0; p < min(3, pieces); ++p) issue(p);
  }
  wg::bar_sync(1, CONSUMERS);
  // then each thread the 4 columns 4 (ctid % 128) of rows 2 i + ctid / 128 of
  // each piece
  float4 acc0[PIECE / 2], acc1[PIECE / 2];
#pragma unroll
  for (int i = 0; i < PIECE / 2; ++i)
    acc0[i] = acc1[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  auto add = [&](float4(&acc)[PIECE / 2], const float4* buf, int row0, int j) {
#pragma unroll
    for (int i = 0; i < PIECE / 2; ++i) {
      const int row = row0 + 2 * i + (ctid >> 7);
      if (row >= nrows) continue;
      const float w = wsm[row * (MAX_SPLITS + 1) + j];
      const float4 v = buf[i * CONSUMERS + ctid];
      acc[i].x += w * v.x;
      acc[i].y += w * v.y;
      acc[i].z += w * v.z;
      acc[i].w += w * v.w;
    }
  };
  for (int p = 0; p < pieces; ++p) {
    const int hf = p % halves, k = p % 3;
    wg::mbar_wait(&mb[k], (p / 3) & 1);
    const float4* buf = reinterpret_cast<const float4*>(smem + k * BUF);
    if (hf == 0)
      add(acc0, buf, 0, p / halves);
    else
      add(acc1, buf, PIECE, p / halves);
    wg::bar_sync(1, CONSUMERS);   // buffer k is free again
    if (ctid == 0 && p + 3 < pieces) issue(p + 3);
  }
  auto emit = [&](const float4(&acc)[PIECE / 2], int row0) {
#pragma unroll
    for (int i = 0; i < PIECE / 2; ++i) {
      const int row = row0 + 2 * i + (ctid >> 7);
      if (row >= nrows) continue;
      const float inv = wsm[row * (MAX_SPLITS + 1) + MAX_SPLITS];
      const __nv_bfloat162 lo = out2(acc[i].x, acc[i].y, inv, sp);
      const __nv_bfloat162 hi = out2(acc[i].z, acc[i].w, inv, sp);
      *reinterpret_cast<uint2*>(out + (base + row) * DN + 4 * (ctid & 127)) = make_uint2(
          *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    }
  };
  emit(acc0, 0);
  emit(acc1, PIECE);
  if (ctid == 0) *sp.ticket = 0;
}

}  // namespace mlas
