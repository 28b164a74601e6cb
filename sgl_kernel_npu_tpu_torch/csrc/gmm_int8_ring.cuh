// The int8 GEMM ring for Hopper, shared by K8a's int8 modes
// (grouped_matmul.cu, gmm_int8_kernel: one work unit a block), the first pass
// of grouped_matmul_combine (K8b, grouped_matmul.cu's combine_rows_kernel: a
// persistent block walking a list of units), the fused dispatch + GEMM1
// (K16a, fused_kernel.cu: a unit at a time, claimed by ticket) and the fused
// MoE's two GEMM phases (fused_full.cu, K16b: a persistent block walking a
// list of units).  A work unit is (work item, column tile): an item is up to
// QM = 128 sorted rows of one group, aligned to the group's first row (the
// wrapper's tile offsets of 128-row items), so a group of up to 128 rows
// streams its weights once; a column tile is 128 columns: 128 consecutive ones
// ("dequant", "none"), or 64 gate columns and the 64 matching up columns (the
// SwiGLU modes: in a packing of width tn = 2 ht, output column j pairs gate
// column (j / ht) 2 ht + j % ht with the up column ht further, gate_col
// below), so that SwiGLU pairs within a thread.
//
// s8 wgmma reads both operands K-major only, and the weights are [G, K, N]
// with N contiguous (the layout the ring GEMMs and the fused MoE read; a
// second, transposed copy would be 11 GB more at DeepSeek-V3), so:
//   Loads (warps 8 and 9): one lane issues each stage of 128 k as TMA boxes
//     of the weights, [128 k][run columns] without swizzle (run = 128 for
//     "dequant"; the SwiGLU halves as boxes of 64, 32 or 16 columns, the
//     widest that divides the pack's half width: every box is contiguous in
//     N) into a landing ring of QRAW stages, and the unit's x rows, [128
//     rows][128 k] in the 128-byte swizzle (K-major A), into a ring of QSX
//     stages, QSX - 1 stages ahead; with a row map (K8a's dispatch_p) the two
//     warps gather the x rows by cp.async into the same swizzle (a row map
//     TMA cannot follow).  The two warps transpose each landed stage into the
//     K-major [128 columns][128 k] weight stage in the 128-byte swizzle, 16
//     k-rows x 4 columns a lane at a time (16 word loads, four 4 x 4 byte
//     transposes by __byte_perm, four 16-byte stores), the lanes spread so
//     that neither the loads nor the stores of a warp meet on a bank
//     (transpose_stage).  rhs_contract_last's [G, N, K] is K-major already:
//     its boxes land in the weight stage as they are.  Columns and k past the
//     edges read as zeros.  Shared memory goes to the bytes in flight (three
//     stages of x, three landed): one transposed weight stage keeps up, since
//     a stage's products and its transpose take a fraction of the time its
//     bytes take to stream (2 x / 1 weight / 4 landed and 2 / 2 / 3 were no
//     faster).  The stages of all units form one stream: the loads of a
//     block's next unit start while the products of its current unit finish.
//   Products (warpgroups 0 and 1): 64 rows each, wgmma m64n128k32 s8 into 64
//     s32 accumulators a thread; each stage's x and weights released when its
//     products are done.  Warpgroup 1 skips the units of at most 64 rows:
//     warpgroup 0 releases their stages for both (two arrivals a warp), so
//     that no idle warp polls a barrier, and before a unit of more rows the
//     two meet at a named barrier (1 would otherwise wait on a stage's barrier
//     phases ahead of 0, whose parity cannot tell them apart).
//   Epilogues keep JAX's order: the int32 sum (exact; JAX sums k-tile
//   partials in f32) to f32, x scale_x[row], x scale_w[g, col], then SwiGLU
//   in f32 and the output; or, requantized (kSwiGLU), the activation to an
//   f32 scratch and its |max| to a per-row atomicMax on the float bits
//   (non-negative floats order as unsigned ints: exact and deterministic),
//   and a later pass requantizes each row.  A unit never writes rows of its
//   item outside its group.  These are the operations of the 64-row
//   mma.sync tile that ran K8a, K8b and K16a before the ring: every output
//   is bit-identical to it.
//
// mbarrier phases: every ring's stage s is number base + s of the block's
// stream (base: the stages the block ran before, returned by int8_ring), and
// its slot and parity follow from that number, so a persistent block keeps
// its barriers across units and across calls of int8_ring.  Between two
// calls the block (K16b: the grid) synchronizes: the first loads of the next
// call take slots whose last release the loading warps did not wait for.
#pragma once

#include "gmm_common.cuh"
#include "wgmma.cuh"

namespace k8 {

using bf16 = __nv_bfloat16;

// kDequant: acc x sx[row] x sw[col] (each scale 1 where its pointer is null);
// kSwiGLU: SwiGLU of the dequantized gate / up pair to an f32 scratch and the
// row's |max| (the requant follows in another pass); kSwiGLUOut: the same
// SwiGLU stored through the output functor (K8a's float "dequant_swiglu").
enum Epilogue { kDequant = 0, kSwiGLU = 1, kSwiGLUOut = 2 };

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

// The group of work item ``item``: tile_off[g] <= item < tile_off[g + 1], by a
// binary search over the device prefix sum of items (no host sync).
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

// x scales: __ldg (read-only for the kernel) or ld.global.cg (written by
// other blocks or peers while the kernel runs: K16b's window).
template <bool RO, class T>
__device__ __forceinline__ T load_x(const T* p) {
  if (RO) return __ldg(p);
  return __ldcg(p);
}

constexpr int QM = 128;                         // rows of an int8 work item
constexpr int QN = 128;                         // columns of a unit
constexpr int QK = 128;                         // k bytes of a stage
constexpr int QSX = 3;                          // x rows, 128 x 128 k
constexpr int QSW = 1;                          // K-major weights, 128 columns x 128 k
constexpr int QRAW = 3;                         // landed [k][n] weights
constexpr int QCONSUMERS = 256;                 // warpgroups 0 and 1 compute,
constexpr int QPRODUCERS = 64;                  // warps 8 and 9 load and transpose
constexpr int QTHREADS = QCONSUMERS + QPRODUCERS;
constexpr uint32_t QX = QM * QK;                // a stage's x rows, 1024-aligned
constexpr uint32_t QW = QN * QK;                // a stage's weights
constexpr uint32_t QW_OFF = QSX * QX;                   // [QSW] K-major weights
constexpr uint32_t QRAW_OFF = QW_OFF + QSW * QW;        // [QRAW] landed weights
constexpr uint32_t QITEM_OFF = QRAW_OFF + QRAW * QW;    // 16 bytes for the caller
// xfull[QSX], xempty[QSX], wfull[QSW], wempty[QSW], landed[QRAW]
constexpr uint32_t QBARS_OFF = QITEM_OFF + 16;
constexpr uint32_t QSMEM = QBARS_OFF + (2 * QSX + 2 * QSW + QRAW) * 8;
static_assert(2 * (QSMEM + 1024) <= 233472, "the int8 ring's blocks exceed an SM's shared memory");

// `count` arrivals on a barrier at once (release at CTA scope).
__device__ __forceinline__ void mbar_arrive_n(uint64_t* bar, int count) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
                   sgl::smem_addr(bar)), "r"(count)
               : "memory");
}

// One work unit: rows [r0, r0 + rows) of group g x column tile bx (a unit of
// no rows loads and multiplies but stores nothing).
struct Unit {
  int g, r0, rows, bx;
};

struct RingBars {
  uint64_t *xfull, *xempty, *wfull, *wempty, *landed;
};

__device__ __forceinline__ RingBars ring_bars(unsigned char* smem) {
  uint64_t* b = reinterpret_cast<uint64_t*>(smem + QBARS_OFF);
  return RingBars{b, b + QSX, b + 2 * QSX, b + 2 * QSX + QSW, b + 2 * QSX + 2 * QSW};
}

// The ring's barriers, by one thread; the block syncs before using them.
__device__ __forceinline__ void ring_init(unsigned char* smem) {
  const RingBars b = ring_bars(smem);
  for (int i = 0; i < QSX; ++i) {
    wg::mbar_init(&b.xfull[i], QPRODUCERS);     // each producer thread once
    wg::mbar_init(&b.xempty[i], QCONSUMERS / 32);   // each computing warp once
  }
  for (int i = 0; i < QSW; ++i) {
    wg::mbar_init(&b.wfull[i], QPRODUCERS);
    wg::mbar_init(&b.wempty[i], QCONSUMERS / 32);
  }
  for (int i = 0; i < QRAW; ++i) wg::mbar_init(&b.landed[i], 1);
}

// The landed weights [k][columns], boxes of `run` columns ([128 k][run] each,
// without swizzle) -> the stage's K-major [128 columns][128 k] in the 128-byte
// swizzle, by the producer warp pw and lane.  A unit is 16 k-rows x 4
// columns: 16 words in, four 4 x 4 byte transposes (__byte_perm), 4 rows of
// 16 bytes out.  Lane l takes columns 4 l .. 4 l + 3 and the k-blocks kb = l
// ^ 4 (l % 2) ^ t, so that a warp's loads touch 32 banks and each quarter
// warp's 16-byte stores 8 distinct ones; in narrow boxes a lane reads its
// rows in the order j ^ g within each quad (g its box's rank, 2 bits) so that
// lanes of different boxes meet other banks (boxes of 16 columns: 2 lanes a
// bank), and its transposes take the rows back in order.
__device__ __forceinline__ void transpose_stage(const unsigned char* raw, unsigned char* ws,
                                                int run, int pw, int lane) {
  const int c0 = 4 * lane;                       // this lane's 4 columns
  const unsigned char* col = raw + (c0 / run) * run * QK + c0 % run;
  const int g = (lane / (run / 4)) & 3;
  const uint32_t s_lo = (g & 1) ? 0x1504u : 0x5140u, s_hi = (g & 1) ? 0x3726u : 0x7362u;
#pragma unroll 1
  for (int t = pw; t < 8; t += QPRODUCERS / 32) {
    const int kb = (lane ^ (4 * (lane & 1)) ^ t) & 7;
    uint32_t v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r)
      v[r] = *reinterpret_cast<const uint32_t*>(col + (16 * kb + (r ^ g)) * run);
    uint32_t o[4][4];                            // o[quad][column]: 4 k bytes of a column
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // v[4 q + j] is row 4 q + (j ^ g): pair A (j = 0, 1), pair B (j = 2, 3)
      const uint32_t lo_a = __byte_perm(v[4 * q], v[4 * q + 1], s_lo);
      const uint32_t hi_a = __byte_perm(v[4 * q], v[4 * q + 1], s_hi);
      const uint32_t lo_b = __byte_perm(v[4 * q + 2], v[4 * q + 3], s_lo);
      const uint32_t hi_b = __byte_perm(v[4 * q + 2], v[4 * q + 3], s_hi);
      const uint32_t lo01 = (g & 2) ? lo_b : lo_a, lo23 = (g & 2) ? lo_a : lo_b;
      const uint32_t hi01 = (g & 2) ? hi_b : hi_a, hi23 = (g & 2) ? hi_a : hi_b;
      o[q][0] = __byte_perm(lo01, lo23, 0x5410);
      o[q][1] = __byte_perm(lo01, lo23, 0x7632);
      o[q][2] = __byte_perm(hi01, hi23, 0x5410);
      o[q][3] = __byte_perm(hi01, hi23, 0x7632);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = c0 + c;
      *reinterpret_cast<uint4*>(ws + n * QK + ((kb ^ (n & 7)) << 4)) =
          make_uint4(o[0][c], o[1][c], o[2][c], o[3][c]);
    }
  }
}

// A unit's products, in one computing warpgroup's 64 accumulators a thread,
// through the epilogue: the warpgroup holds the unit's rows rb .. rb + 63.
// acc[4 i + 2 h + e]: row rb + 16 (warp % 4) + lane / 4 + 8 h, column 8 i + 2
// (lane % 4) + e of the tile (SwiGLU: gate columns i < 8, their up columns i
// + 8).
template <int EPI, bool RO, class Out>
__device__ __forceinline__ void ring_epilogue(const Unit& u, const int (&acc)[64], int rb, int N,
                                              int ht, const float* __restrict__ sx,
                                              const float* __restrict__ sw, Out& out,
                                              float* __restrict__ act,
                                              unsigned* __restrict__ amax) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3, g8 = lane >> 2, t4 = lane & 3;
  const float* swg = sw ? sw + (size_t)u.g * N : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rb + 16 * wq + g8 + 8 * h;
    const bool live = r < u.rows;
    const int row = u.r0 + r;
    const float sxr = live ? (sx ? load_x<RO>(sx + row) : 1.f) : 0.f;
    if (EPI == kDequant) {
      if (!live) continue;
#pragma unroll
      for (int i = 0; i < QN / 8; ++i) {
        const int col = u.bx * QN + 8 * i + 2 * t4;
        if (col >= N) continue;
        const float sw0 = swg ? swg[col] : 1.f, sw1 = swg ? swg[col + 1] : 1.f;
        out(row, col, __int2float_rn(acc[4 * i + 2 * h]) * sxr * sw0,
            __int2float_rn(acc[4 * i + 2 * h + 1]) * sxr * sw1);
      }
    } else {
      const int I = N / 2;
      float m = 0.f;
#pragma unroll
      for (int i = 0; i < QN / 16; ++i) {
        const int j = u.bx * (QN / 2) + 8 * i + 2 * t4;
        if (!live || j >= I) continue;
        const int gc = gate_col(j, ht);        // j and j + 1 share a slab (ht even)
        float a2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d0 = __int2float_rn(acc[4 * i + 2 * h + e]) * sxr * swg[gc + e];
          const float d1 = __int2float_rn(acc[4 * (i + 8) + 2 * h + e]) * sxr * swg[gc + ht + e];
          a2[e] = d0 * (1.f / (1.f + expf(-d0))) * d1;
          m = fmaxf(m, fabsf(a2[e]));
        }
        if (EPI == kSwiGLU) store_pair(act, (size_t)row * I + j, a2[0], a2[1]);
        else out(row, j, a2[0], a2[1]);
      }
      if (EPI == kSwiGLU) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (t4 == 0 && live) atomicMax(amax + row, __float_as_uint(m));
      }
    }
  }
}

// Runs units 0 .. n_units - 1 (unit_of(j) -> Unit) through the ring; every
// thread of the block calls it, and every thread's unit_of gives the same
// units.  Its stages are numbers base .. base + n_units nk - 1 of the block's
// stream (nk = ceil(K / QK)); returns base + n_units nk.  x [S, K] int8 rows
// (row r reads x[xrow[r]] where xrow is given, a zero row where that is <
// 0; else xmap, x as (K, S), boxes of 128 k x 64 rows in the 128-byte
// swizzle), wmap the weights ([G, K, N] as (N, K, G), boxes of run x 128 x 1
// without swizzle; CL: [G, N, K] as (K, N, G), boxes of 128 x 128 x 1 in the
// 128-byte swizzle), sx [S] and sw [G, N] (null: 1).  kDequant and kSwiGLUOut
// store the output pairs by out(row, col, v, v'); kSwiGLU writes act [S, N /
// 2] f32 and amax [S].  RO: x scales read-only for the kernel (__ldg), else
// written while it runs (K16b's window: ld.global.cg).
template <int EPI, bool CL, bool RO, class UnitOf, class Out>
__device__ __forceinline__ uint32_t int8_ring(unsigned char* smem, uint32_t base, int n_units,
                                              UnitOf unit_of,
                                              const CUtensorMap* xmap, const CUtensorMap* wmap,
                                              const int8_t* __restrict__ x,
                                              const int* __restrict__ xrow, int K, int N, int ht,
                                              int run, const float* __restrict__ sx,
                                              const float* __restrict__ sw, Out out,
                                              float* __restrict__ act,
                                              unsigned* __restrict__ amax) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nk = (K + QK - 1) / QK;
  const uint32_t total = (uint32_t)n_units * nk;
  const RingBars b = ring_bars(smem);

  if (warp >= QCONSUMERS / 32) {  // the producer warps
    const int ptid = tid - QCONSUMERS, pw = ptid >> 5;
    unsigned char* raw = smem + QRAW_OFF;
    // each stream the warps issue (landing, x, weights) walks the stages in
    // order: a cursor (unit, k-stage) and the unit's tiles, without a division
    struct Cursor {
      int j, k;
      Unit u;
    };
    Cursor lc{0, 0, {}}, xc{0, 0, {}}, wc{0, 0, {}};
    auto at = [&](Cursor& c) -> const Cursor& {   // the stage the cursor stands at
      if (c.k == 0) c.u = unit_of(c.j);
      return c;
    };
    auto step = [&](Cursor& c) {
      if (++c.k == nk) c.k = 0, ++c.j;
    };
    auto land = [&](uint32_t s) {  // stage s's weights into landing slot (base + s) % QRAW
      const Cursor& c = at(lc);
      const Unit& u = c.u;
      const uint32_t q = base + s;
      uint64_t* bar = &b.landed[q % QRAW];
      unsigned char* dst = raw + (q % QRAW) * QW;
      const int k0 = c.k * QK;
      wg::mbar_expect_tx(bar, QW);
      if (EPI == kDequant) {
        wg::tma_load_3d(dst, wmap, u.bx * QN, k0, u.g, bar);
      } else {
        for (int c = 0; c < QN / 2; c += run) {  // gate columns c .. c + run, then up
          const int gc = gate_col(u.bx * (QN / 2) + c, ht);
          wg::tma_load_3d(dst + c * QK, wmap, gc, k0, u.g, bar);
          wg::tma_load_3d(dst + (QN / 2 + c) * QK, wmap, gc + ht, k0, u.g, bar);
        }
      }
      wg::mbar_arrive(bar);
      step(lc);
    };
    auto load_x = [&](uint32_t s) {  // stage s's x rows into slot (base + s) % QSX
      const uint32_t q = base + s;
      uint64_t* bar = &b.xfull[q % QSX];
      unsigned char* xs = smem + (q % QSX) * QX;
      if (xrow == nullptr) {                   // one lane issues the boxes
        if (ptid == 0) {
          const Cursor& c = at(xc);
          const Unit& u = c.u;
          const int k0 = c.k * QK, active = u.rows > 64 ? 2 : 1;
          wg::mbar_expect_tx(bar, active * 64 * QK);
          for (int h = 0; h < active; ++h)
            wg::tma_load_2d(xs + h * 64 * QK, xmap, k0, u.r0 + 64 * h, bar);
          step(xc);
        }
      } else {  // 16-byte pieces swizzled as TMA would (K % 16 == 0)
        const Cursor& c = at(xc);
        const Unit& u = c.u;
        const int k0 = c.k * QK;
        for (int e = ptid; e < u.rows * (QK / 16); e += QPRODUCERS) {
          const int r = e >> 3, pc = e & 7, kk = k0 + 16 * pc, sr = __ldg(xrow + u.r0 + r);
          const bool live = sr >= 0 && kk < K;
          wg::cp_async16(xs + r * QK + ((pc ^ (r & 7)) << 4), live ? x + (size_t)sr * K + kk : x,
                         live ? 16 : 0);
        }
        step(xc);
      }
      wg::mbar_arrive_cp_async(bar);           // when this thread's x pieces land
    };
    if (!CL && ptid == 0)
      for (uint32_t s = 0; s < QRAW && s < total; ++s) land(s);
    for (uint32_t s = 0; s < QSX && s < total; ++s) load_x(s);
    for (uint32_t s = 0; s < total; ++s) {
      const uint32_t q = base + s;
      unsigned char* wst = smem + QW_OFF + (q % QSW) * QW;
      if (q >= QSW) wg::mbar_wait(&b.wempty[q % QSW], (q / QSW - 1) & 1);
      if (CL) {
        if (ptid == 0) {
          const Cursor& c = at(wc);
          wg::mbar_expect_tx(&b.wfull[q % QSW], QW);
          wg::tma_load_3d(wst, wmap, c.k * QK, c.u.bx * QN, c.u.g, &b.wfull[q % QSW]);
          step(wc);
        }
        wg::mbar_arrive(&b.wfull[q % QSW]);
      } else {
        wg::mbar_wait(&b.landed[q % QRAW], (q / QRAW) & 1);
        transpose_stage(raw + (q % QRAW) * QW, wst, EPI == kDequant ? QN : run, pw, lane);
        wg::fence_proxy();
        wg::mbar_arrive(&b.wfull[q % QSW]);
        wg::bar_sync(1, QPRODUCERS);           // both warps are done with the landing slot
        if (ptid == 0 && s + QRAW < total) land(s + QRAW);
      }
      // x rows QSX - 1 stages ahead, into the slot that stage s - 1 frees
      if (s >= 1 && s - 1 + QSX < total) {
        wg::mbar_wait(&b.xempty[(q - 1) % QSX], ((q - 1) / QSX) & 1);
        load_x(s - 1 + QSX);
      }
    }
    return base + total;
  }

  const int wgi = tid >> 7;
  uint32_t q = base;
  for (int j = 0; j < n_units; ++j) {
    const Unit u = unit_of(j);
    const int active = u.rows > 64 ? 2 : 1;     // computing warpgroups with live rows
    if (active == 2) {
      wg::bar_sync(2, QCONSUMERS);              // warpgroup 1 waits here for 0 to catch up
    } else if (wgi == 1) {                      // 0 releases these stages for both
      q += nk;
      continue;
    }
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int it = 0; it < nk; ++it, ++q) {
      const unsigned char* xs = smem + (q % QSX) * QX;
      const unsigned char* wst = smem + QW_OFF + (q % QSW) * QW;
      wg::mbar_wait(&b.xfull[q % QSX], (q / QSX) & 1);
      wg::mbar_wait(&b.wfull[q % QSW], (q / QSW) & 1);
      wg::fence_proxy();                       // pieces by cp.async and the transposed stores
      wg::fence_operands(acc);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < QK / 32; ++ks)
        wg::mma_s8_m64n128k32(acc, wg::desc_sw128(xs + wgi * 64 * QK + ks * 32, 16, 1024),
                              wg::desc_sw128(wst + ks * 32, 16, 1024));
      wg::commit();
      wg::wait_all();                          // this stage's products are done: free it
      wg::fence_operands(acc);
      __syncwarp();
      if (lane == 0) {                         // for both warpgroups where one computes
        mbar_arrive_n(&b.xempty[q % QSX], 3 - active);
        mbar_arrive_n(&b.wempty[q % QSW], 3 - active);
      }
    }
    ring_epilogue<EPI, RO>(u, acc, 64 * wgi, N, ht, sx, sw, out, act, amax);
  }
  return q;
}

}  // namespace k8
