// fused_deep_moe_full_rank (K16b): DeepSeek-V3's expert-parallel W8A8 MoE
// on one rank in one launch: one-sided dispatch of the int8 rows and their
// scales, GMM1 + dequant + SwiGLU + per-row requant, GMM2 + dequant, the
// combine return, and the weighted top-k reduce.
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/parallel/fused_full.py:
// fused_deep_moe_full_rank (_fused_full_kernel, :1015): one pallas_call per
// rank on a (slot, step) grid whose slots are (expert, m-tile) pairs, remote
// DMAs into the peers' receive windows, arrival-gated GEMM steps, per-tile
// combine returns, and the reduce as a masked matmul over the return window.
//
// The count exchange runs before the kernel, on K15a over the window (JAX's
// NotifyDispatch phase, fused_full.py:15-20), and gives every compact
// offset; the wrapper (parallel/fused_full.py) turns them into the tables
// below.  Rows are packed back to back: JAX's 8-row alignment and its tm,
// tk1, tn1, tk2, tn2, tn3 are a TPU schedule, not semantics (tn1, the gate /
// up pack width, is a layout: it comes in as ht = tn1 / 2).  One persistent,
// co-resident kernel (a cooperative launch) in phases:
//
//   0. entry barrier (window.cuh);
//   1. send: the (destination, expert) segments over the blocks, expert-major
//      with the destination rotated; a block copies its segment's int8 rows,
//      scales and (source, return row) pairs into the destination's window,
//      fences (the async proxy: the destination reads the rows by TMA; then
//      system scope) and release-stores arrive[me][e] = epoch there (one
//      arrival flag a (source, expert), in the window's flag region);
//   2. GMM1: once every source's arrival flag for every local expert is
//      acquired (the sends take microseconds against the GEMMs'
//      milliseconds) and the async proxy fenced, (128-row item, 64 gate + 64
//      up columns) work units, each block walking units blockIdx.x, +
//      gridDim.x, ... on the int8 ring of gmm_int8_ring.cuh (K8a's: weights
//      by TMA into a landing ring and transposed to K-major in shared
//      memory, the received x rows by TMA from this call's window half, s8
//      wgmma); dequant + SwiGLU into an f32 scratch and each row's |max| by
//      atomicMax, then a grid sync;
//   3. the per-row requant (scale max(amax / 127, 1e-12), round half to
//      even) into h1, fenced for the async proxy, then a grid sync: a row's
//      scale needs all its column tiles;
//   4. GMM2: (128-row item, 128 columns) units on the same ring (h1 by TMA),
//      dequant to bf16, each pair of values stored straight into its source
//      rank's return window at the row the source sent it from
//      (fused_full.py:29-34); fence, grid sync;
//   5. the return flags ret[me] = epoch in every peer's window, and the wait
//      for every peer's;
//   6. the weighted top-k reduce in f32 of each token's returned rows, k in
//      order, then bf16.  JAX splits the weights into bf16 hi + lo products
//      on the MXU; f32 weights are a recorded departure, as in
//      gmm2_combine_ring.
//
// Bound on the H100: bytes, by the touched experts' weights read once (at a
// 2048-token chunk of DeepSeek-V3 all 256 experts, 11.27 GB, 3.36 ms at 3.35
// TB/s, against 1.44 T int8 operations, 0.73 ms; at a 64-token chunk ~225
// experts, 2.96 ms).  At a few rows an expert the products cost little and
// the kernel streams weights: the ring keeps three stages (48 KB) in flight
// a block, two blocks an SM, and a block's loading warps run into its next
// unit's stages while the current unit's products and epilogue finish (a
// grid of one unit a block cannot).  What bounds a block is its loading
// warps' pace, the transposes of the landed stages above all, so a
// warpgroup with no live rows in a unit sleeps at a named barrier instead of
// polling the ring's barriers beside them (gmm_int8_ring.cuh).  The sends
// and the returns move 117 MB and 235 MB at a 2048-token chunk; they are not
// overlapped with the GEMMs.  The int32 sums are exact and the epilogues
// those of the 64-row mma.sync tile that the GEMMs ran before the ring
// (gmm_int8_ring.cuh): the output is bit-identical to it.
#include <string.h>

#include "gmm_int8_ring.cuh"
#include "window.cuh"

namespace ffull {

using bf16 = __nv_bfloat16;

// All fields 8 bytes (ctypes builds the same struct: parallel/fused_full.py).
struct Args {
  unsigned long long peers;                     // [R] window base pointers, device
  unsigned long long mine;                      // this rank's window (peers[me]), for the host
  long long me, R, epoch, half;
  long long E, T, K, H, I, ht;                  // local experts, tokens, top-k, widths, pack / 2
  long long cap;                                // rows of the receive regions and the scratch
  long long off_x, off_s, off_m, off_ret;       // offsets in a data half, bytes
  // send side
  unsigned long long xq, xscale;                // [T, H] int8, [T] f32: this rank's rows
  unsigned long long row_tok;                   // [T K] token of each send row, compact order
  unsigned long long seg_cnt, seg_off, seg_dst;  // [R E] rows, first send row, first row there
  // receive side
  unsigned long long offsets, tile_off;         // [E + 1] rows / 128-row items of the experts
  unsigned long long w1, sw1, w2, sw2;          // [E, H, 2I], [E, 2I], [E, I, H], [E, H]
  unsigned long long act, amax, h1, hs;         // scratch [rows, I] f32, [rows] u32, int8, f32
  // reduce
  unsigned long long pair_pos, pair_w;          // [T K] return row (-1 none), weight
  unsigned long long out;                       // [T, H] bf16
  unsigned long long stamps;                    // [blocks, STAMPS] u64 or 0: phase times
};

// The phase boundaries a block stamps (%globaltimer, ns) where Args.stamps is
// given: start, after the entry sync, its sends done, its GMM1 units done,
// after the GMM1 sync, its requant rows done, after that sync, its GMM2 units
// done, after that sync, after the return flags' sync, its reduce done.
constexpr int STAMPS = 11;

__device__ __forceinline__ void stamp(const Args& a, int i) {
  if (a.stamps == 0 || threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  reinterpret_cast<unsigned long long*>(a.stamps)[blockIdx.x * STAMPS + i] = t;
}

template <class T>
__device__ __forceinline__ T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(p);
}

// The block's (item, column tile) units of a GEMM phase of ct column tiles:
// units w = blockIdx.x + j gridDim.x, the item's expert by a binary search
// over the device prefix sum of items (no host sync).
struct Units {
  const int *offsets, *tile_off;
  int E, ct;
  __device__ int count(int n_items) const {
    const int n = n_items * ct;
    return n > (int)blockIdx.x ? (n - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  }
  __device__ k8::Unit operator()(int j) const {
    const int w = blockIdx.x + j * gridDim.x, item = w / ct;
    const int g = k8::find_group(tile_off, E, item);
    const int r0 = offsets[g] + (item - tile_off[g]) * k8::QM;
    return k8::Unit{g, r0, min(r0 + k8::QM, offsets[g + 1]) - r0, w % ct};
  }
};

// GMM1 + dequant + SwiGLU on the block's units: act f32 and each row's |max|
// (amax); returns the ring's stage count for GMM2.
__device__ __forceinline__ uint32_t gmm1_phase(const Args& a, unsigned char* smem,
                                               const CUtensorMap* xmap,
                                               const CUtensorMap* w1map, int run) {
  const char* mine = win::half(ptr<const unsigned long long>(a.peers), (int)a.me, a.epoch, a.half);
  const Units units{ptr<const int>(a.offsets), ptr<const int>(a.tile_off), (int)a.E,
                    (int)(a.I / (k8::QN / 2))};
  return k8::int8_ring<k8::kSwiGLU, false, false>(
      smem, 0, units.count(units.tile_off[a.E]), units, xmap, w1map, nullptr, nullptr, (int)a.H,
      2 * (int)a.I, (int)a.ht, run, reinterpret_cast<const float*>(mine + a.off_s),
      ptr<const float>(a.sw1), [](int, int, float, float) {}, ptr<float>(a.act),
      ptr<unsigned>(a.amax));
}

// GMM2 + dequant to bf16, each pair stored into its source rank's return
// window at the row the source sent it from.
__device__ __forceinline__ void gmm2_phase(const Args& a, unsigned char* smem, uint32_t q,
                                           const CUtensorMap* hmap, const CUtensorMap* w2map) {
  const auto* peers = ptr<const unsigned long long>(a.peers);
  const unsigned long long epoch = (unsigned long long)a.epoch;
  const int H = (int)a.H;
  const int2* meta = reinterpret_cast<const int2*>(win::half(peers, (int)a.me, epoch, a.half) +
                                                   a.off_m);
  const Units units{ptr<const int>(a.offsets), ptr<const int>(a.tile_off), (int)a.E,
                    H / k8::QN};
  k8::int8_ring<k8::kDequant, false, false>(
      smem, q, units.count(units.tile_off[a.E]), units, hmap, w2map, nullptr, nullptr,
      (int)a.I, H, H / 2, k8::QN, ptr<const float>(a.hs), ptr<const float>(a.sw2),
      [&](int row, int col, float v0, float v1) {
        const int2 m = __ldcg(meta + row);
        bf16* ret = reinterpret_cast<bf16*>(win::half(peers, m.x, epoch, a.half) + a.off_ret);
        k8::store_pair(ret, (size_t)m.y * H + col, v0, v1);
      },
      nullptr, nullptr);
}

// xmap: this call's received x rows [cap, H] in this rank's window half,
// hmap: h1 [cap, I] (both boxes of 128 k x 64 rows, 128-byte swizzle), w1map
// / w2map: w1 [E, H, 2I] as (2I, H, E), boxes of run x 128 x 1, and w2 [E, I,
// H] as (H, I, E), boxes of 128 x 128 x 1 (int8_ring).
__global__ void __launch_bounds__(k8::QTHREADS, 2)
    fused_full_kernel(const __grid_constant__ Args a, const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap w1map,
                      const __grid_constant__ CUtensorMap w2map, int run) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(1024) unsigned char smem[];
  const auto* peers = ptr<const unsigned long long>(a.peers);
  const int me = (int)a.me, R = (int)a.R, E = (int)a.E, H = (int)a.H, I = (int)a.I;
  const unsigned long long epoch = (unsigned long long)a.epoch;
  const int tid = threadIdx.x;

  stamp(a, 0);
  if (tid == 0) k8::ring_init(smem);
  win::entry_barrier(peers, me, R, epoch);
  grid.sync();
  stamp(a, 1);

  // 1. send
  {
    const int8_t* xq = ptr<const int8_t>(a.xq);
    const float* xs = ptr<const float>(a.xscale);
    const int* row_tok = ptr<const int>(a.row_tok);
    const int vec = H / 16;
    for (int j = blockIdx.x; j < R * E; j += gridDim.x) {
      const int e = j / R, d = (me + 1 + j % R) % R, seg = d * E + e;
      const int cnt = ptr<const int>(a.seg_cnt)[seg], s0 = ptr<const int>(a.seg_off)[seg];
      const int r0 = ptr<const int>(a.seg_dst)[seg];
      char* dw = win::half(peers, d, epoch, a.half);
      int8_t* xw = reinterpret_cast<int8_t*>(dw + a.off_x);
      for (int i = tid; i < cnt * vec; i += blockDim.x) {
        const int r = i / vec, v = i % vec;
        reinterpret_cast<uint4*>(xw + (size_t)(r0 + r) * H)[v] =
            __ldg(reinterpret_cast<const uint4*>(xq + (size_t)row_tok[s0 + r] * H) + v);
      }
      for (int r = tid; r < cnt; r += blockDim.x) {
        reinterpret_cast<float*>(dw + a.off_s)[r0 + r] = xs[row_tok[s0 + r]];
        reinterpret_cast<int2*>(dw + a.off_m)[r0 + r] = make_int2(me, s0 + r);
      }
      wg::fence_proxy_global();              // the destination reads the rows by TMA
      __threadfence_system();
      __syncthreads();
      if (tid == 0) win::st_release(win::arrive(peers, d) + me * E + e, epoch);
    }
  }
  stamp(a, 2);

  // 2. GMM1 + dequant + SwiGLU, after every source's arrivals for every expert
  {
    const unsigned long long* arrive = win::arrive(peers, me);
    for (int f = tid; f < R * E; f += blockDim.x)
      while (win::ld_acquire(arrive + f) < epoch) {
      }
    __syncthreads();
    wg::fence_proxy_global();                // then TMA reads the arrived rows
  }
  const uint32_t q = gmm1_phase(a, smem, &xmap, &w1map, run);
  stamp(a, 3);
  grid.sync();
  stamp(a, 4);

  // 3. per-row requant
  {
    const int* offsets = ptr<const int>(a.offsets);
    const float* act = ptr<const float>(a.act);
    const unsigned* amax = ptr<const unsigned>(a.amax);
    int8_t* h1 = ptr<int8_t>(a.h1);
    float* hs = ptr<float>(a.hs);
    const int total = offsets[E];
    for (int row = blockIdx.x; row < total; row += gridDim.x) {
      const float scale = fmaxf(__uint_as_float(__ldcg(amax + row)) / 127.f, 1e-12f);
      for (int c = tid; c < I; c += blockDim.x) {
        const float qv = rintf(__ldcg(act + (size_t)row * I + c) / scale);
        h1[(size_t)row * I + c] = (int8_t)fminf(fmaxf(qv, -128.f), 127.f);
      }
      if (tid == 0) hs[row] = scale;
    }
    wg::fence_proxy_global();                // GMM2 reads h1 by TMA
  }
  stamp(a, 5);
  grid.sync();
  stamp(a, 6);

  // 4. GMM2 + dequant, stored into the sources' return windows
  wg::fence_proxy_global();
  gmm2_phase(a, smem, q, &hmap, &w2map);
  stamp(a, 7);
  __threadfence_system();
  grid.sync();
  stamp(a, 8);

  // 5. return flags
  if (blockIdx.x == 0 && tid < R) {
    const int d = (me + tid) % R;
    win::st_release(&win::header(peers, d)->ret[me], epoch);
    const win::Header* mh = win::header(peers, me);
    while (win::ld_acquire(&mh->ret[d]) < epoch) {
    }
  }
  grid.sync();
  stamp(a, 9);

  // 6. weighted top-k reduce of the returned rows, f32, k in order
  {
    const bf16* retw = reinterpret_cast<const bf16*>(win::half(peers, me, epoch, a.half) +
                                                     a.off_ret);
    const int* pair_pos = ptr<const int>(a.pair_pos);
    const float* pair_w = ptr<const float>(a.pair_w);
    bf16* out = ptr<bf16>(a.out);
    const int K = (int)a.K;
    for (int t = blockIdx.x; t < (int)a.T; t += gridDim.x)
      for (int c = 2 * tid; c < H; c += 2 * blockDim.x) {
        float s0 = 0.f, s1 = 0.f;
        for (int k = 0; k < K; ++k) {
          const int p = pair_pos[t * K + k];
          if (p < 0) continue;
          const float w = pair_w[t * K + k];
          const unsigned bits = __ldcg(reinterpret_cast<const unsigned*>(retw + (size_t)p * H + c));
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&bits);
          s0 += w * __low2float(v);
          s1 += w * __high2float(v);
        }
        k8::store_pair(out, (size_t)t * H + c, s0, s1);
      }
  }
  stamp(a, 10);
}

}  // namespace ffull

// The blocks of K16b's co-resident grid: two an SM, each with the ring's
// dynamic shared memory (set on the kernel first).
extern "C" int fused_full_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    const void* kernel = (const void*)ffull::fused_full_kernel;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k8::QSMEM);
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    blocks = win::coop_blocks(kernel, k8::QTHREADS, 2, k8::QSMEM);
  }
  return blocks;
}

// One fused MoE call (Args above); amax [rows] must be zero (the wrapper
// zeroes it), the window and the weights 16-byte aligned (TMA); stamps, where
// given, holds STAMPS u64 for each of the grid's blocks (fused_full_blocks).
// Needs H % 128 == 0, I % 64 == 0, ht % 16 == 0 and 2 I % (2 ht) == 0.
extern "C" int fused_full_launch(const void* args, void* stream) {
  ffull::Args a;
  memcpy(&a, args, sizeof(a));
  if (a.R < 1 || a.R > win::RMAX || a.R * a.E > win::MAX_SEGMENTS || a.H % 128 != 0 ||
      a.I % 64 != 0 || a.cap < 1 || a.ht < 16 || a.ht % 16 != 0 || (2 * a.I) % (2 * a.ht) != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, hmap, w1map, w2map;
  // the received rows in this call's half, h1: (k, rows), boxes of 128 k x 64 rows
  const uint64_t xdims[2] = {(uint64_t)a.H, (uint64_t)a.cap}, xstride[1] = {(uint64_t)a.H};
  const uint64_t hdims[2] = {(uint64_t)a.I, (uint64_t)a.cap}, hstride[1] = {(uint64_t)a.I};
  const uint32_t xbox[2] = {k8::QK, 64};
  const char* xbase = (const char*)a.mine + win::DATA + (size_t)(a.epoch & 1) * a.half + a.off_x;
  int rc = wg::tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xbase, xdims, xstride, xbox);
  if (rc == 0)
    rc = wg::tensor_map(&hmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, (const void*)a.h1, hdims, hstride,
                        xbox);
  // the gate / up halves' boxes: the widest of 64, 32, 16 columns dividing ht
  const int run = a.ht % 64 == 0 ? 64 : a.ht % 32 == 0 ? 32 : 16;
  const uint64_t w1dims[3] = {(uint64_t)(2 * a.I), (uint64_t)a.H, (uint64_t)a.E};
  const uint64_t w1str[2] = {(uint64_t)(2 * a.I), (uint64_t)a.H * 2 * a.I};
  const uint32_t w1box[3] = {(uint32_t)run, k8::QK, 1};
  const uint64_t w2dims[3] = {(uint64_t)a.H, (uint64_t)a.I, (uint64_t)a.E};
  const uint64_t w2str[2] = {(uint64_t)a.H, (uint64_t)a.I * a.H};
  const uint32_t w2box[3] = {k8::QN, k8::QK, 1};
  if (rc == 0)
    rc = wg::tensor_map(&w1map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, (const void*)a.w1, w1dims,
                        w1str, w1box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0)
    rc = wg::tensor_map(&w2map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, (const void*)a.w2, w2dims,
                        w2str, w2box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  const int blocks = fused_full_blocks();
  if (blocks == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a, &xmap, &hmap, &w1map, &w2map, (void*)&run};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)ffull::fused_full_kernel, dim3(blocks), dim3(k8::QTHREADS), params, k8::QSMEM,
      (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
