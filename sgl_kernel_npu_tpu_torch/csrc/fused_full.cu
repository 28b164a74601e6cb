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
// tk1, tn1, tk2, tn2, tn3 are a TPU schedule, not semantics.  One persistent,
// co-resident kernel (a cooperative launch) in phases:
//
//   0. entry barrier (window.cuh);
//   1. send: the (destination, expert) segments over the blocks, expert-major
//      with the destination rotated; a block copies its segment's int8 rows,
//      scales and (source, return row) pairs into the destination's window,
//      fences at system scope and release-stores arrive[me][e] = epoch there
//      (one arrival flag a (source, expert), in the window's flag region);
//   2. GMM1: (expert, 64-row tile) x (64 gate + 64 up columns) work items
//      over the blocks, each first waiting for its expert's arrivals from
//      every source; dequant + SwiGLU into an f32 scratch and each row's
//      |max| by atomicMax (k8::int8_tile, K8a's tile), then a grid sync;
//   3. the per-row requant (scale max(amax / 127, 1e-12), round half to
//      even), then a grid sync: a row's scale needs all its n-slices;
//   4. GMM2: (expert, 64-row tile) x 128 columns, dequant to bf16, each pair
//      of values stored straight into its source rank's return window at the
//      row the source sent it from (fused_full.py:29-34); fence, grid sync;
//   5. the return flags ret[me] = epoch in every peer's window, and the wait
//      for every peer's;
//   6. the weighted top-k reduce in f32 of each token's returned rows, k in
//      order, then bf16.  JAX splits the weights into bf16 hi + lo products
//      on the MXU; f32 weights are a recorded departure, as in
//      gmm2_combine_ring.
//
// Bound on the H100: bytes, by the touched experts' weights read once (at a
// 2048-token chunk of DeepSeek-V3 all 256 experts, 11.27 GB, 3.36 ms at 3.35
// TB/s, against 1.44 T int8 operations, 0.73 ms).  The tiles are K8a's:
// mma.sync on 64-row tiles aligned to each expert's first row, so an expert
// of up to 64 rows reads its weights once a GEMM.  The sends and the returns
// move 117 MB and 235 MB at that chunk; they are not overlapped with the
// GEMMs beyond what the arrival flags let (wgmma, TMA and overlap are later
// work).
#include <string.h>

#include "gmm_tile.cuh"
#include "window.cuh"

namespace ffull {

using bf16 = __nv_bfloat16;

// All fields 8 bytes (ctypes builds the same struct: parallel/fused_full.py).
struct Args {
  unsigned long long peers;                     // [R] window base pointers, device
  long long me, R, epoch, half;
  long long E, T, K, H, I;                      // local experts, tokens, top-k, widths
  long long off_x, off_s, off_m, off_ret;       // offsets in a data half, bytes
  // send side
  unsigned long long xq, xscale;                // [T, H] int8, [T] f32: this rank's rows
  unsigned long long row_tok;                   // [T K] token of each send row, compact order
  unsigned long long seg_cnt, seg_off, seg_dst;  // [R E] rows, first send row, first row there
  // receive side
  unsigned long long offsets, tile_off;         // [E + 1] rows / 64-row tiles of the experts
  unsigned long long w1, sw1, w2, sw2;          // [E, H, 2I], [E, 2I], [E, I, H], [E, H]
  unsigned long long act, amax, h1, hs;         // scratch [rows, I] f32, [rows] u32, int8, f32
  // reduce
  unsigned long long pair_pos, pair_w;          // [T K] return row (-1 none), weight
  unsigned long long out;                       // [T, H] bf16
};

template <class T>
__device__ __forceinline__ T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(p);
}

__global__ void __launch_bounds__(k8::THREADS, 2) fused_full_kernel(Args a) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  __shared__ k8::TileSmem sm;
  const auto* peers = ptr<const unsigned long long>(a.peers);
  const int me = (int)a.me, R = (int)a.R, E = (int)a.E, H = (int)a.H, I = (int)a.I;
  const unsigned long long epoch = (unsigned long long)a.epoch;
  const int tid = threadIdx.x;

  win::entry_barrier(peers, me, R, epoch);
  grid.sync();

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
      __threadfence_system();
      __syncthreads();
      if (tid == 0) win::st_release(win::arrive(peers, d) + me * E + e, epoch);
    }
  }

  char* mine = win::half(peers, me, epoch, a.half);
  const int* offsets = ptr<const int>(a.offsets);
  const int* tile_off = ptr<const int>(a.tile_off);
  const int n_items = tile_off[E];
  float* act = ptr<float>(a.act);
  unsigned* amax = ptr<unsigned>(a.amax);
  int8_t* h1 = ptr<int8_t>(a.h1);
  float* hs = ptr<float>(a.hs);

  // 2. GMM1 + dequant + SwiGLU, each work item after its expert's arrivals
  {
    const unsigned long long* arrive = win::arrive(peers, me);
    const int ct = (I + k8::HALF - 1) / k8::HALF;
    for (int w = blockIdx.x; w < n_items * ct; w += gridDim.x) {
      const int item = w / ct, bx = w % ct;
      const int g = k8::find_group(tile_off, E, item);
      if (tid < R)
        while (win::ld_acquire(arrive + tid * E + g) < epoch) {
        }
      __syncthreads();
      const int r0 = offsets[g] + (item - tile_off[g]) * k8::BM;
      const int r1 = min(r0 + k8::BM, offsets[g + 1]);
      k8::int8_tile<k8::kSwiGLU, false>(
          sm, reinterpret_cast<const int8_t*>(mine + a.off_x), nullptr,
          ptr<const int8_t>(a.w1) + (size_t)g * H * 2 * I, r0, r1, H, 2 * I, I, bx,
          reinterpret_cast<const float*>(mine + a.off_s),
          ptr<const float>(a.sw1) + (size_t)g * 2 * I,
          [](int, int, float, float) {}, act, amax);
    }
  }
  grid.sync();

  // 3. per-row requant
  const int total = offsets[E];
  for (int row = blockIdx.x; row < total; row += gridDim.x) {
    const float scale = fmaxf(__uint_as_float(__ldcg(amax + row)) / 127.f, 1e-12f);
    for (int c = tid; c < I; c += blockDim.x) {
      const float qv = rintf(__ldcg(act + (size_t)row * I + c) / scale);
      h1[(size_t)row * I + c] = (int8_t)fminf(fmaxf(qv, -128.f), 127.f);
    }
    if (tid == 0) hs[row] = scale;
  }
  grid.sync();

  // 4. GMM2 + dequant, stored into the sources' return windows
  {
    const int2* meta = reinterpret_cast<const int2*>(mine + a.off_m);
    const int ct = (H + k8::BN - 1) / k8::BN;
    for (int w = blockIdx.x; w < n_items * ct; w += gridDim.x) {
      const int item = w / ct, bx = w % ct;
      const int g = k8::find_group(tile_off, E, item);
      const int r0 = offsets[g] + (item - tile_off[g]) * k8::BM;
      const int r1 = min(r0 + k8::BM, offsets[g + 1]);
      k8::int8_tile<k8::kDequant, false>(
          sm, h1, nullptr, ptr<const int8_t>(a.w2) + (size_t)g * I * H, r0, r1, I, H, H / 2, bx, hs,
          ptr<const float>(a.sw2) + (size_t)g * H,
          [&](int row, int col, float v0, float v1) {
            const int2 m = __ldcg(meta + row);
            bf16* ret = reinterpret_cast<bf16*>(win::half(peers, m.x, epoch, a.half) + a.off_ret);
            k8::store_pair(ret, (size_t)m.y * H + col, v0, v1);
          },
          nullptr, nullptr);
    }
  }
  __threadfence_system();
  grid.sync();

  // 5. return flags
  if (blockIdx.x == 0 && tid < R) {
    const int d = (me + tid) % R;
    win::st_release(&win::header(peers, d)->ret[me], epoch);
    const win::Header* mh = win::header(peers, me);
    while (win::ld_acquire(&mh->ret[d]) < epoch) {
    }
  }
  grid.sync();

  // 6. weighted top-k reduce of the returned rows, f32, k in order
  {
    const bf16* retw = reinterpret_cast<const bf16*>(mine + a.off_ret);
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
}

}  // namespace ffull

// One fused MoE call (Args above); amax [rows] must be zero (the wrapper
// zeroes it).  Needs H % 128 == 0 and I % 64 == 0.
extern "C" int fused_full_launch(const void* args, void* stream) {
  ffull::Args a;
  memcpy(&a, args, sizeof(a));
  if (a.R < 1 || a.R > win::RMAX || a.R * a.E > win::MAX_SEGMENTS || a.H % 128 != 0 ||
      a.I % 64 != 0)
    return (int)cudaErrorInvalidValue;
  static int blocks = 0;
  if (blocks == 0) blocks = win::coop_blocks((const void*)ffull::fused_full_kernel, k8::THREADS, 2);
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)ffull::fused_full_kernel, dim3(blocks), dim3(k8::THREADS), params, 0,
      (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
