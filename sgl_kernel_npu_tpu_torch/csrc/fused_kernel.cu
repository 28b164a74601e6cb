// fused_dispatch_gmm1_rank (K16a): the one-sided dispatch of int8 rows and the
// dequantizing W8A8 GEMM1 on them, one launch a call.
//
// Replaces the TPU kernel sgl_kernel_npu_tpu/parallel/fused_kernel.py:
// fused_dispatch_gmm1_rank (_fused_kernel, :250): one pallas_call per rank on
// an (expert, n-tile, k-tile) grid that remote-DMAs this rank's rows into
// every peer's receive window in K-column chunks ([NK, R, ER, tk], a
// semaphore a (source, chunk)) and gates each expert's GEMM on the chunks'
// arrival.  The chunk-major window and its per-chunk semaphores are a TPU
// schedule (the MXU starts on chunk 0 while later chunks fly); here each
// source's rows land whole, by source, and an arrival flag a (source, expert)
// gates the GEMM tiles of that segment.
//
// out[e, s seg + i] = bf16(acc x sx[e, s seg + i] x sw1[e, :]), acc = the row
// that source s placed at xsend_s[me, e seg + i] times w1[e]; out [E, R seg,
// N].  A segment's rows past its count (a wrapper argument: the sender's
// counts [R, E]; without it every row of a segment is live) are zeros in
// JAX's xsend, so their outputs are exactly 0: the kernel neither sends nor
// multiplies them and writes the zeros.
//
// Bound on the H100: bytes, by the touched experts' weights read once (at a
// decode step of DeepSeek-V3, 64 rows over ~58 of 256 experts: 1.7 GB, 0.51
// ms at 3.35 TB/s) plus the padded output written once ([256, 128, 4096]
// bf16, 268 MB, 0.08 ms at seg 128); the int8 operations are far below.
//
// Design: one persistent, co-resident kernel (a cooperative launch, every
// block sends before it waits: window.cuh's rules) in phases:
//   0. entry barrier;
//   1. send: the (destination, expert) segments over the blocks, expert-major
//      with the destination rotated; a block copies the segment's live rows
//      into the destination's window at [me, e seg + i], its count to the
//      window's counts [me, e], fences at system scope and release-stores
//      arrive[me E + e] = epoch there;
//   2. GEMM1: (expert, source, 64-row tile) x 128-column work items over the
//      blocks; each waits for its segment's flag, reads the count, runs K8a's
//      int8 tile (gmm_tile.cuh, dequant to bf16) on the live rows and writes
//      zeros for the rows past the count.  An expert's weights are read once
//      a source segment (from L2 after the first); one rank, the card's case,
//      reads them once.
// Every segment of this rank is waited for by some item, so no peer still
// writes this rank's window when the kernel ends.
#include <string.h>

#include "gmm_tile.cuh"
#include "window.cuh"

namespace fkern {

using bf16 = __nv_bfloat16;

// All fields 8 bytes (ctypes builds the same struct: parallel/fused_kernel.py).
struct Args {
  unsigned long long peers;                     // [R] window base pointers, device
  long long me, R, epoch, half;
  long long E, seg, H, N;                       // local experts, segment rows, widths
  long long off_x, off_c;                       // offsets in a data half, bytes
  unsigned long long xsend;                     // [R, E seg, H] int8, placed by destination
  unsigned long long counts;                    // [R, E] int32 live rows a segment, or 0
  unsigned long long w1, sw1, sx;               // [E, H, N] int8, [E, N] f32, [E, R seg] f32
  unsigned long long out;                       // [E, R seg, N] bf16
};

template <class T>
__device__ __forceinline__ T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(p);
}

__global__ void __launch_bounds__(k8::THREADS, 2) fused_kernel_kernel(Args a) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  __shared__ k8::TileSmem sm;
  __shared__ int cnt_s;
  const auto* peers = ptr<const unsigned long long>(a.peers);
  const int me = (int)a.me, R = (int)a.R, E = (int)a.E, seg = (int)a.seg;
  const int H = (int)a.H, N = (int)a.N;
  const unsigned long long epoch = (unsigned long long)a.epoch;
  const int tid = threadIdx.x;

  win::entry_barrier(peers, me, R, epoch);
  grid.sync();

  // 1. send
  {
    const int8_t* xsend = ptr<const int8_t>(a.xsend);
    const int* counts = ptr<const int>(a.counts);
    const int vec = H / 16;
    for (int j = blockIdx.x; j < R * E; j += gridDim.x) {
      const int e = j / R, d = (me + 1 + j % R) % R;
      const int cnt = counts ? min(max(counts[d * E + e], 0), seg) : seg;
      char* dw = win::half(peers, d, epoch, a.half);
      const uint4* src = reinterpret_cast<const uint4*>(xsend + ((size_t)d * E + e) * seg * H);
      uint4* dst = reinterpret_cast<uint4*>(dw + a.off_x + ((size_t)me * E + e) * seg * H);
      for (int i = tid; i < cnt * vec; i += blockDim.x) dst[i] = __ldg(src + i);
      if (tid == 0) reinterpret_cast<int*>(dw + a.off_c)[me * E + e] = cnt;
      __threadfence_system();
      __syncthreads();
      if (tid == 0) win::st_release(win::arrive(peers, d) + me * E + e, epoch);
    }
  }

  // 2. GEMM1 + dequant on each arrived segment, zeros past its count
  {
    const char* mine = win::half(peers, me, epoch, a.half);
    const int* rcnt = reinterpret_cast<const int*>(mine + a.off_c);
    const unsigned long long* arrive = win::arrive(peers, me);
    const int tiles = (seg + k8::BM - 1) / k8::BM, ct = (N + k8::BN - 1) / k8::BN;
    bf16* out = ptr<bf16>(a.out);
    for (int w = blockIdx.x; w < E * R * tiles * ct; w += gridDim.x) {
      const int item = w / ct, bx = w % ct;
      const int e = item / (R * tiles), s = (item / tiles) % R, t = item % tiles;
      if (tid == 0) {
        while (win::ld_acquire(arrive + s * E + e) < epoch) {
        }
        cnt_s = __ldcg(rcnt + s * E + e);
      }
      __syncthreads();
      const int cnt = cnt_s;
      const int r0 = t * k8::BM, r1 = min(r0 + k8::BM, cnt), r_end = min(r0 + k8::BM, seg);
      const size_t row0 = (size_t)e * R * seg + (size_t)s * seg;   // out / sx row of i = 0
      if (r0 < r1)
        k8::int8_tile<k8::kDequant, false>(
            sm, reinterpret_cast<const int8_t*>(mine + a.off_x) + ((size_t)s * E + e) * seg * H,
            nullptr, ptr<const int8_t>(a.w1) + (size_t)e * H * N, r0, r1, H, N, N / 2, bx,
            ptr<const float>(a.sx) + row0, ptr<const float>(a.sw1) + (size_t)e * N,
            [&](int row, int col, float v0, float v1) {
              k8::store_pair(out, (row0 + row) * N + col, v0, v1);
            },
            nullptr, nullptr);
      for (int i = tid; i < (r_end - max(r0, cnt)) * (k8::BN / 2); i += blockDim.x) {
        const int row = max(r0, cnt) + i / (k8::BN / 2), col = bx * k8::BN + 2 * (i % (k8::BN / 2));
        if (col < N) k8::store_pair(out, (row0 + row) * N + col, 0.f, 0.f);
      }
      __syncthreads();                            // cnt_s is rewritten by the next item
    }
  }
}

}  // namespace fkern

// One fused dispatch + GEMM1 call (Args above).  Needs H % 16 == 0, N % 16
// == 0 and R E <= win::MAX_SEGMENTS.
extern "C" int fused_kernel_launch(const void* args, void* stream) {
  fkern::Args a;
  memcpy(&a, args, sizeof(a));
  if (a.R < 1 || a.R > win::RMAX || a.R * a.E > win::MAX_SEGMENTS || a.H % 16 != 0 ||
      a.N % 16 != 0 || a.seg < 1)
    return (int)cudaErrorInvalidValue;
  static int blocks = 0;
  if (blocks == 0)
    blocks = win::coop_blocks((const void*)fkern::fused_kernel_kernel, k8::THREADS, 2);
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fkern::fused_kernel_kernel, dim3(blocks), dim3(k8::THREADS), params, 0,
      (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
