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
// source's rows land whole, and an arrival flag a (source, expert) gates the
// GEMM units of that segment.
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
//      into the destination's window at rows (e R + me) seg + i (expert-major:
//      a window row is its output row, and its scale's), its count to the
//      window's counts [me, e], fences (the async proxy: the destination reads
//      the rows by TMA; then system scope) and release-stores arrive[me E + e]
//      = epoch there;
//   2. GEMM1: units (expert, source, 128-row item of the segment, 128-column
//      tile), taken one at a time by a ticket (an atomic counter, zero between
//      calls): a live unit's weight bytes cost ~100 us of a block, a unit of a
//      dead segment ~3 us, and which segments are live is known only as they
//      arrive, so a fixed split of the units would leave some blocks twice the
//      live units of others (8 tokens: 61 of 256 experts).  A unit waits for
//      its own segment's arrival flag alone (one slow source stalls only its
//      segments), reads the count that came with it, writes zeros with
//      16-byte stores for its rows past the count (all of them in a dead
//      segment), and runs its live rows on K8a's int8 ring
//      (gmm_int8_ring.cuh: weights by TMA, transposed to K-major in shared
//      memory, the rows by TMA from this call's window half, s8 wgmma,
//      dequant to bf16).  Rows of the next segment that a box takes in are
//      never stored.  The ring's blocks sync between units (no run-ahead
//      into the next unit's stages: a ticket is claimed when its unit starts,
//      so that no block holds a unit another could run);
//   3. a grid sync, and block 0 sets the ticket back to 0.
// Every segment of this rank is waited for by some unit, so no peer still
// writes this rank's window when the kernel ends.
#include <string.h>

#include "gmm_int8_ring.cuh"
#include "window.cuh"

namespace fkern {

using bf16 = __nv_bfloat16;

// All fields 8 bytes (ctypes builds the same struct: parallel/fused_kernel.py).
struct Args {
  unsigned long long peers;                     // [R] window base pointers, device
  unsigned long long mine;                      // this rank's window (peers[me]), for the host
  long long me, R, epoch, half;
  long long E, seg, H, N;                       // local experts, segment rows, widths
  long long off_x, off_c;                       // offsets in a data half, bytes
  unsigned long long xsend;                     // [R, E seg, H] int8, placed by destination
  unsigned long long counts;                    // [R, E] int32 live rows a segment, or 0
  unsigned long long w1, sw1, sx;               // [E, H, N] int8, [E, N] f32, [E, R seg] f32
  unsigned long long out;                       // [E, R seg, N] bf16
  unsigned long long ticket;                    // [1] int32, 0 (left 0 by every call)
};

template <class T>
__device__ __forceinline__ T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(p);
}

// xmap: this call's window rows [E R seg, H] (boxes of 128 k x 64 rows,
// 128-byte swizzle), wmap: w1 [E, H, N] as (N, H, E), boxes of 128 x 128 x 1.
__global__ void __launch_bounds__(k8::QTHREADS, 2)
    fused_kernel_kernel(const __grid_constant__ Args a, const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(1024) unsigned char smem[];
  int* unit_s = reinterpret_cast<int*>(smem + k8::QITEM_OFF);
  const auto* peers = ptr<const unsigned long long>(a.peers);
  const int me = (int)a.me, R = (int)a.R, E = (int)a.E, seg = (int)a.seg;
  const int H = (int)a.H, N = (int)a.N;
  const unsigned long long epoch = (unsigned long long)a.epoch;
  const int tid = threadIdx.x;

  if (tid == 0) k8::ring_init(smem);
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
      uint4* dst = reinterpret_cast<uint4*>(dw + a.off_x + ((size_t)e * R + me) * seg * H);
      for (int i = tid; i < cnt * vec; i += blockDim.x) dst[i] = __ldg(src + i);
      if (tid == 0) reinterpret_cast<int*>(dw + a.off_c)[me * E + e] = cnt;
      wg::fence_proxy_global();              // the destination reads the rows by TMA
      __threadfence_system();
      __syncthreads();
      if (tid == 0) win::st_release(win::arrive(peers, d) + me * E + e, epoch);
    }
  }

  // 2. GEMM1 + dequant, a unit a ticket; zeros past each segment's count
  {
    const char* mine = win::half(peers, me, epoch, a.half);
    const int* rcnt = reinterpret_cast<const int*>(mine + a.off_c);
    const unsigned long long* arrive = win::arrive(peers, me);
    const int tiles = (seg + k8::QM - 1) / k8::QM, ct = (N + k8::QN - 1) / k8::QN;
    const int n_units = E * R * tiles * ct;
    const float* sx = ptr<const float>(a.sx);
    const float* sw1 = ptr<const float>(a.sw1);
    bf16* out = ptr<bf16>(a.out);
    int* ticket = ptr<int>(a.ticket);
    uint32_t q = 0;                              // the ring's stages so far
    for (;;) {
      if (tid == 0) {
        const int w = atomicAdd(ticket, 1);
        int cnt = 0;
        if (w < n_units) {
          const int item = w / ct, e = item / (R * tiles), s = (item / tiles) % R;
          while (win::ld_acquire(arrive + s * E + e) < epoch) {
          }
          cnt = __ldcg(rcnt + s * E + e);
        }
        unit_s[0] = w;
        unit_s[1] = cnt;
      }
      __syncthreads();
      const int w = unit_s[0], cnt = unit_s[1];
      if (w >= n_units) break;
      wg::fence_proxy_global();                // then TMA reads the arrived rows
      const int item = w / ct, bx = w % ct;
      const int e = item / (R * tiles), s = (item / tiles) % R, t = item % tiles;
      const int r0 = t * k8::QM, tile_rows = min(k8::QM, seg - r0);
      const int rows = max(0, min(tile_rows, cnt - r0));
      const int row0 = (e * R + s) * seg + r0;   // the item's first window and output row
      {
        const int c0 = bx * k8::QN, vec = min(k8::QN, N - c0) / 8;   // 8 bf16 a store
        for (int i = tid; i < (tile_rows - rows) * vec; i += blockDim.x)
          *reinterpret_cast<uint4*>(out + (size_t)(row0 + rows + i / vec) * N + c0 +
                                    8 * (i % vec)) = make_uint4(0u, 0u, 0u, 0u);
      }
      if (rows > 0) {
        const k8::Unit u{e, row0, rows, bx};
        q = k8::int8_ring<k8::kDequant, false, true>(
            smem, q, 1, [&](int) { return u; }, &xmap, &wmap, nullptr, nullptr, H, N, N / 2,
            k8::QN, sx, sw1,
            [&](int row, int col, float v0, float v1) {
              k8::store_pair(out, (size_t)row * N + col, v0, v1);
            },
            nullptr, nullptr);
      }
      __syncthreads();                           // unit_s and the ring's slots are reused
    }
  }

  // 3. every block is past its last ticket: set the counter back
  grid.sync();
  if (blockIdx.x == 0 && tid == 0) *ptr<int>(a.ticket) = 0;
}

}  // namespace fkern

// The blocks of K16a's co-resident grid: two an SM, each with the ring's
// dynamic shared memory (set on the kernel first).
static int fused_kernel_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    const void* kernel = (const void*)fkern::fused_kernel_kernel;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k8::QSMEM);
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    blocks = win::coop_blocks(kernel, k8::QTHREADS, 2, k8::QSMEM);
  }
  return blocks;
}

// One fused dispatch + GEMM1 call (Args above).  Needs H % 16 == 0, N % 16
// == 0, R E <= win::MAX_SEGMENTS, the window, w1 and the data half 16-byte
// aligned (TMA) and the ticket 0.
extern "C" int fused_kernel_launch(const void* args, void* stream) {
  fkern::Args a;
  memcpy(&a, args, sizeof(a));
  if (a.R < 1 || a.R > win::RMAX || a.R * a.E > win::MAX_SEGMENTS || a.H % 16 != 0 ||
      a.N % 16 != 0 || a.seg < 1 || a.half % 16 != 0 || a.off_x % 16 != 0 || a.w1 % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  // the window rows of this call's half: (k, rows), boxes of 128 k x 64 rows
  const uint64_t xdims[2] = {(uint64_t)a.H, (uint64_t)(a.E * a.R * a.seg)};
  const uint64_t xstride[1] = {(uint64_t)a.H};
  const uint32_t xbox[2] = {k8::QK, 64};
  const char* xbase = (const char*)a.mine + win::DATA + (size_t)(a.epoch & 1) * a.half + a.off_x;
  int rc = wg::tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xbase, xdims, xstride, xbox);
  // w1 [E, H, N] as (N, H, E), boxes of 128 columns x 128 k x 1, no swizzle
  const uint64_t wdims[3] = {(uint64_t)a.N, (uint64_t)a.H, (uint64_t)a.E};
  const uint64_t wstride[2] = {(uint64_t)a.N, (uint64_t)a.H * a.N};
  const uint32_t wbox[3] = {k8::QN, k8::QK, 1};
  if (rc == 0)
    rc = wg::tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, (const void*)a.w1, wdims,
                        wstride, wbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  const int blocks = fused_kernel_blocks();
  if (blocks == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a, &xmap, &wmap};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fkern::fused_kernel_kernel, dim3(blocks), dim3(k8::QTHREADS), params,
      k8::QSMEM, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
