// The one-sided window all-to-alls: pallas_all_to_all (K15a), and
// pallas_ragged_all_to_all (K15b) with its monitored form (K15c: the same
// kernel with bounded waits and statistics).  Also the window's C API:
// allocation, CUDA IPC export and import (parallel/pallas_a2a.py).
//
// Replaces the TPU kernels sgl_kernel_npu_tpu/parallel/pallas_a2a.py:
// pallas_all_to_all (_a2a_kernel, :703), pallas_ragged_all_to_all
// (_ragged_a2a_kernel, :637) and its monitored form
// (_ragged_a2a_monitored_kernel, :594).  There every rank's output buffer is
// its receive window, peers write their blocks into it by remote DMA and DMA
// semaphores are the arrival flags.
//
// Here every rank owns a symmetric window (window.cuh): block s of this
// call's data half receives rank s's rows.  Send: each rank copies its block
// for destination d (K15b: only the first counts[d] rows, and the count) into
// d's window, in chunks (K15b: chunk_rows rows, JAX's chunk_rows; K15a: 64 KB),
// fences at system scope and release-stores the arrival flag pay[me] = epoch
// in d's window.  Receive: wait for pay[s] >= epoch of every source, then copy
// the live rows of each peer's block from the window into the output.  One
// rank is its own only peer: its block is copied straight to the output and
// the flags are its own.
//
// Bound on the H100: bytes, and for the small payloads the fixed cost of a
// launch and the flag handshake.  A peer's live byte is read from x, written
// into the peer's window, read from it and written to the output: four passes
// where the TPU kernel moves it once, because the output is a fresh tensor,
// not the window (the window is fixed memory that peers have mapped).  The
// rank's own block skips the window: x[me] is copied straight to out[me]
// during the sends (one read, one write, as NCCL's self copy); it still takes
// part in the entry barrier and the flags, so the protocol across ranks is the
// same.  The copies are 16-byte words; chunks of a destination go to all
// blocks.
//
// Grid sized to the payload (pallas_a2a.a2a_blocks): ceil(R x block bytes /
// chunk) blocks for the capacity the host knows (the live counts of K15b are
// on the device), at most a co-resident grid.  Up to one chunk in all (K15a:
// R x block bytes <= 64 KB, which holds the per-expert counts [R, 256] int32
// of up to 64 ranks and a decode step's [R, 8] slots; K15b / K15c: R x rows
// <= chunk_rows) the kernel is one block, launched plainly: its phases are
// separated by __syncthreads and it needs no cooperative launch.  A larger
// payload takes a cooperative grid of only the blocks its chunks need (a
// 2048-token chunk's dispatch still fills the co-resident grid), its phases
// separated by grid syncs.
//
// Deadlock: on one rank the same kernel sends and waits, and across ranks a
// rank's wait needs its peer's sends.  Every block issues all its sends before
// any wait (a block or grid sync between), and a grid of several blocks is
// co-resident (a cooperative launch of at most the SMs times the blocks an SM
// holds), so no spinning block keeps a sender from running; one block that
// sends all before it waits cannot deadlock against a peer.
//
// K15c (monitor): each wait polls at most max_polls times, checking every
// peer's abort flag between polls.  A source whose flag does not come in time
// has its count forced to 0, and the waiter release-stores abort_[me] = epoch
// into every peer's window, so every rank leaves its waits instead of hanging.
// stats [R, 6] per source: 0 polls until the flag, 1 timeout, 2 abort seen,
// 3 = col 0, 4 payload missing, 5 zero (JAX's columns).  fault (JAX's
// inject_send_fault) mutes this rank's sends: the one-rank timeout test.
#include <string.h>

#include "window.cuh"

namespace a2a {

constexpr int THREADS = 512;
constexpr int COUNTS_BYTES = 256;               // counts [RMAX] int32 at the half's start

struct Args {
  const unsigned long long* peers;              // [R] window base pointers, device
  int me, R;
  unsigned long long epoch;
  long long half;                               // bytes of one data half
  const char* x;                                // [R, block_bytes] send blocks
  long long block_bytes;                        // bytes of one destination's block
  long long row_bytes;                          // bytes of a row
  int rows;                                     // rows of a block (its capacity)
  long long chunk_bytes;                        // bytes a block copies at a time
  const int* counts;                            // [R] live rows a destination (K15b) or null
  char* out;                                    // [R, block_bytes]
  int* recv_counts;                             // [R] live rows received from each source
  int* stats;                                   // [R, 6] (monitor) or null
  int monitor;
  long long max_polls;
  int fault;
};

// A flag in this rank's own window is written and read by this GPU alone:
// gpu-scope release / acquire order it, where a peer's needs system scope
// (a one-rank call then takes no system-scope fence at all).
__device__ __forceinline__ void flag_store(unsigned long long* p, unsigned long long v, bool own) {
  if (own)
    asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
  else
    win::st_release(p, v);
}

__device__ __forceinline__ unsigned long long flag_load(const unsigned long long* p, bool own) {
  if (!own) return win::ld_acquire(p);
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// window.cuh's entry barrier with the own flag at gpu scope: block 0's
// threads t < R flag their entry into peer (me + t) % R's window, then wait
// for that peer's entry.
__device__ __forceinline__ void entry_barrier(const unsigned long long* peers, int me, int R,
                                              unsigned long long epoch) {
  const int t = threadIdx.x;
  if (blockIdx.x != 0 || t >= R) return;
  const int d = (me + t) % R;
  flag_store(&win::header(peers, d)->entry[me], epoch, d == me);
  const win::Header* mine = win::header(peers, me);
  while (flag_load(&mine->entry[d], d == me) < epoch) {
  }
}

__device__ __forceinline__ size_t block_stride(long long block_bytes) {
  return ((size_t)block_bytes + 255) / 256 * 256;
}

// Copy the live bytes of every (rank, block) pair, chunk by chunk over the
// grid: live(r) bytes of src_of(r) to dst_of(r).
template <class Live, class Src, class Dst>
__device__ void copy_chunks(int R, long long chunk, Live live, Src src_of, Dst dst_of) {
  long long total = 0;
  for (int r = 0; r < R; ++r) total += (live(r) + chunk - 1) / chunk;
  for (long long j = blockIdx.x; j < total; j += gridDim.x) {
    long long c = j;
    int r = 0;
    for (; r < R; ++r) {
      const long long n = (live(r) + chunk - 1) / chunk;
      if (c < n) break;
      c -= n;
    }
    const long long off = c * chunk, n = min(chunk, live(r) - off);
    win::copy_bytes(dst_of(r) + off, src_of(r) + off, (size_t)n, threadIdx.x, blockDim.x);
  }
}

// The phases' barrier: the whole grid, or the one block.
template <bool COOP>
__device__ __forceinline__ void sync_all() {
  if constexpr (COOP)
    cooperative_groups::this_grid().sync();
  else
    __syncthreads();
}

template <bool COOP>
__global__ void __launch_bounds__(THREADS) a2a_kernel(Args a) {
  const int R = a.R, me = a.me;
  const size_t stride = block_stride(a.block_bytes);
  entry_barrier(a.peers, me, R, a.epoch);
  sync_all<COOP>();

  // sends: rotated destination order (rank r starts at r + 1, itself last), as
  // JAX's; the own block goes straight to the output
  if (!a.fault) {
    auto dst_rank = [&](int i) { return (me + 1 + i) % R; };
    auto rows_to = [&](int d) { return a.counts ? min(max(a.counts[d], 0), a.rows) : a.rows; };
    copy_chunks(
        R, a.chunk_bytes, [&](int i) { return (long long)rows_to(dst_rank(i)) * a.row_bytes; },
        [&](int i) { return a.x + (size_t)dst_rank(i) * a.block_bytes; },
        [&](int i) {
          const int d = dst_rank(i);
          return d == me ? a.out + (size_t)me * a.block_bytes
                         : win::half(a.peers, d, a.epoch, a.half) + COUNTS_BYTES + me * stride;
        });
    if (a.counts && blockIdx.x == 0 && threadIdx.x < R) {
      const int d = threadIdx.x;
      reinterpret_cast<volatile int*>(win::half(a.peers, d, a.epoch, a.half))[me] = rows_to(d);
    }
    if (R > 1) __threadfence_system();   // one rank wrote no peer's window
  }
  sync_all<COOP>();

  // arrival: block 0's thread t signals destination (me + t) % R, then waits
  // for the same rank as a source
  if (blockIdx.x == 0 && threadIdx.x < R) {
    const int s = (me + threadIdx.x) % R;
    if (!a.fault) flag_store(&win::header(a.peers, s)->pay[me], a.epoch, s == me);
    const win::Header* mine = win::header(a.peers, me);
    long long polls = 0;
    int arrived = 0, aborted = 0;
    for (;;) {
      if (flag_load(&mine->pay[s], s == me) >= a.epoch) {
        arrived = 1;
        break;
      }
      if (a.monitor) {
        for (int q = 0; q < R && !aborted; ++q)
          aborted = win::ld_acquire(&mine->abort_[q]) >= a.epoch;
        if (aborted || polls >= a.max_polls) break;
      }
      ++polls;
    }
    const int timeout = !arrived && !aborted;
    if (timeout)
      for (int q = 0; q < R; ++q) win::st_release(&win::header(a.peers, q)->abort_[me], a.epoch);
    const volatile int* sent = reinterpret_cast<volatile const int*>(
        win::half(a.peers, me, a.epoch, a.half));
    const int n = !arrived ? 0 : a.counts ? sent[s] : a.rows;
    reinterpret_cast<volatile int*>(a.recv_counts)[s] = n;
    if (a.stats) {
      const int p = (int)min(polls, (long long)0x7fffffff);
      int* st = a.stats + 6 * s;
      st[0] = p;
      st[1] = timeout;
      st[2] = aborted;
      st[3] = p;
      st[4] = !arrived;
      st[5] = 0;
    }
  }
  sync_all<COOP>();

  // receive: the live rows of each peer's block, window -> output (the own
  // block is already there)
  const char* mine = win::half(a.peers, me, a.epoch, a.half) + COUNTS_BYTES;
  copy_chunks(
      R, a.chunk_bytes,
      [&](int s) {
        return s == me ? 0ll
                       : (long long)reinterpret_cast<volatile const int*>(a.recv_counts)[s] *
                             a.row_bytes;
      },
      [&](int s) { return mine + (size_t)s * stride; },
      [&](int s) { return a.out + (size_t)s * a.block_bytes; });
}

}  // namespace a2a

// ---------------------------------------------------------------------------
// the window's C API

// A zeroed window of `bytes` on the current device.
extern "C" int window_alloc(long long bytes, void** out) {
  cudaError_t e = cudaMalloc(out, (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(*out, 0, (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

extern "C" int window_free(void* p) { return (int)cudaFree(p); }

// The window's IPC handle (64 bytes) into `handle`.
extern "C" int window_ipc_handle(void* p, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, p);
  if (e != cudaSuccess) return (int)e;
  memcpy(handle, &h, sizeof(h));
  return 0;
}

// A peer's window, mapped into this process from its handle.
extern "C" int window_ipc_open(const void* handle, void** out) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int window_ipc_close(void* p) { return (int)cudaIpcCloseMemHandle(p); }

// One all-to-all over the window (Args above).  counts null: K15a, every row
// of every block; else K15b / K15c.  recv_counts [R] int32 is written in
// both modes.  blocks: the grid the payload needs (pallas_a2a.a2a_blocks);
// one block is a plain launch, more a cooperative one of at most the
// co-resident grid.
extern "C" int a2a_launch(const void* peers, int me, int R, unsigned long long epoch,
                          long long half, const void* x, long long block_bytes,
                          long long row_bytes, int rows, long long chunk_bytes,
                          const void* counts, void* out, void* recv_counts, void* stats,
                          int monitor, long long max_polls, int fault, int blocks,
                          void* stream) {
  if (R < 1 || R > win::RMAX || me < 0 || me >= R || chunk_bytes <= 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  a2a::Args a{(const unsigned long long*)peers, me, R, epoch, half, (const char*)x,
              block_bytes, row_bytes, rows, chunk_bytes, (const int*)counts, (char*)out,
              (int*)recv_counts, (int*)stats, monitor, max_polls, fault};
  if (blocks == 1) {
    a2a::a2a_kernel<false><<<1, a2a::THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  static int coop = 0;
  if (coop == 0) coop = win::coop_blocks((const void*)a2a::a2a_kernel<true>, a2a::THREADS, 2);
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)a2a::a2a_kernel<true>,
                                                    dim3(blocks < coop ? blocks : coop),
                                                    dim3(a2a::THREADS), params, 0,
                                                    (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
