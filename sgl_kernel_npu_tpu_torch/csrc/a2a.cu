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
// the live rows of each block from the window into the output.  One rank is
// its own only peer: the sends are local stores and the flags its own.
//
// Bound on the H100: bytes.  Each live byte is read from x, written into the
// window, read from it and written to the output: four passes where the TPU
// kernel moves it once, because the output is a fresh tensor, not the window
// (the window is fixed memory that peers have mapped).  The copies are 16-byte
// words over a co-resident grid; chunks of a destination go to all blocks.
//
// Deadlock: on one rank the same kernel sends and waits, and across ranks a
// rank's wait needs its peer's sends.  Every block issues all its sends before
// any wait (a grid sync between), and the grid is co-resident (a cooperative
// launch of the SMs times the blocks an SM holds), so no spinning block keeps
// a sender from running.
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

__global__ void __launch_bounds__(THREADS) a2a_kernel(Args a) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  const int R = a.R, me = a.me;
  const size_t stride = block_stride(a.block_bytes);
  win::entry_barrier(a.peers, me, R, a.epoch);
  grid.sync();

  // sends: rotated destination order (rank r starts at r + 1), as JAX's
  if (!a.fault) {
    auto dst_rank = [&](int i) { return (me + 1 + i) % R; };
    auto rows_to = [&](int d) { return a.counts ? min(max(a.counts[d], 0), a.rows) : a.rows; };
    copy_chunks(
        R, a.chunk_bytes, [&](int i) { return (long long)rows_to(dst_rank(i)) * a.row_bytes; },
        [&](int i) { return a.x + (size_t)dst_rank(i) * a.block_bytes; },
        [&](int i) {
          return win::half(a.peers, dst_rank(i), a.epoch, a.half) + COUNTS_BYTES + me * stride;
        });
    if (a.counts && blockIdx.x == 0 && threadIdx.x < R) {
      const int d = threadIdx.x;
      reinterpret_cast<volatile int*>(win::half(a.peers, d, a.epoch, a.half))[me] = rows_to(d);
    }
    __threadfence_system();
  }
  grid.sync();

  // arrival: block 0's thread t signals destination (me + t) % R, then waits
  // for the same rank as a source
  if (blockIdx.x == 0 && threadIdx.x < R) {
    const int s = (me + threadIdx.x) % R;
    if (!a.fault) win::st_release(&win::header(a.peers, s)->pay[me], a.epoch);
    const win::Header* mine = win::header(a.peers, me);
    long long polls = 0;
    int arrived = 0, aborted = 0;
    for (;;) {
      if (win::ld_acquire(&mine->pay[s]) >= a.epoch) {
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
  grid.sync();

  // receive: the live rows of each source's block, window -> output
  const char* mine = win::half(a.peers, me, a.epoch, a.half) + COUNTS_BYTES;
  copy_chunks(
      R, a.chunk_bytes,
      [&](int s) {
        return (long long)reinterpret_cast<volatile const int*>(a.recv_counts)[s] * a.row_bytes;
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
// both modes.
extern "C" int a2a_launch(const void* peers, int me, int R, unsigned long long epoch,
                          long long half, const void* x, long long block_bytes,
                          long long row_bytes, int rows, long long chunk_bytes,
                          const void* counts, void* out, void* recv_counts, void* stats,
                          int monitor, long long max_polls, int fault, void* stream) {
  if (R < 1 || R > win::RMAX || me < 0 || me >= R || chunk_bytes <= 0)
    return (int)cudaErrorInvalidValue;
  a2a::Args a{(const unsigned long long*)peers, me, R, epoch, half, (const char*)x,
              block_bytes, row_bytes, rows, chunk_bytes, (const int*)counts, (char*)out,
              (int*)recv_counts, (int*)stats, monitor, max_polls, fault};
  static int blocks = 0;
  if (blocks == 0) blocks = win::coop_blocks((const void*)a2a::a2a_kernel, a2a::THREADS, 2);
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)a2a::a2a_kernel, dim3(blocks),
                                                    dim3(a2a::THREADS), params, 0,
                                                    (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
