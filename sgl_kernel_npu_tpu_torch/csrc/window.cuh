// The symmetric window of the one-sided exchanges (a2a.cu, K15a-c, and
// fused_full.cu, K16b): device memory on every rank of a process group, each
// rank's allocation mapped into every other rank's address space by CUDA IPC
// (parallel/pallas_a2a.py).  Layout of one rank's window:
//
//   [0, HDR)                  Header: arrival flags, each an epoch
//   [HDR, DATA)               K16b's arrival flags, one a (source, expert)
//   [DATA, DATA + half)       data of the calls with an even epoch
//   [DATA + half, DATA + 2 half) data of the calls with an odd epoch
//
// A flag word is never data: a stale count or row of another call read as a
// flag would pass for an arrival.
//
// Every call takes the next epoch (a host counter that all ranks advance in
// step) and its flags say "this happened in call `epoch`": a waiter polls for
// a flag >= epoch, so flags are never reset and there is no reset race.  The
// data halves alternate by epoch parity, so a rank that has finished call e
// and started call e + 1 never writes where a slower peer still reads call e.
//
// A sender stores its payload, fences at system scope, then release-stores
// the flag in the peer's window; a receiver polls with ld.acquire.sys.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace win {

namespace cg = cooperative_groups;

constexpr int RMAX = 64;                        // ranks a window serves

struct Header {
  unsigned long long entry[RMAX];               // rank s entered call `epoch`
  unsigned long long pay[RMAX];                 // rank s's payload to me has landed
  unsigned long long abort_[RMAX];              // rank s timed out in call `epoch`
  unsigned long long ret[RMAX];                 // rank s's returned rows (K16b) have landed
};
constexpr size_t HDR = sizeof(Header);          // 2048 bytes
constexpr int MAX_SEGMENTS = RMAX * 256;        // (source, expert) arrival flags
constexpr size_t DATA = HDR + MAX_SEGMENTS * sizeof(unsigned long long);

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ Header* header(const unsigned long long* peers, int r) {
  return reinterpret_cast<Header*>(peers[r]);
}

// This call's data half in rank r's window.
__device__ __forceinline__ char* half(const unsigned long long* peers, int r,
                                      unsigned long long epoch, long long half_bytes) {
  return reinterpret_cast<char*>(peers[r]) + DATA + (size_t)(epoch & 1ull) * half_bytes;
}

// Rank r's (source, expert) arrival flags.
__device__ __forceinline__ unsigned long long* arrive(const unsigned long long* peers, int r) {
  return reinterpret_cast<unsigned long long*>(peers[r] + HDR);
}

// Entry barrier (JAX's _entry_barrier): every rank flags its entry into every
// peer's window, then waits for all peers' entries.  Block 0's threads t < R
// take peer (me + t) % R; the caller syncs the grid after it.
__device__ __forceinline__ void entry_barrier(const unsigned long long* peers, int me, int R,
                                              unsigned long long epoch) {
  const int t = threadIdx.x;
  if (blockIdx.x != 0 || t >= R) return;
  const int d = (me + t) % R;
  st_release(&header(peers, d)->entry[me], epoch);
  const Header* mine = header(peers, me);
  while (ld_acquire(&mine->entry[d]) < epoch) {
  }
}

// dst[0, n) = src[0, n) by the threads [tid, tid + nth, ...): 16-byte words
// where both ends and n allow, else 4-byte, else bytes.  Loads bypass L1
// (ld.global.cg): window memory is written by other blocks and peers while
// the kernel runs.
__device__ __forceinline__ void copy_bytes(char* dst, const char* src, size_t n, size_t tid,
                                           size_t nth) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) | n;
  if ((a & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (size_t i = tid; i < n / 16; i += nth) d[i] = __ldcg(s + i);
  } else if ((a & 3) == 0) {
    unsigned* d = reinterpret_cast<unsigned*>(dst);
    const unsigned* s = reinterpret_cast<const unsigned*>(src);
    for (size_t i = tid; i < n / 4; i += nth) d[i] = __ldcg(s + i);
  } else {
    for (size_t i = tid; i < n; i += nth) dst[i] = src[i];
  }
}

// Blocks of a co-resident grid of `kernel` at `threads` a block and
// `dyn_smem` bytes of dynamic shared memory a block (a kernel above 48 KB has
// its cudaFuncAttributeMaxDynamicSharedMemorySize set first): the SMs times
// the blocks an SM holds.  A cooperative launch refuses a larger grid, so
// every block of the kernel is resident and a spinning block never starves
// an unlaunched sender.
inline int coop_blocks(const void* kernel, int threads, int max_per_sm, size_t dyn_smem = 0) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, dyn_smem);
  if (per > max_per_sm) per = max_per_sm;
  return per * sms;
}

}  // namespace win
