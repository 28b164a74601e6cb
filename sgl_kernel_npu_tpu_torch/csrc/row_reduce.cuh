// A row reduction held in registers, across a thread-block cluster: the
// shared routine of quant_per_token (K5) and swiglu_quant (K7a, both
// csrc/quant.cu), rms_norm (K6a), add_rms_norm (K6b / K6c) and l1_norm (K6d,
// all csrc/norm.cu).
//
// Bound on the H100: bytes, and at decode-sized row counts the latency of a
// launch: 8 rows of 16384 bf16 are 0.26 MB, 0.1 us at 3.35 TB/s, where one
// block a row leaves 124 of 132 SMs idle and each of its threads walks the
// row load after load.
//
// Design.  The launch plan comes from the wrapper (ops/row_reduce.py
// _row_plan, which the CPU tests check).  At decode a wide row is split
// across a cluster of C in {2, 4, 8} blocks; at chunk sizes a block takes
// block_rows rows one after another and loads the next row's vectors while
// it reduces and writes the current one.  A row's vectors (16 bytes of the
// input each, or one element where the width or an address does not allow
// 16-byte accesses) are cut into C spans of ceil(nvec / C); vector j of a
// block's span goes to thread j % threads as its (j / threads)-th vector, so
// a warp reads 512 consecutive bytes.  A thread loads its vectors once into
// registers (VM of them, the plan's vecs rounded up to 1, 2, 4 or 8; a row
// wider than that streams the rest, reading them again for the output),
// reduces them in order, and the block reduces in a fixed order: a warp
// butterfly (every lane ends with the same bits), then the warps in index
// order.  With C > 1, each block's partial goes to its shared memory, a
// cluster barrier makes it visible, and every block reads the C partials
// through distributed shared memory (mapa + ld.shared::cluster) in rank
// order 0 .. C - 1: every block of the cluster gets the same value, the same
// on every run.  A second barrier, arrived at once the partials are read and
// waited on before exit, keeps a block's shared memory alive while a peer
// reads it.
#pragma once

#include "common.cuh"

namespace rowr {

constexpr int MAX_THREADS = 512;   // a block (ops/row_reduce.py MAX_THREADS)
constexpr int VMAX = 8;            // vectors a thread holds (ops/row_reduce.py VMAX)
constexpr unsigned FULL = 0xffffffffu;

// N consecutive elements of T as raw 32-bit words, moved in one access of
// 2, 4, 8 or 16 bytes (32: two of 16).
template <typename T, int N>
struct Pack {
  static constexpr int BYTES = N * (int)sizeof(T);
  static constexpr int WORDS = BYTES < 4 ? 1 : BYTES / 4;
  uint32_t w[WORDS];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (BYTES >= 16) {
#pragma unroll
      for (int i = 0; i < BYTES / 16; ++i) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = u.x, w[4 * i + 1] = u.y, w[4 * i + 2] = u.z, w[4 * i + 3] = u.w;
      }
    } else if constexpr (BYTES == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    } else if constexpr (BYTES == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }

  // element i as f32 (exact for bf16)
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[i]);
    } else {
      return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
    }
  }

  // the N values f as T (bf16 rounded to nearest even)
  __device__ __forceinline__ void set(const float (&f)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(f[i]);
      } else {
        const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(f[i]));
        w[i >> 1] = (i & 1) ? (w[i >> 1] | (b << 16)) : b;
      }
    }
  }

  // the words to p, in one access as load's
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (BYTES >= 16) {
#pragma unroll
      for (int i = 0; i < BYTES / 16; ++i)
        reinterpret_cast<uint4*>(p)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                                                    w[4 * i + 3]);
    } else if constexpr (BYTES == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (BYTES == 4) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)w[0];
    }
  }
};

// Store N values as T (f32, or bf16 rounded to nearest even) in one access.
template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&f)[N]) {
  Pack<T, N> o;
  o.set(f);
  o.store(p);
}

// Store N int8 levels (each in [-128, 127]) in one access.
template <int N>
__device__ __forceinline__ void store(int8_t* p, const int (&l)[N]) {
  uint32_t o[N < 4 ? 1 : N / 4] = {};
#pragma unroll
  for (int i = 0; i < N; ++i) o[i >> 2] |= (uint32_t)(l[i] & 0xff) << (8 * (i & 3));
  if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(o[0], o[1]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(p) = o[0];
  } else {
    static_assert(N == 1, "1, 4 or 8 levels a store");
    *reinterpret_cast<uint8_t*>(p) = (uint8_t)o[0];
  }
}

struct Sum {
  static __device__ __forceinline__ float op(float a, float b) { return __fadd_rn(a, b); }
};
struct Max {
  static __device__ __forceinline__ float op(float a, float b) { return fmaxf(a, b); }
};

// This block's span of a row's nvec vectors, and thread t's v-th vector in it.
struct Span {
  int lo, hi;   // vectors [lo, hi) of the row
  __device__ __forceinline__ Span(int nvec, int cluster, int rank) {
    const int per = (nvec + cluster - 1) / cluster;
    lo = min(nvec, rank * per);
    hi = min(nvec, lo + per);
  }
  // the row's vector index of this thread's v-th vector, or -1 past the span
  __device__ __forceinline__ int at(int v) const {
    const int g = lo + v * (int)blockDim.x + (int)threadIdx.x;
    return g < hi ? g : -1;
  }
};

// The rows of this block and its rank in a row's cluster: with cluster > 1,
// row blockIdx.x / cluster as rank blockIdx.x % cluster; else block_rows
// consecutive rows from blockIdx.x * block_rows.
struct Rows {
  int lo, hi, rank;
  __device__ __forceinline__ Rows(int rows, int cluster, int block_rows) {
    rank = blockIdx.x % cluster;
    lo = cluster > 1 ? blockIdx.x / cluster : blockIdx.x * block_rows;
    hi = cluster > 1 ? lo + 1 : min(rows, lo + block_rows);
  }
};

// This thread's first VM vectors of the row at r (those inside the span).
template <typename T, int N, int VM>
__device__ __forceinline__ void load_held(Pack<T, N> (&held)[VM], const T* r, const Span& span,
                                          int vecs) {
#pragma unroll
  for (int v = 0; v < VM; ++v)
    if (v < vecs && span.at(v) >= 0) held[v].load(r + (size_t)span.at(v) * N);
}

// Whether a block of several rows loads the next row's vectors into a second
// set of registers while it reduces and writes the current one: where the
// registers allow it.
template <int VM>
constexpr bool AHEAD = VM <= 4;

// Reduce over the block in a fixed order: a warp butterfly, then the warps
// in index order through red[] (blockDim.x / 32 floats).  Every thread gets
// the same bits.  red[] may be written again after the next __syncthreads.
template <class Op>
__device__ __forceinline__ float block_all(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = Op::op(v, __shfl_xor_sync(FULL, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int i = 1; i < MAX_THREADS / 32; ++i)
    if (i < (int)(blockDim.x >> 5)) s = Op::op(s, red[i]);
  return s;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// *p in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float load_peer(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(sgl::smem_addr(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// The cluster's value from each block's partial p (the same in all its
// threads): the C partials in rank order.  With C > 1 the caller ends with
// cluster_done(C) before it exits.
template <class Op>
__device__ __forceinline__ float cluster_all(float p, float* part, int cluster) {
  if (cluster == 1) return p;
  if (threadIdx.x == 0) *part = p;
  cluster_arrive();
  cluster_wait();                              // every partial is written
  const int lane = threadIdx.x & 31;
  const float mine = lane < cluster ? load_peer(part, lane) : 0.f;
  float s = __shfl_sync(FULL, mine, 0);
  for (int r = 1; r < cluster; ++r) s = Op::op(s, __shfl_sync(FULL, mine, r));
  cluster_arrive();                            // this block has read its peers
  return s;
}

// No block leaves while a peer may still read its partial.
__device__ __forceinline__ void cluster_done(int cluster) {
  if (cluster > 1) cluster_wait();
}

// Launch `kernel` on `blocks` blocks of `threads`, in clusters of `cluster`
// blocks along x when cluster > 1 (blocks is a multiple of it).  Returns
// the launch's error, or cudaGetLastError().
template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), int blocks, int threads, int cluster, cudaStream_t s,
           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  const cudaError_t last = cudaGetLastError();   // read, so that no later launch reports it
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace rowr
