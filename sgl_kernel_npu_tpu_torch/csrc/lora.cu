// Fused LoRA delta for Hopper: delta[t] = s_t * (x[t] A[a_t]^T) B[a_t]^T, the
// adapter a_t chosen per token (bgmv) or per sequence of packed varlen rows
// (sgmv).
//
// Replaces the TPU kernels of sgl_kernel_npu_tpu/ops/lora_pallas.py:
// bgmv_fused (_bgmv_kernel, K13a), which multiplies every token by every
// adapter's A in one wide product and masks all but its own adapter's
// columns (L times the work, to fill the MXU), and sgmv_fused (_sgmv_kernel,
// K13b), which walks row tiles grouped by sequence with the tile's adapter
// weights in VMEM.
//
// Bound on the H100: bytes.  Each token reads its adapter's A and B once
// (R x (H + D) values: 256 KB in bf16 at rank 16 and H = D = 4096) and does
// 2 R (H + D) operations on them, about one an element; at decode (a few
// tokens, a few adapters) the weights are the bytes, at a 512-row prefill the
// same adapter is re-read by every token of its sequence, from L2.
//
// Design: two launches, no per-call transpose and no work for other adapters.
// (One launch, with blocks taking shrink then expand items by an atomic
// ticket and the expand waiting on the shrink's flags, was measured slower on
// the H100 at every bgmv shape: the ticket -> shrink -> flag -> expand chain
// is longer than the gap between two launches.)
//   shrink: a block per (token, 4 rank components), a warp per component:
//     the warp's lanes stride over H with 16-byte loads of x and of A's row
//     (both read in their stored layout), sum in f32, scale in f32, mask
//     components at or above the adapter's rank, and write s [T, R] f32
//     (which stays in f32, never rounded to x's type) and each token's
//     adapter (-1 for a dead token: an id outside [0, L), or a row past the
//     packed sequences).  sgmv finds a row's sequence by a block-wide scan of
//     the sequence lengths (no prefix-sum launch, no host sync); a
//     zero-length sequence owns no row.
//   expand: a block per (token, 256 output columns), a thread per column:
//     the token's s in shared memory, the column's R weights read from B's
//     stored [L, D, R] rows (16-byte loads, neighbouring threads on
//     neighbouring rows) or from a pre-transposed bt [L, R, D]; dead tokens
//     write exact zeros and read no weight.
#include "common.cuh"

namespace lora {

constexpr int SHRINK_WARPS = 4;
constexpr int EXPAND_THREADS = 256;

// 8 consecutive elements as f32 (one 16-byte load of bf16, two of f32), or 1.
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = __bfloat162float(p[0]);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x, f[2 * i + 1] = t.y;
    }
  }
}

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = p[0];
  } else {
    const float4 u = *reinterpret_cast<const float4*>(p);
    const float4 v = *reinterpret_cast<const float4*>(p + 4);
    f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
    f[4] = v.x, f[5] = v.y, f[6] = v.z, f[7] = v.w;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// The sequence of packed row t: the number of sequence ends at or below t
// (nseq if none is above it), the lengths summed a block's width at a time by
// an inclusive scan.  Every thread of the block calls it and gets the answer.
__device__ __forceinline__ int sequence_of(const int* lens, int nseq, int t) {
  constexpr int N = SHRINK_WARPS * 32;
  __shared__ int warp_total[SHRINK_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int base = 0, seq = 0;
  for (int g0 = 0; g0 < nseq && base <= t; g0 += N) {   // base is uniform over the block
    const int g = g0 + threadIdx.x;
    int end = g < nseq ? lens[g] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, end, o);
      if (lane >= o) end += v;
    }
    if (lane == 31) warp_total[warp] = end;
    __syncthreads();
    int chunk = 0;
#pragma unroll
    for (int w = 0; w < SHRINK_WARPS; ++w) {
      if (w < warp) end += warp_total[w];
      chunk += warp_total[w];
    }
    seq += __syncthreads_count(g < nseq && base + end <= t);   // also: warp_total read
    base += chunk;
  }
  return seq;
}

// x [T, H] of TX, a [L, R, H] of TW.  bgmv (lens null): ids [T] per token,
// every component live, scale `scaling`.  sgmv: ids [nseq] per sequence, lens
// [nseq] the sequence lengths, ranks [L] int32 and scalings [L] f32 per
// adapter.  -> s [T, R] f32, row_adapter [T] int32 (-1 dead).
template <typename TX, typename TW, int V>
__global__ void __launch_bounds__(SHRINK_WARPS * 32)
    shrink_kernel(const TX* __restrict__ x, const TW* __restrict__ a, const int* __restrict__ ids,
                  const int* __restrict__ lens, const int* __restrict__ ranks,
                  const float* __restrict__ scalings, float scaling, int nseq, int H, int L,
                  int R, float* __restrict__ s, int* __restrict__ row_adapter) {
  const int t = blockIdx.x;
  int adapter;
  if (lens != nullptr) {
    const int g = sequence_of(lens, nseq, t);
    adapter = g < nseq ? ids[g] : -1;
  } else {
    adapter = ids[t];
  }
  const bool live = adapter >= 0 && adapter < L;
  int rank = R;
  float scale = scaling;
  if (live && lens != nullptr) {
    rank = min(max(ranks[adapter], 0), R);
    scale = scalings[adapter];
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) row_adapter[t] = live ? adapter : -1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.y * SHRINK_WARPS + warp;
  if (r >= R) return;
  if (!live || r >= rank) {
    if (lane == 0) s[(size_t)t * R + r] = 0.f;
    return;
  }
  const TX* xr = x + (size_t)t * H;
  const TW* ar = a + ((size_t)adapter * R + r) * H;
  float acc = 0.f;
  for (int c = lane * V; c < H; c += 32 * V) {
    float xv[V], av[V];
    load_v(xr + c, xv);
    load_v(ar + c, av);
#pragma unroll
    for (int i = 0; i < V; ++i) acc += xv[i] * av[i];
  }
  acc = sgl::warp_sum(acc);
  if (lane == 0) s[(size_t)t * R + r] = __fmul_rn(acc, scale);
}

// s [T, R] f32, row_adapter [T]; b [L, D, R] (transposed == 0) or bt [L, R, D]
// of TW -> out [T, D] f32.  V: 8 when a [L, D, R] row allows 16-byte loads.
template <typename TW, int V>
__global__ void __launch_bounds__(EXPAND_THREADS)
    expand_kernel(const float* __restrict__ s, const int* __restrict__ row_adapter,
                  const TW* __restrict__ b, int D, int R, int transposed,
                  float* __restrict__ out) {
  extern __shared__ float sh[];
  const int t = blockIdx.x;
  const int d = blockIdx.y * EXPAND_THREADS + threadIdx.x;
  const int adapter = row_adapter[t];
  if (adapter < 0) {                       // uniform over the block
    if (d < D) out[(size_t)t * D + d] = 0.f;
    return;
  }
  for (int r = threadIdx.x; r < R; r += EXPAND_THREADS) sh[r] = s[(size_t)t * R + r];
  __syncthreads();
  if (d >= D) return;
  float acc = 0.f;
  if (transposed) {
    const TW* col = b + (size_t)adapter * R * D + d;
    for (int r = 0; r < R; ++r) acc += sh[r] * to_f(col[(size_t)r * D]);
  } else {
    const TW* row = b + ((size_t)adapter * D + d) * R;
    for (int r = 0; r < R; r += V) {
      float w[V];
      load_v(row + r, w);
#pragma unroll
      for (int i = 0; i < V; ++i) acc += sh[r + i] * w[i];
    }
  }
  out[(size_t)t * D + d] = acc;
}

__host__ __forceinline__ bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename TX, typename TW>
int shrink(const void* x, const void* a, const int* ids, const int* lens, const int* ranks,
           const float* scalings, float scaling, int nseq, int T, int H, int L, int R, float* s,
           int* row_adapter, cudaStream_t st) {
  const dim3 grid(T, (R + SHRINK_WARPS - 1) / SHRINK_WARPS);
  if (H % 8 == 0 && aligned16(x) && aligned16(a))
    shrink_kernel<TX, TW, 8><<<grid, SHRINK_WARPS * 32, 0, st>>>(
        (const TX*)x, (const TW*)a, ids, lens, ranks, scalings, scaling, nseq, H, L, R, s,
        row_adapter);
  else
    shrink_kernel<TX, TW, 1><<<grid, SHRINK_WARPS * 32, 0, st>>>(
        (const TX*)x, (const TW*)a, ids, lens, ranks, scalings, scaling, nseq, H, L, R, s,
        row_adapter);
  return (int)cudaGetLastError();
}

template <typename TW>
int expand(const float* s, const int* row_adapter, const void* b, int T, int D, int R,
           int transposed, float* out, cudaStream_t st) {
  const dim3 grid(T, (D + EXPAND_THREADS - 1) / EXPAND_THREADS);
  const size_t smem = (size_t)R * sizeof(float);
  if (!transposed && R % 8 == 0 && aligned16(b))
    expand_kernel<TW, 8><<<grid, EXPAND_THREADS, smem, st>>>(s, row_adapter, (const TW*)b, D, R,
                                                              transposed, out);
  else
    expand_kernel<TW, 1><<<grid, EXPAND_THREADS, smem, st>>>(s, row_adapter, (const TW*)b, D, R,
                                                              transposed, out);
  return (int)cudaGetLastError();
}

}  // namespace lora

// x [T, H] (bf16 if x_bf16 else f32), a [L, R, H] (bf16 if w_bf16 else f32).
// bgmv: ids [T] int32, lens / ranks / scalings null, `scaling` for every
// token.  sgmv: ids [nseq] int32 per sequence, lens [nseq] int32 (the
// sequence lengths), ranks [L] int32, scalings [L] f32.  -> s [T, R] f32 and
// row_adapter [T] int32.
extern "C" int lora_shrink_launch(const void* x, const void* a, const void* ids, const void* lens,
                                  const void* ranks, const void* scalings, float scaling,
                                  int nseq, int T, int H, int L, int R, int x_bf16, int w_bf16,
                                  void* s, void* row_adapter, void* stream) {
  if (T == 0 || R == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  const int* id = (const int*)ids;
  const int* ln = (const int*)lens;
  const int* rk = (const int*)ranks;
  const float* sc = (const float*)scalings;
  float* so = (float*)s;
  int* ra = (int*)row_adapter;
  auto run = [&](auto tx, auto tw) {
    using TX = decltype(tx);
    using TW = decltype(tw);
    return lora::shrink<TX, TW>(x, a, id, ln, rk, sc, scaling, nseq, T, H, L, R, so, ra, st);
  };
  if (x_bf16) return w_bf16 ? run(bf16(), bf16()) : run(bf16(), 0.f);
  return w_bf16 ? run(0.f, bf16()) : run(0.f, 0.f);
}

// s [T, R] f32, row_adapter [T] int32 (from lora_shrink_launch), b [L, D, R]
// or, when transposed, bt [L, R, D] (bf16 if w_bf16 else f32) -> out [T, D]
// f32.
extern "C" int lora_expand_launch(const void* s, const void* row_adapter, const void* b, int T,
                                  int D, int R, int transposed, int w_bf16, void* out,
                                  void* stream) {
  if (T == 0 || D == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (w_bf16)
    return lora::expand<__nv_bfloat16>((const float*)s, (const int*)row_adapter, b, T, D, R,
                                       transposed, (float*)out, st);
  return lora::expand<float>((const float*)s, (const int*)row_adapter, b, T, D, R, transposed,
                             (float*)out, st);
}
