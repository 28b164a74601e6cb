"""W8A8 grouped expert GEMMs of the decode MoE: plain versions and the Hopper
kernels (K3, K4).

Counterpart of ``sgl_kernel_npu_tpu/ops/gmm_ring.py``.  The TPU kernels
stream weights through a manual DMA ring and build the row dispatch and the
combine as one-hot MXU products; the CUDA kernels (``csrc/gmm_ring.cu``)
gather rows by ``tok_of_row`` and combine by ``dest`` directly, and keep the
JAX names so the counterpart is easy to find.

- :func:`gmm1_ring` — grouped W8A8 GEMM1 over expert-sorted rows, dequant,
  SwiGLU on the full-width gate ‖ up packing, per-row int8 requant; on int8
  tokens, or on bf16 / f32 tokens quantized per token first (JAX's in-kernel
  quant mode).
- :func:`gmm2_combine_ring` — grouped W8A8 GEMM2, dequant, weighted top-k
  combine into ``[n_tok, N]`` f32 (optionally on top of ``init``).  The combine
  weights stay f32 (the TPU kernel's hi/lo bf16 split is an MXU artefact).
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.grouped_matmul import (
    _offsets,
    gmm_dequant_ref,
    swiglu_requant_ref,
)
from sgl_kernel_npu_tpu_torch.ops.quant import quant_per_token_ref
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda
from sgl_kernel_npu_tpu_torch.utils.counters import counted, launched

MAX_TOPK = 32   # csrc/gmm_ring.cu: the kernels read 4-byte words of K and N


def _check_int8(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int8 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int8 tensor, got {t.dtype}")


def gmm1_ring_ref(xq, tok_of_row, w1, group_sizes, scale_x_tok, scale_w):
    """Plain GMM1: rows ``xq[tok_of_row]`` (a token id outside ``[0, n_tok)``
    reads as zero) → ``(h1 [S, N/2] int8, hs [S] f32)``; rows past the groups'
    total are zeros.  Float ``xq`` is quantized per token first
    (:func:`~sgl_kernel_npu_tpu_torch.ops.quant.quant_per_token_ref`) and
    ``scale_x_tok`` is ignored."""
    if xq.dtype != torch.int8:
        xq, scale_x_tok = quant_per_token_ref(xq)
    n_tok = xq.shape[0]
    valid = (tok_of_row >= 0) & (tok_of_row < n_tok)
    tok = torch.where(valid, tok_of_row, 0).long()
    xs = torch.where(valid[:, None], xq[tok], 0)
    sx = torch.where(valid, scale_x_tok.float()[tok], 0.0)
    live = torch.arange(tok_of_row.shape[0], device=xq.device) < group_sizes.sum()
    return swiglu_requant_ref(gmm_dequant_ref(xs, w1, group_sizes, sx, scale_w.float()), live)


def gmm2_combine_ring_ref(x, w2, group_sizes, scale_x, scale_w, dest, topk_w, *,
                          init=None):
    """Plain GMM2 + combine: ``out[t] = init[t] + Σ_k topk_w[t,k] · y[dest[t,k]]``
    with ``y`` the dequantized grouped product (zero outside every group)."""
    y = gmm_dequant_ref(x, w2, group_sizes, scale_x.float(), scale_w.float())
    d = dest.long()
    ok = (d >= 0) & (d < group_sizes.sum())
    rows = y[torch.where(ok, d, 0)] * (topk_w.float() * ok)[..., None]   # [n_tok, k, N]
    out = rows.sum(dim=1)
    return out if init is None else out + init.float()


@counted(modes=("float_x",))
def gmm1_ring(xq, tok_of_row, w1, group_sizes, scale_x_tok, scale_w):
    """Grouped W8A8 GEMM1 + dequant → SwiGLU → per-row requant.

    ``xq [n_tok, K]`` int8 tokens, ``tok_of_row [S]`` sorted row → token,
    ``w1 [G, K, 2I]`` int8 (gate ‖ up at full width), ``group_sizes [G]``,
    ``scale_x_tok [n_tok]``, ``scale_w [G, 2I]`` → ``(h1 [S, I] int8, hs [S])``.
    Float tokens (bf16 or f32 ``xq``, JAX's in-kernel quant mode) are
    quantized per token inside the GEMM kernel, each once a launch (the first
    block to read a token quantizes it into scratch), and ``scale_x_tok`` is
    ignored (None).  CUDA tensors launch ``csrc/gmm_ring.cu``; CPU tensors
    take :func:`gmm1_ring_ref`."""
    args = (xq, tok_of_row, w1, group_sizes, scale_x_tok, scale_w)
    if not on_cuda(*(a for a in args if a is not None)):
        return gmm1_ring_ref(*args)
    s = tok_of_row.shape[0]
    n_tok, k = xq.shape
    g, k_w, n = w1.shape
    dev = xq.device
    xf = qflag = None
    if xq.dtype != torch.int8:                   # the float-input mode
        if xq.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"gmm1_ring takes int8, bf16 or f32 tokens, got {xq.dtype}")
        xf = xq.contiguous()
        xq = torch.empty((n_tok, k), dtype=torch.int8, device=dev)
        scale_x_tok = torch.empty(n_tok, dtype=torch.float32, device=dev)
        qflag = torch.empty(n_tok, dtype=torch.int32, device=dev)
    _check_int8("xq", xq)
    _check_int8("w1", w1)
    if k_w != k or k % 4 or n % 8 or scale_w.shape != (g, n):
        raise ValueError(f"gmm1_ring shapes: xq {tuple(xq.shape)}, w1 {tuple(w1.shape)}, "
                         f"scale_w {tuple(scale_w.shape)} (K % 4 and I % 4 must be 0)")
    tok = tok_of_row.to(torch.int32).contiguous()
    sx = scale_x_tok.float().contiguous()
    sw = scale_w.float().contiguous()
    act = torch.empty((s, n // 2), dtype=torch.float32, device=dev)
    amax = torch.empty((s,), dtype=torch.int32, device=dev)
    h1 = torch.empty((s, n // 2), dtype=torch.int8, device=dev)
    hs = torch.empty((s,), dtype=torch.float32, device=dev)
    offsets = _offsets(group_sizes)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.gmm1_ring_launch(
        xq.data_ptr(), tok.data_ptr(), n_tok, w1.data_ptr(), offsets.data_ptr(), g, s, k,
        n, sx.data_ptr(), sw.data_ptr(), act.data_ptr(), amax.data_ptr(), h1.data_ptr(),
        hs.data_ptr(), None if xf is None else xf.data_ptr(),
        int(xf is not None and xf.dtype == torch.bfloat16),
        None if qflag is None else qflag.data_ptr(), cuda_lib.stream_ptr(xq)), "gmm1_ring")
    launched(gmm1_ring, *(() if xf is None else ("float_x",)))
    return h1, hs


@counted
def gmm2_combine_ring(x, w2, group_sizes, scale_x, scale_w, dest, topk_w, *, init=None):
    """Grouped W8A8 GEMM2 with the fused weighted top-k combine.

    ``x [S, K]`` int8 (GMM1 output), ``w2 [G, K, N]`` int8, ``scale_x [S]``,
    ``scale_w [G, N]``, ``dest / topk_w [n_tok, ktop]`` (token, k) → sorted row
    and its f32 weight, ``init [n_tok, N]`` optional accumulator start →
    ``[n_tok, N]`` f32.  CUDA tensors launch ``csrc/gmm_ring.cu``; CPU tensors
    take :func:`gmm2_combine_ring_ref`."""
    args = (x, w2, group_sizes, scale_x, scale_w, dest, topk_w)
    if not on_cuda(*args, *(() if init is None else (init,))):
        return gmm2_combine_ring_ref(*args, init=init)
    s, k = x.shape
    g, k_w, n = w2.shape
    n_tok, ktop = dest.shape
    _check_int8("x", x)
    _check_int8("w2", w2)
    if (k_w != k or k % 4 or n % 4 or ktop > MAX_TOPK
            or scale_w.shape != (g, n) or topk_w.shape != dest.shape):
        raise ValueError(f"gmm2_combine_ring shapes: x {tuple(x.shape)}, w2 "
                         f"{tuple(w2.shape)}, dest {tuple(dest.shape)} (K % 4 and N % 4 "
                         f"must be 0, top-k <= {MAX_TOPK})")
    dev = x.device
    sx = scale_x.float().contiguous()
    sw = scale_w.float().contiguous()
    d = dest.to(torch.int32).contiguous()
    tw = topk_w.float().contiguous()
    init_c = None if init is None else init.float().contiguous()
    y = torch.empty((s, n), dtype=torch.float32, device=dev)
    out = torch.empty((n_tok, n), dtype=torch.float32, device=dev)
    offsets = _offsets(group_sizes)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.gmm2_combine_ring_launch(
        x.data_ptr(), s, k, w2.data_ptr(), offsets.data_ptr(), g, n, sx.data_ptr(),
        sw.data_ptr(), d.data_ptr(), tw.data_ptr(),
        None if init_c is None else init_c.data_ptr(), n_tok, ktop, y.data_ptr(),
        out.data_ptr(), cuda_lib.stream_ptr(x)), "gmm2_combine_ring")
    gmm2_combine_ring.launches += 1
    return out
