"""W8A8 (int8 weights × per-token int8 activations) projection helpers.

Counterpart of ``sgl_kernel_npu_tpu/models/w8a8.py``: per-output-channel
symmetric weight quant at load time, per-token dynamic activation quant
(``quant_per_token``, K5) at run time, the int8 GEMM ``quant_matmul`` (K1)
and the fused SwiGLU requant ``swiglu_quant`` (K7a).  ``plain=True`` takes
the kernels' plain versions.  ``calibrate_kv_scales`` waits for Llama's int8
KV cache.
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.activation import swiglu_quant, swiglu_quant_ref
from sgl_kernel_npu_tpu_torch.ops.matmul import quant_matmul, quant_matmul_ref
from sgl_kernel_npu_tpu_torch.ops.quant import (
    quant_per_channel,
    quant_per_token,
    quant_per_token_ref,
)


def quantize_matrix(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-out-channel symmetric int8 quant of a ``[K, N]`` matrix →
    ``(w_q [N, K] int8, de_scale [N] f32)``, the layout :func:`quant_matmul`
    takes (K contiguous)."""
    q, s = quant_per_channel(w, dim=0)
    return q.T.contiguous(), s


def qmm(x_q, sx, wq_s, out_dtype=torch.float32, *, plain: bool = False):
    """Dequantized ``x @ w``: the int8 GEMM with the per-channel de-scale in
    its epilogue, then × the per-token scale outside the kernel."""
    w_q, sw = wq_s
    gemm = quant_matmul_ref if plain else quant_matmul
    y = gemm(x_q, w_q, sw, out_dtype=torch.float32)
    return (y * sx[:, None]).to(out_dtype)


def project(x, wq_s, out_dtype=torch.float32, *, plain: bool = False):
    """Per-token quantize ``x`` then W8A8-project it."""
    x_q, sx = (quant_per_token_ref if plain else quant_per_token)(x)
    return qmm(x_q, sx, wq_s, out_dtype, plain=plain)


def mlp_swiglu(x, w_gate_up_q, w_down_q, out_dtype, *, plain: bool = False):
    """W8A8 SwiGLU MLP: GEMM (gate ‖ up) → bf16 → fused SwiGLU + requant →
    GEMM (down)."""
    gu = project(x, w_gate_up_q, plain=plain)
    a_q, sa = (swiglu_quant_ref if plain else swiglu_quant)(gu.to(torch.bfloat16))
    return qmm(a_q, sa, w_down_q, out_dtype, plain=plain)
