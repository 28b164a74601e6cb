"""W8A8 (int8 weights × per-token int8 activations) projection helpers.

Counterpart of ``sgl_kernel_npu_tpu/models/w8a8.py``: per-output-channel
symmetric weight quant at load time, per-token dynamic activation quant
(``quant_per_token``, K5) at run time, the int8 GEMM ``quant_matmul`` (K1)
and the fused SwiGLU requant ``swiglu_quant`` (K7a).  ``plain=True`` takes
the kernels' plain versions.  Also the int8 KV cache's calibration
(``calibrate_kv_scales``) and the converter of JAX's quantized weights
(``from_jax_weights_q``).
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.activation import swiglu_quant, swiglu_quant_ref
from sgl_kernel_npu_tpu_torch.ops.matmul import quant_matmul, quant_matmul_ref
from sgl_kernel_npu_tpu_torch.ops.quant import (
    INT8_MAX,
    quant_per_channel,
    quant_per_token,
    quant_per_token_ref,
)
from sgl_kernel_npu_tpu_torch.utils.common import resolve_device, to_torch


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


def calibrate_kv_scales(caches) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per-kv-head int8 cache scales read off a float run's paged caches
    ``[(k_cache, v_cache)]`` of layout ``[P, Hkv, page, D]`` (unwritten pages
    are zeros and raise no maximum): ``max(|x|max, 1e-6) / 127`` per layer
    and kv head → ``[(k_scale [Hkv], v_scale [Hkv])]``, the models'
    ``kv_scales``."""
    def head_scale(c):
        amax = c.float().abs().amax(dim=(0, 2, 3)).clamp_min(1e-6)
        return amax / torch.full_like(amax, INT8_MAX)
    return [(head_scale(k), head_scale(v)) for k, v in caches]


def from_jax_weights_q(weights_q_np: dict, device="cuda") -> dict:
    """JAX's quantized projections ``{"layers": [{name: (w_q [N, K] int8,
    de_scale [N] f32)}]}`` (numpy leaves, the models' ``quantize_weights``)
    → the port's tensors on ``device``; the layouts already agree."""
    dev = resolve_device(device)
    return {"layers": [{name: (to_torch(w, dev), to_torch(s, dev)) for name, (w, s) in lw.items()}
                       for lw in weights_q_np["layers"]]}
