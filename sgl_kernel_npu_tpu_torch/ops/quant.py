"""Per-token dynamic INT8 quantization: plain helpers and the Hopper kernel (K5).

Counterpart of ``sgl_kernel_npu_tpu/ops/quant.py``.  :func:`quant_per_token`
launches ``csrc/quant.cu`` (a row reduction on ``csrc/row_reduce.cuh``, its
plan from ``ops/row_reduce.py``) for a CUDA tensor and takes
:func:`quant_per_token_ref` for a CPU tensor.  :func:`wire_quant`, the
expert-parallel exchange's wire quant, rides the same kernel.
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.row_reduce import launch_plan
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda
from sgl_kernel_npu_tpu_torch.utils.counters import counted

INT8_MAX = 127.0


def saturate_int8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even (``torch.round``), then clamp to the int8 range."""
    return torch.clamp(torch.round(x), -128.0, INT8_MAX).to(torch.int8)


def row_scale(xf: torch.Tensor) -> torch.Tensor:
    """Per-row ``amax / 127`` of an f32 tensor, by true division, as the JAX
    code and the CUDA kernels compute it.  (PyTorch divides a CUDA tensor by
    a Python scalar as a multiply by its reciprocal, one ulp off at times,
    and a scale one ulp off moves every value at a rounding tie by a level.)"""
    amax = xf.abs().amax(dim=-1)
    return amax / torch.full_like(amax, INT8_MAX)


def quant_per_token_ref(x: torch.Tensor, eps: float = 1e-12):
    """Per-row symmetric dynamic quant: (int8 values, float32 scales [rows])."""
    xf = x.float()
    scale = torch.clamp_min(row_scale(xf), eps)
    return saturate_int8(xf / scale[..., None]), scale


def quant_per_channel(w: torch.Tensor, dim: int):
    """Symmetric int8 weight quant, one scale per channel, the amax taken over
    ``dim`` → (int8 values, f32 scales without ``dim``)."""
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(dim=dim) / INT8_MAX, 1e-12)
    return saturate_int8(wf / s.unsqueeze(dim)), s


_MAGIC = 12582912.0   # 1.5 2^23: an f32 sum in [2^23, 2^24) is an integer


def quant_levels_plain(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K5's rule for its int8 levels (``csrc/quant.cu`` ``level``), in f32 on
    the CPU: ``q = x · (1 / s)`` with the reciprocal rounded once, rounded half
    to even by adding 1.5 2^23 where ``q`` lies at least 2^-15 from a
    half-integer, else ``saturate_int8(x / s)`` by IEEE division.  For rows
    whose scale is ``max(amax / 127, 1e-12)`` it equals
    ``saturate_int8(x / s)``: ``q`` lies within 2^-16 of ``x / s`` and the
    IEEE quotient within 2^-18 (the CPU tests hold it on every bf16 value)."""
    s = scale[..., None]
    q = xf * (torch.ones_like(s) / s)
    t = q + _MAGIC
    fast = (q - (t - _MAGIC)).abs() <= 0.5 - 2.0 ** -15
    level = (t.view(torch.int32) - 0x4B400000).clamp(-128, 127).to(torch.int8)
    return torch.where(fast, level, saturate_int8(xf / s))


def quant_static_per_channel_ref(x: torch.Tensor, scale: torch.Tensor,
                                 offset: torch.Tensor) -> torch.Tensor:
    """Static per-channel quant: ``saturate_int8(x · scale + offset)`` in f32."""
    return saturate_int8(x.float() * scale.float() + offset.float())


def dequant_per_token(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


@counted
def quant_per_token(x: torch.Tensor):
    """Per-token dynamic int8 quant of ``x [rows, hidden]`` (bf16 or f32) →
    ``(int8 [rows, hidden], f32 scales [rows])``, the scale clamped at 1e-12.
    CUDA tensors launch ``csrc/quant.cu`` (bit-equal to the plain version: the
    row's max does not depend on the order); CPU tensors take
    :func:`quant_per_token_ref`."""
    if not on_cuda(x):
        return quant_per_token_ref(x)
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quant_per_token takes a 2-D bf16 or f32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    rows, hidden = x.shape
    q = torch.empty((rows, hidden), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    plan = launch_plan(x, q)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.quant_per_token_launch(
        x.data_ptr(), rows, hidden, int(x.dtype == torch.bfloat16), *plan, q.data_ptr(),
        scale.data_ptr(), cuda_lib.stream_ptr(x)), "quant_per_token")
    quant_per_token.launches += 1
    return q, scale


def wire_quant(x: torch.Tensor):
    """Per-row int8 wire quant of ``[..., H]`` payloads for the
    expert-parallel dispatch and combine → ``(int8 [..., H], f32 scales
    [...])``, through :func:`quant_per_token` (K5) as JAX's goes through its
    Pallas kernel."""
    lead, h = x.shape[:-1], x.shape[-1]
    q, s = quant_per_token(x.reshape(-1, h))
    return q.reshape(*lead, h), s.reshape(lead)
