"""Quantized matmul building blocks: static per-tensor quant and the W8A8 GEMM
(K1).

Counterpart of ``sgl_kernel_npu_tpu/ops/matmul.py``.  :func:`quant_matmul`
launches ``csrc/quant_matmul.cu`` for CUDA tensors and takes
:func:`quant_matmul_ref` for CPU tensors.  The TPU wrapper pads N and K to
its tiles; the CUDA kernels (up to 16 rows a decode kernel on mma.sync,
above it wgmma s8 tiles fed by TMA) mask the ragged edges themselves and
need only K % 16 == 0.  ``batch_matmul_transpose`` is not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda
from sgl_kernel_npu_tpu_torch.utils.counters import counted


def quant_per_tensor(x: torch.Tensor, scale, zp) -> torch.Tensor:
    """Static per-tensor quant: round(x / scale + zp) saturated to int8."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    zp = torch.as_tensor(zp, dtype=torch.float32, device=x.device)
    y = x.float() / scale + zp
    return torch.clamp(torch.round(y), -128, 127).to(torch.int8)


def quant_matmul_ref(x_q, w_q, de_scale, bias=None, out_dtype=torch.bfloat16):
    """Plain ``(x_q @ w_q.T + bias) * de_scale`` (``w_q`` is ``[N, K]``).  The
    integer products are summed in float64, which holds every sum of these
    widths exactly (there is no int32 matmul on the card), so the result
    equals the int32 accumulator; then + bias, → f32 (round to nearest),
    × de_scale in f32, → ``out_dtype``."""
    acc = x_q.double() @ w_q.double().T
    if bias is not None:
        acc = acc + bias.double()[None, :]
    return (acc.float() * de_scale.float()[None, :]).to(out_dtype)


def _check(x_q, w_q, de_scale, bias, out_dtype):
    m, k = x_q.shape
    n, k_w = w_q.shape
    for name, t in (("x_q", x_q), ("w_q", w_q)):
        if t.dtype != torch.int8 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"quant_matmul: {name} must be a contiguous, 16-byte aligned "
                             f"int8 tensor, got {t.dtype}")
    if k_w != k or k % 16:
        raise ValueError(f"quant_matmul shapes: x_q {tuple(x_q.shape)}, w_q "
                         f"{tuple(w_q.shape)} (K must agree and K % 16 must be 0)")
    if de_scale.shape != (n,) or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"quant_matmul: de_scale and bias must be [{n}]")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quant_matmul: out_dtype must be f32 or bf16, got {out_dtype}")


@counted
def quant_matmul(x_q, w_q, de_scale, bias=None, *, out_dtype=torch.bfloat16):
    """W8A8 GEMM: ``x_q [M, K] int8 @ w_q [N, K].T`` + int32 ``bias [N]``,
    × f32 per-channel ``de_scale [N]`` → ``[M, N]`` f32 or bf16.  CUDA tensors
    launch ``csrc/quant_matmul.cu``; CPU tensors take :func:`quant_matmul_ref`."""
    args = (x_q, w_q, de_scale, *(() if bias is None else (bias,)))
    if not on_cuda(*args):
        return quant_matmul_ref(x_q, w_q, de_scale, bias, out_dtype)
    _check(x_q, w_q, de_scale, bias, out_dtype)
    m, k = x_q.shape
    n = w_q.shape[0]
    ds = de_scale.float().contiguous()
    b = None if bias is None else bias.to(torch.int32).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.quant_matmul_launch(
        x_q.data_ptr(), w_q.data_ptr(), None if b is None else b.data_ptr(), ds.data_ptr(),
        m, n, k, int(out_dtype == torch.bfloat16), out.data_ptr(),
        cuda_lib.stream_ptr(x_q)), "quant_matmul")
    quant_matmul.launches += 1
    return out
