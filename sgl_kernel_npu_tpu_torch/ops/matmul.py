"""Quantized matmul building blocks: static per-tensor quant and the W8A8 GEMM
(K1).

Counterpart of ``sgl_kernel_npu_tpu/ops/matmul.py``.  :func:`quant_matmul`
launches ``csrc/quant_matmul.cu`` for CUDA tensors and takes
:func:`quant_matmul_ref` for CPU tensors.  The TPU wrapper pads N and K to
its tiles; the CUDA kernels (up to 16 rows a decode kernel on mma.sync,
above it wgmma s8 tiles fed by TMA) mask the ragged edges themselves and
need only K % 16 == 0.  :func:`batch_matmul_transpose` (JAX's einsum,
no Pallas kernel) is torch ops: its int8 products are summed exactly in
float64, on the card as on the CPU (``torch.bmm`` takes no int8 on CUDA).
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


QUANT_MODES = ("per_channel_symm", "per_channel_asymm", "per_token_symm")


def batch_matmul_transpose(a: torch.Tensor, b: torch.Tensor, out_dtype=None, *,
                           quant_mode: str | None = None, de_scale=None, bias=None,
                           per_token_scale=None) -> torch.Tensor:
    """``out[i, j] = a[i, j, :] @ b[j]`` (einsum ``bmk,mkn->bmn``; JAX's
    ``batch_matmul_transpose``).  Float: f32 accumulation, out in
    ``out_dtype`` (a's dtype by default).  ``quant_mode`` (int8 ``a`` /
    ``b``, out bf16 by default): the int32 sums ``acc`` (exact: summed in
    float64, which holds them for any K below 2^37), then

    - ``per_channel_symm``:  ``acc · de_scale[m, n]``
    - ``per_channel_asymm``: ``(acc + bias[m, n]) · de_scale[m, n]`` (``bias``
      the int32 zero-point correction)
    - ``per_token_symm``:    ``acc · de_scale[m, n] · per_token_scale[b, m]``

    ``de_scale`` broadcasts from ``[m, n]`` or ``[n]``, ``per_token_scale``
    from ``[b, m]`` or ``[b]``; the products in f32, as JAX's."""
    if quant_mode is None:
        return torch.einsum("bmk,mkn->bmn", a.float(), b.float()).to(out_dtype or a.dtype)
    if quant_mode not in QUANT_MODES:
        raise ValueError(f"unsupported quant_mode {quant_mode!r}; one of {QUANT_MODES}")
    if de_scale is None:
        raise ValueError("quantized modes need de_scale")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"quantized modes take int8 a and b, got {a.dtype} and {b.dtype}")
    acc = torch.einsum("bmk,mkn->bmn", a.double(), b.double()).to(torch.int32)
    if quant_mode == "per_channel_asymm":
        if bias is None:
            raise ValueError("per_channel_asymm needs the int32 bias term")
        acc = acc + bias.to(torch.int32)[None]
    ds = de_scale.float()
    out = acc.float() * (ds[None] if ds.ndim == 1 else ds)[None]
    if quant_mode == "per_token_symm":
        if per_token_scale is None:
            raise ValueError("per_token_symm needs per_token_scale")
        pts = per_token_scale.float()
        out = out * (pts[:, None] if pts.ndim == 1 else pts)[..., None]
    return out.to(out_dtype or torch.bfloat16)
