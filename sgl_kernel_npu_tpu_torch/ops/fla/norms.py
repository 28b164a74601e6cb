"""Gated group layer / RMS norm.

Counterpart of ``sgl_kernel_npu_tpu/ops/fla/norms.py``: ``y = norm(x or
x·silu(z))`` per group, f32 inside; with ``norm_before_gate`` the gate
applies after the norm, ``y = (norm(x)·w + b)·silu(z)``.
"""

from __future__ import annotations

import torch


def layernorm_gated(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                    z: torch.Tensor | None = None, *, eps: float = 1e-5,
                    group_size: int | None = None, norm_before_gate: bool = True,
                    is_rms_norm: bool = False) -> torch.Tensor:
    n = x.shape[-1]
    group_size = group_size or n
    if n % group_size:
        raise ValueError(f"width {n} is not a multiple of group_size {group_size}")
    xf = x.float()
    if z is not None and not norm_before_gate:
        zf = z.float()
        xf = xf * zf * torch.sigmoid(zf)
    xg = xf.reshape(*xf.shape[:-1], n // group_size, group_size)
    if is_rms_norm:
        var = (xg * xg).mean(dim=-1, keepdim=True)
        xn = xg * torch.rsqrt(var + eps)
    else:
        mu = xg.mean(dim=-1, keepdim=True)
        var = ((xg - mu) ** 2).mean(dim=-1, keepdim=True)
        xn = (xg - mu) * torch.rsqrt(var + eps)
    y = xn.reshape(xf.shape) * weight.float()
    if bias is not None:
        y = y + bias.float()
    if z is not None and norm_before_gate:
        zf = z.float()
        y = y * zf * torch.sigmoid(zf)
    return y.to(x.dtype)
