"""RMSNorm reference.

Counterpart of ``sgl_kernel_npu_tpu/ops/norm.py``: only ``rms_norm_ref``, which
the DeepSeek path calls (the K6 norm kernels are not on this slice's path).
"""

from __future__ import annotations

import torch


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
