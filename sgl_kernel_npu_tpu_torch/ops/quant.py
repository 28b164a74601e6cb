"""Per-token dynamic INT8 quantization helpers.

Counterpart of ``sgl_kernel_npu_tpu/ops/quant.py`` (the plain helpers this
slice needs; the ``quant_per_token`` kernel K5 is not ported yet).
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0


def saturate_int8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even (``torch.round``), then clamp to the int8 range."""
    return torch.clamp(torch.round(x), -128.0, INT8_MAX).to(torch.int8)


def quant_per_token_ref(x: torch.Tensor, eps: float = 1e-12):
    """Per-row symmetric dynamic quant: (int8 values, float32 scales [rows])."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / INT8_MAX, eps)
    return saturate_int8(xf / scale[..., None]), scale
