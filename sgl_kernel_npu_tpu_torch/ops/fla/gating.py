"""Fused GDN gating.

Counterpart of ``sgl_kernel_npu_tpu/ops/fla/gating.py``:
``g = -exp(A_log) · softplus(a + dt_bias, beta, threshold)``, ``beta_out =
sigmoid(b)``, in f32.  Elementwise torch ops: JAX has no kernel here either.
"""

from __future__ import annotations

import torch


def softplus_beta(x: torch.Tensor, beta: float = 1.0, threshold: float = 20.0) -> torch.Tensor:
    bx = beta * x
    return torch.where(bx <= threshold, (1.0 / beta) * torch.log1p(torch.exp(bx)), x)


def fused_gdn_gating(A_log: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     dt_bias: torch.Tensor, beta: float = 1.0, threshold: float = 20.0):
    """``A_log [HV]``, ``a`` / ``b [..., HV]``, ``dt_bias [HV]`` → ``(g,
    beta_out)`` in f32."""
    x = a.float() + dt_bias.float()
    g = -torch.exp(A_log.float()) * softplus_beta(x, beta, threshold)
    return g, torch.sigmoid(b.float())
