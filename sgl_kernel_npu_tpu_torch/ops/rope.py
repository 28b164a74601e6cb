"""Rotate-half rotary position embedding.

Counterpart of ``sgl_kernel_npu_tpu/ops/rope.py`` (``rope_cos_sin``,
``apply_rope``, ``apply_rope_interleaved``).
"""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, rotary_dim: int, base: float = 10000.0,
                 dtype=torch.float32):
    """cos/sin tables ``[len(positions), rotary_dim]`` (neox layout: the
    frequency of pair ``i`` repeats across both halves)."""
    half = rotary_dim // 2
    inv_freq = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32,
                                            device=positions.device) * 2.0 / rotary_dim))
    freqs = positions.float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x*cos + rotate_half(x)*sin`` for ``x [N, heads, D]``, ``cos/sin [N, D]``."""
    xf = x.float()
    return (xf * cos.float()[:, None, :] + rotate_half(xf) * sin.float()[:, None, :]).to(x.dtype)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """GPT-J (interleaved) RoPE: the pairs are adjacent elements ``(2i, 2i+1)``,
    rotated by the first half of ``cos/sin [N, D]``; ``x [N, heads, D]``."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    half = cos.shape[-1] // 2
    c = cos.float()[:, None, :half]
    s = sin.float()[:, None, :half]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(xf.shape).to(x.dtype)
