"""Paged KV-cache writes (reshape-and-cache), in place.

Counterpart of ``sgl_kernel_npu_tpu/ops/mem_cache/kv_cache.py``.  JAX returns a
new cache (donated under jit); the port writes the cache tensor in place and
returns it.  Layout: ``[num_pages, kv_heads, page_size, head_dim]``, slot =
page * page_size + offset; the transposed variant holds
``[num_pages, kv_heads, head_dim, page_size]`` (the MLA rope cache).

Slot ``-1`` means "skip" (JAX scatters with ``mode="drop"``): the engine sends
it for every pad row.  Those rows are masked out explicitly — a plain index
with ``-1 // page_size`` would write into the last page.
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.quant import saturate_int8


def _live(slot_mapping: torch.Tensor):
    idx = torch.nonzero(slot_mapping >= 0).squeeze(1)
    return idx, slot_mapping.long()[idx]


def reshape_and_cache(value: torch.Tensor, cache: torch.Tensor,
                      slot_mapping: torch.Tensor) -> torch.Tensor:
    """Write ``value [N, kv_heads, head_dim]`` into ``cache`` at
    ``slot_mapping [N]`` (-1 = skip)."""
    page_size = cache.shape[2]
    idx, slots = _live(slot_mapping)
    cache[slots // page_size, :, slots % page_size, :] = value[idx].to(cache.dtype)
    return cache


def write_kv(value: torch.Tensor, cache: torch.Tensor, slot_mapping: torch.Tensor,
             scale=None) -> torch.Tensor:
    """:func:`reshape_and_cache`, writing the int8 levels ``round(value /
    scale)`` (half to even, saturated) into an int8 cache.  ``scale`` is a
    scalar or one per kv head ``[Hkv]``; where a cache row holds two kv heads
    (the packed layout, ``value [N, Hkv / 2, 2 D]``) each head's scale covers
    its half of the row.  The scale divides as a tensor: PyTorch divides a
    CUDA tensor by a Python scalar as a multiply by its reciprocal, which
    can move a value at a rounding tie by a level (``ops/quant.row_scale``)."""
    if cache.dtype == torch.int8:
        s = torch.as_tensor(scale, dtype=torch.float32, device=value.device)
        if s.dim():
            rows, width = value.shape[1], value.shape[2]
            hpr = s.numel() // rows
            s = s.reshape(rows, hpr, 1).expand(rows, hpr, width // hpr).reshape(1, rows, width)
        value = saturate_int8(value.float() / s)
    return reshape_and_cache(value, cache, slot_mapping)


def reshape_and_cache_transposed(value: torch.Tensor, cache: torch.Tensor,
                                 slot_mapping: torch.Tensor) -> torch.Tensor:
    """Same write into the transposed layout ``[pages, kv_heads, head_dim, page]``."""
    page_size = cache.shape[3]
    idx, slots = _live(slot_mapping)
    cache[slots // page_size, :, :, slots % page_size] = value[idx].to(cache.dtype)
    return cache
