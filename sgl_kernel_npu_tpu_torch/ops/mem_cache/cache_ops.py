"""Cache-location scatter and gather ops.

Counterpart of ``sgl_kernel_npu_tpu/ops/mem_cache/cache_ops.py`` (the
reference's ``cache_location_assign``, its inverse gather, and
``assign_cache_op``): masked index writes and gathers in int32, on the
inputs' device.  Where JAX returns a new array, the port writes the pool or
the destination in place and returns it.  Indices follow JAX's rules:
negative ones count from the end; a scatter drops what then lies outside the
array, a gather clamps it.  JAX has no Pallas kernel here and the port none.
"""

from __future__ import annotations

import torch

_I32 = torch.int32


def _segments(start: torch.Tensor, end: torch.Tensor, max_total: int):
    """Flat positions ``[max_total]`` → (request, offset in its segment,
    valid) over the ragged segments ``start .. end``."""
    lens = (end - start).to(_I32)
    seg_ends = torch.cumsum(lens, 0, dtype=_I32)
    starts = seg_ends - lens
    p = torch.arange(max_total, dtype=_I32, device=lens.device)
    b = torch.searchsorted(seg_ends, p, right=True).clamp(0, lens.shape[0] - 1)
    return b, p - starts[b], p < seg_ends[-1]


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where(idx < 0, idx + n, idx)


def cache_loc_assign(req_pool_indices: torch.Tensor, token_pool: torch.Tensor,
                     start_offset: torch.Tensor, end_offset: torch.Tensor,
                     out_cache_loc: torch.Tensor) -> torch.Tensor:
    """``token_pool[req_pool_indices[i], start[i]:end[i]] = `` request i's
    segment of ``out_cache_loc``, in place; returns ``token_pool``."""
    b, j, valid = _segments(start_offset, end_offset, out_cache_loc.shape[0])
    n_rows, n_cols = token_pool.shape
    rows = _wrap(req_pool_indices.to(_I32)[b], n_rows)
    cols = _wrap(start_offset.to(_I32)[b] + j, n_cols)
    keep = valid & (rows >= 0) & (rows < n_rows) & (cols >= 0) & (cols < n_cols)
    token_pool[rows[keep].long(), cols[keep].long()] = out_cache_loc[keep].to(token_pool.dtype)
    return token_pool


def cache_loc_update(req_pool_indices: torch.Tensor, req_to_token: torch.Tensor,
                     start_offset: torch.Tensor, end_offset: torch.Tensor,
                     max_total: int) -> torch.Tensor:
    """The inverse gather: each request's locations ``req_to_token[row,
    start:end]`` packed into ``[max_total]``, -1 past the total."""
    b, j, valid = _segments(start_offset, end_offset, max_total)
    n_rows, n_cols = req_to_token.shape
    rows = _wrap(req_pool_indices.to(_I32)[b], n_rows).clamp(0, n_rows - 1)
    cols = _wrap(start_offset.to(_I32)[b] + j, n_cols).clamp(0, n_cols - 1)
    vals = req_to_token[rows.long(), cols.long()]
    return torch.where(valid, vals, torch.full_like(vals, -1))


def assign_cache_op(dst: torch.Tensor, src: torch.Tensor, dst_start, dst_end, src_start,
                    src_end) -> torch.Tensor:
    """Ranged copy ``dst[d0:d1] = src[s0:s1]`` (the shorter length) along
    the first dimension, in place; the bounds are ints or 0-d tensors, read on
    the device.  Returns ``dst``."""
    p = torch.arange(dst.shape[0], dtype=_I32, device=dst.device)
    length = torch.minimum(torch.as_tensor(dst_end - dst_start),
                           torch.as_tensor(src_end - src_start)).to(_I32).to(dst.device)
    in_range = (p >= dst_start) & (p < dst_start + length)
    src_idx = (p - dst_start + src_start).clamp(0, src.shape[0] - 1)
    mask = in_range.reshape((-1,) + (1,) * (dst.ndim - 1))
    dst.copy_(torch.where(mask, src[src_idx.long()], dst))
    return dst
