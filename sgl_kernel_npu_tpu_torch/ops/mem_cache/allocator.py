"""Paged-KV slot allocation.

Counterpart of ``sgl_kernel_npu_tpu/ops/mem_cache/allocator.py`` (the
reference's ``alloc_extend``, a three-part fill): from each request's previous
and new length, its last occupied slot and a free-page list, the token slots
of every request's extension, packed back to back.  Each output position
derives its slot in closed form, in int32 as JAX does (``cumsum``,
``searchsorted(right=True)``, clips at JAX's places), on the inputs' device.
JAX has no Pallas kernel here and the port none.
"""

from __future__ import annotations

import torch

_I32 = torch.int32


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=_I32)


def alloc_extend(pre_lens: torch.Tensor, seq_lens: torch.Tensor, last_loc: torch.Tensor,
                 free_pages: torch.Tensor, *, page_size: int,
                 max_extend_tokens: int) -> torch.Tensor:
    """Token-slot ids for extending each request.

    Args:
        pre_lens: ``[B]`` current lengths; seq_lens: ``[B]`` target lengths.
        last_loc: ``[B]`` last occupied slot id of each request.
        free_pages: ``[F]`` free physical page ids, consumed in order.
        max_extend_tokens: output size (at least the total extension).

    Returns ``[max_extend_tokens]`` int32 slot ids, -1 past the total.
    """
    pre_lens, seq_lens = pre_lens.to(_I32), seq_lens.to(_I32)
    extend = seq_lens - pre_lens
    seg_ends = _cumsum(extend)
    starts = seg_ends - extend                       # output segment start of each request
    pages_before = -(-pre_lens // page_size)
    new_pages = -(-seq_lens // page_size) - pages_before
    page_starts = _cumsum(new_pages) - new_pages     # free-list offset of each request

    p = torch.arange(max_extend_tokens, dtype=_I32, device=pre_lens.device)
    b = torch.searchsorted(seg_ends, p, right=True).clamp(0, pre_lens.shape[0] - 1)
    j = p - starts[b]                                # position within the extension
    tok = pre_lens[b] + j                            # absolute position in the sequence
    page = tok // page_size
    in_old_partial = page < pages_before[b]
    free_idx = (page_starts[b] + page - pages_before[b]).clamp(0, free_pages.shape[0] - 1)
    slot_new = free_pages[free_idx].to(_I32) * page_size + tok % page_size
    slot_old = last_loc.to(_I32)[b] + 1 + j
    slot = torch.where(in_old_partial, slot_old, slot_new)
    return torch.where(p < seg_ends[-1], slot, torch.full_like(slot, -1))


def alloc_decode(seq_lens: torch.Tensor, last_loc: torch.Tensor, free_pages: torch.Tensor, *,
                 page_size: int = 128) -> torch.Tensor:
    """One decode token a request: the slot of position ``seq_lens - 1``,
    from a new free page where that position opens one."""
    seq_lens = seq_lens.to(_I32)
    needs_page = ((seq_lens - 1) % page_size == 0).to(_I32)
    page_ord = _cumsum(needs_page) - needs_page
    new_slot = free_pages[page_ord.clamp(0, free_pages.shape[0] - 1)].to(_I32) * page_size
    return torch.where(needs_page.bool(), new_slot, last_loc.to(_I32) + 1)
