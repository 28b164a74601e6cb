"""Sinks attention: only the paged-prefill helpers that the MLA prefill and
the lightning indexer use.

Counterpart of ``sgl_kernel_npu_tpu/ops/attention/sinks_attention.py``; the
sinks kernels (K12) are not ported yet.
"""

from __future__ import annotations


def _prefill_page_bounds(seq_len: int, ctx: int, qc: int, *, cq: int, window: int,
                         page_size: int, max_pages: int) -> tuple[int, int]:
    """``[lo_page, hi_page]`` of the KV pages visible to q-chunk ``qc`` of a
    request: its rows hold positions ``[ctx - seq_len + qc*cq, ...) ∩ [., ctx)``;
    the causal bound gives ``hi``, the sliding window (if any) ``lo``."""
    start = ctx - seq_len + qc * cq
    hi_pos = min(ctx - seq_len + (qc + 1) * cq, ctx)          # exclusive
    hi_page = min(max((hi_pos - 1) // page_size, 0), max_pages - 1)
    lo_pos = max(start - (window - 1), 0) if window > 0 else 0
    lo_page = min(max(min(lo_pos // page_size, hi_page), 0), max_pages - 1)
    return lo_page, hi_page


def prefill_q_chunk(max_q: int, q_chunk: int = 64) -> int:
    """Tokens in a q-chunk of the paged prefill kernels (JAX's grids): up to
    ``q_chunk``, at least 8, at most ``max_q``.  The indexer's scores, the
    page selection and the block-sparse prefill must agree on it: a chunk's
    pages are selected for exactly these rows."""
    return min(q_chunk, max(8, max_q))
