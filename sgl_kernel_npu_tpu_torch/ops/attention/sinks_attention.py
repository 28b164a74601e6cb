"""Attention with sink logits (GPT-OSS) over the paged KV cache: plain
versions and the Hopper kernels (K12a decode, K12d prefill), and the paged
prefill helpers the MLA prefill and the lightning indexer share.

Counterpart of ``sgl_kernel_npu_tpu/ops/attention/sinks_attention.py``
(``attention_sinks_ref``, ``attention_sinks``, ``attention_sinks_prefill``,
``attention_sinks_prefill_pallas``; the names are kept, the kernels are CUDA:
``csrc/sinks_attention.cu``).  A learned logit per q head joins the softmax
denominator only (one extra always-attended key whose value is 0); q head h
reads kv head ``h // (Hq / Hkv)``.  Layouts: query ``[S, Hq * D]``, caches
``[pages, Hkv, page, D]``, out ``[S, Hq * D]``.  Even layers of GPT-OSS slide:
a decode token sees positions ``[ctx - window, ctx)``, a prefill token at
``qpos`` sees ``(qpos - window, qpos]``; ``window = 0`` is full attention.
Masked scores are the finite ``-1e30`` (``decode_attention.NEG_INF``).

Not ported yet (ROADMAP queue A): the int8 KV cache (``k_scale`` /
``v_scale``) and the packed layout (``attention_sinks_packed``, K12b-c).
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.attention.decode_attention import NEG_INF, _gather_pages
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda
from sgl_kernel_npu_tpu_torch.utils.counters import counted

KERNEL_HEAD_DIMS = (64, 128)   # head widths the CUDA kernels are built for
DECODE_MAX_GROUP = 8           # q heads a kv head in the decode kernel (one a warp)


def _no_int8(k_cache, v_cache, k_scale, v_scale) -> None:
    if k_cache.dtype == torch.int8 or v_cache.dtype == torch.int8 \
            or k_scale is not None or v_scale is not None:
        raise NotImplementedError("the int8 KV cache of sinks attention is not ported yet "
                                  "(ROADMAP queue A, GPT-OSS)")


def packed_rows(seq_lens: torch.Tensor, s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """For each of ``s`` packed rows: its request and its index among the
    request's new tokens (rows past the last request count on in it, as
    JAX's ``searchsorted`` clip gives)."""
    dev = seq_lens.device
    sl = seq_lens.long()
    ends = torch.cumsum(sl, 0)
    rows = torch.arange(s, device=dev)
    req = torch.clamp(torch.searchsorted(ends, rows, right=True), 0, sl.shape[0] - 1)
    return req, rows - (ends[req] - sl[req])


def _softmax_with_sink(logits: torch.Tensor, sinks, hkv: int, group: int) -> torch.Tensor:
    """Softmax over the last dim of ``logits [..., Hkv, G, L]`` with head
    (k, g)'s sink logit as one more entry that is then dropped."""
    if sinks is None:
        return torch.softmax(logits, dim=-1)
    sink = sinks.float().reshape(hkv, group)[..., None].expand(*logits.shape[:-1], 1)
    return torch.softmax(torch.cat([logits, sink], dim=-1), dim=-1)[..., :-1]


# ---------------------------------------------------------------------------
# decode (K12a)
# ---------------------------------------------------------------------------

def attention_sinks_ref(query, k_cache, v_cache, sinks, block_tables, context_lens, scale,
                        sliding_window_size: int, q_head_num: int, k_head_num: int,
                        k_scale=None, v_scale=None):
    """Plain paged decode attention with sinks and sliding window (f32 math
    over the whole block table): query ``[S, Hq * D]`` → ``[S, Hq * Dv]``."""
    _no_int8(k_cache, v_cache, k_scale, v_scale)
    s = query.shape[0]
    d = query.shape[-1] // q_head_num
    dv = v_cache.shape[-1]
    group = q_head_num // k_head_num
    max_len = block_tables.shape[1] * k_cache.shape[2]
    q = query.reshape(s, k_head_num, group, d).float()
    k = _gather_pages(k_cache, block_tables, max_len).float()           # [S, Hkv, L, D]
    v = _gather_pages(v_cache, block_tables, max_len).float()
    logits = torch.einsum("skgd,skld->skgl", q, k) * scale
    pos = torch.arange(max_len, device=query.device)[None, None, None, :]
    ctx = context_lens.to(query.device).long()[:, None, None, None]
    mask = pos < ctx
    if sliding_window_size > 0:
        mask &= pos >= ctx - sliding_window_size
    p = _softmax_with_sink(torch.where(mask, logits, NEG_INF), sinks, k_head_num, group)
    out = torch.einsum("skgl,skld->skgd", p, v)
    return out.reshape(s, q_head_num * dv).to(query.dtype)


def _decode_page_bounds(ctx: int, *, window: int, page_size: int,
                        max_pages: int) -> tuple[int, int]:
    """``[lo_page, hi_page]`` of the KV pages a decode token (position
    ``ctx - 1``) can see: the window's pages on a sliding layer."""
    hi_page = min(max((ctx - 1) // page_size, 0), max_pages - 1)
    lo = max(ctx - window, 0) if window > 0 else 0
    lo_page = min(max(min(lo // page_size, hi_page), 0), max_pages - 1)
    return lo_page, hi_page


def _check_kernel_operands(query, k_cache, v_cache, q_head_num: int, k_head_num: int,
                           max_group: int) -> tuple[int, int]:
    """What the CUDA sinks kernels take → ``(head_dim, group)``."""
    d = query.shape[-1] // q_head_num
    group = q_head_num // k_head_num
    if not (query.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16):
        raise ValueError(f"the CUDA sinks kernels take bf16 queries and caches, got "
                         f"{query.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if d not in KERNEL_HEAD_DIMS or k_cache.shape != v_cache.shape \
            or tuple(k_cache.shape[1::2]) != (k_head_num, d) or group * k_head_num != q_head_num \
            or not 1 <= group <= max_group:
        raise ValueError(f"sinks kernel shapes: head_dim in {KERNEL_HEAD_DIMS}, caches "
                         f"[P, {k_head_num}, page, {d}] alike, at most {max_group} q heads a "
                         f"kv head; got query {tuple(query.shape)} with {q_head_num} heads, "
                         f"caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("paged caches must be contiguous")
    return d, group


@counted
def attention_sinks(query, k_cache, v_cache, sinks, block_tables, context_lens, scale,
                    sliding_window_size: int, q_head_num: int, k_head_num: int, *,
                    k_scale=None, v_scale=None):
    """Paged decode attention with sinks and sliding window: query ``[S, Hq *
    D]`` (one new token a row, ``context_lens`` including it) → ``[S, Hq *
    D]``.  CUDA tensors launch ``csrc/sinks_attention.cu`` (bf16, D 64 or 128,
    at most 8 q heads a kv head); CPU tensors take :func:`attention_sinks_ref`.
    Pad rows (ctx 1, block table of zeros) are safe."""
    _no_int8(k_cache, v_cache, k_scale, v_scale)
    if not on_cuda(query, k_cache, v_cache, sinks, block_tables, context_lens):
        return attention_sinks_ref(query, k_cache, v_cache, sinks, block_tables, context_lens,
                                   scale, sliding_window_size, q_head_num, k_head_num)
    d, group = _check_kernel_operands(query, k_cache, v_cache, q_head_num, k_head_num,
                                      DECODE_MAX_GROUP)
    q = query.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    ctx = context_lens.to(torch.int32).contiguous()
    sk = sinks.float().contiguous()
    out = torch.empty_like(q)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.sinks_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), sk.data_ptr(), bt.data_ptr(),
        ctx.data_ptr(), out.data_ptr(), q.shape[0], k_head_num, group, d, k_cache.shape[2],
        bt.shape[1], int(sliding_window_size), float(scale), cuda_lib.stream_ptr(q)),
        "attention_sinks")
    attention_sinks.launches += 1
    return out


# ---------------------------------------------------------------------------
# prefill (K12d)
# ---------------------------------------------------------------------------

def attention_sinks_prefill(query, k_cache, v_cache, sinks, seq_lens, block_tables,
                            context_lens, scale, sliding_window_size: int, q_head_num: int,
                            k_head_num: int, k_scale=None, v_scale=None):
    """Golden varlen prefill with sinks (f32 math): query rows are each
    request's last ``seq_lens[b]`` positions, packed; token j of request b
    attends causally to positions ``<= context_len - seq_len + j`` (window
    applies).  Rows past the requests attend as the last request's."""
    _no_int8(k_cache, v_cache, k_scale, v_scale)
    s = query.shape[0]
    d = query.shape[-1] // q_head_num
    dv = v_cache.shape[-1]
    group = q_head_num // k_head_num
    max_len = block_tables.shape[1] * k_cache.shape[2]
    req, j = packed_rows(seq_lens.to(query.device), s)
    ctx = context_lens.to(query.device).long()
    qpos = ctx[req] - seq_lens.to(query.device).long()[req] + j
    q = query.reshape(s, k_head_num, group, d).float()
    k = _gather_pages(k_cache, block_tables, max_len).float()[req]     # [S, Hkv, L, D]
    v = _gather_pages(v_cache, block_tables, max_len).float()[req]
    logits = torch.einsum("skgd,skld->skgl", q, k) * scale
    pos = torch.arange(max_len, device=query.device)[None, None, None, :]
    hi = (qpos + 1)[:, None, None, None]
    mask = pos < hi
    if sliding_window_size > 0:
        mask &= pos >= hi - sliding_window_size
    p = _softmax_with_sink(torch.where(mask, logits, NEG_INF), sinks, k_head_num, group)
    out = torch.einsum("skgl,skld->skgd", p, v)
    return out.reshape(s, q_head_num * dv).to(query.dtype)


def attention_sinks_prefill_plain(query, k_cache, v_cache, sinks, seq_lens, block_tables,
                                  context_lens, scale, sliding_window_size: int,
                                  q_head_num: int, k_head_num: int, *,
                                  max_q: int | None = None, k_scale=None, v_scale=None):
    """Plain version of :func:`attention_sinks_prefill_pallas` (f32 math, one
    request at a time over the keys it can see): the golden's function, and
    rows past the requests (the engine's pad rows) exactly 0, as the JAX
    kernel leaves them.  ``max_q`` shapes only the kernel's grid."""
    _no_int8(k_cache, v_cache, k_scale, v_scale)
    s = query.shape[0]
    d = query.shape[-1] // q_head_num
    dv = v_cache.shape[-1]
    group = q_head_num // k_head_num
    max_len = block_tables.shape[1] * k_cache.shape[2]
    out = query.new_zeros((s, q_head_num * dv))
    start = 0
    for b, (sl, cl) in enumerate(zip(seq_lens.tolist(), context_lens.tolist())):
        rows = min(sl, s - start)
        if rows <= 0:
            continue
        n_keys = min(cl, max_len)
        bt = block_tables[b : b + 1]
        k = _gather_pages(k_cache, bt, n_keys)[0].float()                # [Hkv, L, D]
        v = _gather_pages(v_cache, bt, n_keys)[0].float()
        q = query[start : start + rows].reshape(rows, k_head_num, group, d).float()
        logits = torch.einsum("tkgd,kld->tkgl", q, k) * scale
        qpos = cl - sl + torch.arange(rows, device=query.device)[:, None]
        kpos = torch.arange(n_keys, device=query.device)[None, :]
        mask = kpos <= qpos
        if sliding_window_size > 0:
            mask &= kpos > qpos - sliding_window_size
        p = _softmax_with_sink(torch.where(mask[:, None, None, :], logits, NEG_INF), sinks,
                               k_head_num, group)
        o = torch.einsum("tkgl,kld->tkgd", p, v)
        out[start : start + rows] = o.reshape(rows, q_head_num * dv).to(query.dtype)
        start += sl
    return out


@counted
def attention_sinks_prefill_pallas(query, k_cache, v_cache, sinks, seq_lens, block_tables,
                                   context_lens, scale, sliding_window_size: int,
                                   q_head_num: int, k_head_num: int, *,
                                   max_q: int | None = None, k_scale=None, v_scale=None):
    """Varlen causal prefill with sinks (``sinks=None``: none) and sliding
    window over the paged cache: query ``[S, Hq * D]`` packed by request →
    ``[S, Hq * D]``, rows past the requests 0.  ``max_q`` bounds every
    request's new-token count (defaults to ``S``).  CUDA tensors launch
    ``csrc/sinks_attention.cu`` (bf16, D 64 or 128, at most 128 q heads a kv
    head), which reads the packed rows directly; CPU tensors take
    :func:`attention_sinks_prefill_plain`."""
    _no_int8(k_cache, v_cache, k_scale, v_scale)
    args = (query, k_cache, v_cache, seq_lens, block_tables, context_lens)
    if not on_cuda(*args, *(() if sinks is None else (sinks,))):
        return attention_sinks_prefill_plain(query, k_cache, v_cache, sinks, seq_lens,
                                             block_tables, context_lens, scale,
                                             sliding_window_size, q_head_num, k_head_num)
    d, group = _check_kernel_operands(query, k_cache, v_cache, q_head_num, k_head_num, 128)
    q = query.contiguous()
    s = q.shape[0]
    sl = seq_lens.to(torch.int32).contiguous()
    starts = (torch.cumsum(sl, 0, dtype=torch.int32) - sl).contiguous()
    ctx = context_lens.to(torch.int32).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    sk = None if sinks is None else sinks.float().contiguous()
    out = torch.zeros_like(q)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.sinks_prefill_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if sk is None else sk.data_ptr(), bt.data_ptr(), sl.data_ptr(), ctx.data_ptr(),
        starts.data_ptr(), out.data_ptr(), sl.shape[0], k_head_num, group, d, k_cache.shape[2],
        bt.shape[1], int(sliding_window_size), int(max_q or s), float(scale),
        cuda_lib.stream_ptr(q)), "attention_sinks_prefill_pallas")
    attention_sinks_prefill_pallas.launches += 1
    return out


# ---------------------------------------------------------------------------
# paged-prefill helpers (the MLA prefill and the lightning indexer)
# ---------------------------------------------------------------------------

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
