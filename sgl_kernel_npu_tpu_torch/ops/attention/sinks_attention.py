"""Attention with sink logits (GPT-OSS) over the paged KV cache: goldens,
plain versions and the Hopper kernels (K12a decode, K12b / K12c decode over
the packed cache, K12d prefill), and the paged prefill helpers the MLA
prefill and the lightning indexer share.

Counterpart of ``sgl_kernel_npu_tpu/ops/attention/sinks_attention.py`` and
``sinks_flat.py`` (``attention_sinks_ref``, ``attention_sinks``,
``pack_kv_sinks``, ``attention_sinks_packed``, ``attention_sinks_prefill``,
``attention_sinks_prefill_pallas``, ``attention_sinks_prefill_packed``; the
names are kept, the kernels are CUDA: ``csrc/sinks_attention.cu``).  A learned
logit per q head joins the softmax denominator only (one extra
always-attended key whose value is 0); q head h reads kv head ``h // (Hq /
Hkv)``.  Layouts: query ``[S, Hq * D]``, caches ``[pages, Hkv, page, D]`` or
packed ``[pages, Hkv / 2, page, 2 D]``, out ``[S, Hq * D]``.  Even layers of
GPT-OSS slide: a decode token sees positions ``[ctx - window, ctx)``, a
prefill token at ``qpos`` sees ``(qpos - window, qpos]``; ``window = 0`` is
full attention.  Masked scores are the finite ``-1e30``
(``decode_attention.NEG_INF``).

Caches are bf16, f32 (plain versions only) or int8 levels ``round(x /
scale)`` with a scalar or per-kv-head scale.  The goldens
(``attention_sinks_ref``, ``attention_sinks_prefill``) dequantize the
gathered keys, as JAX's do; the plain versions that stand beside the kernels
(``attention_sinks_plain``, ``attention_sinks_prefill_plain``: the wrappers'
CPU path and the models' ``plain=True``) take the wrappers' fold of
``k_scale`` into q and ``v_scale`` into the output, so that kernel and plain
version differ only in the kernel's arithmetic.  The packed layout is the
TPU's way to fill 128 lanes at D = 64; on the H100 it reads the bytes of the
plain layout, and the kernels take it by strides, without JAX's
zero-interleaved queries.
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.attention.decode_attention import (
    NEG_INF,
    _gather_pages,
    _kv_head_scale,
    _scale_arg,
    check_paged_operands,
    paged_decode,
    paged_decode_plain,
    paged_decode_ref,
    scale_heads,
    softmax_with_sink,
)
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda
from sgl_kernel_npu_tpu_torch.utils.counters import counted

PREFILL_MAX_GROUP = 128   # q heads a kv head the prefill kernel takes (its ValueError rule)


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


def pack_kv_sinks(cache: torch.Tensor) -> torch.Tensor:
    """``[P, Hkv, page, d]`` → the packed ``[P, Hkv / 2, page, 2 d]``: kv
    heads 2j and 2j + 1 share a row (2j in lanes ``[0, d)``)."""
    p, h, pg, d = cache.shape
    if h % 2:
        raise ValueError(f"the packed layout needs an even kv-head count, got {h}")
    return cache.reshape(p, h // 2, 2, pg, d).transpose(2, 3).reshape(p, h // 2, pg, 2 * d)


def _hpr(packed: bool) -> int:
    return 2 if packed else 1


# ---------------------------------------------------------------------------
# decode (K12a; K12b / K12c over the packed cache)
# ---------------------------------------------------------------------------

def attention_sinks_ref(query, k_cache, v_cache, sinks, block_tables, context_lens, scale,
                        sliding_window_size: int, q_head_num: int, k_head_num: int,
                        k_scale=None, v_scale=None):
    """Golden paged decode attention with sinks and sliding window
    (:func:`decode_attention.paged_decode_ref`: f32 math over the whole block
    table, int8 levels dequantized after the gather, as JAX's golden): query
    ``[S, Hq * D]`` → ``[S, Hq * Dv]``."""
    return paged_decode_ref(query, k_cache, v_cache, sinks, block_tables, context_lens, scale,
                            sliding_window_size, q_head_num, k_head_num, k_scale, v_scale)


def attention_sinks_plain(query, k_cache, v_cache, sinks, block_tables, context_lens, scale,
                          sliding_window_size: int, q_head_num: int, k_head_num: int, *,
                          k_scale=None, v_scale=None, packed: bool = False):
    """Plain version of the decode kernels (K12a; K12b / K12c with
    ``packed``): :func:`decode_attention.paged_decode_plain`, the int8 scales
    folded as the wrappers fold them."""
    return paged_decode_plain(query, k_cache, v_cache, sinks, block_tables, context_lens, scale,
                              sliding_window_size, q_head_num, k_head_num, k_scale, v_scale,
                              _hpr(packed))


def _decode_page_bounds(ctx: int, *, window: int, page_size: int,
                        max_pages: int) -> tuple[int, int]:
    """``[lo_page, hi_page]`` of the KV pages a decode token (position
    ``ctx - 1``) can see: the window's pages on a sliding layer."""
    hi_page = min(max((ctx - 1) // page_size, 0), max_pages - 1)
    lo = max(ctx - window, 0) if window > 0 else 0
    lo_page = min(max(min(lo // page_size, hi_page), 0), max_pages - 1)
    return lo_page, hi_page


@counted
def attention_sinks(query, k_cache, v_cache, sinks, block_tables, context_lens, scale,
                    sliding_window_size: int, q_head_num: int, k_head_num: int, *,
                    k_scale=None, v_scale=None):
    """Paged decode attention with sinks and sliding window: query ``[S, Hq *
    D]`` (one new token a row, ``context_lens`` including it) → ``[S, Hq *
    D]``.  CUDA tensors launch ``csrc/sinks_attention.cu`` (bf16 or int8
    caches, D in ``KERNEL_HEAD_DIMS``, any group); CPU tensors take
    :func:`attention_sinks_plain`.  Pad rows (ctx 1, block table of zeros)
    are safe."""
    args = (query, k_cache, v_cache, sinks, block_tables, context_lens, scale,
            sliding_window_size, q_head_num, k_head_num)
    if not on_cuda(query, k_cache, v_cache, sinks, block_tables, context_lens):
        return attention_sinks_plain(*args, k_scale=k_scale, v_scale=v_scale)
    out = paged_decode(*args, k_scale, v_scale)
    attention_sinks.launches += 1
    return out


@counted
def attention_sinks_packed(query, k_packed, v_packed, sinks, block_tables, context_lens, scale,
                           sliding_window_size: int, q_head_num: int, k_head_num: int, *,
                           k_scale=None, v_scale=None, impl: str = "flat"):
    """:func:`attention_sinks` over the packed cache (:func:`pack_kv_sinks`
    layout; K12b ``impl="blockspec"``, K12c ``impl="flat"``, JAX's default).
    Both ``impl`` values are TPU schedules of one function and launch the
    same CUDA kernel, which reads each kv head's half row by strides; int8
    scales are per original kv head.  CPU tensors take
    :func:`attention_sinks_plain` with ``packed``."""
    if impl not in ("flat", "blockspec"):
        raise ValueError(f"impl must be 'flat' or 'blockspec', got {impl!r}")
    args = (query, k_packed, v_packed, sinks, block_tables, context_lens, scale,
            sliding_window_size, q_head_num, k_head_num, k_scale, v_scale, 2)
    if not on_cuda(query, k_packed, v_packed, sinks, block_tables, context_lens):
        return paged_decode_plain(*args)
    out = paged_decode(*args)
    attention_sinks_packed.launches += 1
    return out


# ---------------------------------------------------------------------------
# prefill (K12d)
# ---------------------------------------------------------------------------

def attention_sinks_prefill(query, k_cache, v_cache, sinks, seq_lens, block_tables,
                            context_lens, scale, sliding_window_size: int, q_head_num: int,
                            k_head_num: int, k_scale=None, v_scale=None):
    """Golden varlen prefill with sinks (f32 math; int8 levels dequantized
    after the gather): query rows are each request's last ``seq_lens[b]``
    positions, packed; token j of request b attends causally to positions
    ``<= context_len - seq_len + j`` (window applies).  Rows past the
    requests attend as the last request's."""
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
    if k_cache.dtype == torch.int8:
        k = k * _kv_head_scale(k_scale, k_head_num, k.device)[None]
    if v_cache.dtype == torch.int8:
        v = v * _kv_head_scale(v_scale, k_head_num, v.device)[None]
    logits = torch.einsum("skgd,skld->skgl", q, k) * scale
    pos = torch.arange(max_len, device=query.device)[None, None, None, :]
    hi = (qpos + 1)[:, None, None, None]
    mask = pos < hi
    if sliding_window_size > 0:
        mask &= pos >= hi - sliding_window_size
    p = softmax_with_sink(torch.where(mask, logits, NEG_INF), sinks, k_head_num, group)
    out = torch.einsum("skgl,skld->skgd", p, v)
    return out.reshape(s, q_head_num * dv).to(query.dtype)


def attention_sinks_prefill_plain(query, k_cache, v_cache, sinks, seq_lens, block_tables,
                                  context_lens, scale, sliding_window_size: int,
                                  q_head_num: int, k_head_num: int, *,
                                  max_q: int | None = None, k_scale=None, v_scale=None,
                                  packed: bool = False):
    """Plain version of :func:`attention_sinks_prefill_pallas` (f32 math, one
    request at a time over the keys it can see, the int8 scales folded as
    the wrapper folds them): the golden's function, and rows past the
    requests (the engine's pad rows) exactly 0, as the JAX kernel leaves
    them.  ``max_q`` shapes only the kernel's grid."""
    s = query.shape[0]
    d = query.shape[-1] // q_head_num
    group = q_head_num // k_head_num
    hpr = _hpr(packed)
    int8 = k_cache.dtype == torch.int8
    max_len = block_tables.shape[1] * k_cache.shape[2]
    out = query.new_zeros((s, k_head_num, group, v_cache.shape[-1] // hpr))
    start = 0
    for b, (sl, cl) in enumerate(zip(seq_lens.tolist(), context_lens.tolist())):
        rows = min(sl, s - start)
        if rows <= 0:
            continue
        n_keys = min(cl, max_len)
        bt = block_tables[b : b + 1]
        k = _gather_pages(k_cache, bt, n_keys, hpr)[0].float()               # [Hkv, L, D]
        v = _gather_pages(v_cache, bt, n_keys, hpr)[0].float()
        q = query[start : start + rows].reshape(rows, k_head_num, group, d)
        if int8:
            q = scale_heads(q, k_scale, k_head_num)
        logits = torch.einsum("tkgd,kld->tkgl", q.float(), k) * scale
        qpos = cl - sl + torch.arange(rows, device=query.device)[:, None]
        kpos = torch.arange(n_keys, device=query.device)[None, :]
        mask = kpos <= qpos
        if sliding_window_size > 0:
            mask &= kpos > qpos - sliding_window_size
        p = softmax_with_sink(torch.where(mask[:, None, None, :], logits, NEG_INF), sinks,
                              k_head_num, group)
        out[start : start + rows] = torch.einsum("tkgl,kld->tkgd", p, v).to(query.dtype)
        start += sl
    if v_cache.dtype == torch.int8:
        out = scale_heads(out, v_scale, k_head_num)
    return out.reshape(s, -1)


PREFILL_ROWS, PREFILL_KEYS = 64, 64   # the prefill kernel's flat rows a block, keys a chunk
LOG2E = 1.4426950408889634


def attention_sinks_prefill_tiled_plain(query, k_cache, v_cache, sinks, seq_lens, block_tables,
                                        context_lens, scale, sliding_window_size: int,
                                        q_head_num: int, k_head_num: int, *, k_scale=None,
                                        v_scale=None, packed: bool = False):
    """The walk of the CUDA K12d on the CPU, for tests (no caller on the main
    path): :func:`attention_sinks_prefill_plain`'s function, arguments and
    pad rows (exactly 0).

    Per request and kv head, blocks of ``PREFILL_ROWS`` flat rows ``f = j G
    + h`` (token j, head h of the group; a block's rows span tokens at G <
    64, a token's heads span blocks at G > 64) walk ``PREFILL_KEYS``-key
    chunks aligned to ``PREFILL_KEYS``, from the chunk that holds the block's
    first row's window start to the one that holds its last live row's
    causal end; each row masks keys outside its own (qpos - window, qpos].
    The scores are f32 products scaled by ``scale · log2 e`` (one f32
    factor; the kernel fuses the product with the running max's subtraction
    in one FMA, one rounding fewer), the online softmax is base 2 (masked
    keys weigh 0), P is rounded to the query's dtype at the running max for
    the PV product while the denominator sums the unrounded P; the sink (times
    log2 e) joins the denominator at the end, out = acc · e / denom rounded
    once.  An int8 cache: q is folded as bf16(f32(q) k_scale) and the output
    as bf16(f32(out) v_scale), the kernel's two roundings."""
    s = query.shape[0]
    d = query.shape[-1] // q_head_num
    group = q_head_num // k_head_num
    hkv, hpr = k_head_num, _hpr(packed)
    dt, dev = query.dtype, query.device
    max_len = block_tables.shape[1] * k_cache.shape[2]
    scale2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    out = query.new_zeros((s, hkv, group, d))
    start = 0
    for b, (sl, cl) in enumerate(zip(seq_lens.tolist(), context_lens.tolist())):
        rows = min(sl, s - start)
        if rows <= 0:
            continue
        n = sl * group
        blocks = -(-n // PREFILL_ROWS)
        pos0 = cl - sl
        q = query[start : start + rows].reshape(rows, hkv, group, d)
        if k_cache.dtype == torch.int8:
            q = scale_heads(q, k_scale, hkv)
        q = q.float().permute(1, 0, 2, 3).reshape(hkv, rows * group, d)
        q = torch.nn.functional.pad(q, (0, 0, 0, blocks * PREFILL_ROWS - rows * group))
        q = q.reshape(hkv, blocks, PREFILL_ROWS, d)
        f = torch.arange(blocks * PREFILL_ROWS, device=dev).reshape(blocks, PREFILL_ROWS)
        live, qpos = f // group < sl, pos0 + f // group
        first = torch.arange(blocks, device=dev) * PREFILL_ROWS
        k_lo = (torch.clamp_min(pos0 + first // group - sliding_window_size + 1, 0)
                if sliding_window_size > 0 else torch.zeros_like(first))
        k_hi = torch.clamp_max(pos0 + torch.clamp_max((first + PREFILL_ROWS - 1) // group, sl - 1)
                               + 1, max_len)
        c_begin = k_lo // PREFILL_KEYS * PREFILL_KEYS
        span = -(-int(k_hi.max()) // PREFILL_KEYS) * PREFILL_KEYS
        bt = block_tables[b : b + 1]
        k = _gather_pages(k_cache, bt, min(cl, max_len), hpr)[0].float()      # [Hkv, L, D]
        v = _gather_pages(v_cache, bt, min(cl, max_len), hpr)[0].float()
        k = torch.nn.functional.pad(k, (0, 0, 0, max(span - k.shape[1], 0)))
        v = torch.nn.functional.pad(v, (0, 0, 0, max(span - v.shape[1], 0)))
        m = torch.full((hkv, blocks, PREFILL_ROWS), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((hkv, blocks, PREFILL_ROWS, d), dtype=torch.float32, device=dev)
        for c0 in range(int(c_begin.min()), span, PREFILL_KEYS):
            kpos = torch.arange(c0, c0 + PREFILL_KEYS, device=dev)
            walk = (c_begin <= c0) & (c0 < k_hi)                            # [blocks]
            ok = (live[..., None] & (kpos <= qpos[..., None])
                  & (kpos < k_hi[:, None, None]))                           # [blocks, rows, keys]
            if sliding_window_size > 0:
                ok &= kpos > qpos[..., None] - sliding_window_size
            sc = torch.einsum("hnrd,hcd->hnrc", q, k[:, c0 : c0 + PREFILL_KEYS])
            sc = torch.where(ok, sc * scale2, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.where(ok, torch.exp2(sc - m_new[..., None]), 0.0)
            pv = torch.einsum("hnrc,hcd->hnrd", p.to(dt).float(), v[:, c0 : c0 + PREFILL_KEYS])
            w = walk[None, :, None]
            l = torch.where(w, l * alpha + p.sum(dim=-1), l)
            acc = torch.where(w[..., None], acc * alpha[..., None] + pv, acc)
            m = torch.where(w, m_new, m)
        e = torch.ones_like(m)
        if sinks is None:
            denom = torch.clamp_min(l, 1e-30)
        else:
            heads = torch.arange(hkv, device=dev)[:, None, None] * group + f % group
            sink = sinks.float()[heads] * torch.tensor(LOG2E, dtype=torch.float32)
            m_fin = torch.maximum(m, sink)
            e = torch.exp2(m - m_fin)
            denom = torch.clamp_min(l * e + torch.exp2(sink - m_fin), 1e-30)
        o = (acc * e[..., None] / denom[..., None]).to(dt)
        o = o.reshape(hkv, blocks * PREFILL_ROWS, d)[:, : rows * group]
        out[start : start + rows] = o.reshape(hkv, rows, group, d).permute(1, 0, 2, 3)
        start += sl
    if v_cache.dtype == torch.int8:
        out = scale_heads(out, v_scale, hkv)
    return out.reshape(s, -1)


@counted
def attention_sinks_prefill_pallas(query, k_cache, v_cache, sinks, seq_lens, block_tables,
                                   context_lens, scale, sliding_window_size: int,
                                   q_head_num: int, k_head_num: int, *,
                                   max_q: int | None = None, k_scale=None, v_scale=None,
                                   packed: bool = False):
    """Varlen causal prefill with sinks (``sinks=None``: none) and sliding
    window over the paged cache (``packed``: the :func:`pack_kv_sinks`
    layout): query ``[S, Hq * D]`` packed by request → ``[S, Hq * D]``, rows
    past the requests 0.  ``max_q`` bounds every request's new-token count
    (defaults to ``S``).  CUDA tensors launch ``csrc/sinks_attention.cu``
    (bf16 or int8 caches, D in ``KERNEL_HEAD_DIMS``, int8 in
    ``INT8_HEAD_DIMS``, at most 128 q heads a
    kv head, caches 16-byte aligned): one launch, which reads the packed
    rows directly, folds an int8 cache's scales into q and the output itself
    (a Python scalar by value), reads the sinks as stored (f32 or bf16) and
    zeroes the rows past the requests; CPU tensors take
    :func:`attention_sinks_prefill_plain`."""
    args = (query, k_cache, v_cache, seq_lens, block_tables, context_lens)
    if not on_cuda(*args, *(() if sinks is None else (sinks,))):
        return attention_sinks_prefill_plain(
            query, k_cache, v_cache, sinks, seq_lens, block_tables, context_lens, scale,
            sliding_window_size, q_head_num, k_head_num, k_scale=k_scale, v_scale=v_scale,
            packed=packed)
    hpr = _hpr(packed)
    d, group = check_paged_operands(query, k_cache, v_cache, q_head_num, k_head_num, hpr,
                                    PREFILL_MAX_GROUP)
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("the prefill kernel reads the caches by TMA boxes and 16-byte copies: "
                         "they must start 16-byte aligned")
    s = query.shape[0]
    int8 = k_cache.dtype == torch.int8
    q = query.contiguous()
    dev = q.device
    sl = seq_lens.to(torch.int32).contiguous()
    ctx = context_lens.to(torch.int32).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    sk = sinks
    if sk is not None:
        if sk.numel() != q_head_num:
            raise ValueError(f"sinks: one logit a q head ({q_head_num}), got {sk.numel()}")
        sk = (sk if sk.dtype in (torch.float32, torch.bfloat16) else sk.float()).contiguous()
    ks, ks_val, ks_step = _scale_arg(k_scale if int8 else None, k_head_num, dev)
    vs, vs_val, vs_step = _scale_arg(v_scale if int8 else None, k_head_num, dev)
    out = torch.empty((s, q_head_num * d), dtype=torch.bfloat16, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.sinks_prefill_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(sk),
        int(sk is not None and sk.dtype == torch.bfloat16), ptr(ks), ks_val, ks_step, ptr(vs),
        vs_val, vs_step, bt.data_ptr(), sl.data_ptr(), ctx.data_ptr(), out.data_ptr(), s,
        sl.shape[0], k_head_num, hpr, group, d, int(int8), k_cache.shape[2], bt.shape[1],
        k_cache.shape[0], int(sliding_window_size), int(max_q or s), float(scale),
        cuda_lib.stream_ptr(q)), "attention_sinks_prefill_pallas")
    attention_sinks_prefill_pallas.launches += 1
    return out


def attention_sinks_prefill_packed(query, k_packed, v_packed, sinks, seq_lens, block_tables,
                                   context_lens, scale, sliding_window_size: int,
                                   q_head_num: int, k_head_num: int, k_scale=None,
                                   v_scale=None, *, max_q: int | None = None):
    """Varlen prefill over the packed cache: K12d
    (:func:`attention_sinks_prefill_pallas` with ``packed``, counted there),
    as JAX runs its prefill kernel there.  JAX zero-interleaves the queries
    to fill the TPU's lanes; the CUDA kernel reads each kv head's half row
    by strides instead."""
    return attention_sinks_prefill_pallas(
        query, k_packed, v_packed, sinks, seq_lens, block_tables, context_lens, scale,
        sliding_window_size, q_head_num, k_head_num, max_q=max_q, k_scale=k_scale,
        v_scale=v_scale, packed=True)


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
