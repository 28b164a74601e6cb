"""Paged decode attention: MLA (K2) and GQA (K11a / K11b), plain versions and
the Hopper kernels.

Counterpart of ``sgl_kernel_npu_tpu/ops/attention/decode_attention.py``
(``decode_mla_ref``, ``decode_mla``, ``decode_gqa_ref``, ``decode_gqa``,
``decode_gqa_high_performance``).  MLA: q ``[B, Hq, 512 + 64]`` (nope ‖
rope), latent cache ``[pages, 1, page, 512]``, rope cache transposed
``[pages, 1, 64, page]``; V aliases K_nope; the CUDA kernel is
``csrc/decode_mla.cu``.  The latent cache is bf16 or int8: the
``int8_nzcache`` levels ``round(k / k_scale)``, where the plain version
dequantizes and the kernel folds ``k_scale`` into q_nope and the output
itself, with the two roundings of the JAX wrapper's fold (one launch a
call).  The kernel splits each row's keys across blocks and merges the
splits (:func:`mla_split_size`; its algorithm on the CPU:
:func:`decode_mla_split_plain`).

GQA: q ``[B, Hq, D]``, caches ``[pages, Hkv, page, D]`` bf16, f32 or int8
(levels ``round(x / scale)``, a scalar or per-kv-head scale) → ``[B, Hq,
D]``.  Its CUDA kernel is the decode kernel of ``csrc/sinks_attention.cu``
without a sink (:func:`paged_decode`, shared with the sinks attention of
``sinks_attention.py``), bf16 or int8 caches only.  Its goldens dequantize
the gathered keys, as JAX's do; its plain version
(:func:`paged_decode_plain`) takes the wrapper's fold, so that kernel and
plain version differ only in the kernel's arithmetic.

DeepSeek-V3.2's sparse decode (DSA) is glue around K2, as in JAX:
``decode_mla_block_sparse`` (page mode: the indexer's top pages, sorted, as a
pruned block table for K2) and ``decode_mla_sparse`` (token mode: a gather of
the selected latents and one masked softmax).
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import cdiv, on_cuda, round_up, top_k
from sgl_kernel_npu_tpu_torch.utils.counters import counted

NEG_INF = -1e30
D_NOPE, D_ROPE = 512, 64   # widths the CUDA kernels are built for
KERNEL_HEAD_DIMS = (32, 64, 128, 256)   # head widths of the GQA / sinks kernels
INT8_HEAD_DIMS = (32, 64, 128)          # of those, the widths built for int8 caches
# The decode kernel's splits (csrc/sinks_attention.cu): keys a split at least;
# splits a row at most (16: a long table's blocks then fit on the card at
# once; the kernel takes up to 32, one a lane of its merge); keys a staged
# chunk; q heads a block
DECODE_SPLIT, DECODE_MAX_SPLITS, DECODE_CHUNK, DECODE_HEADS = 256, 16, 64, 64
# K2's splits (csrc/decode_mla.cu): keys a split at least, a multiple of its
# 64-key chunk (an MLA key costs 128 heads x 1088 x 2 flops, far more than a
# GQA key, so the splits are shorter; at most DECODE_MAX_SPLITS a row); q
# heads a block
MLA_SPLIT, MLA_HEADS = 128, 64


def _gather_pages(buffer: torch.Tensor, block_table: torch.Tensor, max_len: int,
                  heads_per_row: int = 1) -> torch.Tensor:
    """``[pages, H / hpr, page, hpr * D]`` + ``[B, max_pages]`` → ``[B, H,
    max_len, D]``; ``heads_per_row`` 2 reads the packed layout
    (``sinks_attention.pack_kv_sinks``: heads 2j and 2j + 1 side by side)."""
    _, rows, page_size, width = buffer.shape
    d = width // heads_per_row
    n_pages = cdiv(max_len, page_size)
    pages = buffer[block_table[:, :n_pages].long()]            # [B, n, H / hpr, page, hpr * D]
    b = pages.shape[0]
    pages = pages.reshape(b, n_pages, rows, page_size, heads_per_row, d).permute(0, 2, 4, 1, 3, 5)
    return pages.reshape(b, rows * heads_per_row, n_pages * page_size, d)[:, :, :max_len]


def int8_scale(k_nope_buffer: torch.Tensor, k_scale):
    """The dequant scale of an int8 latent cache (1 when not given), None for
    a float cache."""
    if k_nope_buffer.dtype != torch.int8:
        return None
    return 1.0 if k_scale is None else k_scale


def dequant_latent(k_nope: torch.Tensor, ks) -> torch.Tensor:
    """Gathered latent rows → f32 (× ``ks`` for int8 levels, ``ks`` not None)."""
    return k_nope.float() if ks is None else k_nope.float() * ks


def fold_q_scale(q: torch.Tensor, ks) -> torch.Tensor:
    """q with ``ks`` folded into its nope part, cast back to q's dtype (JAX
    ``decode_attention.py:314-317``): scores see ``(q · ks) · k_level``.  One
    pass over q: the nope part times ``ks`` and the rope part times 1, in f32,
    rounded once to q's dtype."""
    scale = torch.ones(q.shape[-1], dtype=torch.float32, device=q.device)
    scale[:D_NOPE] = ks
    return torch.mul(q, scale, out=torch.empty_like(q))


def unfold_out_scale(out: torch.Tensor, ks) -> torch.Tensor:
    """The kernel's output over int8 levels × ``ks`` (V aliases K), in place:
    the f32 product rounded to out's dtype."""
    return out.mul_(ks)


def check_mla_operands(q, k_nope_buffer, k_rope_buffer) -> None:
    """What the CUDA MLA kernels take: bf16 q and rope cache, a bf16 or int8
    latent cache, 512 + 64 wide, one latent head, the transposed rope
    layout, contiguous caches."""
    page_size = k_nope_buffer.shape[2]
    if not (q.dtype == k_rope_buffer.dtype == torch.bfloat16
            and k_nope_buffer.dtype in (torch.bfloat16, torch.int8)):
        raise ValueError(f"the CUDA MLA kernels take bf16 q and rope cache and a bf16 or "
                         f"int8 latent cache, got {q.dtype}, {k_nope_buffer.dtype}, "
                         f"{k_rope_buffer.dtype}")
    if (q.shape[-1] != D_NOPE + D_ROPE or k_nope_buffer.shape[1] != 1
            or k_nope_buffer.shape[3] != D_NOPE
            or tuple(k_rope_buffer.shape[1:]) != (1, D_ROPE, page_size)):
        raise ValueError(f"MLA kernel shapes: q [.., 576], latent [P, 1, page, 512], "
                         f"rope [P, 1, 64, page]; got {tuple(q.shape)}, "
                         f"{tuple(k_nope_buffer.shape)}, {tuple(k_rope_buffer.shape)}")
    if not (k_nope_buffer.is_contiguous() and k_rope_buffer.is_contiguous()):
        raise ValueError("paged caches must be contiguous")


def mla_split_size(table_keys: int) -> int:
    """Keys a split of K2 over a block table of ``table_keys`` keys:
    ``MLA_SPLIT``, or more (a multiple of the 64-key chunk) where a row
    could otherwise need more than ``DECODE_MAX_SPLITS``.  From shapes
    alone (no host sync), so bf16 and int8 caches split alike."""
    return _split_size(table_keys, 0, MLA_SPLIT)


def decode_mla_ref(q, k_nope_buffer, k_rope_buffer, kv_seq_lens, sm_scale, block_table,
                   k_scale=None):
    """Plain paged MLA decode attention (f32 math).  ``kv_seq_lens`` count the
    keys each sequence sees; the whole block table is gathered.  An int8
    latent cache holds ``round(k / k_scale)`` levels."""
    d_nope = k_nope_buffer.shape[-1]
    max_len = block_table.shape[1] * k_nope_buffer.shape[2]
    q_nope, q_pe = q[..., :d_nope].float(), q[..., d_nope:].float()
    k_nope = dequant_latent(_gather_pages(k_nope_buffer, block_table, max_len)[:, 0],
                            int8_scale(k_nope_buffer, k_scale))                # [B, L, 512]
    k_rope = _gather_pages(k_rope_buffer.transpose(-1, -2), block_table,
                           max_len)[:, 0].float()                               # [B, L, 64]
    qk = torch.einsum("bhd,bld->bhl", q_nope, k_nope)
    qk = (qk + torch.einsum("bhd,bld->bhl", q_pe, k_rope)) * sm_scale
    pos = torch.arange(max_len, device=q.device)
    qk = torch.where(pos[None, None, :] < kv_seq_lens.to(q.device)[:, None, None], qk, NEG_INF)
    p = torch.softmax(qk, dim=-1)
    return torch.einsum("bhl,bld->bhd", p, k_nope).to(q.dtype)


def decode_mla_split_plain(q, k_nope_buffer, k_rope_buffer, kv_seq_lens, sm_scale, block_table,
                           *, k_scale=None, split: int):
    """K2's algorithm in plain PyTorch, for the tests: an int8 cache's
    ``k_scale`` folded into q_nope (:func:`fold_q_scale`: f32, rounded to
    q's dtype) and the levels read as they are; each row's keys in splits of
    ``split`` keys (:func:`split_plan`, window 0), per split its ``(m, l,
    o)`` with P rounded to q's dtype for P V (the kernel: bf16) and the
    denominator over the rounded P, the splits merged in split order; the
    output rounded, then the fold's ``× k_scale`` rounded again
    (:func:`unfold_out_scale`); a row of context 0 is 0.  The kernel's
    chunks and warpgroups within a split, its f32 sums in another order and
    its exponentials in base 2 differ from this at rounding level only."""
    ks = int8_scale(k_nope_buffer, k_scale)
    if ks is not None:
        q = fold_q_scale(q, ks)
    b, h, _ = q.shape
    table_keys = block_table.shape[1] * k_nope_buffer.shape[2]
    n_splits, _, hi, n_live = split_plan(kv_seq_lens.to(q.device), 0, table_keys, split)
    pos = torch.arange(n_splits * split, device=q.device)
    valid = (pos[None, :] < hi[:, None]).reshape(b, 1, n_splits, split)
    idx = pos.clamp(max=max(table_keys - 1, 0))
    kn = _gather_pages(k_nope_buffer, block_table, table_keys)[:, 0][:, idx].float()
    kr = _gather_pages(k_rope_buffer.transpose(-1, -2), block_table,
                       table_keys)[:, 0][:, idx].float()                   # [B, n split, 64]
    qk = torch.einsum("bhd,bld->bhl", q[..., :D_NOPE].float(), kn)
    qk = (qk + torch.einsum("bhd,bld->bhl", q[..., D_NOPE:].float(), kr)) * sm_scale
    qk = torch.where(valid, qk.reshape(b, h, n_splits, split), NEG_INF)
    m = qk.amax(-1)                                                        # [B, H, n]
    p = torch.where(valid, torch.exp(qk - m[..., None]), 0.0).to(q.dtype).float()
    l = p.sum(-1)
    o = torch.einsum("bhns,bnsd->bhnd", p, kn.reshape(b, n_splits, split, D_NOPE))
    w = torch.exp(m - m.amax(-1, keepdim=True))
    l_all = (l * w).sum(-1)
    o_all = (o * w[..., None]).sum(-2)
    out = (o_all / l_all.clamp(min=1e-30)[..., None]).to(q.dtype)
    out = torch.where((n_live > 0)[:, None, None], out, 0)
    return out if ks is None else unfold_out_scale(out, ks)


@counted
def decode_mla(q, k_nope_buffer, k_rope_buffer, kv_seq_lens, sm_scale, block_table, *,
               k_scale=None):
    """Paged MLA decode attention → ``[B, Hq, 512]``.

    CUDA tensors launch ``csrc/decode_mla.cu`` (one launch, no host sync:
    the split size comes from shapes, :func:`mla_split_size`, the merge's
    scratch is ``torch.empty`` and the int8 fold is inside); CPU tensors
    take :func:`decode_mla_ref`.  Pad rows (ctx 1, block table of zeros) are
    safe.  ``k_scale``: the dequant scale of an int8 latent cache
    (``ctkv_scale``), a number (a tensor is read to the host)."""
    if not on_cuda(q, k_nope_buffer, k_rope_buffer, kv_seq_lens, block_table):
        return decode_mla_ref(q, k_nope_buffer, k_rope_buffer, kv_seq_lens, sm_scale,
                              block_table, k_scale)
    check_mla_operands(q, k_nope_buffer, k_rope_buffer)
    ks = int8_scale(k_nope_buffer, k_scale)
    b, hq, _ = q.shape
    q = q.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k_nope_buffer, k_rope_buffer)):
        raise ValueError("decode_mla reads q and the caches 16 bytes at a time (TMA): they must "
                         "start 16-byte aligned")
    bt = block_table.to(torch.int32).contiguous()
    ctx = kv_seq_lens.to(torch.int32).contiguous()
    page = k_nope_buffer.shape[2]
    table_keys = bt.shape[1] * page
    split = mla_split_size(table_keys)
    n_splits = split_count(table_keys, 0, split)
    dev = q.device
    out = torch.empty((b, hq, D_NOPE), dtype=q.dtype, device=dev)
    part_o = part_ml = tickets = None
    if n_splits > 1:
        part_o = torch.empty(b * hq * n_splits * D_NOPE, dtype=torch.float32, device=dev)
        part_ml = torch.empty(b * hq * n_splits * 2, dtype=torch.float32, device=dev)
        tickets = _tickets(q, b * cdiv(hq, MLA_HEADS))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.decode_mla_launch(
        q.data_ptr(), k_nope_buffer.data_ptr(), k_rope_buffer.data_ptr(), bt.data_ptr(),
        ctx.data_ptr(), out.data_ptr(), ptr(part_o), ptr(part_ml), ptr(tickets), b, hq,
        bt.shape[1], page, k_nope_buffer.shape[0], split, n_splits, float(sm_scale),
        int(ks is not None), float(1.0 if ks is None else ks), cuda_lib.stream_ptr(q)),
        "decode_mla")
    decode_mla.launches += 1
    return out


# ---------------------------------------------------------------------------
# paged GQA decode (K11a, K11b), and the kernel it shares with sinks attention
# ---------------------------------------------------------------------------

def _kv_head_scale(scale, hkv: int, device) -> torch.Tensor:
    """An int8 cache's dequant scale (scalar, per-kv-head ``[Hkv]``, or None
    for 1) → ``[Hkv, 1, 1]`` f32 on ``device``."""
    s = torch.as_tensor(1.0 if scale is None else scale, dtype=torch.float32, device=device)
    return (s.reshape(-1, 1, 1) if s.dim() else s).expand(hkv, 1, 1)


def scale_heads(x: torch.Tensor, scale, hkv: int) -> torch.Tensor:
    """``x [N, Hkv, G, D]`` times an int8 cache's per-kv-head scale in f32,
    cast back to x's dtype: the fold of ``k_scale`` into q and of ``v_scale``
    into the output (JAX ``decode_attention.py:644-645``, ``:703-704``)."""
    return (x * _kv_head_scale(scale, hkv, x.device)).to(x.dtype)   # promotes to f32


def softmax_with_sink(logits: torch.Tensor, sinks, hkv: int, group: int) -> torch.Tensor:
    """Softmax over the last dim of ``logits [..., Hkv, G, L]``, with head
    (k, g)'s sink logit as one more entry that is then dropped (``sinks``
    None: the plain softmax)."""
    if sinks is None:
        return torch.softmax(logits, dim=-1)
    sink = sinks.float().reshape(hkv, group)[..., None].expand(*logits.shape[:-1], 1)
    return torch.softmax(torch.cat([logits, sink], dim=-1), dim=-1)[..., :-1]


def decode_math(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, context_lens, scale,
                window: int, sinks) -> torch.Tensor:
    """f32 attention of ``q [S, Hkv, G, D]`` over gathered ``k`` / ``v [S,
    Hkv, L, D]``: row s sees positions ``[ctx - window, ctx)`` (all before
    ``ctx`` at window 0), with the sink logits when given → ``[S, Hkv, G,
    Dv]`` f32."""
    hkv, group = q.shape[1], q.shape[2]
    logits = torch.einsum("skgd,skld->skgl", q.float(), k.float()) * scale
    pos = torch.arange(k.shape[2], device=q.device)[None, None, None, :]
    ctx = context_lens.to(q.device).long()[:, None, None, None]
    mask = pos < ctx
    if window > 0:
        mask &= pos >= ctx - window
    p = softmax_with_sink(torch.where(mask, logits, NEG_INF), sinks, hkv, group)
    return torch.einsum("skgl,skld->skgd", p, v.float())


def check_paged_operands(query, k_cache, v_cache, q_head_num: int, k_head_num: int,
                         heads_per_row: int, max_group: int | None = None) -> tuple[int, int]:
    """What the CUDA kernels of ``csrc/sinks_attention.cu`` take → ``(head_dim,
    group)``: a bf16 query, bf16 or int8 caches alike in the layout of
    ``heads_per_row``, Dk = Dv in ``KERNEL_HEAD_DIMS`` (int8 caches in
    ``INT8_HEAD_DIMS``: no int8 instance is built at 256), contiguous
    caches."""
    d = query.shape[-1] // q_head_num
    group = q_head_num // k_head_num
    if query.dtype != torch.bfloat16 or k_cache.dtype != v_cache.dtype \
            or k_cache.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"the CUDA attention kernels take a bf16 query and bf16 or int8 caches "
                         f"alike, got {query.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    rows = k_head_num // heads_per_row
    if d not in KERNEL_HEAD_DIMS or group * k_head_num != q_head_num \
            or k_head_num % heads_per_row or k_cache.shape != v_cache.shape \
            or (k_cache.shape[1], k_cache.shape[3]) != (rows, heads_per_row * d) \
            or (max_group is not None and group > max_group):
        raise ValueError(f"attention kernel shapes: head_dim (Dk = Dv) in {KERNEL_HEAD_DIMS}, "
                         f"caches [P, {rows}, page, {heads_per_row * d}] alike"
                         + ("" if max_group is None else f", at most {max_group} q heads a kv head")
                         + f"; got query {tuple(query.shape)} with {q_head_num} heads, caches "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if k_cache.dtype == torch.int8 and d not in INT8_HEAD_DIMS:
        raise ValueError(f"the attention kernels take int8 caches at head_dim {INT8_HEAD_DIMS}, "
                         f"got {d}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("paged caches must be contiguous")
    return d, group


def paged_decode_ref(query, k_cache, v_cache, sinks, block_tables, context_lens, scale,
                     window: int, q_head_num: int, k_head_num: int, k_scale=None,
                     v_scale=None) -> torch.Tensor:
    """Golden of :func:`paged_decode` on the plain layout, as JAX's goldens:
    f32 math over the whole block table, int8 levels dequantized after the
    gather.  query ``[S, Hq * Dk]`` → ``[S, Hq * Dv]``."""
    s = query.shape[0]
    d = query.shape[-1] // q_head_num
    max_len = block_tables.shape[1] * k_cache.shape[2]
    k = _gather_pages(k_cache, block_tables, max_len).float()           # [S, Hkv, L, D]
    v = _gather_pages(v_cache, block_tables, max_len).float()
    if k_cache.dtype == torch.int8:
        k = k * _kv_head_scale(k_scale, k_head_num, k.device)[None]
    if v_cache.dtype == torch.int8:
        v = v * _kv_head_scale(v_scale, k_head_num, v.device)[None]
    q = query.reshape(s, k_head_num, q_head_num // k_head_num, d)
    out = decode_math(q, k, v, context_lens, scale, window, sinks)
    return out.reshape(s, -1).to(query.dtype)


def paged_decode_plain(query, k_cache, v_cache, sinks, block_tables, context_lens, scale,
                       window: int, q_head_num: int, k_head_num: int, k_scale=None, v_scale=None,
                       heads_per_row: int = 1) -> torch.Tensor:
    """Plain version of :func:`paged_decode` (f32 math over the whole block
    table), on the kernel's terms: an int8 cache's ``k_scale`` folded into q
    (cast back to q's dtype), the levels read as they are, then ``v_scale``
    folded into the output; a row that sees no key (ctx 0) is 0.  query
    ``[S, Hq * D]`` → ``[S, Hq * Dv]``."""
    s = query.shape[0]
    d = query.shape[-1] // q_head_num
    max_len = block_tables.shape[1] * k_cache.shape[2]
    q = query.reshape(s, k_head_num, q_head_num // k_head_num, d)
    if k_cache.dtype == torch.int8:
        q = scale_heads(q, k_scale, k_head_num)
    k = _gather_pages(k_cache, block_tables, max_len, heads_per_row)
    v = _gather_pages(v_cache, block_tables, max_len, heads_per_row)
    out = decode_math(q, k, v, context_lens, scale, window, sinks).to(query.dtype)
    lo, hi = visible_keys(context_lens.to(q.device), window, max_len)
    out = torch.where((lo < hi)[:, None, None, None], out, 0)
    if v_cache.dtype == torch.int8:
        out = scale_heads(out, v_scale, k_head_num)
    return out.reshape(s, -1)


def visible_keys(context_lens: torch.Tensor, window: int, table_keys: int):
    """Per decode row, the keys ``[lo, hi)`` it sees: from its window start
    (0 without a window) to its context, within the block table's
    ``table_keys`` (torch ops on ``context_lens``' device: no host sync)."""
    ctx = context_lens.long()
    lo = (ctx - window).clamp(min=0) if window > 0 else torch.zeros_like(ctx)
    return lo, ctx.clamp(max=table_keys)


def _most_keys(table_keys: int, window: int) -> int:
    return min(window, table_keys) if window > 0 else table_keys


def _split_size(table_keys: int, window: int, split: int) -> int:
    keys = _most_keys(table_keys, window)
    if cdiv(keys, split) <= DECODE_MAX_SPLITS:
        return split
    return round_up(cdiv(keys, DECODE_MAX_SPLITS), DECODE_CHUNK)


def decode_split_size(table_keys: int, window: int) -> int:
    """Keys a split of the decode kernel over a block table of
    ``table_keys`` keys: ``DECODE_SPLIT``, or more (a multiple of the chunk)
    where a row could otherwise need more than ``DECODE_MAX_SPLITS``.  From
    shapes alone, so bf16 and int8 caches split alike."""
    return _split_size(table_keys, window, DECODE_SPLIT)


def split_count(table_keys: int, window: int, split: int) -> int:
    """Splits of ``split`` keys that cover any row's keys: the grid's split
    dimension, from shapes alone."""
    return max(cdiv(_most_keys(table_keys, window), split), 1)


def split_plan(context_lens: torch.Tensor, window: int, table_keys: int, split: int):
    """The decode kernel's split plan → ``(n_splits, lo, hi, n_live)``:
    :func:`split_count`, then per row (:func:`visible_keys`, no host sync) its keys
    ``[lo, hi)`` and its live splits, split ``j`` covering ``[lo + j split,
    min(lo + (j + 1) split, hi))``."""
    n_splits = split_count(table_keys, window, split)
    lo, hi = visible_keys(context_lens, window, table_keys)
    n_live = torch.where(lo < hi, torch.div(hi - lo + split - 1, split, rounding_mode="floor"), 0)
    return n_splits, lo, hi, n_live


def paged_decode_split_plain(query, k_cache, v_cache, sinks, block_tables, context_lens, scale,
                             window: int, q_head_num: int, k_head_num: int, k_scale=None,
                             v_scale=None, heads_per_row: int = 1, *, split: int):
    """The decode kernel's algorithm in plain PyTorch, for the tests: each
    row's keys in splits of ``split`` (:func:`split_plan`), per split its
    ``(m, l, o)`` with P rounded to q's dtype for P V (the kernel: bf16) and
    the f32 P in l, the splits merged in split order, the sink logit joining
    the denominator at the merge, a row with no key 0, the int8 scales folded
    as the kernel folds them.  The kernel's warps and chunks within a split,
    its f32 sums in another order and its exponentials in base 2 differ from
    this at rounding level only."""
    s = query.shape[0]
    d = query.shape[-1] // q_head_num
    group = q_head_num // k_head_num
    table_keys = block_tables.shape[1] * k_cache.shape[2]
    n_splits, lo, hi, n_live = split_plan(context_lens.to(query.device), window, table_keys,
                                          split)
    q = query.reshape(s, k_head_num, group, d)
    if k_cache.dtype == torch.int8:
        q = scale_heads(q, k_scale, k_head_num)
    pos = lo[:, None] + torch.arange(n_splits * split, device=query.device)   # [S, n split]
    valid = (pos < hi[:, None]).reshape(s, 1, 1, n_splits, split)
    idx = pos.clamp(max=max(table_keys - 1, 0))[:, None, :, None].expand(-1, k_head_num, -1, d)
    k = torch.gather(_gather_pages(k_cache, block_tables, table_keys, heads_per_row), 2, idx)
    v = torch.gather(_gather_pages(v_cache, block_tables, table_keys, heads_per_row), 2, idx)
    logits = torch.einsum("skgd,skld->skgl", q.float(), k.float()) * scale
    logits = torch.where(valid, logits.reshape(s, k_head_num, group, n_splits, split), NEG_INF)
    m = logits.amax(-1)                                                      # [S, Hkv, G, n]
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    l = p.sum(-1)
    o = torch.einsum("skgnl,sknld->skgnd", p.to(q.dtype).float(),
                     v.float().reshape(s, k_head_num, n_splits, split, d))
    m_all = m.amax(-1)
    w = torch.exp(m - m_all[..., None])
    l_all = (l * w).sum(-1)
    o_all = (o * w[..., None]).sum(-2)
    if sinks is None:
        e, denom = torch.ones_like(l_all), l_all.clamp(min=1e-30)
    else:
        sink = sinks.float().reshape(k_head_num, group)
        m_fin = torch.maximum(m_all, sink)
        e = torch.exp(m_all - m_fin)
        denom = l_all * e + torch.exp(sink - m_fin)
    out = (o_all * e[..., None] / denom[..., None]).to(query.dtype)
    out = torch.where((n_live > 0)[:, None, None, None], out, 0)
    if v_cache.dtype == torch.int8:
        out = scale_heads(out, v_scale, k_head_num)
    return out.reshape(s, -1)


_TICKETS: dict = {}


def _tickets(q: torch.Tensor, n: int) -> torch.Tensor:
    """The decode kernels' split counters (GQA: a (row, kv head, 64 q
    heads); K2: a (row, 64 heads)) on q's device and stream: zero, and left
    zero by every launch (the merging block resets its own), so only a first
    use or a growth writes them."""
    key = (q.device, cuda_lib.stream_ptr(q))
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=q.device)
    return t


def _scale_arg(scale, hkv: int, device) -> tuple:
    """An int8 cache's scale as the decode kernel takes it: ``(f32 tensor or
    None, value, step)``, the tensor indexed kv head × step; a Python number
    goes by value (no copy to the card)."""
    if scale is None or isinstance(scale, (int, float)):
        return None, 1.0 if scale is None else float(scale), 0
    t = torch.as_tensor(scale).to(device=device, dtype=torch.float32).reshape(-1).contiguous()
    if t.numel() not in (1, hkv):
        raise ValueError(f"an int8 cache's scale is a scalar or one per kv head ({hkv}), got "
                         f"{t.numel()} values")
    return t, 1.0, int(t.numel() > 1)


def paged_decode(query, k_cache, v_cache, sinks, block_tables, context_lens, scale,
                 window: int, q_head_num: int, k_head_num: int, k_scale=None, v_scale=None,
                 heads_per_row: int = 1) -> torch.Tensor:
    """Launch the decode kernel of ``csrc/sinks_attention.cu`` on CUDA
    tensors: query ``[S, Hq * D]`` (one new token a row, ``context_lens``
    including it) over the paged caches (``heads_per_row`` 2: the packed
    layout), with the sink logits ``sinks [Hq]`` (f32 or bf16, read as
    stored) or none, a sliding ``window`` or none (0) → ``[S, Hq * D]`` bf16.
    One launch and no host sync: the kernel folds an int8 cache's scales
    into q and the output itself, and the split size comes from shapes
    (:func:`decode_split_size`); the merge's scratch is ``torch.empty``.
    Uncounted: each public wrapper counts its own launches."""
    d, group = check_paged_operands(query, k_cache, v_cache, q_head_num, k_head_num,
                                    heads_per_row)
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("the decode kernel reads the caches 16 bytes at a time: they must "
                         "start 16-byte aligned")
    s = query.shape[0]
    int8 = k_cache.dtype == torch.int8
    q = query.contiguous()
    dev = q.device
    bt = block_tables.to(torch.int32).contiguous()
    ctx = context_lens.to(torch.int32).contiguous()
    sk = sinks
    if sk is not None:
        if sk.numel() != q_head_num:
            raise ValueError(f"sinks: one logit a q head ({q_head_num}), got {sk.numel()}")
        sk = (sk if sk.dtype in (torch.float32, torch.bfloat16) else sk.float()).contiguous()
    ks, ks_val, ks_step = _scale_arg(k_scale if int8 else None, k_head_num, dev)
    vs, vs_val, vs_step = _scale_arg(v_scale if int8 else None, k_head_num, dev)
    table_keys = bt.shape[1] * k_cache.shape[2]
    split = decode_split_size(table_keys, window)
    n_splits = split_count(table_keys, window, split)
    out = torch.empty((s, q_head_num * d), dtype=torch.bfloat16, device=dev)
    part_o = part_ml = tickets = None
    if n_splits > 1:
        part_o = torch.empty(s * q_head_num * n_splits * d, dtype=torch.float32, device=dev)
        part_ml = torch.empty(s * q_head_num * n_splits * 2, dtype=torch.float32, device=dev)
        tickets = _tickets(q, s * k_head_num * cdiv(group, DECODE_HEADS))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.sinks_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(sk),
        int(sk is not None and sk.dtype == torch.bfloat16), ptr(ks), ks_val, ks_step, ptr(vs),
        vs_val, vs_step, bt.data_ptr(), ctx.data_ptr(), out.data_ptr(), ptr(part_o),
        ptr(part_ml), ptr(tickets), s, k_head_num, heads_per_row, group, d, int(int8),
        k_cache.shape[2], bt.shape[1], int(window), split, n_splits, float(scale),
        cuda_lib.stream_ptr(q)), "paged decode")
    return out


def decode_gqa_ref(q, k_buffer, v_buffer, kv_seq_lens, sm_scale, block_table, k_scale=None,
                   v_scale=None):
    """Golden paged GQA decode (:func:`paged_decode_ref`): ``q [B, Hq, Dk]``
    → ``[B, Hq, Dv]``."""
    b, hq, dk = q.shape
    out = paged_decode_ref(q.reshape(b, hq * dk), k_buffer, v_buffer, None, block_table,
                           kv_seq_lens, sm_scale, 0, hq, k_buffer.shape[1], k_scale, v_scale)
    return out.reshape(b, hq, -1)


def decode_gqa_plain(q, k_buffer, v_buffer, kv_seq_lens, sm_scale, block_table, *, k_scale=None,
                     v_scale=None):
    """Plain version of :func:`decode_gqa` (:func:`paged_decode_plain`: the
    wrapper's fold of the int8 scales)."""
    b, hq, dk = q.shape
    out = paged_decode_plain(q.reshape(b, hq * dk), k_buffer, v_buffer, None, block_table,
                             kv_seq_lens, sm_scale, 0, hq, k_buffer.shape[1], k_scale, v_scale)
    return out.reshape(b, hq, -1)


@counted
def decode_gqa(q, k_buffer, v_buffer, kv_seq_lens, sm_scale, block_table, *, k_scale=None,
               v_scale=None):
    """Paged GQA decode attention (K11a): ``q [B, Hq, D]`` over caches
    ``[pages, Hkv, page, D]`` → ``[B, Hq, D]``; ``kv_seq_lens`` count the
    keys each row sees.  Int8 caches hold ``round(x / scale)`` levels,
    ``k_scale`` / ``v_scale`` scalar or ``[Hkv]``.  CUDA tensors launch
    ``csrc/sinks_attention.cu``'s decode kernel without a sink (bf16 or int8
    caches, D in ``KERNEL_HEAD_DIMS``, int8 in ``INT8_HEAD_DIMS``, Dk = Dv;
    anything else raises); CPU
    tensors take :func:`decode_gqa_plain`.  Pad rows (ctx 1, block table of
    zeros) are safe."""
    if not on_cuda(q, k_buffer, v_buffer, kv_seq_lens, block_table):
        return decode_gqa_plain(q, k_buffer, v_buffer, kv_seq_lens, sm_scale, block_table,
                                k_scale=k_scale, v_scale=v_scale)
    b, hq, dk = q.shape
    out = paged_decode(q.reshape(b, hq * dk), k_buffer, v_buffer, None, block_table, kv_seq_lens,
                       sm_scale, 0, hq, k_buffer.shape[1], k_scale, v_scale)
    decode_gqa.launches += 1
    return out.reshape(b, hq, dk)


def decode_gqa_high_performance(q, k_buffer, v_buffer, kv_seq_lens, sm_scale, block_table, *,
                                k_scale=None, v_scale=None):
    """K11b: :func:`decode_gqa`'s function, which JAX computes as a flat page
    walk with a 4-deep DMA ring where the head dims are lane-aligned (K11a
    elsewhere).  Both are TPU schedules of one function: here it is
    :func:`decode_gqa`, and it counts there."""
    return decode_gqa(q, k_buffer, v_buffer, kv_seq_lens, sm_scale, block_table,
                      k_scale=k_scale, v_scale=v_scale)


# ---------------------------------------------------------------------------
# DSA sparse decode (glue around K2)
# ---------------------------------------------------------------------------

def select_decode_pages(token_scores, kv_seq_lens, page_size: int, num_sel_pages: int):
    """Page mode's choice for each decode row: the top ``num_sel_pages`` pages
    by the maximum indexer score of their valid tokens, the row's last
    (partial) page forced in, **sorted ascending** → ``[B, min(num_sel_pages,
    max_pages)]``.  Sorted, the full pages come first, then the partial page,
    then pages past the context (chosen only when fewer pages are valid), so
    K2 can walk the pruned table as if it were contiguous."""
    b, width = token_scores.shape
    max_pages = width // page_size
    sl = kv_seq_lens.to(token_scores.device).long()
    pos = torch.arange(width, device=token_scores.device).reshape(max_pages, page_size)
    valid = pos[None] < sl[:, None, None]
    ps = token_scores.reshape(b, max_pages, page_size).float()
    pscore = torch.where(valid, ps, float("-inf")).amax(dim=-1)
    last = torch.div(sl - 1, page_size, rounding_mode="floor")
    pscore = pscore.scatter(1, last[:, None], float("inf"))
    sel = top_k(pscore, min(num_sel_pages, max_pages))[1]
    return torch.sort(sel, dim=-1).values


def pruned_block_table(block_table, kv_seq_lens, sel_pages, page_size: int):
    """The block table of the selected pages and the keys K2 then walks: the
    valid tokens of the selected pages, summed."""
    bt_sel = torch.gather(block_table.long(), 1, sel_pages.long()).to(torch.int32)
    sl = kv_seq_lens.to(sel_pages.device).long()
    vp = torch.clamp(sl[:, None] - sel_pages.long() * page_size, 0, page_size)
    return bt_sel, vp.sum(dim=-1).to(torch.int32)


def decode_mla_block_sparse(q, k_nope_buffer, k_rope_buffer, kv_seq_lens, sm_scale,
                            block_table, token_scores, num_sel_pages: int, *, k_scale=None,
                            plain: bool = False):
    """Block-sparse MLA decode (DSA page mode): :func:`select_decode_pages`
    over ``token_scores [B, max_pages · page]`` (the indexer's), then K2
    :func:`decode_mla` (``plain``: :func:`decode_mla_ref`) over the pruned
    block table.  Softmax covers every valid token of every selected page."""
    page = k_nope_buffer.shape[2]
    sel = select_decode_pages(token_scores, kv_seq_lens, page, num_sel_pages)
    bt_sel, seq_sel = pruned_block_table(block_table, kv_seq_lens, sel, page)
    attend = decode_mla_ref if plain else decode_mla
    return attend(q, k_nope_buffer, k_rope_buffer, seq_sel, sm_scale, bt_sel, k_scale=k_scale)


def decode_mla_sparse(q, k_nope_buffer, k_rope_buffer, kv_seq_lens, sm_scale, block_table,
                      topk_index, k_scale=None):
    """Sparse MLA decode over token positions ``topk_index [B, K]`` (DSA token
    mode, -1 = pad): the selected latents gathered, one masked f32 softmax
    (``-1e30`` sentinel) → ``[B, Hq, 512]`` in q's dtype.  Glue, as in JAX."""
    page_size, d_nope = k_nope_buffer.shape[2], k_nope_buffer.shape[3]
    idx = topk_index.long()
    live = (idx >= 0) & (idx < kv_seq_lens.to(idx.device).long()[:, None])
    safe = torch.where(live, idx, 0)
    phys = torch.gather(block_table.long(), 1, torch.div(safe, page_size, rounding_mode="floor"))
    slot = safe % page_size
    kn = dequant_latent(k_nope_buffer[phys, 0, slot, :], int8_scale(k_nope_buffer, k_scale))
    kr = k_rope_buffer[phys, 0, :, slot].float()                        # [B, K, Lrope]
    qk = torch.einsum("bhd,bkd->bhk", q[..., :d_nope].float(), kn)
    qk = qk + torch.einsum("bhd,bkd->bhk", q[..., d_nope:].float(), kr)
    qk = torch.where(live[:, None, :], qk * sm_scale, NEG_INF)
    p = torch.softmax(qk, dim=-1)
    return torch.einsum("bhk,bkd->bhd", p, kn).to(q.dtype)
