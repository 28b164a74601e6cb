"""Varlen causal MLA prefill over the paged latent cache: plain versions and
the Hopper kernels (K9a dense, K9b block-sparse).

Counterpart of ``sgl_kernel_npu_tpu/ops/attention/mla_prefill.py``
(``mla_prefill_ref``, ``mla_prefill_pallas``, ``select_prefill_pages``,
``mla_prefill_block_sparse``; the names are kept so the counterparts are easy
to find, but the kernels are CUDA: ``csrc/mla_prefill.cu``).  Absorbed
queries q ``[S, H, 512 + 64]``, packed by request, attend to the latent
cache; token j of request b sees cache positions ``<= context_len - seq_len
+ j``.  Rows past the request lengths are zeros.  The latent cache is bf16 or
int8 (``k_scale``), as in ``decode_attention``.

The block-sparse variant (DeepSeek-V3.2 DSA, page mode) restricts each
q-chunk of up to 64 tokens to the pages the lightning indexer selected for
it.  Its masked scores follow the JAX kernel's ``-1e30`` convention: a row
with no live key among its chunk's pages gets the mean of the latents of
those pages (ROADMAP §C).
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.attention.decode_attention import (
    D_NOPE,
    NEG_INF,
    _gather_pages,
    check_mla_operands,
    dequant_latent,
    fold_q_scale,
    int8_scale,
    unfold_out_scale,
)
from sgl_kernel_npu_tpu_torch.ops.attention.mla_train import LOG2E
from sgl_kernel_npu_tpu_torch.ops.attention.sinks_attention import (
    _prefill_page_bounds,
    prefill_q_chunk,
)
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import cdiv, on_cuda, top_k
from sgl_kernel_npu_tpu_torch.utils.counters import counted


def mla_prefill_ref(q, k_nope_buffer, k_rope_buffer, seq_lens, block_tables, context_lens,
                    sm_scale, k_scale=None):
    """Plain varlen causal MLA prefill (f32 math), one request at a time over
    the pages its queries can see.  An int8 latent cache holds
    ``round(k / k_scale)`` levels."""
    s, h, _ = q.shape
    page_size, dn = k_nope_buffer.shape[2], k_nope_buffer.shape[3]
    max_pages = block_tables.shape[1]
    ks = int8_scale(k_nope_buffer, k_scale)
    out = q.new_zeros((s, h, dn))
    start = 0
    for b, (sl, cl) in enumerate(zip(seq_lens.tolist(), context_lens.tolist())):
        if sl == 0:
            continue
        _, hi = _prefill_page_bounds(sl, cl, 0, cq=sl, window=0, page_size=page_size,
                                     max_pages=max_pages)
        n_keys = (hi + 1) * page_size
        bt = block_tables[b : b + 1]
        kn = dequant_latent(_gather_pages(k_nope_buffer, bt, n_keys)[0, 0], ks)      # [L, 512]
        kr = _gather_pages(k_rope_buffer.transpose(-1, -2), bt, n_keys)[0, 0].float()
        qb = q[start : start + sl].float()
        qk = torch.einsum("shd,ld->shl", qb[..., :dn], kn)
        qk = (qk + torch.einsum("shd,ld->shl", qb[..., dn:], kr)) * sm_scale
        qpos = cl - sl + torch.arange(sl, device=q.device)
        mask = torch.arange(n_keys, device=q.device)[None, None, :] <= qpos[:, None, None]
        p = torch.softmax(torch.where(mask, qk, NEG_INF), dim=-1)
        out[start : start + sl] = torch.einsum("shl,ld->shd", p, kn).to(q.dtype)
        start += sl
    return out


SPARSE_ROWS = 64   # query rows (tokens x heads) a K9a / K9b block, csrc/mla_sparse.cuh
SPARSE_KEYS = 64   # keys a staged chunk of that block


def _check_aligned(what: str, *tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the kernel copies 16-byte pieces: q and the caches must "
                         "start 16-byte aligned")


@counted
def mla_prefill_pallas(q, k_nope_buffer, k_rope_buffer, seq_lens, block_tables,
                       context_lens, sm_scale, *, max_q: int | None = None, k_scale=None):
    """Varlen paged MLA prefill: q ``[S, H, 576]`` → ``[S, H, 512]``.

    ``max_q`` bounds every request's new-token count (defaults to ``S``);
    ``k_scale`` is the dequant scale of an int8 latent cache.  CUDA tensors
    launch ``csrc/mla_prefill.cu`` (blocks of :func:`sparse_tiling`'s rows
    with one chunk of ``max_q`` tokens; :func:`mla_prefill_tiled_plain` is
    its walk on the CPU); CPU tensors take :func:`mla_prefill_ref`."""
    if not on_cuda(q, k_nope_buffer, k_rope_buffer, seq_lens, block_tables, context_lens):
        return mla_prefill_ref(q, k_nope_buffer, k_rope_buffer, seq_lens, block_tables,
                               context_lens, sm_scale, k_scale)
    check_mla_operands(q, k_nope_buffer, k_rope_buffer)
    ks = int8_scale(k_nope_buffer, k_scale)
    s, h, _ = q.shape
    bsz = seq_lens.shape[0]
    q = (q if ks is None else fold_q_scale(q, ks)).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    starts = (torch.cumsum(sl, 0, dtype=torch.int32) - sl).contiguous()
    ctx = context_lens.to(torch.int32).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    _check_aligned("mla_prefill", q, k_nope_buffer, k_rope_buffer)
    out = torch.zeros((s, h, D_NOPE), dtype=q.dtype, device=q.device)
    max_q = int(max_q or s)
    tq, hb, _ = sparse_tiling(h, max_q)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.mla_prefill_launch(
        q.data_ptr(), k_nope_buffer.data_ptr(), k_rope_buffer.data_ptr(), bt.data_ptr(),
        sl.data_ptr(), ctx.data_ptr(), starts.data_ptr(), out.data_ptr(), bsz, h,
        bt.shape[1], k_nope_buffer.shape[2], k_nope_buffer.shape[0], max_q, tq, hb,
        float(sm_scale), int(ks is not None), cuda_lib.stream_ptr(q)), "mla_prefill")
    mla_prefill_pallas.launches += 1
    return out if ks is None else unfold_out_scale(out, ks)


def mla_prefill_tiled_plain(q, k_nope_buffer, k_rope_buffer, seq_lens, block_tables,
                            context_lens, sm_scale, *, max_q: int | None = None, k_scale=None):
    """The walk of the CUDA K9a on the CPU, for tests (any widths; no caller
    on the main path) → :func:`mla_prefill_pallas`'s output.

    Per request, blocks of :func:`sparse_tiling`'s ``tq`` tokens x ``hb``
    heads (one chunk of ``max_q`` tokens) walk ``SPARSE_KEYS``-key chunks of
    positions from 0 up to the causal end of their last live token, each row
    masking keys past its own (masked keys weigh 0).  An int8 latent is read
    as levels with ``k_scale`` folded into q and unfolded from the output
    (``fold_q_scale`` / ``unfold_out_scale``, the wrapper's).  The scores are
    f32 products scaled by ``sm_scale · log2 e`` (rounded to f32 once, as the
    kernel folds it), the online softmax is base 2, P is rounded to the
    latent's dtype (bf16 for int8 levels) for the PV product and for the
    denominator, and ``out = acc / l`` is rounded once; rows past the
    requests are zeros."""
    s, h, _ = q.shape
    dn = k_nope_buffer.shape[3]
    tq, hb, _ = sparse_tiling(h, int(max_q or s))
    ks = int8_scale(k_nope_buffer, k_scale)
    qf = q if ks is None else fold_q_scale(q, ks)
    p_dtype = torch.bfloat16 if ks is not None else k_nope_buffer.dtype
    scale2 = torch.tensor(sm_scale, dtype=torch.float32) * torch.tensor(LOG2E,
                                                                       dtype=torch.float32)
    dev = q.device
    out = q.new_zeros((s, h, dn))
    r = torch.arange(SPARSE_ROWS, device=dev)
    start = 0
    for b, (sl, cl) in enumerate(zip(seq_lens.tolist(), context_lens.tolist())):
        if sl == 0:
            continue
        # blocks [token tile, head tile] of 64 rows: token t tq + r / hb, head h0 + r % hb
        tiles = torch.arange(cdiv(sl, tq), device=dev)[:, None, None]
        heads0 = torch.arange(cdiv(h, hb), device=dev)[None, :, None] * hb
        tok, head = torch.broadcast_tensors(tiles * tq + r // hb, heads0 + r % hb)
        live = (r < tq * hb) & (tok < sl) & (head < h)
        qpos = cl - sl + tok
        rows = qf[start + tok.clamp(max=sl - 1), head.clamp(max=h - 1)].float()
        rows = torch.where(live[..., None], rows, 0.0)                    # [T, HT, 64, 576]
        kend = cl - sl + torch.clamp_max(tiles[..., 0] * tq + tq, sl)     # [T, 1]
        bt = block_tables[b : b + 1]
        kn = _gather_pages(k_nope_buffer, bt, cl)[0, 0].float()               # levels for int8
        kr = _gather_pages(k_rope_buffer.transpose(-1, -2), bt, cl)[0, 0].float()
        keys = torch.cat([kn, kr], dim=-1)
        m = torch.full(live.shape, NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((*live.shape, dn), dtype=torch.float32, device=dev)
        for k0 in range(0, cl, SPARSE_KEYS):
            kpos = torch.arange(k0, min(k0 + SPARSE_KEYS, cl), device=dev)
            sc = torch.einsum("thrd,cd->thrc", rows, keys[kpos]) * scale2
            ok = live[..., None] & (kpos <= qpos[..., None]) & (kpos < kend[..., None, None])
            sc = torch.where(ok, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.where(ok, torch.exp2(sc - m_new[..., None]), 0.0).to(p_dtype).float()
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("thrc,cd->thrd", p, kn[kpos])
            m = m_new
        o = (acc / torch.where(l > 0, l, 1.0)[..., None]).to(q.dtype)
        out[start + tok[live], head[live]] = o[live]
        start += sl
    return out if ks is None else unfold_out_scale(out, ks)


# ---------------------------------------------------------------------------
# DSA block-sparse prefill: the indexer's pages per q-chunk
# ---------------------------------------------------------------------------

MAX_SEL = 256   # selected pages a chunk can name in the CUDA kernel


def sparse_tiling(heads: int, cq: int) -> tuple[int, int, int]:
    """The block tiling of K9a and K9b: ``(tq, hb, tiles)``, a block holding
    ``tq`` tokens x ``hb`` heads (at most ``SPARSE_ROWS`` rows), ``tiles``
    token tiles a q-chunk of ``cq`` tokens (K9a: one chunk of ``max_q``).
    All heads when fewer than 64 (8 tokens x 8 heads at H = 8), else one
    token x 64 heads; a K9b block never holds tokens of two chunks, whose
    pages differ."""
    hb = min(heads, SPARSE_ROWS)
    tq = max(1, min(SPARSE_ROWS // hb, cq))
    return tq, hb, cdiv(cq, tq)


def select_prefill_pages(page_scores, seq_lens, context_lens, *, cq: int, page_size: int,
                         num_sel: int):
    """The top ``num_sel`` pages of each (request, q-chunk of ``cq`` tokens)
    from per-token page scores ``[B, max_q, max_pages]`` (``-inf`` where a
    token sees none of a page): a chunk's score of a page is its tokens'
    maximum; the chunk's last causal page is forced in (3e38).  Returns
    ``pos_sel [B, ceil(max_q / cq), num_sel]`` int32, pages in score order,
    ``-1`` for a slot whose score is not above ``-1e30`` (dead chunks, pages
    no token of the chunk sees)."""
    b, max_q, max_pages = page_scores.shape
    qcn = cdiv(max_q, cq)
    dev = page_scores.device
    if max_q % cq:
        page_scores = torch.nn.functional.pad(page_scores, (0, 0, 0, qcn * cq - max_q),
                                              value=NEG_INF)
    cs = page_scores.reshape(b, qcn, cq, max_pages).amax(dim=2)          # [B, QC, pages]
    qc_idx = torch.arange(qcn, device=dev)[None, :]
    sl = seq_lens.to(dev).long()[:, None]
    ctx = context_lens.to(dev).long()[:, None]
    live_chunk = qc_idx * cq < sl
    qhi = torch.minimum((qc_idx + 1) * cq, sl) - 1
    hi_page = torch.clamp(torch.div(ctx - sl + qhi, page_size, rounding_mode="floor"),
                          0, max_pages - 1)
    forced = torch.where(live_chunk, torch.tensor(3e38, device=dev),
                         torch.tensor(NEG_INF, device=dev)).to(cs.dtype)
    cs = cs.scatter(2, hi_page[..., None], forced[..., None])
    vals, pos = top_k(cs, num_sel)
    return torch.where(vals > NEG_INF, pos, -1).to(torch.int32)


def _check_pos_sel(pos_sel, max_q: int, cq: int) -> None:
    """pos_sel's chunks must be the kernels' (JAX asserts the same)."""
    if pos_sel.shape[1] != cdiv(max_q, cq):
        raise ValueError(f"pos_sel has {pos_sel.shape[1]} chunks; max_q {max_q} in chunks of "
                         f"{cq} makes {cdiv(max_q, cq)}")


def mla_prefill_block_sparse_ref(q, k_nope_buffer, k_rope_buffer, seq_lens, block_tables,
                                 context_lens, sm_scale, pos_sel, *, max_q: int | None = None,
                                 q_chunk: int = 64, k_scale=None):
    """Plain version of :func:`mla_prefill_block_sparse` (f32 math): for each
    live chunk its live selected pages gathered whole, in their order, and
    one masked softmax with the ``-1e30`` sentinel, so a row that sees none
    of their keys averages them, as the JAX kernel does."""
    s, h, _ = q.shape
    page_size, dn = k_nope_buffer.shape[2], k_nope_buffer.shape[3]
    max_q = max_q or s
    cq = prefill_q_chunk(max_q, q_chunk)
    _check_pos_sel(pos_sel, max_q, cq)
    ks = int8_scale(k_nope_buffer, k_scale)
    out = q.new_zeros((s, h, dn))
    sel_all = pos_sel.tolist()
    start = 0
    for b, (sl, cl) in enumerate(zip(seq_lens.tolist(), context_lens.tolist())):
        for qc in range(cdiv(sl, cq)):
            pages = [p for p in sel_all[b][qc] if p >= 0]
            if not pages:
                continue
            r0, r1 = qc * cq, min((qc + 1) * cq, sl)
            bt = block_tables[b, pages][None]                       # the pages, in order
            n_keys = len(pages) * page_size
            kn = dequant_latent(_gather_pages(k_nope_buffer, bt, n_keys)[0, 0], ks)
            kr = _gather_pages(k_rope_buffer.transpose(-1, -2), bt, n_keys)[0, 0].float()
            kpos = (torch.tensor(pages, device=q.device)[:, None] * page_size
                    + torch.arange(page_size, device=q.device)[None, :]).reshape(-1)
            qb = q[start + r0 : start + r1].float()
            qk = torch.einsum("shd,ld->shl", qb[..., :dn], kn)
            qk = (qk + torch.einsum("shd,ld->shl", qb[..., dn:], kr)) * sm_scale
            qpos = cl - sl + torch.arange(r0, r1, device=q.device)
            mask = kpos[None, None, :] <= qpos[:, None, None]
            p = torch.softmax(torch.where(mask, qk, NEG_INF), dim=-1)
            out[start + r0 : start + r1] = torch.einsum("shl,ld->shd", p, kn).to(q.dtype)
        start += sl
    return out


@counted
def mla_prefill_block_sparse(q, k_nope_buffer, k_rope_buffer, seq_lens, block_tables,
                             context_lens, sm_scale, pos_sel, *, max_q: int | None = None,
                             q_chunk: int = 64, k_scale=None):
    """Block-sparse varlen paged MLA prefill (DSA): :func:`mla_prefill_pallas`'s
    function with each q-chunk of ``prefill_q_chunk(max_q, q_chunk)`` tokens
    restricted to the pages ``pos_sel [B, chunks, P]`` names (positions in
    the sequence, ``-1`` = dead; :func:`select_prefill_pages`).  Causal
    masking is by each key's position, so the pages' order only changes the
    order of accumulation.  CUDA tensors launch ``csrc/mla_prefill.cu``; CPU
    tensors take :func:`mla_prefill_block_sparse_ref`."""
    if not on_cuda(q, k_nope_buffer, k_rope_buffer, seq_lens, block_tables, context_lens,
                   pos_sel):
        return mla_prefill_block_sparse_ref(q, k_nope_buffer, k_rope_buffer, seq_lens,
                                            block_tables, context_lens, sm_scale, pos_sel,
                                            max_q=max_q, q_chunk=q_chunk, k_scale=k_scale)
    check_mla_operands(q, k_nope_buffer, k_rope_buffer)
    s, h, _ = q.shape
    max_q = int(max_q or s)
    cq = prefill_q_chunk(max_q, q_chunk)
    _check_pos_sel(pos_sel, max_q, cq)
    if pos_sel.shape[2] > MAX_SEL:
        raise ValueError(f"the CUDA kernel takes at most {MAX_SEL} pages a chunk, got "
                         f"{pos_sel.shape[2]}")
    ks = int8_scale(k_nope_buffer, k_scale)
    bsz = seq_lens.shape[0]
    q = (q if ks is None else fold_q_scale(q, ks)).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    starts = (torch.cumsum(sl, 0, dtype=torch.int32) - sl).contiguous()
    ctx = context_lens.to(torch.int32).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    sel = pos_sel.to(torch.int32).contiguous()
    _check_aligned("mla_prefill_block_sparse", q, k_nope_buffer, k_rope_buffer)
    out = torch.zeros((s, h, D_NOPE), dtype=q.dtype, device=q.device)
    tq, hb, tiles = sparse_tiling(h, cq)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.mla_prefill_sparse_launch(
        q.data_ptr(), k_nope_buffer.data_ptr(), k_rope_buffer.data_ptr(), bt.data_ptr(),
        sl.data_ptr(), ctx.data_ptr(), starts.data_ptr(), sel.data_ptr(), out.data_ptr(), bsz,
        h, bt.shape[1], k_nope_buffer.shape[2], k_nope_buffer.shape[0], tq, hb, tiles, cq,
        sel.shape[1], sel.shape[2], float(sm_scale), int(ks is not None),
        cuda_lib.stream_ptr(q)), "mla_prefill_block_sparse")
    mla_prefill_block_sparse.launches += 1
    return out if ks is None else unfold_out_scale(out, ks)
