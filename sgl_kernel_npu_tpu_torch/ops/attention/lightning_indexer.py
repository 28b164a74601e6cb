"""Lightning indexer (DeepSeek-V3.2 sparse attention, DSA): plain versions and
the Hopper kernel (K10).

Counterpart of ``sgl_kernel_npu_tpu/ops/attention/lightning_indexer.py``.  Per
query token the indexer scores every cached key as
``Σ_h w[t, h] · relu(q[t, h] · k[pos])`` in f32 over the paged index-key cache
``[pages, 1, page, idx_dim]`` (one key head), masks causally (queries
right-aligned to their request's keys) and, in :func:`lightning_indexer`,
keeps the ``sparse_count`` best positions.  This is the JAX package's indexer
(bf16 index keys, no index rope, no key LayerNorm, no FP8).

Masked scores are exactly ``-inf`` (the JAX code's sentinel here), never the
``-1e30`` of the attention modules: the page selections compare against
``-1e30`` and a dead position must stay below it.

The prefill scores run on ``csrc/lightning_indexer.cu`` for CUDA tensors
(the name ``..._pallas`` is kept so the counterpart is easy to find); the
decode scores are glue, as in JAX.
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.attention.decode_attention import _gather_pages
from sgl_kernel_npu_tpu_torch.ops.attention.sinks_attention import prefill_q_chunk
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import cdiv, on_cuda, top_k
from sgl_kernel_npu_tpu_torch.utils.counters import counted

NEG_INF = float("-inf")
IDX_DIM = 128                    # index-key width the CUDA kernel is built for
IDX_HEADS = (16, 32, 64, 128)    # index heads it takes
# The kernel's tiles (csrc/lightning_indexer.cu): query rows (tokens x heads)
# a block; keys a chunk.  Where a call's token tiles give fewer than
# LI_BLOCKS blocks, each tile's key range is cut into splits of at least
# LI_MIN_CHUNKS chunks, a block each.
LI_ROWS, LI_CHUNK, LI_BLOCKS, LI_MIN_CHUNKS = 512, 64, 132, 4
_ROW_CHUNK = 64                  # query rows a step of the plain version scores


def lightning_indexer_scores_prefill_ref(q_dense, w_dense, key, lens_q, lens_k, block_table,
                                         *, causal: bool = True, q_chunk: int = 64):
    """Plain version of :func:`lightning_indexer_scores_prefill_pallas`: per
    request its keys gathered once, then an f32 einsum over 64 query rows at
    a time (a [64, heads, keys] f32 block: ~70 MB at 64 heads and 4,224
    keys)."""
    bsz, max_q, _, _ = q_dense.shape
    page = key.shape[2]
    width = block_table.shape[1] * page
    cq = prefill_q_chunk(max_q, q_chunk)
    mq = cdiv(max_q, cq) * cq
    out = torch.full((bsz, mq, width), NEG_INF, dtype=torch.float32, device=q_dense.device)
    for b, (lq, lk) in enumerate(zip(lens_q.tolist(), lens_k.tolist())):
        n_keys = min(lk, width)
        if lq == 0 or n_keys <= 0:
            continue
        k_b = _gather_pages(key, block_table[b : b + 1], n_keys)[0, 0].float()     # [L, D]
        pos = torch.arange(n_keys, device=q_dense.device)
        for r0 in range(0, lq, _ROW_CHUNK):
            r1 = min(lq, r0 + _ROW_CHUNK)
            s = torch.einsum("rnd,ld->rnl", q_dense[b, r0:r1].float(), k_b).clamp_min_(0.0)
            s = torch.einsum("rn,rnl->rl", w_dense[b, r0:r1].float(), s)
            t = torch.arange(r0, r1, device=q_dense.device)
            qpos = lk - lq + t if causal else torch.full_like(t, lk - 1)
            out[b, r0:r1, :n_keys] = torch.where(pos[None, :] <= qpos[:, None], s, NEG_INF)
    return out


def indexer_splits(blocks: int, width: int) -> tuple[int, int]:
    """K10's key splits for ``blocks`` (token tile, request) pairs over
    ``width`` keys → ``(chunks a split, splits)``: one split (the whole
    table) where the tiles alone give ``LI_BLOCKS`` blocks, else enough
    splits of at least ``LI_MIN_CHUNKS`` chunks to reach that many.  From
    shapes alone (no host sync)."""
    chunks = max(cdiv(width, LI_CHUNK), 1)
    splits = max(1, min(cdiv(chunks, LI_MIN_CHUNKS), cdiv(LI_BLOCKS, max(blocks, 1))))
    cps = cdiv(chunks, splits)
    return cps, cdiv(chunks, cps)


@counted
def lightning_indexer_scores_prefill_pallas(q_dense, w_dense, key, lens_q, lens_k, block_table,
                                            *, causal: bool = True, q_chunk: int = 64):
    """Masked indexer scores ``[B, max_q_pad, max_pages · page]`` f32 of
    dense-padded queries ``q_dense [B, max_q, N1, D]`` with weights ``w_dense
    [B, max_q, N1]`` against the paged keys ``key [pages, 1, page, D]``:
    ``-inf`` outside each row's causal range (``causal=False``: outside the
    context), past ``lens_k`` and on rows past ``lens_q``.  ``max_q_pad``
    rounds ``max_q`` up to the q-chunk (``sinks_attention.prefill_q_chunk``).

    CUDA tensors launch ``csrc/lightning_indexer.cu`` (bf16 q and keys of
    width 128 starting 16-byte aligned, f32 weights, 16-128 heads, page a
    multiple of 8; one launch, its key splits from shapes,
    :func:`indexer_splits`); CPU tensors take
    :func:`lightning_indexer_scores_prefill_ref`."""
    if not on_cuda(q_dense, w_dense, key, lens_q, lens_k, block_table):
        return lightning_indexer_scores_prefill_ref(q_dense, w_dense, key, lens_q, lens_k,
                                                    block_table, causal=causal, q_chunk=q_chunk)
    bsz, max_q, n1, d = q_dense.shape
    page = key.shape[2]
    if not (q_dense.dtype == key.dtype == torch.bfloat16 and w_dense.dtype == torch.float32):
        raise ValueError(f"the CUDA indexer takes bf16 queries and keys and f32 weights, got "
                         f"{q_dense.dtype}, {key.dtype}, {w_dense.dtype}")
    if (d != IDX_DIM or n1 not in IDX_HEADS or tuple(key.shape[1:]) != (1, page, IDX_DIM)
            or page % 8 or tuple(w_dense.shape) != (bsz, max_q, n1)):
        raise ValueError(f"indexer kernel shapes: q [B, mq, N1 in {IDX_HEADS}, {IDX_DIM}], "
                         f"w [B, mq, N1], keys [P, 1, page % 8 == 0, {IDX_DIM}]; got "
                         f"{tuple(q_dense.shape)}, {tuple(w_dense.shape)}, {tuple(key.shape)}")
    cq = prefill_q_chunk(max_q, q_chunk)
    mq = cdiv(max_q, cq) * cq
    q = q_dense.contiguous()
    w = w_dense.contiguous()
    k = key.contiguous()
    bt = block_table.to(torch.int32).contiguous()
    lq = lens_q.to(torch.int32).contiguous()
    lk = lens_k.to(torch.int32).contiguous()
    if q.data_ptr() % 16 or k.data_ptr() % 16:
        raise ValueError("the indexer kernel reads q and the keys by TMA: they must start "
                         "16-byte aligned")
    width = bt.shape[1] * page
    out = torch.empty((bsz, mq, width), dtype=torch.float32, device=q.device)
    cps, splits = indexer_splits(bsz * cdiv(mq, LI_ROWS // n1), width)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.lightning_indexer_prefill_launch(
        q.data_ptr(), w.data_ptr(), k.data_ptr(), bt.data_ptr(), lq.data_ptr(), lk.data_ptr(),
        out.data_ptr(), bsz, max_q, mq, n1, bt.shape[1], page, k.shape[0], cps, splits,
        int(causal), cuda_lib.stream_ptr(q)), "lightning_indexer_scores_prefill_pallas")
    lightning_indexer_scores_prefill_pallas.launches += 1
    return out


def lightning_indexer_scores_decode(query, key, weights, actual_seq_lengths_key, block_table):
    """Masked indexer scores for one decode token a request: ``query [B, N1,
    D]``, ``weights [B, N1]`` → ``[B, max_pages · page]`` f32, ``-inf`` past
    each context.  Glue (a gather and an f32 einsum), as in JAX; feeds
    ``decode_attention.select_decode_pages``."""
    width = block_table.shape[1] * key.shape[2]
    k_lin = _gather_pages(key, block_table, width)[:, 0].float()             # [B, L, D]
    s = torch.einsum("bnd,bld->bnl", query.float(), k_lin).clamp_min_(0.0)
    s = torch.einsum("bn,bnl->bl", weights.float(), s)
    pos = torch.arange(width, device=query.device)
    return torch.where(pos[None, :] < actual_seq_lengths_key.to(query.device).long()[:, None],
                       s, NEG_INF)


def lightning_indexer(query, key, weights, actual_seq_lengths_query, actual_seq_lengths_key,
                      block_table, layout_query: str = "BSND", sparse_count: int = 2048,
                      sparse_mode: int = 3, backend: str = "pallas", max_q: int | None = None):
    """The ``sparse_count`` best key positions of each query token, best first,
    ``-1`` past ``min(sparse_count, lens_k)`` and on pad tokens: int32 shaped
    like ``query`` with its last two dimensions → ``[1, sparse_count]``.

    ``layout_query`` ``"BSND"`` (``query [B, S1, N1, D]``, ``weights [B, S1,
    N1]``, ``actual_seq_lengths_query [B]`` or None for S1 each) or ``"TND"``
    (``[T, N1, D]``, ``[T, N1]``, prefix sums ``[B]``).  ``sparse_mode`` 3 is
    causal.  ``backend="pallas"`` scores through K10
    (:func:`lightning_indexer_scores_prefill_pallas`, ``max_q`` the static
    per-request bound), ``"xla"`` through the gathered-key einsum, the plain
    version.  The selection keeps ``jax.lax.top_k``'s order (ties by index)."""
    dev = query.device
    n1, d = query.shape[-2], query.shape[-1]
    bsz = block_table.shape[0]
    if layout_query == "BSND":
        b, s1 = query.shape[0], query.shape[1]
        q_flat, w_flat = query.reshape(b * s1, n1, d), weights.reshape(b * s1, n1)
        tok_b = torch.arange(b, device=dev).repeat_interleave(s1)
        lens_q = (torch.full((b,), s1, dtype=torch.long, device=dev)
                  if actual_seq_lengths_query is None
                  else actual_seq_lengths_query.to(dev).long())
        tok_j = torch.arange(s1, device=dev).repeat(b)
        tok_valid = tok_j < lens_q[tok_b]
        out_shape, n_tok = (b, s1, 1, sparse_count), s1
    elif layout_query == "TND":
        t = query.shape[0]
        q_flat, w_flat = query.reshape(t, n1, d), weights.reshape(t, n1)
        ends = actual_seq_lengths_query.to(dev).long()
        tok_b = torch.clamp(torch.searchsorted(ends, torch.arange(t, device=dev), right=True),
                            0, bsz - 1)
        starts = torch.cat([ends.new_zeros(1), ends[:-1]])
        tok_j = torch.arange(t, device=dev) - starts[tok_b]
        lens_q = ends - starts
        tok_valid = torch.arange(t, device=dev) < ends[-1]
        out_shape, n_tok = (t, 1, sparse_count), t
    else:
        raise ValueError(layout_query)

    width = block_table.shape[1] * key.shape[2]
    lens_k = actual_seq_lengths_key.to(dev).long()
    if backend == "pallas":
        mq = max_q or n_tok
        keep = tok_j < mq
        q_dense = query.new_zeros((bsz, mq, n1, d))
        q_dense[tok_b[keep], tok_j[keep]] = q_flat[keep]
        w_dense = torch.zeros((bsz, mq, n1), dtype=torch.float32, device=dev)
        w_dense[tok_b[keep], tok_j[keep]] = w_flat[keep].float()
        scores_dense = lightning_indexer_scores_prefill_pallas(
            q_dense, w_dense, key, lens_q, lens_k, block_table, causal=sparse_mode == 3)
        scores = scores_dense[tok_b, torch.clamp(tok_j, max=scores_dense.shape[1] - 1)]
    elif backend == "xla":
        k_tok = _gather_pages(key, block_table, width)[:, 0][tok_b].float()     # [T, L, D]
        s = torch.einsum("tnd,tld->tnl", q_flat.float(), k_tok).clamp_min_(0.0)
        scores = torch.einsum("tn,tnl->tl", w_flat.float(), s)
        pos = torch.arange(width, device=dev)[None, :]
        s2 = lens_k[tok_b][:, None]
        mask = pos < s2
        if sparse_mode == 3:
            mask &= pos <= (s2[:, 0] - lens_q[tok_b] + tok_j)[:, None]
        scores = torch.where(mask, scores, NEG_INF)
    else:
        raise ValueError(backend)

    kk = min(sparse_count, width)
    idx = top_k(scores, kk)[1].to(torch.int32)
    if kk < sparse_count:
        idx = torch.nn.functional.pad(idx, (0, sparse_count - kk), value=-1)
    # the reference fills min(sparse_count, lens_k) slots (dead positions at
    # the tail of the order) and pads the rest with -1
    valid = torch.clamp(lens_k[tok_b], max=sparse_count)
    col = torch.arange(sparse_count, device=dev)[None, :]
    idx = torch.where((col < valid[:, None]) & tok_valid[:, None], idx, -1)
    return idx.reshape(out_shape)
