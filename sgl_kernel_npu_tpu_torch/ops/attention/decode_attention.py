"""Paged MLA decode attention: plain version and the Hopper kernel (K2).

Counterpart of ``sgl_kernel_npu_tpu/ops/attention/decode_attention.py``
(``decode_mla_ref``, ``decode_mla``).  Layouts are the JAX package's: q
``[B, Hq, 512 + 64]`` (nope ‖ rope), latent cache ``[pages, 1, page, 512]``,
rope cache transposed ``[pages, 1, 64, page]``; V aliases K_nope.  The CUDA
kernel is ``csrc/decode_mla.cu``.  The latent cache is bf16 or int8: the
``int8_nzcache`` levels ``round(k / k_scale)``, where the plain version
dequantizes and the kernel's wrapper folds ``k_scale`` into q_nope and the
output, as the JAX wrapper does (the kernel reads levels only).

DeepSeek-V3.2's sparse decode (DSA) is glue around K2, as in JAX:
``decode_mla_block_sparse`` (page mode: the indexer's top pages, sorted, as a
pruned block table for K2) and ``decode_mla_sparse`` (token mode: a gather of
the selected latents and one masked softmax).
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import cdiv, on_cuda, top_k
from sgl_kernel_npu_tpu_torch.utils.counters import counted

NEG_INF = -1e30
D_NOPE, D_ROPE = 512, 64   # widths the CUDA kernels are built for


def _gather_pages(buffer: torch.Tensor, block_table: torch.Tensor, max_len: int) -> torch.Tensor:
    """``[pages, H, page, D]`` + ``[B, max_pages]`` → ``[B, H, max_len, D]``."""
    _, h, page_size, d = buffer.shape
    n_pages = cdiv(max_len, page_size)
    pages = buffer[block_table[:, :n_pages].long()]            # [B, n, H, page, D]
    b = pages.shape[0]
    return pages.permute(0, 2, 1, 3, 4).reshape(b, h, n_pages * page_size, d)[:, :, :max_len]


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
    ``decode_attention.py:314-317``): scores see ``(q · ks) · k_level``."""
    qn = (q[..., :D_NOPE].float() * ks).to(q.dtype)
    return torch.cat([qn, q[..., D_NOPE:]], dim=-1)


def unfold_out_scale(out: torch.Tensor, ks) -> torch.Tensor:
    """The kernel's output over int8 levels × ``ks`` (V aliases K)."""
    return (out.float() * ks).to(out.dtype)


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


@counted
def decode_mla(q, k_nope_buffer, k_rope_buffer, kv_seq_lens, sm_scale, block_table, *,
               k_scale=None):
    """Paged MLA decode attention → ``[B, Hq, 512]``.

    CUDA tensors launch ``csrc/decode_mla.cu``; CPU tensors take
    :func:`decode_mla_ref`.  Pad rows (ctx 1, block table of zeros) are safe.
    ``k_scale``: the dequant scale of an int8 latent cache (``ctkv_scale``)."""
    if not on_cuda(q, k_nope_buffer, k_rope_buffer, kv_seq_lens, block_table):
        return decode_mla_ref(q, k_nope_buffer, k_rope_buffer, kv_seq_lens, sm_scale,
                              block_table, k_scale)
    check_mla_operands(q, k_nope_buffer, k_rope_buffer)
    ks = int8_scale(k_nope_buffer, k_scale)
    b, hq, _ = q.shape
    q = (q if ks is None else fold_q_scale(q, ks)).contiguous()
    bt = block_table.to(torch.int32).contiguous()
    ctx = kv_seq_lens.to(torch.int32).contiguous()
    out = torch.empty((b, hq, D_NOPE), dtype=q.dtype, device=q.device)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.decode_mla_launch(
        q.data_ptr(), k_nope_buffer.data_ptr(), k_rope_buffer.data_ptr(), bt.data_ptr(),
        ctx.data_ptr(), out.data_ptr(), b, hq, bt.shape[1], k_nope_buffer.shape[2],
        float(sm_scale), int(ks is not None), cuda_lib.stream_ptr(q)), "decode_mla")
    decode_mla.launches += 1
    return out if ks is None else unfold_out_scale(out, ks)


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
