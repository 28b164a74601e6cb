"""Varlen causal MLA prefill over the paged latent cache: plain version and
the Hopper kernel (K9).

Counterpart of ``sgl_kernel_npu_tpu/ops/attention/mla_prefill.py``
(``mla_prefill_ref``, ``mla_prefill_pallas``; the name is kept so the
counterpart is easy to find, but the kernel is CUDA: ``csrc/mla_prefill.cu``).
Absorbed queries q ``[S, H, 512 + 64]``, packed by request, attend to the
latent cache; token j of request b sees cache positions
``<= context_len - seq_len + j``.  Rows past the request lengths are zeros.
The latent cache is bf16 or int8 (``k_scale``), as in ``decode_attention``.
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
from sgl_kernel_npu_tpu_torch.ops.attention.sinks_attention import _prefill_page_bounds
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda
from sgl_kernel_npu_tpu_torch.utils.counters import counted

ROWS = 16   # query rows (tokens x heads) per CUDA block, csrc/mla_attention.cuh


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


@counted
def mla_prefill_pallas(q, k_nope_buffer, k_rope_buffer, seq_lens, block_tables,
                       context_lens, sm_scale, *, max_q: int | None = None, k_scale=None):
    """Varlen paged MLA prefill: q ``[S, H, 576]`` → ``[S, H, 512]``.

    ``max_q`` bounds every request's new-token count (defaults to ``S``);
    ``k_scale`` is the dequant scale of an int8 latent cache.  CUDA tensors
    launch ``csrc/mla_prefill.cu``; CPU tensors take :func:`mla_prefill_ref`."""
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
    out = torch.zeros((s, h, D_NOPE), dtype=q.dtype, device=q.device)
    # a block holds 16 rows: all heads of 16 / H tokens when H < 16
    heads_per_block = min(ROWS, 1 << max(h - 1, 0).bit_length())
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.mla_prefill_launch(
        q.data_ptr(), k_nope_buffer.data_ptr(), k_rope_buffer.data_ptr(), bt.data_ptr(),
        sl.data_ptr(), ctx.data_ptr(), starts.data_ptr(), out.data_ptr(), bsz, h,
        bt.shape[1], k_nope_buffer.shape[2], int(max_q or s), ROWS // heads_per_block,
        float(sm_scale), int(ks is not None), cuda_lib.stream_ptr(q)), "mla_prefill")
    mla_prefill_pallas.launches += 1
    return out if ks is None else unfold_out_scale(out, ks)
