"""Ring attention: context-parallel attention over a process group.

Counterpart of ``sgl_kernel_npu_tpu/parallel/ring_attention.py``.  The
sequence is sharded over the ranks of ``group``: rank r owns the absolute
positions ``[r·T_local, (r+1)·T_local)`` of q, k and v ``[B, T_local, H,
D]``.  The queries stay; the K / V blocks travel round the ring
(:func:`~sgl_kernel_npu_tpu_torch.parallel.collectives.ring_permute`), and
each step folds one block into an online softmax in f32 (JAX's
``_block_update``).  The masks use absolute positions, so the result equals
full causal attention; blocks wholly in the future are masked, not skipped,
as in JAX.  GQA: k / v may have fewer heads (``Hq % Hkv == 0``).

JAX has no Pallas kernel here: the block update is torch ops on the card
(einsum products, the exponentials), as XLA's ops are on the TPU.
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.parallel.collectives import (
    all_gather,
    group_rank,
    group_size,
    ring_permute,
)

NEG_INF = -1e30


def ring_attention_ref(q, k, v, sm_scale: float, *, causal: bool = True,
                       q_offset: int = 0) -> torch.Tensor:
    """Golden: full (unsharded) attention in f32; q ``[B, T, Hq, D]``, k / v
    ``[B, S, Hkv, D]`` → ``[B, T, Hq, Dv]`` in q's dtype.  The queries sit
    at positions ``q_offset + i`` (0: the whole sequence, JAX's)."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, t, hkv, hq // hkv, d)
    logits = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) * sm_scale
    if causal:
        mask = (q_offset + torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s, device=q.device)[None, :])
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return out.reshape(b, t, hq, -1).to(q.dtype)


def gathered_attention(q, k, v, sm_scale: float, *, q_offset: int) -> torch.Tensor:
    """Causal attention of one rank's queries ``q [B, T, Hq, D]`` at
    positions ``q_offset + i`` over K / V ``[B, S, Hkv, D]`` that every rank
    already holds whole (``models.llama.prefill_step_cp`` all-gathers them
    for its cache write): what :func:`ring_attention` gives at those rows,
    with no K / V hop.  Only the rows up to the last query's position are
    read; one kv head at a time bounds the f32 scores at ``[B, G, T,
    q_offset + T]``."""
    hkv = k.shape[2]
    g = q.shape[2] // hkv
    seen = slice(0, q_offset + q.shape[1])
    return torch.cat([ring_attention_ref(q[:, :, h * g:(h + 1) * g], k[:, seen, h:h + 1],
                                         v[:, seen, h:h + 1], sm_scale, q_offset=q_offset)
                      for h in range(hkv)], dim=2)


def _block_update(qf, kb, vb, sm_scale, q_pos, k_pos, m, l, acc, causal):
    """One online-softmax update of the local queries with a K / V block."""
    logits = torch.einsum("bthgd,bshd->bhgts", qf, kb.float()) * sm_scale
    if causal:
        logits = torch.where(q_pos[:, None] >= k_pos[None, :], logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhgts,bshd->bhgtd", p, vb.float())
    return m_new, l, acc


def ring_attention(q, k, v, sm_scale: float, *, group, causal: bool = True) -> torch.Tensor:
    """This rank's block of context-parallel attention: q / k / v ``[B,
    T_local, H(kv), D]`` at this rank's positions → ``[B, T_local, Hq, Dv]``
    in q's dtype, equal to the full-sequence result at those positions.  The
    K / V blocks make R - 1 hops (JAX's scan makes R, the last unused)."""
    r, me = group_size(group), group_rank(group)
    b, tl, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = hq // hkv
    dev = q.device
    qf = q.float().reshape(b, tl, hkv, g, d)
    local = torch.arange(tl, device=dev)
    q_pos = me * tl + local
    m = torch.full((b, hkv, g, tl, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, tl, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, tl, dv), dtype=torch.float32, device=dev)
    kb, vb = k, v
    for i in range(r):
        k_pos = ((me - i) % r) * tl + local
        m, l, acc = _block_update(qf, kb, vb, sm_scale, q_pos, k_pos, m, l, acc, causal)
        if i < r - 1:
            kb, vb = ring_permute(kb, group), ring_permute(vb, group)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, tl, hq, dv).to(q.dtype)


def ring_attention_sharded(q, k, v, *, group, sm_scale: float,
                           causal: bool = True) -> torch.Tensor:
    """Global ``[B, T, H, D]`` arrays (the same on every rank), the sequence
    sharded over ``group``: this rank attends its ``T / R`` rows and the
    result comes back whole on every rank."""
    r, me = group_size(group), group_rank(group)
    t = q.shape[1]
    if t % r:
        raise ValueError(f"sequence length {t} does not divide by the ring of {r} ranks")
    mine = slice(me * t // r, (me + 1) * t // r)
    out = ring_attention(q[:, mine], k[:, mine], v[:, mine], sm_scale, group=group,
                         causal=causal)
    return all_gather(out, group, dim=1)
