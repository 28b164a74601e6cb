"""Recurrent (decode) gated delta rule with fused sigmoid gating.

Counterpart of ``sgl_kernel_npu_tpu/ops/fla/recurrent.py``
(``fused_sigmoid_gating_delta_rule_update``), per token::

    g  = -exp(A_log) · softplus(a + dt_bias)      β = sigmoid(b)
    S *= exp(g);  v' = β (v - kᵀS);  S += k ⊗ v';  o = qᵀS

with optional q / k L2 norm, the per-request state in a pool addressed by
``initial_state_indices`` (-1: a zero state, no write back).  Decode T is 1
(a few with MTP): a loop over tokens of batched products over every
request and head, as JAX's ``lax.scan``.  Where JAX donates the pool and
returns the new one, the port writes the rows back into the pool in place
and returns it.
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.fla.chunk import l2norm
from sgl_kernel_npu_tpu_torch.ops.fla.gating import softplus_beta


def fused_sigmoid_gating_delta_rule_update(A_log, a, dt_bias, q, k, v, b,
                                           initial_state_source: torch.Tensor,
                                           initial_state_indices: torch.Tensor, *,
                                           softplus_beta_p: float = 1.0,
                                           softplus_threshold: float = 20.0,
                                           scale: float | None = None,
                                           use_qk_l2norm_in_kernel: bool = True):
    """``A_log [HV]``, ``a`` / ``b [B, T, HV]``, ``dt_bias [HV]``, ``q`` /
    ``k [B, T, H, K]``, ``v [B, T, HV, V]``, the pool ``[P, HV, K, V]`` and
    ``initial_state_indices [B]`` → ``(o [B, T, HV, V] in v's type, the
    pool)``.  Rows with an index in ``[0, P)`` write their final state back
    (in place); an index below 0 starts from zeros and writes nothing."""
    bsz, t, h, kd = q.shape
    hv, vd = v.shape[2], v.shape[-1]
    if scale is None:
        scale = kd ** -0.5
    rep = hv // h
    if rep > 1:
        q = q.repeat_interleave(rep, dim=2)
        k = k.repeat_interleave(rep, dim=2)
    if use_qk_l2norm_in_kernel:
        q, k = l2norm(q), l2norm(k)
    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    g = -torch.exp(A_log.float())[None, None] * softplus_beta(
        a.float() + dt_bias.float()[None, None], softplus_beta_p, softplus_threshold)
    decay = torch.exp(g)                                    # [B, T, HV]
    beta = torch.sigmoid(b.float())

    pool = initial_state_source
    idx = initial_state_indices.to(device=pool.device, dtype=torch.long)
    s = pool.index_select(0, idx.clamp(0, pool.shape[0] - 1)).float()
    s = torch.where((idx >= 0)[:, None, None, None], s, 0.0)      # [B, HV, K, V]
    o = torch.empty((bsz, t, hv, vd), dtype=torch.float32, device=vf.device)
    for i in range(t):
        k_t = kf[:, i]                                             # [B, HV, K]
        s = s * decay[:, i][..., None, None]
        v_p = (vf[:, i] - (k_t[..., None, :] @ s)[..., 0, :]) * beta[:, i][..., None]
        s = s + k_t[..., :, None] * v_p[..., None, :]
        o[:, i] = (qf[:, i][..., None, :] @ s)[..., 0, :]
    keep = (idx >= 0) & (idx < pool.shape[0])
    pool.index_copy_(0, idx[keep], s[keep].to(pool.dtype))
    return o.to(v.dtype), pool
