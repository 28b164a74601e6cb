"""Chunked gated delta rule forward (flash linear attention, Qwen3-Next's
GDN layers).

Counterpart of ``sgl_kernel_npu_tpu/ops/fla/chunk.py`` (``l2norm``,
``tril_nilpotent_inverse``, ``chunk_gated_delta_rule``,
``chunk_gated_delta_rule_varlen``, ``chunk_gated_delta_rule_ref``).  JAX
runs the pipeline as batched einsums over ``[B·HV, n_chunks, C, D]`` and one
``lax.scan`` over chunks, and writes no Pallas kernel for it; so does the
port, in f32 throughout: the intra-chunk work (decays, ``K Kᵀ``, the
nilpotent-squaring inverse of ``I - A`` with JAX's number of squarings, the
WY factors ``u`` / ``w``, the masked ``Q Kᵀ``) is batched over every chunk
and head at once, then a Python loop over chunks carries the state, each
step a few batched matmuls over all ``B·HV`` heads.
"""

from __future__ import annotations

import numpy as np
import torch


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Row L2 normalisation in f32, cast back to x's type."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).sum(dim=-1, keepdim=True) + eps)).to(x.dtype)


def tril_nilpotent_inverse(a: torch.Tensor) -> torch.Tensor:
    """``(I - A)⁻¹`` for strictly lower-triangular ``A`` (batched on leading
    dims) by repeated squaring: ``(I + A)(I + A²)(I + A⁴)…``, exact once
    ``2^m >= C`` since ``A`` is nilpotent."""
    c = a.shape[-1]
    eye = torch.eye(c, dtype=a.dtype, device=a.device)
    inv = eye + a
    p = a
    for _ in range(max(1, (c - 1).bit_length() - 1)):
        p = p @ p
        inv = inv @ (eye + p)
    return inv


def chunk_gated_delta_rule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                           beta: torch.Tensor, *, scale: float | None = None,
                           chunk_size: int = 64, initial_state: torch.Tensor | None = None,
                           output_final_state: bool = True,
                           use_qk_l2norm_in_kernel: bool = False):
    """Chunked GDN forward: ``q`` / ``k [B, T, H, K]``, ``v [B, T, HV, V]``,
    ``g`` (log decay) / ``beta [B, T, HV]``, ``initial_state [B, HV, K, V]``
    → ``(o [B, T, HV, V] in v's type, final_state [B, HV, K, V] f32 or
    None)``.  GQA: with HV > H each q / k head serves HV / H value heads.
    (JAX returns o in f32, its ``v`` rebound to the f32 copy by then; the
    port returns v's own type, as the recurrent update does, so that a bf16
    model's residual stream stays bf16 through a GDN layer's prefill.)"""
    b, t, h, kd = q.shape
    hv, vd = v.shape[2], v.shape[-1]
    if hv > h:
        rep = hv // h
        q = q.repeat_interleave(rep, dim=2)
        k = k.repeat_interleave(rep, dim=2)
    if use_qk_l2norm_in_kernel:
        q, k = l2norm(q), l2norm(k)
    if scale is None:
        scale = kd ** -0.5
    c = chunk_size
    pad = (-t) % c
    nt = (t + pad) // c
    out_dtype = v.dtype

    def prep(x):
        # [B, T, HV, ...] → f32 [B·HV, NT, C, ...], zero rows past T
        x = x.float()
        if pad:
            x = torch.nn.functional.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))
        return x.movedim(2, 1).reshape((b * hv, nt, c) + tuple(x.shape[3:]))

    q, k, v, gg, bb = prep(q * scale), prep(k), prep(v), prep(g), prep(beta)
    dev = q.device
    v_beta = v * bb[..., None]
    k_beta = k * bb[..., None]
    gc = torch.cumsum(gg, dim=-1)                               # within-chunk decay
    tri = torch.ones((c, c), dtype=torch.bool, device=dev).tril()
    tri_strict = torch.ones((c, c), dtype=torch.bool, device=dev).tril(-1)
    decay = torch.where(tri, torch.exp(gc[..., :, None] - gc[..., None, :]), 0.0)
    kkt = k_beta @ k.transpose(-1, -2)                          # [Z, NT, C, C]
    a = torch.where(tri_strict, -(kkt * decay), 0.0)
    t_inv = tril_nilpotent_inverse(a)                           # (I - A)^-1
    egc = torch.exp(gc)
    u = t_inv @ v_beta                                          # WY: u
    w = t_inv @ (k_beta * egc[..., None])                       # WY: w
    attn = torch.where(tri, (q @ k.transpose(-1, -2)) * decay, 0.0)
    g_last = gc[..., -1]                                        # [Z, NT]
    q_dec = q * egc[..., None]
    k_dec = (k * torch.exp(g_last[..., None] - gc)[..., None]).transpose(-1, -2)   # [Z, NT, K, C]
    s_dec = torch.exp(g_last)[..., None, None]                  # [Z, NT, 1, 1]

    if initial_state is None:
        s = torch.zeros((b * hv, kd, vd), dtype=torch.float32, device=dev)
    else:
        s = initial_state.reshape(b * hv, kd, vd).float()
    o = torch.empty((b * hv, nt, c, vd), dtype=torch.float32, device=dev)
    for i in range(nt):
        v_new = u[:, i] - w[:, i] @ s
        o[:, i] = q_dec[:, i] @ s + attn[:, i] @ v_new
        s = s * s_dec[:, i] + k_dec[:, i] @ v_new
    o = o.reshape(b, hv, nt * c, vd)[:, :, :t].transpose(1, 2)
    final = s.reshape(b, hv, kd, vd) if output_final_state else None
    return o.to(out_dtype), final


def chunk_gated_delta_rule_varlen(q, k, v, g, beta, cu_seqlens, *, scale=None, chunk_size=64,
                                  use_qk_l2norm_in_kernel=False):
    """Varlen (packed) chunked GDN: ``[T_total, H(V), D]`` / ``[T_total,
    HV]`` tensors with sequences at ``cu_seqlens [N + 1]`` → ``(o [T_total,
    HV, V], None)``.  As JAX: one batch-of-1 pass in which a large negative
    constant added to ``g`` at each sequence start makes every decay across
    a boundary exactly 0, so the state restarts at each sequence (boundaries
    need not be chunk-aligned; initial states are zero)."""
    t = q.shape[0]
    starts = cu_seqlens[:-1].long().to(q.device)
    is_start = torch.zeros((t,), dtype=torch.float32, device=q.device)
    is_start[starts[starts < t]] = 1.0
    g_reset = g.float() - 1e4 * is_start[:, None]
    o, _ = chunk_gated_delta_rule(q[None], k[None], v[None], g_reset[None], beta[None],
                                  scale=scale, chunk_size=chunk_size, output_final_state=False,
                                  use_qk_l2norm_in_kernel=use_qk_l2norm_in_kernel)
    return o[0], None


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def chunk_gated_delta_rule_ref(q, k, v, g, beta, *, scale=None, chunk_size=64,
                               initial_state=None, use_qk_l2norm_in_kernel=False):
    """Golden: a straight-line per-(batch, head, chunk) loop in numpy with a
    true matrix inverse (JAX's ``chunk_gated_delta_rule_ref``) → ``(o [B, T,
    HV, V], final_state [B, HV, K, V])`` as f32 CPU tensors."""
    q, k, v, g, beta = map(_np, (q, k, v, g, beta))
    b, t, h, kd = q.shape
    hv, vd = v.shape[2], v.shape[-1]
    if hv > h:
        q = np.repeat(q, hv // h, axis=2)
        k = np.repeat(k, hv // h, axis=2)
    if use_qk_l2norm_in_kernel:
        q = q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
        k = k / (np.linalg.norm(k, axis=-1, keepdims=True) + 1e-12)
    scale = scale or kd ** -0.5
    c = chunk_size
    pad = (-t) % c
    o = np.zeros((b, t, hv, vd), np.float32)
    s_out = np.zeros((b, hv, kd, vd), np.float32)
    for bi in range(b):
        for hi in range(hv):
            qs = np.pad(q[bi, :, hi] * scale, ((0, pad), (0, 0)))
            ks = np.pad(k[bi, :, hi], ((0, pad), (0, 0)))
            vs = np.pad(v[bi, :, hi], ((0, pad), (0, 0)))
            gs = np.pad(g[bi, :, hi], (0, pad))
            bs = np.pad(beta[bi, :, hi], (0, pad))
            s = (np.zeros((kd, vd), np.float32) if initial_state is None
                 else _np(initial_state)[bi, hi].copy())
            for ci in range((t + pad) // c):
                sl = slice(ci * c, (ci + 1) * c)
                qi, ki, vi, gi, bti = qs[sl], ks[sl], vs[sl], gs[sl], bs[sl]
                gci = np.cumsum(gi)
                dec = np.tril(np.exp(gci[:, None] - gci[None, :]))
                a = -np.tril((ki * bti[:, None]) @ ki.T * dec, -1)
                tinv = np.linalg.inv(np.eye(c) - a)
                u = tinv @ (vi * bti[:, None])
                w = tinv @ (ki * bti[:, None] * np.exp(gci)[:, None])
                v_new = u - w @ s
                attn = np.tril(qi @ ki.T * dec)
                oi = (qi * np.exp(gci)[:, None]) @ s + attn @ v_new
                s = s * np.exp(gci[-1]) + (ki * np.exp(gci[-1] - gci)[:, None]).T @ v_new
                rows = min(c, max(0, t - ci * c))
                o[bi, ci * c : ci * c + rows, hi] = oi[:rows]
            s_out[bi, hi] = s
    return torch.from_numpy(o), torch.from_numpy(s_out)
