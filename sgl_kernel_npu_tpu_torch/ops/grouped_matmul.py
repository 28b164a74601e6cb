"""Host helpers of the grouped (ragged) expert GEMMs.

Counterpart of the helpers in ``sgl_kernel_npu_tpu/ops/grouped_matmul.py``
that the ring GEMMs and the weight quantizer use.  The BlockSpec grouped
kernels there (K8) are not ported yet; the port's ``gmm_ring`` kernels find
their groups from the offsets and need no tile schedule.
"""

from __future__ import annotations

import torch


def gmm_dequant_ref(x_q, w_q, group_sizes, scale_x, scale_w):
    """Plain W8A8 grouped matmul with per-row × per-channel dequant:
    ``out[i] = (x_q[i] @ w_q[g(i)]) * scale_x[i] * scale_w[g(i)]`` over rows
    grouped contiguously; rows past the groups' total are zeros.  The integer
    products are summed exactly (float64 holds every int8 dot product of
    these widths), then rounded to f32 as the int32 accumulator would be."""
    rows, n = x_q.shape[0], w_q.shape[2]
    out = torch.zeros((rows, n), dtype=torch.float32, device=x_q.device)
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        if size:
            rs = slice(start, start + size)
            acc = (x_q[rs].double() @ w_q[g].double()).float()
            out[rs] = acc * scale_x[rs, None] * scale_w[g][None, :]
        start += size
    return out


def swiglu_block(acc: torch.Tensor) -> torch.Tensor:
    """SwiGLU over a ``[rows, gate ‖ up]`` tile: silu(gate) * up."""
    half = acc.shape[-1] // 2
    gate, up = acc[:, :half], acc[:, half:]
    return gate * torch.sigmoid(gate) * up


def default_pack_tn(n: int) -> int:
    """Widest pack width (≤ 2048) dividing ``n``; ``n`` itself otherwise."""
    for t in (2048, 1024, 512, 256):
        if n % t == 0:
            return t
    return n


def moe_pack_tn(n: int) -> int:
    """Pack width of the fused-MoE GMM1 weights: full width (the ring GEMM's
    SwiGLU needs gate ‖ up at full width) unless ``n`` is very large.  Same
    rule as the JAX package so both quantize to one layout."""
    if 128 * n * 4 + 2 * 256 * (128 + n) <= 12 * 2**20:
        return n
    return default_pack_tn(n)


def pack_gmm1_weights(w_gate: torch.Tensor, w_up: torch.Tensor, tn: int) -> torch.Tensor:
    """Interleave gate/up column blocks: each tn-wide slab = [gate tn/2 | up tn/2].
    ``[G, K, I]`` x2 → ``[G, K, 2I]``."""
    g, k, i = w_gate.shape
    half = tn // 2
    if i % half:
        raise ValueError(f"intermediate {i} is not a multiple of tn/2 = {half}")
    blocks = i // half
    return torch.stack([w_gate.reshape(g, k, blocks, half),
                        w_up.reshape(g, k, blocks, half)], dim=3).reshape(g, k, 2 * i)


def pack_gmm1_scales(s_gate: torch.Tensor, s_up: torch.Tensor, tn: int) -> torch.Tensor:
    """Per-channel scales packed to match :func:`pack_gmm1_weights`."""
    g, i = s_gate.shape
    half = tn // 2
    blocks = i // half
    return torch.stack([s_gate.reshape(g, blocks, half),
                        s_up.reshape(g, blocks, half)], dim=2).reshape(g, 2 * i)
