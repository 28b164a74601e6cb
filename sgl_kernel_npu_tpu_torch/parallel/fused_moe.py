"""Expert-parallel fused MoE bodies and the W8A8 expert-weight quant.

Counterpart of ``sgl_kernel_npu_tpu/parallel/fused_moe.py``:
:func:`fused_deep_moe_rank` (DeepSeek-V3's W8A8 MoE on one rank, the
unfused form of ``Buffer.fused_deep_moe``), :func:`fused_oai_moe_rank`
(GPT-OSS's, behind ``Buffer.fused_oai_moe``) and
:func:`quantize_expert_weights`.
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.activation import swiglu_oai_ref
from sgl_kernel_npu_tpu_torch.ops.grouped_matmul import (
    _row_groups,
    grouped_matmul,
    grouped_matmul_float,
    grouped_matmul_float_plain,
    grouped_matmul_plain,
    moe_pack_tn,
    pack_gmm1_scales,
    pack_gmm1_weights,
)
from sgl_kernel_npu_tpu_torch.ops.quant import (
    quant_per_channel,
    quant_per_token,
    quant_per_token_ref,
)
from sgl_kernel_npu_tpu_torch.parallel import ep_core
from sgl_kernel_npu_tpu_torch.utils.common import cdiv


def pack_width(n: int, pack_tn: int | None) -> int:
    """The gate / up pack width of a GMM1 weight of ``n = 2I`` columns:
    ``pack_tn`` (at most ``n``), else ``moe_pack_tn``'s (JAX's rule)."""
    return moe_pack_tn(n) if pack_tn is None else min(pack_tn, n)


def fused_deep_moe_rank(x, topk_idx, topk_weights, w1, w1_scale, w2, w2_scale, *, group,
                        num_experts: int, num_ranks: int, pair_capacity: int,
                        seg_capacity: int, gmm_tiles=None, pack_tn: int | None = None,
                        chunks: int = 1, use_int8_dispatch: bool = True,
                        backend: str = "xla", plain: bool = False):
    """DeepSeek-V3's W8A8 MoE on one rank (JAX's ``fused_deep_moe_rank``):
    ragged dispatch on ``backend`` (int8 per-token wire with
    ``use_int8_dispatch``, else x's dtype and the per-token quant after
    arrival) → ``grouped_matmul`` ``dequant_swiglu_quant`` (K8a: GMM1,
    dequant, SwiGLU, per-row requant) → ``dequant`` (GMM2, bf16) → combine
    on ``backend`` to bf16.  A gate / up packing narrower than 2I
    (``pack_tn``, :func:`pack_width`) runs GMM1 as K8a ``dequant_swiglu`` to
    f32, the per-row requant on K5 (``quant_per_token``: the same formula,
    true division), then K8a ``dequant``, as JAX's wide-N path.  ``chunks >
    1`` runs the token slices one after another with the capacities divided
    (JAX's overlap of slices is XLA's scheduling; here they run in order).
    ``gmm_tiles`` is the TPU's tile choice and is not taken.  ``plain`` runs
    the plain versions of K8a and K5.  Returns ``(combined [T, H] bf16,
    group_sizes [E_local], num_dropped [])``."""
    common = dict(group=group, num_experts=num_experts, num_ranks=num_ranks,
                  use_int8_dispatch=use_int8_dispatch, backend=backend, plain=plain)
    if chunks > 1:
        t = x.shape[0]
        if t % chunks:
            raise ValueError(f"token count {t} not divisible by chunks={chunks}")
        tc = t // chunks
        outs = [fused_deep_moe_rank(x[c * tc:(c + 1) * tc], topk_idx[c * tc:(c + 1) * tc],
                                    topk_weights[c * tc:(c + 1) * tc], w1, w1_scale, w2,
                                    w2_scale, pair_capacity=cdiv(pair_capacity, chunks),
                                    seg_capacity=cdiv(seg_capacity, chunks), pack_tn=pack_tn,
                                    **common)
                for c in range(chunks)]
        return (torch.cat([o[0] for o in outs]), sum(o[1] for o in outs),
                sum(o[2] for o in outs))
    d = ep_core.dispatch_ragged_core(
        x, topk_idx, group=group, num_experts=num_experts, num_ranks=num_ranks,
        pair_capacity=pair_capacity, seg_capacity=seg_capacity, use_int8=use_int8_dispatch,
        backend=backend)
    if use_int8_dispatch:
        xs, sx = d["recv_x_sorted"], d["recv_scales_sorted"]
    else:                           # the float wire: per-token quant after arrival
        xs, sx = quant_per_token_ref(d["recv_x_sorted"])
    gs = d["group_sizes"]
    gm = grouped_matmul_plain if plain else grouped_matmul
    tn = pack_width(w1.shape[-1], pack_tn)
    if tn == w1.shape[-1]:
        q2, s2 = gm(xs, w1, gs, sx, w1_scale, epilogue="dequant_swiglu_quant")
    else:
        h1 = gm(xs, w1, gs, sx, w1_scale, epilogue="dequant_swiglu", tn=tn,
                out_dtype=torch.float32)
        q2, s2 = (quant_per_token_ref if plain else quant_per_token)(h1)
    y = gm(q2, w2, gs, s2, w2_scale, epilogue="dequant")
    combined = ep_core.combine_ragged_core(
        y, topk_weights, d["handle"], group=group, num_ranks=num_ranks,
        num_local_experts=num_experts // num_ranks, seg_capacity=seg_capacity,
        out_dtype=torch.bfloat16, backend=backend)
    return combined, gs, d["num_dropped"]


def fused_oai_moe_rank(x, topk_idx, topk_weights, w_gate_up, b_gate_up, w_down, b_down, *,
                       group, num_experts: int, num_ranks: int, pair_capacity: int,
                       seg_capacity: int, alpha: float = 1.702, limit: float = 7.0,
                       plain: bool = False):
    """GPT-OSS's MoE on one rank: ragged dispatch at x's dtype → ``x @
    w_gate_up[e]`` (interleaved gate | up, ``[E_local, H, 2I]``) on K8a's
    ``none`` mode, plus the expert's bias in f32 → the clamped SwiGLU in f32
    (``swiglu_oai_ref``, as JAX), cast to x's dtype → ``@ w_down[e]`` plus its
    bias → combine at x's dtype.  Each sorted row's expert comes from a
    device search over the groups' prefix sum.  ``plain`` runs K8a's plain
    version.  Returns ``(combined [T, H], group_sizes [E_local],
    num_dropped [])``."""
    d = ep_core.dispatch_ragged_core(
        x, topk_idx, group=group, num_experts=num_experts, num_ranks=num_ranks,
        pair_capacity=pair_capacity, seg_capacity=seg_capacity, use_int8=False)
    xin, gs = d["recv_x_sorted"], d["group_sizes"]
    row_e = _row_groups(gs, xin.shape[0])                  # expert of each sorted row
    gmm = grouped_matmul_float_plain if plain else grouped_matmul_float
    gu = gmm(xin, w_gate_up, gs) + b_gate_up[row_e]
    act = swiglu_oai_ref(gu, alpha, limit).to(xin.dtype)
    y = gmm(act, w_down, gs) + b_down[row_e]
    combined = ep_core.combine_ragged_core(
        y.to(xin.dtype), topk_weights, d["handle"], group=group, num_ranks=num_ranks,
        num_local_experts=num_experts // num_ranks, seg_capacity=seg_capacity,
        out_dtype=x.dtype)
    return combined, gs, d["num_dropped"]


def quantize_expert_weights(w_gate, w_up, w_down, tn: int | None = None):
    """Float expert weights → the fused MoE's W8A8 layout.

    ``w_gate``/``w_up`` ``[E, H, I]``, ``w_down`` ``[E, I, H]`` → ``(w1 int8
    [E, H, 2I], w1_scale [E, 2I], w2 int8 [E, I, H], w2_scale [E, H])``, gate /
    up packed in slabs of width ``tn`` (``moe_pack_tn``'s rule by default: full
    width, what the ring GEMMs' SwiGLU pairs up), as JAX's."""
    tn = moe_pack_tn(2 * w_gate.shape[-1]) if tn is None else tn
    qg, sg = quant_per_channel(w_gate, dim=1)     # [E, K, N]: per output channel
    qu, su = quant_per_channel(w_up, dim=1)
    qd, sd = quant_per_channel(w_down, dim=1)
    return pack_gmm1_weights(qg, qu, tn), pack_gmm1_scales(sg, su, tn), qd, sd
