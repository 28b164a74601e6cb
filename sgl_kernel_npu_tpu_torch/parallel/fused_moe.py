"""Expert-weight quantization for the W8A8 MoE.

Counterpart of ``sgl_kernel_npu_tpu/parallel/fused_moe.py:quantize_expert_weights``
(the expert-parallel fused MoE of that module is not ported yet).
"""

from __future__ import annotations

from sgl_kernel_npu_tpu_torch.ops.grouped_matmul import (
    moe_pack_tn,
    pack_gmm1_scales,
    pack_gmm1_weights,
)
from sgl_kernel_npu_tpu_torch.ops.quant import quant_per_channel


def quantize_expert_weights(w_gate, w_up, w_down):
    """Float expert weights → the W8A8 layout of the ring GEMMs.

    ``w_gate``/``w_up`` ``[E, H, I]``, ``w_down`` ``[E, I, H]`` → ``(w1 int8
    [E, H, 2I], w1_scale [E, 2I], w2 int8 [E, I, H], w2_scale [E, H])``, gate ‖
    up packed at full width (the JAX package's ``moe_pack_tn`` rule), which is
    what the ring GEMMs' SwiGLU pairs up."""
    n = 2 * w_gate.shape[-1]
    tn = moe_pack_tn(n)
    if tn != n:
        raise NotImplementedError(
            f"gate/up packing of width {tn} < {n} feeds grouped_matmul's float "
            "dequant_swiglu epilogue (K8a), not ported yet (ROADMAP queue B)")
    qg, sg = quant_per_channel(w_gate, dim=1)     # [E, K, N]: per output channel
    qu, su = quant_per_channel(w_up, dim=1)
    qd, sd = quant_per_channel(w_down, dim=1)
    return pack_gmm1_weights(qg, qu, tn), pack_gmm1_scales(sg, su, tn), qd, sd
