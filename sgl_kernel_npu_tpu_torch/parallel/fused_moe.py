"""Expert-weight quantization for the W8A8 MoE.

Counterpart of ``sgl_kernel_npu_tpu/parallel/fused_moe.py:quantize_expert_weights``
(the expert-parallel fused MoE of that module is not ported yet).
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.grouped_matmul import (
    moe_pack_tn,
    pack_gmm1_scales,
    pack_gmm1_weights,
)
from sgl_kernel_npu_tpu_torch.ops.quant import INT8_MAX, saturate_int8


def _chan_quant(w: torch.Tensor):
    """Per-output-channel symmetric int8: ``w [E, K, N]`` → (int8, scales [E, N])."""
    s = torch.clamp_min(w.abs().amax(dim=1) / INT8_MAX, 1e-12)
    return saturate_int8(w / s[:, None, :]), s


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
            f"gate/up packing of width {tn} < {n} feeds the BlockSpec grouped GEMMs "
            "(K8), not ported yet (ROADMAP queue B)")
    qg, sg = _chan_quant(w_gate.float())
    qu, su = _chan_quant(w_up.float())
    qd, sd = _chan_quant(w_down.float())
    return pack_gmm1_weights(qg, qu, tn), pack_gmm1_scales(sg, su, tn), qd, sd
