"""Flash linear attention: the gated delta rule (Qwen3-Next's GDN layers)."""

from sgl_kernel_npu_tpu_torch.ops.fla.chunk import (
    chunk_gated_delta_rule,
    chunk_gated_delta_rule_ref,
    chunk_gated_delta_rule_varlen,
    l2norm,
)
from sgl_kernel_npu_tpu_torch.ops.fla.gating import fused_gdn_gating
from sgl_kernel_npu_tpu_torch.ops.fla.norms import layernorm_gated
from sgl_kernel_npu_tpu_torch.ops.fla.recurrent import fused_sigmoid_gating_delta_rule_update

__all__ = [
    "chunk_gated_delta_rule",
    "chunk_gated_delta_rule_ref",
    "chunk_gated_delta_rule_varlen",
    "l2norm",
    "fused_gdn_gating",
    "layernorm_gated",
    "fused_sigmoid_gating_delta_rule_update",
]
