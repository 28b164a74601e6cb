"""Zero experts (identity experts) for EPLB.

Counterpart of ``sgl_kernel_npu_tpu/ops/moe.py``: expert ids at or past
``num_experts`` are "zero experts" that act as the identity.  Their weighted
input is computed locally and they leave the routing (weight 0, id
``identity_mask_value``), so the expert-parallel dispatch sees only real
experts; a token routed to zero experts alone keeps slot 0 on expert 0 with
weight 0, which keeps the dispatch well formed.
"""

from __future__ import annotations

import torch


def zero_experts_compute_identity(expert_indices: torch.Tensor, expert_scales: torch.Tensor,
                                  num_experts: int, zero_expert_type: str,
                                  hidden_states: torch.Tensor, identity_mask_value: int = 0):
    """``expert_indices [S, K]``, ``expert_scales [S, K]``, ``hidden_states
    [S, D]`` → ``(zero_result [S, D], new_indices, new_scales)``:
    ``zero_result`` is each row times the summed weight of its zero experts
    (in f32, then the states' dtype)."""
    if zero_expert_type != "identity":
        raise ValueError(f"zero_expert_type {zero_expert_type!r}: only 'identity' is defined")
    is_zero = expert_indices >= num_experts
    zero_scale = torch.where(is_zero, expert_scales, 0.0).sum(dim=1)
    zero_result = (hidden_states.float() * zero_scale[:, None].float()).to(hidden_states.dtype)
    new_scales = torch.where(is_zero, 0.0, expert_scales).to(expert_scales.dtype)
    new_indices = torch.where(is_zero, identity_mask_value, expert_indices)
    first_col = torch.arange(expert_indices.shape[1], device=expert_indices.device) == 0
    all_zero = is_zero.all(dim=1)
    new_indices = torch.where(all_zero[:, None] & first_col[None, :], 0,
                              new_indices).to(expert_indices.dtype)
    return zero_result, new_indices, new_scales
