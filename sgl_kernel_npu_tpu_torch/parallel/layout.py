"""Dispatch layout: per-rank and per-expert token counts of a local batch.

Counterpart of ``sgl_kernel_npu_tpu/parallel/layout.py``: a few one-hot
reductions, no kernel.
"""

from __future__ import annotations

import torch


def get_dispatch_layout(topk_idx: torch.Tensor, num_experts: int, num_ranks: int):
    """Routing statistics of ``topk_idx [T, K]`` (global expert ids, ``-1``
    for an inactive slot) → ``(num_tokens_per_rank [R], num_tokens_per_expert
    [E], is_token_in_rank [T, R] bool)``, counts int32."""
    if num_experts % num_ranks:
        raise ValueError(f"num_experts {num_experts} is not divisible by {num_ranks} ranks")
    valid = topk_idx >= 0
    safe = torch.where(valid, topk_idx, 0).long()
    onehot_e = torch.nn.functional.one_hot(safe, num_experts) * valid[..., None]
    per_expert = onehot_e.sum(dim=(0, 1)).to(torch.int32)
    onehot_r = torch.nn.functional.one_hot(safe // (num_experts // num_ranks),
                                           num_ranks) * valid[..., None]
    in_rank = onehot_r.sum(dim=1) > 0
    return in_rank.sum(dim=0).to(torch.int32), per_expert, in_rank
