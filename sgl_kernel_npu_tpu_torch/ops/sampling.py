"""Token log-probabilities for greedy decoding.

Counterpart of ``sgl_kernel_npu_tpu/ops/sampling.py:token_logprobs``; greedy
decoding is ``argmax`` (sampled decoding is not ported yet).
"""

from __future__ import annotations

import torch


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """log P(token) per row under the unfiltered distribution ``[B]``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(1, tokens.long()[:, None])[:, 0]
