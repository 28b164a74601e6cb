"""Batched token sampling (temperature / top-k / top-p / min-p), penalties,
token masks and log-probabilities.

Counterpart of ``sgl_kernel_npu_tpu/ops/sampling.py``: one function samples a
mixed batch with per-row parameters, greedy rows (temperature 0) taking the
argmax, the filters composing top-k → top-p → min-p (SGLang's order).  Plain
torch on the logits' device: a descending sort, a softmax and a cumsum of
``[B, V]`` per call, no host sync.  The draws are ``utils/prng``'s
Threefry-2x32, JAX's bits for the same ``(seed, step)``.

Top-p keeps a token while the mass before it is ``< top_p``; the f32 cumsum
of torch and of XLA round differently, so a token whose mass lies within a
few ulps of ``top_p`` can be kept by one and dropped by the other (likewise
min-p's ``prob < min_p · pmax`` and the Gumbel sums, whose ``log`` differs by
an ulp between libraries).
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.utils import prng

NEG_INF = float("-inf")


def _filter_logits(logits: torch.Tensor, top_k, top_p, min_p) -> torch.Tensor:
    """Mask ``logits [B, V]`` (f32) to the allowed set.  Row params: ``top_k
    <= 0`` disables top-k, ``top_p >= 1`` top-p, ``min_p <= 0`` min-p.  Top-p
    reads the sorted distribution before top-k, min-p the filtered row, as
    JAX's."""
    v = logits.shape[-1]
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    # top-k: threshold at the k-th largest logit
    k = torch.clamp(torch.where(top_k <= 0, v, top_k), 1, v).long()
    kth = sorted_l.gather(1, (k - 1)[:, None])
    logits = torch.where(logits < kth, NEG_INF, logits)
    # top-p (nucleus): a token survives iff the mass BEFORE it is < top_p
    probs_sorted = torch.softmax(sorted_l, dim=-1)
    mass_before = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
    keep_sorted = mass_before < torch.clamp(top_p, max=1.0)[:, None]
    thr = torch.where(keep_sorted, sorted_l, float("inf")).amin(dim=-1)
    logits = torch.where(logits < thr[:, None], NEG_INF, logits)
    # min-p: drop tokens whose prob < min_p x the max prob of the filtered row
    probs = torch.softmax(logits, dim=-1)
    pmax = probs.amax(dim=-1, keepdim=True)
    return torch.where(probs < min_p[:, None] * pmax, NEG_INF, logits)


def sample_tokens(logits: torch.Tensor, seeds: torch.Tensor, steps: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
                  min_p: torch.Tensor) -> torch.Tensor:
    """Per-row sampling over a mixed batch → int32 tokens ``[B]``;
    deterministic in ``(seed, step)``: ``logits [B, V]``, ``seeds`` /
    ``steps`` / ``top_k`` int ``[B]``, ``temperature`` (``<= 0``: greedy) /
    ``top_p`` / ``min_p`` f32 ``[B]``, all on the logits' device."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / torch.clamp(temperature, min=1e-6)[:, None]
    filtered = _filter_logits(scaled, top_k, top_p, min_p)
    key = prng.fold_in(prng.key(seeds), steps)
    sampled = prng.categorical(key, filtered).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, sampled)


# JAX's un-jitted golden entry: the same function here
sample_tokens_ref = sample_tokens


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """log P(token) per row under the unfiltered distribution ``[B]``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(1, tokens.long()[:, None])[:, 0]


def apply_token_mask(logits: torch.Tensor, allowed_mask: torch.Tensor) -> torch.Tensor:
    """Constrained decoding hook: keep only tokens where ``allowed_mask``
    (bool ``[V]`` or ``[B, V]``) is True."""
    return torch.where(allowed_mask, logits, NEG_INF)


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor, repetition: torch.Tensor,
                    presence: torch.Tensor, frequency: torch.Tensor) -> torch.Tensor:
    """Occurrence penalties before the filters (HF / OpenAI semantics):
    ``counts [B, V]`` (or ``[B, 1]`` zeros: a no-op) int occurrences,
    ``repetition`` (1 off: a seen logit divided by it when positive, else
    multiplied), ``presence`` (0 off: subtracted if seen), ``frequency`` (0
    off: subtracted x count), each f32 ``[B]``.  Out in the logits' dtype."""
    lf = logits.float()
    seen = counts > 0
    rep = repetition[:, None]
    lf = torch.where(seen, torch.where(lf > 0, lf / rep, lf * rep), lf)
    lf = lf - presence[:, None] * seen.float()
    lf = lf - frequency[:, None] * counts.float()
    return lf.to(logits.dtype)
