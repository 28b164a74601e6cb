"""LoRA batched / segmented matvecs: BGMV, SGMV, SGEMMV, and the fused delta.

Counterpart of ``sgl_kernel_npu_tpu/ops/lora.py``:

- shrink: hidden → (num_slices × rank), scaled;
- expand: rank → hidden slices, accumulated into a base output at slice
  offsets;
- ``bgmv_*``: an adapter per token; ``sgmv_*``: an adapter per sequence plus
  the sequence lengths; ``sgemmv_*``: per-adapter ranks and scalings (the
  general case, which the others specialise).

Slices are packed compactly by the adapter's own rank: weight row / output
column ``c`` is slice ``c // r``, component ``c % r``.  These are plain torch
functions, as in JAX (jnp there), with one formulation: each token gathers
its adapter's weights.  (JAX's all-adapters route for small pools,
``_dense_all_ok``, computes the same function in another summation order.)

:func:`fused_lora_delta` launches K13a (``lora_pallas.bgmv_fused``) at every
size on the card, where JAX picks among its jnp chain, the kernel and the
gather chain by TPU heuristics; all compute one function, but JAX's chain
rounds the shrink to x's type and the kernel keeps it in f32.
:func:`fused_sgmv_delta` launches K13b (``lora_pallas.sgmv_fused``).
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops import lora_pallas


def token_lora_indices(weight_indices: torch.Tensor, seq_lengths: torch.Tensor,
                       total_tokens: int):
    """Per-token adapter index from per-sequence indices and lengths →
    ``(indices [T] int32, valid [T])``; rows past the sequences take the last
    sequence's index and are not valid."""
    ends = torch.cumsum(seq_lengths.long(), 0)
    rows = torch.arange(total_tokens, device=seq_lengths.device)
    seq = torch.searchsorted(ends, rows, right=True).clamp(0, seq_lengths.shape[0] - 1)
    return weight_indices.to(torch.int32)[seq], rows < ends[-1]


def _shrink(x, weights, tok_idx, valid, ranks, scalings, num_slices: int):
    """``out[t, :S·r] = scaling[a] · (x[t] @ weights[a, :S·r]ᵀ)`` in x's type;
    columns at or above ``num_slices · rank[a]`` and invalid rows are 0."""
    out_dim = weights.shape[1]
    idx = tok_idx.long()
    out = torch.einsum("th,trh->tr", x.float(), weights[idx].float())
    rank_t = ranks.long()[idx]
    col = torch.arange(out_dim, device=x.device)
    mask = (col[None, :] < num_slices * rank_t[:, None]) & valid[:, None]
    out = torch.where(mask, out * scalings.float()[idx][:, None], torch.zeros_like(out))
    return out.to(x.dtype)


def _expand(x, weights, tok_idx, valid, ranks, slice_offsets, base_output):
    """Per slice s: ``out[:, off_s:off_{s+1}] += x[:, s·r:(s+1)·r] @ B_sᵀ``
    (compact-by-rank input, the rank per token) → base_output's type."""
    t = x.shape[0]
    num_slices = len(slice_offsets) - 1
    max_rank = x.shape[1] // num_slices
    if base_output is None:
        base_output = torch.zeros((t, int(slice_offsets[-1])), dtype=x.dtype, device=x.device)
    out = base_output.to(torch.float32, copy=True)
    idx = tok_idx.long()
    w = weights[idx]                                      # [T, out_dim, maxR]
    rank_t = ranks.long()[idx]
    j = torch.arange(max_rank, device=x.device)[None, :]
    for s in range(num_slices):
        o0, o1 = int(slice_offsets[s]), int(slice_offsets[s + 1])
        cols = (s * rank_t[:, None] + j).clamp(0, x.shape[1] - 1)
        xs = torch.gather(x, 1, cols).float()
        xs = torch.where((j < rank_t[:, None]) & valid[:, None], xs, torch.zeros_like(xs))
        out[:, o0:o1] += torch.einsum("tr,tdr->td", xs, w[:, o0:o1, :].float())
    return out.to(base_output.dtype)


# -- BGMV: an adapter per token -------------------------------------------------

def bgmv_shrink(x, weights, weight_indices, scaling: float = 1.0):
    """x ``[T, H]`` × A ``[L, R, H]`` per token → ``[T, R]``, × scaling."""
    l, r = weights.shape[0], weights.shape[1]
    ranks = torch.full((l,), r, dtype=torch.int32, device=x.device)
    scalings = torch.full((l,), scaling, dtype=torch.float32, device=x.device)
    valid = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
    return _shrink(x, weights, weight_indices, valid, ranks, scalings, num_slices=1)


def bgmv_expand(x, weights, weight_indices, base_output=None, slice_offset: int = 0,
                slice_size: int | None = None, output_dim: int | None = None):
    """x ``[T, R]`` × B ``[L, D, R]`` per token → added into
    ``output[:, off:off + size]`` (in the output's type)."""
    t = x.shape[0]
    slice_size = slice_size if slice_size is not None else weights.shape[1]
    output_dim = output_dim if output_dim is not None else slice_offset + slice_size
    if base_output is None:
        base_output = torch.zeros((t, output_dim), dtype=x.dtype, device=x.device)
    w = weights[weight_indices.long()][:, :slice_size, :]
    delta = torch.einsum("tr,tdr->td", x.float(), w.float()).to(base_output.dtype)
    out = base_output.clone()
    out[:, slice_offset:slice_offset + slice_size] += delta
    return out


# -- SGMV / SGEMMV: an adapter per sequence ---------------------------------------

def sgmv_shrink(x, weights, weight_indices, seq_lengths, lora_ranks, lora_scalings,
                num_slices: int = 1):
    """Sequence-grouped shrink."""
    tok_idx, valid = token_lora_indices(weight_indices, seq_lengths, x.shape[0])
    return _shrink(x, weights, tok_idx, valid, lora_ranks, lora_scalings, num_slices)


def sgmv_expand(x, weights, weight_indices, seq_lengths, lora_ranks, slice_offsets,
                base_output=None):
    """Sequence-grouped expand."""
    tok_idx, valid = token_lora_indices(weight_indices, seq_lengths, x.shape[0])
    return _expand(x, weights, tok_idx, valid, lora_ranks, tuple(slice_offsets), base_output)


# SGEMMV is SGMV with per-adapter ranks and scalings, which the core takes.
sgemmv_shrink = sgmv_shrink
sgemmv_expand = sgmv_expand


# -- the fused kernels -------------------------------------------------------------

def fused_lora_delta(x, a, b, token_adapter, *, scaling: float = 1.0, bt=None):
    """Per-token LoRA delta ``scaling · (x @ A[i]ᵀ) @ B[i]ᵀ`` through K13a
    (``lora_pallas.bgmv_fused``): x ``[T, H]``, a ``[L, R, H]``, b ``[L, D,
    R]`` (or ``bt [L, R, D]``), token_adapter ``[T]`` → ``[T, D]`` in x's
    type."""
    return lora_pallas.bgmv_fused(x, a, b, token_adapter, bt=bt, scaling=scaling).to(x.dtype)


def fused_sgmv_delta(x, a, b, weight_indices, seq_lengths, lora_ranks, lora_scalings):
    """Per-sequence LoRA delta over packed varlen rows through K13b
    (``lora_pallas.sgmv_fused``) → ``[S, D]`` in x's type."""
    return lora_pallas.sgmv_fused(x, a, b, weight_indices, seq_lengths, lora_ranks,
                                  lora_scalings).to(x.dtype)
