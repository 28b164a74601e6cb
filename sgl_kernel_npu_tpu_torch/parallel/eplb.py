"""EPLB: expert-parallel load balancing with redundant experts.

Counterpart of ``sgl_kernel_npu_tpu/parallel/eplb.py``.  A placement turns a
logical per-expert load into physical expert slots (hot experts get
replicas, instances bin-packed so every rank carries about the same load);
:func:`remap_topk` rewrites logical top-k ids into physical slot ids on the
device, round-robin over an expert's replicas by row; the physical problem
is a plain ``num_experts = num_ranks × slots_per_rank`` MoE, so every
``Buffer`` entry point serves it unchanged.  Placement is host numpy, as in
JAX; the remap tables ride the device.  No kernel: plain torch.
"""

from __future__ import annotations

import numpy as np
import torch


def make_placement(load, num_ranks: int, slots_per_rank: int) -> np.ndarray:
    """``placement [num_ranks · slots_per_rank]`` int32: the logical expert
    of each physical slot (-1 empty, never routed to), from ``load [E]``
    nonnegative per-expert token counts.  Spare slots go one by one to the
    expert with the largest load a replica; instances (share = load /
    replicas, descending) go to the least-loaded rank with a free slot."""
    load = np.asarray(load, np.float64)
    e = load.shape[0]
    total = num_ranks * slots_per_rank
    if total < e:
        raise ValueError(f"{total} physical slots < {e} experts")
    load = np.maximum(load, 1e-9)          # empty experts still need one home
    reps = np.ones(e, np.int64)
    for _ in range(total - e):
        reps[np.argmax(load / reps)] += 1
    inst = sorted(((load[x] / reps[x], x) for x in range(e) for _ in range(reps[x])),
                  reverse=True)
    placement = np.full((num_ranks, slots_per_rank), -1, np.int32)
    rank_load = np.zeros(num_ranks)
    rank_fill = np.zeros(num_ranks, np.int64)
    for share, x in inst:
        open_ranks = np.where(rank_fill < slots_per_rank)[0]
        r = open_ranks[np.argmin(rank_load[open_ranks])]
        placement[r, rank_fill[r]] = x
        rank_fill[r] += 1
        rank_load[r] += share
    return placement.reshape(-1)


def make_remap_tables(placement, num_experts: int, device="cuda"):
    """The tables of :func:`remap_topk`: ``(starts [E], counts [E], slots
    [n_instances])`` int32 on ``device``, the replica slots grouped by
    logical expert."""
    placement = np.asarray(placement)
    groups = [np.where(placement == x)[0] for x in range(num_experts)]
    counts = np.asarray([len(g) for g in groups], np.int32)
    if (counts == 0).any():
        raise ValueError("every logical expert needs at least one slot")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    slots = np.concatenate(groups).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (starts, counts, slots))


def remap_topk(topk_idx: torch.Tensor, starts, counts, slots) -> torch.Tensor:
    """Logical top-k ids ``[T, K]`` → physical slot ids (-1 passes through):
    replica ``(row + k) mod count`` of each expert."""
    t, k = topk_idx.shape
    e = topk_idx.to(torch.int32)
    valid = e >= 0
    safe = torch.where(valid, e, 0).long()
    row = (torch.arange(t, device=e.device)[:, None] + torch.arange(k, device=e.device)[None])
    phys = slots.long()[starts.long()[safe] + torch.remainder(row, counts.long()[safe])]
    return torch.where(valid, phys.to(torch.int32), e)


def physical_expert_weights(w: torch.Tensor, placement) -> torch.Tensor:
    """A per-logical-expert tensor ``[E, ...]`` gathered into physical-slot
    order ``[R·S, ...]``; empty slots copy expert 0 (never routed to)."""
    p = torch.from_numpy(np.maximum(np.asarray(placement), 0).astype(np.int64)).to(w.device)
    return w.index_select(0, p)


def logical_load(recv_count_matrix, placement, num_experts: int) -> np.ndarray:
    """A physical-slot receive-count matrix (``[src, R·S]`` or ``[R·S]``)
    folded back to the logical per-expert load of the next placement."""
    m = np.asarray(recv_count_matrix.cpu() if isinstance(recv_count_matrix, torch.Tensor)
                   else recv_count_matrix, np.float64)
    per_slot = m if m.ndim == 1 else m.sum(axis=0)
    out = np.zeros(num_experts)
    for slot, x in enumerate(np.asarray(placement)):
        if x >= 0:
            out[x] += per_slot[slot]
    return out
