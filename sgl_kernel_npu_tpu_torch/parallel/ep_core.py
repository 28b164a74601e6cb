"""Expert-parallel dispatch / combine core (per-rank functions).

Counterpart of ``sgl_kernel_npu_tpu/parallel/ep_core.py`` on its default
transport.  Every function takes this rank's rows and a ``torch.distributed``
process group, where JAX's take the per-rank view inside ``shard_map`` over a
mesh axis; ``lax.all_to_all(tiled=True)`` over the axis becomes
:func:`all_to_all` over the group (``all_to_all_single``: NCCL on the card,
gloo on the CPU), differentiable for training.  Shapes are the JAX package's
static worst cases: no host sync on the serving path.

One stable sort of the (token, k) pairs by (destination rank, local expert)
makes every routing decision (:func:`make_routing_plan`, JAX's, ties in
order).  Each rank sends ``[R, C, H]`` rows (``C = pair_capacity``) and an
int slot per row.

- :func:`dispatch_core` / :func:`combine_core` use JAX's receiver layout,
  ``[E_local, R·seg, H]`` with a segment per (expert, source rank).
- :func:`dispatch_ragged_core` / :func:`combine_ragged_core` (the normal
  mode: rows sorted by local expert for the grouped GEMMs) never build that
  layout.  JAX scatters the received rows into it and then compacts it; the
  port composes the two index maps (received row → padded slot → sorted
  row), so the sorted rows are JAX's.  Its combine returns each received
  row's expert output to the same ``[R, C]`` slot it came in, and the source
  gathers its (token, k) pairs from their (destination rank, send slot).  At
  DeepSeek-V3's training batch the padded layout would be 3.8 GB a direction;
  the exchanged rows are 0.12 GB.  The handle's ``gather_idx`` and
  ``recv_sort_order`` index the exchange layout accordingly (ROADMAP §C).

Transports (``backend``), as JAX's ``_make_a2a``: ``"xla"`` is the
collective of the group; ``"pallas"`` runs every exchange on the window
all-to-all K15a (:func:`~sgl_kernel_npu_tpu_torch.parallel.pallas_a2a.pallas_all_to_all`);
``"pallas_ragged"`` moves the dispatched rows and their slot / scale blob on
the ragged window all-to-all K15b (live rows only, after a count phase), the
per-expert counts on K15a, and on the combine's return hop again only the
live rows (K15b).  ``monitor`` (``"pallas_ragged"`` only) runs the payload
exchange as K15c and returns JAX's wait-cost and timeout statistics.  The
validated exchange, the TP all-gather, multi-round dispatch, elastic rank
remaps and shared-expert ranks are not ported (ROADMAP item 16) and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from sgl_kernel_npu_tpu_torch.config import check_backend
from sgl_kernel_npu_tpu_torch.ops.quant import wire_quant
from sgl_kernel_npu_tpu_torch.parallel.pallas_a2a import (
    group_info,
    pallas_all_to_all,
    pallas_ragged_all_to_all,
)

STAT_KEYS = ("wait_recv_cost_stats", "timeout_flags", "abort_observed",
             "payload_wait_cost_stats", "payload_timeout_flags")   # stats columns 0-4


def _unported(what: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP item 16)")


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    all_to_all.calls += 1
    return out


class _AllToAll(torch.autograd.Function):
    """The exchange of equal blocks is its own transpose: the gradient of the
    block a rank received goes back to the rank that sent it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)`` over
    the group: block ``r`` of dim 0 goes to rank ``r``, block ``s`` of the
    result came from rank ``s``.  Differentiable.  ``all_to_all.calls``
    counts the exchanges (backward ones too)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _AllToAll.apply(x, group)
    return _exchange(x, group)


all_to_all.calls = 0


def _make_a2a(group, backend: str):
    """The equal-block exchange of a transport, as JAX's: the group's
    collective (:func:`all_to_all`) or, for both one-sided transports, the
    window all-to-all K15a."""
    if backend in ("pallas", "pallas_ragged"):
        return lambda x: pallas_all_to_all(x.contiguous(), group=group)
    check_backend(backend)
    return lambda x: all_to_all(x, group)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

class RoutingPlan(NamedTuple):
    """Source-side routing decisions for one batch, JAX's fields; every
    ``[T*K]`` field indexed by the flattened (token, k) pairs in order."""

    dst_rank: torch.Tensor         # [T*K] destination rank (R = dropped)
    send_slot: torch.Tensor        # [T*K] row in the per-destination send block
    dest_slot: torch.Tensor        # [T*K] slot in the receiver's padded layout, -1 invalid
    gather_idx: torch.Tensor       # [T*K] index into combine_core's returned rows
    ok: torch.Tensor               # [T*K] bool: survives routing and capacity
    src_token: torch.Tensor        # [T*K] local token id
    counts_per_expert: torch.Tensor  # [E] rows this rank sends to each global expert
    num_dropped: torch.Tensor      # [] capacity-overflow drops
    send_pos: torch.Tensor         # [T*K] row in the compact (dst, slot)-sorted layout


class DispatchHandle(NamedTuple):
    """What a dispatch hands its combine.  From :func:`dispatch_core`,
    ``gather_idx`` indexes the returned padded layout ``[R, E_local, seg]``
    (JAX's); from :func:`dispatch_ragged_core` it indexes the returned
    exchange rows ``[R, C]``, and ``recv_sort_order`` maps each received row
    ``[R·C]`` to its sorted row (``R·C`` for none)."""

    gather_idx: torch.Tensor           # [T, K]
    ok: torch.Tensor                   # [T, K]
    recv_sort_order: torch.Tensor | None
    recv_valid_count: torch.Tensor | None
    sent_counts: torch.Tensor | None = None   # [R, E_local] rows sent to (dst, e)
    recv_counts: torch.Tensor | None = None   # [R, E_local] rows received from (src, e)


def make_routing_plan(topk_idx: torch.Tensor, *, num_experts: int, num_ranks: int,
                      my_rank: int, pair_capacity: int, seg_capacity: int, rank_remap=None,
                      expert_owner=None, expert_slot=None,
                      num_local_slots: int | None = None) -> RoutingPlan:
    """One stable sort of ``topk_idx [T, K]`` (global expert ids, -1
    inactive) by (destination rank, local expert) → every routing decision
    (JAX's ``make_routing_plan``: equal keys keep their order).
    ``pair_capacity`` bounds the rows sent to one rank, ``seg_capacity`` the
    rows landing in one (expert, source rank) segment; rows past either are
    dropped and counted.  Elastic remaps and shared-expert placements
    (``rank_remap``, ``expert_owner`` / ``expert_slot``) raise."""
    e_local = num_experts // num_ranks
    if (rank_remap is not None or expert_owner is not None or expert_slot is not None
            or num_local_slots not in (None, e_local)):
        _unported("make_routing_plan's rank_remap / expert_owner placements (elastic and "
                  "shared-expert ranks)")
    dev = topk_idx.device
    t, k = topk_idx.shape
    n = t * k
    flat_e = topk_idx.reshape(n).long()
    valid = flat_e >= 0
    safe_e = torch.where(valid, flat_e, 0)
    sentinel = num_ranks * e_local
    key = torch.where(valid, safe_e, sentinel)       # dst * slots + slot = the expert id
    sorted_key, order = torch.sort(key, stable=True)
    pos = torch.arange(n, device=dev)
    idx_in_expert = pos - torch.searchsorted(sorted_key, sorted_key)
    sorted_valid = sorted_key < sentinel
    sorted_dst = torch.where(sorted_valid, sorted_key // e_local, num_ranks)
    idx_in_dst = pos - torch.searchsorted(sorted_dst, sorted_dst)
    ok = sorted_valid & (idx_in_dst < pair_capacity) & (idx_in_expert < seg_capacity)
    slot_id = torch.where(sorted_valid, sorted_key % e_local, 0)
    dest_slot = torch.where(ok, slot_id * (num_ranks * seg_capacity) + my_rank * seg_capacity
                            + idx_in_expert, -1)
    gather = torch.where(ok, sorted_dst * (e_local * seg_capacity) + slot_id * seg_capacity
                         + idx_in_expert, 0)
    send_pos = torch.where(ok, torch.cumsum(ok.long(), 0) - 1, n)
    counts = torch.zeros(sentinel + 1, dtype=torch.int32, device=dev).scatter_add_(
        0, sorted_key, ok.to(torch.int32))[:sentinel]

    def unsort(v):
        out = torch.empty_like(v)
        out[order] = v
        return out

    return RoutingPlan(
        dst_rank=unsort(sorted_dst), send_slot=unsort(idx_in_dst),
        dest_slot=unsort(dest_slot), gather_idx=unsort(gather), ok=unsort(ok),
        src_token=pos // k, counts_per_expert=counts,
        num_dropped=(sorted_valid & ~ok).sum().to(torch.int32), send_pos=unsort(send_pos))


def _send_sources(plan: RoutingPlan, num_ranks: int, pair_capacity: int) -> torch.Tensor:
    """``[R·C]``: the (token, k) pair each send slot carries (``T·K`` for an
    empty slot)."""
    n = plan.ok.numel()
    slots = num_ranks * pair_capacity
    flat = torch.where(plan.ok, plan.dst_rank * pair_capacity + plan.send_slot, slots)
    src = torch.full((slots + 1,), n, dtype=torch.long, device=flat.device)
    return src.scatter_(0, flat, torch.arange(n, device=flat.device))[:slots]


def _take(values: torch.Tensor, idx: torch.Tensor, fill=0) -> torch.Tensor:
    """``values[idx]`` along dim 0, ``fill`` where ``idx == len(values)``."""
    pad = torch.full((1,) + values.shape[1:], fill, dtype=values.dtype, device=values.device)
    return torch.cat([values, pad])[idx]


def _pack_send_buffers(plan: RoutingPlan, payload: torch.Tensor, num_ranks: int,
                       pair_capacity: int, sources: torch.Tensor | None = None) -> torch.Tensor:
    """``[R, C, ...]`` send blocks: each slot holds its pair's token row of
    ``payload`` (zeros for an empty slot)."""
    if sources is None:
        sources = _send_sources(plan, num_ranks, pair_capacity)
    tok = _take(plan.src_token, sources, payload.shape[0])
    return _take(payload, tok).reshape((num_ranks, pair_capacity) + payload.shape[1:])


class _Exchanged(NamedTuple):
    plan: RoutingPlan
    recv: torch.Tensor            # [R, C, H] rows received from each source rank
    recv_meta: torch.Tensor       # [R, C] their slots in the padded layout, -1 none
    counts: torch.Tensor          # [R, E_local] rows received from (src, local expert)
    recv_scale: torch.Tensor | None   # [R, C] int8 wire scales
    stats: torch.Tensor | None = None  # [R, 6] the monitored payload exchange's


def _dispatch_exchange(x, topk_idx, *, group, num_experts, num_ranks, pair_capacity,
                       seg_capacity, use_int8, backend="xla", monitor=False) -> _Exchanged:
    size, me = group_info(group)
    if size != num_ranks:
        raise ValueError(f"num_ranks {num_ranks} but the group has {size} ranks")
    plan = make_routing_plan(topk_idx, num_experts=num_experts, num_ranks=num_ranks,
                             my_rank=me, pair_capacity=pair_capacity,
                             seg_capacity=seg_capacity)
    payload, scale = wire_quant(x) if use_int8 else (x, None)
    src = _send_sources(plan, num_ranks, pair_capacity)
    send_x = _pack_send_buffers(plan, payload, num_ranks, pair_capacity, src)
    send_meta = _take(plan.dest_slot, src, -1).reshape(num_ranks, pair_capacity).to(torch.int32)
    send_counts = plan.counts_per_expert.reshape(num_ranks, -1)
    send_scale = (_pack_send_buffers(plan, scale, num_ranks, pair_capacity, src)
                  if use_int8 else None)
    if backend != "pallas_ragged":
        a2a = _make_a2a(group, backend)
        counts = a2a(send_counts)
        recv, recv_meta = a2a(send_x), a2a(send_meta)
        return _Exchanged(plan, recv, recv_meta, counts,
                          a2a(send_scale) if use_int8 else None)
    # the payload, then its slots (and scale bits) as one int32 blob, live rows
    # only; the per-expert counts on K15a (JAX's ep_core.py:298-336)
    rows_to_dst = send_counts.sum(-1, dtype=torch.int32)
    res = pallas_ragged_all_to_all(send_x, rows_to_dst, group=group, monitor=monitor)
    recv, rcnt = res[0], res[1]
    blob = send_meta[:, :, None]
    if use_int8:
        blob = torch.cat([blob, send_scale.float().view(torch.int32)[:, :, None]], dim=-1)
    recv_blob, _ = pallas_ragged_all_to_all(blob, rows_to_dst, group=group)
    # rows past rcnt[s] are undefined window memory: their slots must not scatter
    live = torch.arange(pair_capacity, device=x.device)[None, :] < rcnt[:, None]
    recv_meta = torch.where(live, recv_blob[:, :, 0], -1)
    recv_scale = recv_blob[:, :, 1].contiguous().view(torch.float32) if use_int8 else None
    counts = pallas_all_to_all(send_counts.contiguous(), group=group)
    return _Exchanged(plan, recv, recv_meta, counts, recv_scale,
                      res[2] if monitor else None)


def _check_transport(backend: str, monitor: bool = False, validate: bool = False) -> None:
    check_backend(backend)
    if validate:
        _unported("the validated exchange (validate_comm)")
    if monitor and backend != "pallas_ragged":
        raise ValueError(f"monitor needs the 'pallas_ragged' transport, not {backend!r}")


def _stat_columns(stats: torch.Tensor | None) -> dict:
    """JAX's statistics keys from a monitored exchange's ``stats [R, 6]``."""
    return {} if stats is None else {k: stats[:, i] for i, k in enumerate(STAT_KEYS)}


def dispatch_core(x, topk_idx, *, group, num_experts: int, num_ranks: int, pair_capacity: int,
                  seg_capacity: int, use_int8: bool, backend: str = "xla",
                  monitor: bool = False, validate: bool = False) -> dict:
    """Per-rank dispatch into JAX's padded receiver layout: ``recv_x
    [E_local, R·seg, H]`` (int8 with ``use_int8``, then ``recv_scales
    [E_local, R·seg]``), ``recv_count [E_local]``, ``recv_count_matrix [R,
    E_local]``, ``num_dropped`` and the combine ``handle``; with ``monitor``
    also JAX's statistics keys (``wait_recv_cost_stats`` …)."""
    _check_transport(backend, monitor, validate)
    t, hidden = x.shape
    e_local = num_experts // num_ranks
    ex = _dispatch_exchange(x, topk_idx, group=group, num_experts=num_experts,
                            num_ranks=num_ranks, pair_capacity=pair_capacity,
                            seg_capacity=seg_capacity, use_int8=use_int8, backend=backend,
                            monitor=monitor)
    n_slots = e_local * num_ranks * seg_capacity
    meta = ex.recv_meta.reshape(-1).long()
    meta = torch.where(meta >= 0, meta, n_slots)

    def packed(rows, *shape):
        out = torch.zeros((n_slots + 1,) + rows.shape[1:], dtype=rows.dtype, device=rows.device)
        return out.index_copy_(0, meta, rows)[:n_slots].reshape(*shape)

    plan = ex.plan
    out = {
        "recv_x": packed(ex.recv.reshape(-1, hidden), e_local, num_ranks * seg_capacity, hidden),
        "recv_count": ex.counts.sum(0, dtype=torch.int32),
        "recv_count_matrix": ex.counts,
        "num_dropped": plan.num_dropped,
        "handle": DispatchHandle(
            gather_idx=plan.gather_idx.reshape(t, -1), ok=plan.ok.reshape(t, -1),
            recv_sort_order=None, recv_valid_count=None,
            sent_counts=plan.counts_per_expert.reshape(num_ranks, e_local),
            recv_counts=ex.counts),
        **_stat_columns(ex.stats),
    }
    if use_int8:
        out["recv_scales"] = packed(ex.recv_scale.reshape(-1), e_local, num_ranks * seg_capacity)
    return out


def _weighted_sum(rows: torch.Tensor, topk_weights, handle: DispatchHandle, out_dtype):
    """``Σ_k w[t, k] · rows[gather_idx[t, k]]`` in f32 over the surviving
    pairs, then ``out_dtype``.  A dropped pair's row is masked, not weighed
    by 0: after a ragged return it may be undefined window memory."""
    t, k = handle.gather_idx.shape
    picked = rows[handle.gather_idx.reshape(-1)].reshape(t, k, -1).float()
    picked = torch.where(handle.ok[..., None], picked, 0.0)
    w = torch.where(handle.ok, topk_weights, 0.0).float()
    return (picked * w[..., None]).sum(dim=1).to(out_dtype)


def _ragged_return(rows: torch.Tensor, counts: torch.Tensor, group, monitor: bool = False):
    """The live-rows return hop: ``rows [R, C, ...]`` whose first
    ``counts[d]`` rows go back to rank d, on K15b (K15c with ``monitor``)."""
    res = pallas_ragged_all_to_all(rows.contiguous(), counts.to(torch.int32), group=group,
                                   monitor=monitor)
    return res[0], (res[2] if monitor else None)


def combine_core(y, topk_weights, handle: DispatchHandle, *, group, num_ranks: int,
                 seg_capacity: int, out_dtype=None, backend: str = "xla",
                 use_int8_comm: bool = False, monitor: bool = False):
    """Per-rank combine of expert outputs in :func:`dispatch_core`'s padded
    layout ``y [E_local, R·seg, H]`` → ``[T, H]`` = Σ_k w[t, k] ·
    expert_out(t, k) in f32, then ``out_dtype`` (y's by default).
    ``use_int8_comm`` returns the rows int8 per row with their scales.
    ``"pallas_ragged"`` compacts each destination's live rows (expert, then
    slot) by ``handle.recv_counts``, moves them on K15b and re-expands them
    at the source by ``handle.sent_counts`` (JAX's ep_core.py:442-498);
    with ``monitor`` it returns ``(combined, stats [R, 6])``."""
    _check_transport(backend, monitor)
    e_local, slots, hidden = y.shape
    if slots != num_ranks * seg_capacity:
        raise ValueError(f"y has {slots} slots an expert, want {num_ranks} x {seg_capacity}")
    by_rank = y.reshape(e_local, num_ranks, seg_capacity, hidden).transpose(0, 1)
    stats = None
    if backend == "pallas_ragged":
        cap = e_local * seg_capacity
        seg_pos = torch.arange(seg_capacity, device=y.device)
        occ = (seg_pos[None, None, :] < handle.recv_counts[:, :, None]).reshape(num_ranks, cap)
        tgt = torch.where(occ, torch.cumsum(occ.long(), 1) - 1, cap)
        rows = by_rank.reshape(num_ranks, cap, hidden)
        if use_int8_comm:
            rows, row_scale = wire_quant(rows.contiguous())
        send = torch.zeros((num_ranks, cap + 1, hidden), dtype=rows.dtype, device=y.device)
        send.scatter_(1, tgt[..., None].expand(-1, -1, hidden), rows)
        back_counts = handle.recv_counts.sum(1, dtype=torch.int32)
        recv, stats = _ragged_return(send[:, :cap], back_counts, group, monitor)
        if use_int8_comm:
            sc = torch.zeros((num_ranks, cap + 1), dtype=torch.float32, device=y.device)
            sc.scatter_(1, tgt, row_scale)
            rs, _ = _ragged_return(sc[:, :cap, None], back_counts, group)
            recv = recv.float() * rs
        # expand: the block from d holds my rows in (expert, slot) order
        occ2 = (seg_pos[None, None, :] < handle.sent_counts[:, :, None]).reshape(num_ranks, cap)
        src_pos = torch.where(occ2, torch.cumsum(occ2.long(), 1) - 1, cap)
        recvp = torch.cat([recv, recv.new_zeros((num_ranks, 1, hidden))], dim=1)
        back = torch.gather(recvp, 1, src_pos[..., None].expand(-1, -1, hidden))
    elif use_int8_comm:
        a2a = _make_a2a(group, backend)
        q, scale = wire_quant(by_rank.contiguous())
        back = a2a(q).float() * a2a(scale[..., None])
    else:
        back = _make_a2a(group, backend)(by_rank.contiguous())
    out = _weighted_sum(back.reshape(-1, hidden), topk_weights, handle, out_dtype or y.dtype)
    return (out, stats) if monitor else out


def dispatch_ragged_core(x, topk_idx, *, group, num_experts: int, num_ranks: int,
                         pair_capacity: int, seg_capacity: int, use_int8: bool,
                         backend: str = "xla", monitor: bool = False) -> dict:
    """Normal-mode (prefill) dispatch: ``recv_x_sorted [R·C, H]``, the
    received rows grouped by local expert (within an expert by source rank,
    then in the source's order; rows past the total zero), ``group_sizes
    [E_local]``, ``recv_count_matrix``, ``num_dropped``, the ``handle`` and,
    with ``use_int8``, ``recv_scales_sorted [R·C]``; with ``monitor``
    JAX's statistics keys.  The rows are JAX's; the padded layout is never
    built (the module docstring)."""
    _check_transport(backend, monitor)
    t, hidden = x.shape
    ex = _dispatch_exchange(x, topk_idx, group=group, num_experts=num_experts,
                            num_ranks=num_ranks, pair_capacity=pair_capacity,
                            seg_capacity=seg_capacity, use_int8=use_int8, backend=backend,
                            monitor=monitor)
    plan, counts = ex.plan, ex.counts
    group_sizes = counts.sum(0, dtype=torch.int32)
    expert_off = (torch.cumsum(group_sizes, 0) - group_sizes).long()
    src_off = (torch.cumsum(counts, 0) - counts).long()       # rows of expert e from ranks < s
    meta = ex.recv_meta.reshape(-1).long()
    live = meta >= 0
    m = torch.where(live, meta, 0)
    e, s, i = m // (num_ranks * seg_capacity), (m // seg_capacity) % num_ranks, m % seg_capacity
    cap = num_ranks * pair_capacity
    row = torch.where(live, expert_off[e] + src_off[s, e] + i, cap)   # received row → sorted row
    slot = torch.full((cap + 1,), cap, dtype=torch.long, device=row.device)
    slot = slot.scatter_(0, row, torch.arange(cap, device=row.device))[:cap]
    out = {
        "recv_x_sorted": _take(ex.recv.reshape(cap, hidden), slot),
        "group_sizes": group_sizes,
        "recv_count_matrix": counts,
        "num_dropped": plan.num_dropped,
        "handle": DispatchHandle(
            gather_idx=torch.where(plan.ok, plan.dst_rank * pair_capacity + plan.send_slot,
                                   0).reshape(t, -1),
            ok=plan.ok.reshape(t, -1), recv_sort_order=row,
            recv_valid_count=group_sizes.sum(dtype=torch.int32),
            sent_counts=plan.counts_per_expert.reshape(num_ranks, -1), recv_counts=counts),
        **_stat_columns(ex.stats),
    }
    if use_int8:
        out["recv_scales_sorted"] = _take(ex.recv_scale.reshape(cap), slot)
    return out


def combine_ragged_core(y_sorted, topk_weights, handle: DispatchHandle, *, group,
                        num_ranks: int, num_local_experts: int, seg_capacity: int,
                        out_dtype=None, backend: str = "xla"):
    """Normal-mode combine: each received row's expert output (``y_sorted``
    in :func:`dispatch_ragged_core`'s order) goes back to the slot it came in
    on, and each source weighs its (token, k) pairs: ``[T, H]`` in f32, then
    ``out_dtype`` (y's by default).  On ``"pallas_ragged"`` only the live
    rows go back (K15b): the rows received from each source are a prefix of
    its block."""
    _check_transport(backend)
    cap, hidden = y_sorted.shape
    rows = _take(y_sorted, handle.recv_sort_order.clamp(max=cap)).reshape(num_ranks, -1, hidden)
    if backend == "pallas_ragged":
        back, _ = _ragged_return(rows, handle.recv_counts.sum(1, dtype=torch.int32), group)
    else:
        back = _make_a2a(group, backend)(rows)
    return _weighted_sum(back.reshape(-1, hidden), topk_weights, handle,
                         out_dtype or y_sorted.dtype)


def dispatch_tp_allgather(*args, **kwargs):
    """JAX's TP all-gather of the low-latency dispatch: not ported."""
    _unported("dispatch_tp_allgather (the TP all-gather of low-latency dispatch)")


def dispatch_ragged_multi_round(*args, **kwargs):
    """JAX's multi-round normal dispatch: not ported."""
    _unported("dispatch_ragged_multi_round (multi-round dispatch)")
