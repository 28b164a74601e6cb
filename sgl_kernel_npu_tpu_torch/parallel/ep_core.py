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
exchange as K15c and returns JAX's wait-cost and timeout statistics.
``validate`` adds JAX's checksum guard to :func:`dispatch_core`
(:func:`payload_checksum`; the expected sums on the group's collective).

Also JAX's placements (``rank_remap``: dead and rehomed ranks;
``expert_owner`` / ``expert_slot``: shared-expert ranks,
:func:`shared_expert_layout`), the TP all-gather of the low-latency layout
(:func:`dispatch_tp_allgather` / :func:`combine_tp_reduce`, on a TP process
group) and multi-round normal dispatch (:func:`dispatch_ragged_multi_round`
/ :func:`combine_ragged_multi_round`, on any transport where JAX's runs its
default one).  Where JAX scatters with a slot of -1, XLA wraps it to the
layout's last slot; the port drops it (a scratch row past the end), which
differs only where that last slot holds a row.
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
    inactive) by (destination rank, local slot) → every routing decision
    (JAX's ``make_routing_plan``: equal keys keep their order).
    ``pair_capacity`` bounds the rows sent to one rank, ``seg_capacity`` the
    rows landing in one (slot, source rank) segment; rows past either are
    dropped and counted.  ``rank_remap [R]`` maps each owner rank to the
    rank that serves it now, below 0 dead (its rows dropped and counted);
    ``expert_owner`` / ``expert_slot [E_total]`` place every expert id
    (ids past ``E_total`` inactive), ``num_local_slots`` slots a rank
    (:func:`shared_expert_layout`).  The tables are moved to ``topk_idx``'s
    device."""
    e_local = num_experts // num_ranks
    slots = num_local_slots or e_local
    dev = topk_idx.device
    t, k = topk_idx.shape
    n = t * k
    flat_e = topk_idx.reshape(n).long()
    # an id past the experts is inactive (JAX's sorts past every live key)
    n_ids = num_ranks * e_local if expert_owner is None else expert_owner.shape[0]
    valid = (flat_e >= 0) & (flat_e < n_ids)
    safe_e = torch.where(valid, flat_e, 0)
    if expert_owner is not None:
        dst = expert_owner.to(dev, torch.long)[safe_e]
        slot = expert_slot.to(dev, torch.long)[safe_e]
    else:
        dst, slot = safe_e // e_local, safe_e % e_local
    dead_drops = 0
    if rank_remap is not None:
        dst = rank_remap.to(dev, torch.long)[dst]
        dead_drops = (valid & (dst < 0)).sum()
        valid = valid & (dst >= 0)
    sentinel = num_ranks * slots
    key = torch.where(valid, dst * slots + slot, sentinel)
    sorted_key, order = torch.sort(key, stable=True)
    pos = torch.arange(n, device=dev)
    idx_in_expert = pos - torch.searchsorted(sorted_key, sorted_key)
    sorted_valid = sorted_key < sentinel
    sorted_dst = torch.where(sorted_valid, sorted_key // slots, num_ranks)
    idx_in_dst = pos - torch.searchsorted(sorted_dst, sorted_dst)
    ok = sorted_valid & (idx_in_dst < pair_capacity) & (idx_in_expert < seg_capacity)
    slot_id = torch.where(sorted_valid, sorted_key % slots, 0)
    dest_slot = torch.where(ok, slot_id * (num_ranks * seg_capacity) + my_rank * seg_capacity
                            + idx_in_expert, -1)
    gather = torch.where(ok, sorted_dst * (slots * seg_capacity) + slot_id * seg_capacity
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
        num_dropped=((sorted_valid & ~ok).sum() + dead_drops).to(torch.int32),
        send_pos=unsort(send_pos))


def shared_expert_layout(num_experts: int, num_ranks: int, num_shared_ranks: int,
                         device="cuda"):
    """Placement with dedicated shared-expert ranks (JAX's): the first
    ``num_shared_ranks`` ranks serve only the shared expert, the routed
    experts live on the others; virtual id ``num_experts + j`` addresses
    shared rank j's slot 0.  Returns ``(expert_owner [E + Ns], expert_slot
    [E + Ns], num_local_slots)`` (int32 tensors on ``device``: the card
    unless the caller asks for the CPU)."""
    moe_ranks = num_ranks - num_shared_ranks
    if num_shared_ranks >= num_ranks or num_experts % moe_ranks:
        raise ValueError(f"{num_experts} experts do not spread over the {moe_ranks} ranks left "
                         f"of {num_ranks} beside {num_shared_ranks} shared ones")
    e_local = num_experts // moe_ranks
    ids = torch.arange(num_experts, dtype=torch.int32, device=device)
    shared = torch.arange(num_shared_ranks, dtype=torch.int32, device=device)
    owner = torch.cat([num_shared_ranks + ids // e_local, shared])
    slot = torch.cat([ids % e_local, torch.zeros_like(shared)])
    return owner, slot, e_local


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


def payload_checksum(a: torch.Tensor, dims) -> torch.Tensor:
    """JAX's order-independent checksum: the wrapping int32 sum over
    ``dims`` of the raw bits (int8 widened, bf16 viewed as int16 and
    sign-extended, f32 viewed as int32, other dtypes cast).  The sum runs in
    int64 and is reduced modulo 2^32 back to int32, so it equals XLA's
    wrapping int32 sum bit for bit."""
    if a.dtype == torch.bfloat16:
        v = a.contiguous().view(torch.int16)
    elif a.dtype == torch.float32:
        v = a.contiguous().view(torch.int32)
    else:
        v = a
    s = v.to(torch.int64).sum(dim=dims)
    return ((s + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


class _Exchanged(NamedTuple):
    plan: RoutingPlan
    recv: torch.Tensor            # [R, C, H] rows received from each source rank
    recv_meta: torch.Tensor       # [R, C] their slots in the padded layout, -1 none
    counts: torch.Tensor          # [R, slots] rows received from (src, local slot)
    recv_scale: torch.Tensor | None   # [R, C] int8 wire scales
    stats: torch.Tensor | None = None  # [R, 6] the monitored payload exchange's
    validation_flags: torch.Tensor | None = None   # [R] checksum mismatch by source


def _dispatch_exchange(x, topk_idx, *, group, num_experts, num_ranks, pair_capacity,
                       seg_capacity, use_int8, backend="xla", monitor=False, validate=False,
                       placement=None) -> _Exchanged:
    size, me = group_info(group)
    if size != num_ranks:
        raise ValueError(f"num_ranks {num_ranks} but the group has {size} ranks")
    plan = make_routing_plan(topk_idx, num_experts=num_experts, num_ranks=num_ranks,
                             my_rank=me, pair_capacity=pair_capacity,
                             seg_capacity=seg_capacity, **(placement or {}))
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
        ex = _Exchanged(plan, recv, recv_meta, counts, a2a(send_scale) if use_int8 else None)
        live = None
    else:
        # the payload, then its slots (and scale bits) as one int32 blob, live
        # rows only; the per-expert counts on K15a (JAX's ep_core.py:298-336)
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
        ex = _Exchanged(plan, recv, recv_meta, counts, recv_scale, res[2] if monitor else None)
    if not validate:
        return ex
    # JAX's guard: each source's checksum of the rows it sent rides the
    # group's collective; the receiver sums what landed (on the ragged
    # transport the rows past a source's count zeroed first)
    expect = all_to_all(payload_checksum(send_x, (1, 2))[:, None], group)[:, 0]
    got = ex.recv if live is None else torch.where(live[..., None], ex.recv, 0)
    return ex._replace(validation_flags=(payload_checksum(got, (1, 2)) != expect).to(torch.int32))


def _check_transport(backend: str, monitor: bool = False) -> None:
    check_backend(backend)
    if monitor and backend != "pallas_ragged":
        raise ValueError(f"monitor needs the 'pallas_ragged' transport, not {backend!r}")


def _stat_columns(stats: torch.Tensor | None) -> dict:
    """JAX's statistics keys from a monitored exchange's ``stats [R, 6]``."""
    return {} if stats is None else {k: stats[:, i] for i, k in enumerate(STAT_KEYS)}


def dispatch_core(x, topk_idx, *, group, num_experts: int, num_ranks: int, pair_capacity: int,
                  seg_capacity: int, use_int8: bool, rank_remap=None, expert_owner=None,
                  expert_slot=None, num_local_slots: int | None = None, backend: str = "xla",
                  monitor: bool = False, validate: bool = False) -> dict:
    """Per-rank dispatch into JAX's padded receiver layout: ``recv_x
    [slots, R·seg, H]`` (``slots`` = ``num_local_slots`` or E_local; int8
    with ``use_int8``, then ``recv_scales [slots, R·seg]``), ``recv_count
    [slots]``, ``recv_count_matrix [R, slots]``, ``num_dropped`` and the
    combine ``handle``; with ``monitor`` also JAX's statistics keys
    (``wait_recv_cost_stats`` …), with ``validate`` ``validation_flags
    [R]`` (1 where the rows from a source do not sum to its checksum).  The
    placements (``rank_remap``, ``expert_owner`` …) are
    :func:`make_routing_plan`'s."""
    _check_transport(backend, monitor)
    t, hidden = x.shape
    e_local = num_local_slots or num_experts // num_ranks
    placement = dict(rank_remap=rank_remap, expert_owner=expert_owner, expert_slot=expert_slot,
                     num_local_slots=e_local)
    ex = _dispatch_exchange(x, topk_idx, group=group, num_experts=num_experts,
                            num_ranks=num_ranks, pair_capacity=pair_capacity,
                            seg_capacity=seg_capacity, use_int8=use_int8, backend=backend,
                            monitor=monitor, validate=validate, placement=placement)
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
    if validate:
        out["validation_flags"] = ex.validation_flags
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


def packed_to_sorted(recv_x, recv_scales, counts_matrix, rows: int | None = None):
    """The live rows of :func:`dispatch_core`'s packed layout ``recv_x
    [E_local, R·seg, H]`` grouped by local expert (within one by source rank),
    gathered on the device with no host sync → ``(x_sorted [rows, H],
    scales_sorted [rows] | None, tgt [E_local·R·seg])``: rows past the live
    ones zero, ``tgt`` each slot's sorted row (``rows`` for an empty slot).
    A segment's live rows are its first ``counts_matrix [R, E_local]``
    entries; ``rows`` (every slot by default) must hold them all."""
    e_local, slots, hidden = recv_x.shape
    seg = slots // counts_matrix.shape[0]
    n = e_local * slots
    rows = n if rows is None else rows
    dev = recv_x.device
    occ = (torch.arange(seg, device=dev)[None, None, :] < counts_matrix.T[:, :, None]).reshape(-1)
    tgt = torch.where(occ, torch.cumsum(occ.long(), 0) - 1, rows)
    src = torch.full((rows + 1,), n, dtype=torch.long, device=dev).scatter_(
        0, tgt, torch.arange(n, device=dev))[:rows]
    scales = None if recv_scales is None else _take(recv_scales.reshape(n), src)
    return _take(recv_x.reshape(n, hidden), src), scales, tgt


def sorted_to_packed(y_sorted: torch.Tensor, tgt: torch.Tensor, e_local: int) -> torch.Tensor:
    """Reverse of :func:`packed_to_sorted`: ``y_sorted [rows, H]`` back in
    the packed layout ``[E_local, R·seg, H]``, zero in the empty slots."""
    return _take(y_sorted, tgt).reshape(e_local, -1, y_sorted.shape[-1])


def sorted_row_expert(group_sizes: torch.Tensor, n_rows: int):
    """``(expert [n_rows], live [n_rows])`` of rows grouped by local expert
    in ``group_sizes`` order: each row's local expert (the last one past the
    live rows) and whether it is a live row."""
    ends = torch.cumsum(group_sizes, 0)
    rows = torch.arange(n_rows, device=group_sizes.device)
    expert = torch.searchsorted(ends, rows, right=True).clamp(max=group_sizes.numel() - 1)
    return expert, rows < ends[-1]


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


def _all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def dispatch_tp_allgather(recv_x: torch.Tensor, recv_scales: torch.Tensor | None,
                          counts_matrix: torch.Tensor, *, tp_group):
    """JAX's TP variant of the low-latency dispatch: the experts' weights
    split over the TP group, every TP rank gathers its peers' packed rows
    along the slot axis, in TP rank order.  ``recv_x [E_local, R·seg, H]``
    → ``[E_local, TP·R·seg, H]``, ``recv_scales`` likewise, ``counts_matrix
    [R, E_local]`` → ``[TP·R, E_local]``."""
    gathered = torch.cat(_all_gather(recv_x, tp_group), dim=1)
    counts = torch.cat(_all_gather(counts_matrix, tp_group), dim=0)
    scales = (torch.cat(_all_gather(recv_scales, tp_group), dim=1)
              if recv_scales is not None else None)
    return gathered, scales, counts


def combine_tp_reduce(y: torch.Tensor, *, tp_group, seg_total: int) -> torch.Tensor:
    """Reverse of :func:`dispatch_tp_allgather`: the TP ranks' partial expert
    outputs summed (an all-reduce in y's dtype, as JAX's ``psum``), then this
    TP rank's ``seg_total`` slots taken back for the EP combine."""
    y = y.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=tp_group)
    me = dist.get_rank(tp_group)
    return y[:, me * seg_total:(me + 1) * seg_total]


def dispatch_ragged_multi_round(x, topk_idx, *, rounds: int, group, num_experts: int,
                                num_ranks: int, pair_capacity: int, seg_capacity: int,
                                use_int8: bool, backend: str = "xla") -> dict:
    """Normal-mode dispatch of ``T / rounds`` tokens a round
    (:func:`dispatch_ragged_core` each, ``pair_capacity`` / ``seg_capacity``
    a round's), the received rows merged into one matrix sorted by local
    expert, experts major and rounds minor, so one grouped GEMM covers the
    batch (JAX's).  Returns :func:`dispatch_ragged_core`'s keys (the counts
    and drops summed over the rounds; ``recv_x_sorted [rounds·R·C, H]``)
    with ``round_handles`` and ``round_positions`` (each round's sorted rows'
    places in the merged matrix, its length for none).  ``backend`` is every
    round's transport (JAX's runs its default)."""
    t, hidden = x.shape
    if t % rounds:
        raise ValueError(f"{t} tokens do not split into {rounds} equal rounds")
    tr = t // rounds
    per = [dispatch_ragged_core(x[r * tr:(r + 1) * tr], topk_idx[r * tr:(r + 1) * tr],
                                group=group, num_experts=num_experts, num_ranks=num_ranks,
                                pair_capacity=pair_capacity, seg_capacity=seg_capacity,
                                use_int8=use_int8, backend=backend) for r in range(rounds)]
    cap_r = num_ranks * pair_capacity
    total = rounds * cap_r
    gs = torch.stack([p["group_sizes"] for p in per]).long()       # [rounds, E_local]
    group_sizes = gs.sum(0)
    seg_off = (torch.cumsum(group_sizes, 0) - group_sizes)[None] + torch.cumsum(gs, 0) - gs
    # JAX writes with mode="drop": a row past the end goes to a scratch row
    merged = x.new_zeros((total + 1, hidden), dtype=per[0]["recv_x_sorted"].dtype)
    merged_scale = x.new_zeros(total + 1, dtype=torch.float32) if use_int8 else None
    positions = []
    for r, p in enumerate(per):
        e_of_row, live = sorted_row_expert(gs[r], cap_r)
        pos = seg_off[r, e_of_row] + torch.arange(cap_r, device=x.device) - (
            torch.cumsum(gs[r], 0) - gs[r])[e_of_row]
        pos = torch.where(live, pos, total)
        merged.index_copy_(0, pos, p["recv_x_sorted"])
        if use_int8:
            merged_scale.index_copy_(0, pos, p["recv_scales_sorted"])
        positions.append(pos)
    out = {
        "recv_x_sorted": merged[:total],
        "group_sizes": group_sizes.to(torch.int32),
        "recv_count_matrix": sum(p["recv_count_matrix"] for p in per),
        "num_dropped": sum(p["num_dropped"] for p in per),
        "round_handles": [p["handle"] for p in per],
        "round_positions": positions,
    }
    if use_int8:
        out["recv_scales_sorted"] = merged_scale[:total]
    return out


def combine_ragged_multi_round(y_sorted, topk_weights, round_handles, round_positions, *,
                               group, num_ranks: int, num_local_experts: int,
                               seg_capacity: int, out_dtype=None, backend: str = "xla"):
    """Reverse of :func:`dispatch_ragged_multi_round`: each round's rows taken
    from the merged matrix, then that round's :func:`combine_ragged_core` on
    its tokens → ``[T, H]``."""
    t_r = topk_weights.shape[0] // len(round_handles)
    return torch.cat([
        combine_ragged_core(_take(y_sorted, pos), topk_weights[r * t_r:(r + 1) * t_r], h,
                            group=group, num_ranks=num_ranks,
                            num_local_experts=num_local_experts, seg_capacity=seg_capacity,
                            out_dtype=out_dtype, backend=backend)
        for r, (h, pos) in enumerate(zip(round_handles, round_positions))])
