"""Two-tier (layered) expert-parallel dispatch / combine over node and ICI groups.

Counterpart of ``sgl_kernel_npu_tpu/parallel/layered.py`` (the reference's
A2 layered mode).  A token crosses the slow inter-node hop once a (token,
destination node), however many of its top-k experts live on that node,
lands on the proxy rank (the rank of that node with the sender's intra-node
index) and fans out to its expert ranks over the fast intra-node hop.  The
combine reverses the route and reduces the k expert outputs of a node at
the proxy, so the slow hop carries one row a (token, node) both ways.

JAX's two mesh axes are two ``torch.distributed`` process groups here: the
node group (this rank and its mirrors on the other nodes, ranked by node)
and the ICI group (this node's ranks, ranked by intra-node index); global
rank = node · ranks_per_node + ici.  Every process must create every group
in the same order (``dist.new_group`` is collective).  ``node_group`` None
is the default group; ``ici_group`` None means one rank a node (no
intra-node hop), as JAX's ``ici_axis=None``.

Static shapes throughout (no host sync).  ``use_int8`` quantizes each token
once at the source (K5) and carries the int8 rows and their f32 scales over
both hops.  The receiver's packed layout is ``ep_core.dispatch_core``'s.
``dcn_transport="monitored"`` moves the node hop onto the window transport
with bounded polls (K15c over the node group): rows, top-k ids and scales
packed as bytes into one payload (``view(torch.uint8)`` where JAX bitcasts),
a timed-out node's rows dropped, and its wait / timeout statistics returned.
As in ``ep_core``, a slot of -1 is dropped where JAX's scatter wraps it to
the last slot.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from sgl_kernel_npu_tpu_torch.ops.quant import wire_quant
from sgl_kernel_npu_tpu_torch.parallel.ep_core import (
    all_to_all,
    packed_to_sorted,
    sorted_to_packed,
)
from sgl_kernel_npu_tpu_torch.parallel.pallas_a2a import pallas_ragged_all_to_all


def _a2a(v: torch.Tensor, group) -> torch.Tensor:
    """The group's all-to-all of equal blocks; no group (one rank a node):
    the identity."""
    return v if group is None else all_to_all(v, group)


def _node(group):
    return dist.group.WORLD if group is None else group


class LayeredHandle(NamedTuple):
    """What :func:`dispatch_layered` hands :func:`combine_layered` (JAX's)."""

    send_token: torch.Tensor     # [N, C1] source: token of each node-hop row (-1 none)
    pair_node: torch.Tensor      # [T*K] source: destination node of a pair (N invalid)
    pair_ok1: torch.Tensor       # [T*K] source: the pair survived the node hop's capacity
    p2_gather: torch.Tensor      # [N*C1*K] proxy: row in the returned outputs
    p2_ok: torch.Tensor          # [N*C1*K]
    p2_dest: torch.Tensor        # [N*C1*K] slot in the packed layout (-1 invalid)
    p2_dst_p: torch.Tensor       # [N*C1*K] destination intra-node rank (P invalid)
    p2_send_slot: torch.Tensor   # [N*C1*K] row in the intra-node send block


def _unsort(order: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(v)
    out[order] = v
    return out


def _scatter_rows(n_rows: int, idx: torch.Tensor, rows: torch.Tensor, fill=0) -> torch.Tensor:
    """``[n_rows, ...]`` filled with ``fill``, row ``idx[i]`` = ``rows[i]``;
    an index of ``n_rows`` (or past it, or below 0) is dropped (JAX's
    ``mode="drop"``) into a scratch row."""
    idx = torch.where((idx >= 0) & (idx < n_rows), idx, n_rows)
    out = torch.full((n_rows + 1,) + rows.shape[1:], fill, dtype=rows.dtype, device=rows.device)
    return out.index_copy_(0, idx, rows)[:n_rows]


def _phase1_plan(topk_idx, *, num_experts, num_nodes, ranks_per_node, c1):
    """The (token, destination node) pairs deduplicated into a node's rows."""
    t, k = topk_idx.shape
    n = t * k
    dev = topk_idx.device
    e_local_rank = num_experts // (num_nodes * ranks_per_node)
    flat_e = topk_idx.reshape(n).long()
    valid = (flat_e >= 0) & (flat_e < num_experts)
    dst_node = (torch.where(valid, flat_e, 0) // e_local_rank) // ranks_per_node
    token = torch.arange(n, device=dev) // k
    sentinel = num_nodes * t
    sk, order = torch.sort(torch.where(valid, dst_node * t + token, sentinel), stable=True)
    pos = torch.arange(n, device=dev)
    is_first = pos == torch.searchsorted(sk, sk)        # first pair of its (node, token)
    distinct_id = torch.cumsum(is_first.long(), 0) - 1
    node_of = torch.where(sk < sentinel, sk // t, num_nodes)
    row_in_node = distinct_id - distinct_id[torch.searchsorted(node_of, node_of)]
    row_ok = (sk < sentinel) & (row_in_node < c1)
    pair_node = _unsort(order, node_of)
    pair_row = _unsort(order, row_in_node)
    pair_ok = _unsort(order, row_ok)
    pair_first = _unsort(order, is_first & row_ok)
    n_dropped = ((sk < sentinel) & ~row_ok).sum().to(torch.int32)
    slot = torch.where(pair_first, pair_node * c1 + pair_row, num_nodes * c1)
    send_token = _scatter_rows(num_nodes * c1, slot, token, -1).reshape(num_nodes, c1)
    counts1 = (send_token >= 0).sum(1, dtype=torch.int32)
    return pair_node, pair_ok, send_token, counts1, n_dropped


def _phase2_plan(recv_topk, live_row, *, num_experts, num_nodes, ranks_per_node, my_node,
                 my_ici, c2, seg_capacity) -> dict:
    """The proxy's fan-out: the (row, k) pairs owned by this node → (intra-node
    rank, slot, source-rank segment).  Segments are indexed by the original
    global source rank: proxies at different intra-node indices carry
    disjoint sources, so counting locally is consistent globally."""
    rows, k = recv_topk.shape                   # rows = N * C1
    dev = recv_topk.device
    c1 = rows // num_nodes
    m = rows * k
    p = ranks_per_node
    e_l = num_experts // (num_nodes * p)
    flat_e = recv_topk.reshape(m).long()
    row_id = torch.arange(m, device=dev) // k
    src_node = row_id // c1
    valid = live_row.reshape(rows)[row_id] & (flat_e >= 0) & (flat_e < num_experts)
    safe_e = torch.where(valid, flat_e, 0)
    owner = safe_e // e_l
    valid = valid & (owner // p == my_node)
    sentinel = p * e_l * num_nodes
    key = torch.where(valid, ((owner % p) * e_l + safe_e % e_l) * num_nodes + src_node, sentinel)
    sk, order = torch.sort(key, stable=True)
    pos = torch.arange(m, device=dev)
    live = sk < sentinel
    idx_in_seg = pos - torch.searchsorted(sk, sk)
    sdst = torch.where(live, sk // (e_l * num_nodes), p)
    idx_in_dst = pos - torch.searchsorted(sdst, sdst)
    ok = live & (idx_in_seg < seg_capacity) & (idx_in_dst < c2)
    s_node = torch.where(live, sk % num_nodes, 0)
    s_slot = torch.where(live, (sk // num_nodes) % e_l, 0)
    num_ranks = num_nodes * p
    dest_slot = torch.where(ok, s_slot * (num_ranks * seg_capacity)
                            + (s_node * p + my_ici) * seg_capacity + idx_in_seg, -1)
    # the proxy's returned outputs: [P (dst), e_l, N (src node), seg]
    gather = torch.where(ok, ((sdst * e_l + s_slot) * num_nodes + s_node) * seg_capacity
                         + idx_in_seg, 0)
    return dict(dst_p=_unsort(order, sdst), send_slot=_unsort(order, idx_in_dst),
                dest_slot=_unsort(order, dest_slot), gather=_unsort(order, gather),
                ok=_unsort(order, ok), row_id=row_id,
                n_dropped=(live & ~ok).sum().to(torch.int32))


def _group_rank(group, size: int, what: str) -> int:
    if group is None:
        if size != 1:
            raise ValueError(f"no {what} group needs {what} size 1, not {size}")
        return 0
    if dist.get_world_size(group) != size:
        raise ValueError(f"the {what} group has {dist.get_world_size(group)} ranks, not {size}")
    return dist.get_rank(group)


def _to_bytes(a: torch.Tensor) -> torch.Tensor:
    """``[..., W]`` of any dtype → its bytes ``[..., W · itemsize]`` (uint8)."""
    return a.contiguous().view(torch.uint8)


def _node_hop_monitored(send_x, send_tk, send_sc, counts1, node_group, max_polls, fault):
    """The node hop on K15c: the rows, ids and scales as one byte payload;
    rows past a source's received count (all of a timed-out node's) become
    dead rows.  → ``(recv_x, recv_tk, recv_sc | None, stats [N, 6])``."""
    parts = [send_x, send_tk] + ([send_sc] if send_sc is not None else [])
    widths = [_to_bytes(a).shape[-1] for a in parts]
    payload = torch.cat([_to_bytes(a) for a in parts], dim=-1)
    recv, rcnt, stats = pallas_ragged_all_to_all(payload, counts1, group=node_group,
                                                 monitor=True, max_poll_rounds=max_polls,
                                                 inject_send_fault=fault)
    live = torch.arange(recv.shape[1], device=recv.device)[None, :] < rcnt[:, None]
    outs, at = [], 0
    for a, w, dead in zip(parts, widths, (0, -1, 0.0)):
        v = recv[..., at:at + w].contiguous().view(a.dtype)
        outs.append(torch.where(live[..., None], v, torch.full_like(v, dead)))
        at += w
    return outs[0], outs[1], (outs[2] if send_sc is not None else None), stats


def dispatch_layered(x, topk_idx, *, node_group, ici_group, num_nodes: int,
                     ranks_per_node: int, num_experts: int, phase1_capacity: int,
                     phase2_capacity: int, seg_capacity: int, use_int8: bool = False,
                     monitor: bool = False, dcn_transport: str = "xla",
                     dcn_max_poll_rounds: int = 5_000_000,
                     _dcn_inject_fault: bool = False) -> dict:
    """Two-tier dispatch of this rank's ``x [T, H]`` by ``topk_idx [T, K]``
    (JAX's, per rank).  Returns ``recv_x [E_local, R·seg, H]``
    (``ep_core.dispatch_core``'s packed layout; int8 with ``use_int8``, then
    ``recv_scales [E_local, R·seg]``), ``recv_count [E_local]``,
    ``recv_count_matrix [R, E_local]``, ``dcn_rows [N]`` (deduplicated
    node-hop rows sent to each node), ``num_dropped`` and the ``handle``;
    with ``monitor`` also ``stats`` (``dcn_send_rows``, ``ici_send_rows``,
    ``dropped_phase1``, ``dropped_phase2``, and on the monitored node hop
    ``dcn_wait_cost``, ``dcn_timeout_flags``, ``dcn_abort_observed`` [N]).
    ``_dcn_inject_fault`` mutes this rank's node-hop sends (the dead-node
    test; monitored hop only)."""
    if dcn_transport not in ("xla", "monitored"):
        raise ValueError(f"unknown dcn_transport {dcn_transport!r}; expected 'xla' or "
                         "'monitored'")
    if _dcn_inject_fault and dcn_transport != "monitored":
        raise ValueError("_dcn_inject_fault needs dcn_transport='monitored'")
    t, hidden = x.shape
    k = topk_idx.shape[1]
    n_nodes, p = num_nodes, ranks_per_node
    num_ranks = n_nodes * p
    e_local = num_experts // num_ranks
    node_group = _node(node_group)
    my_node = _group_rank(node_group, n_nodes, "node")
    my_ici = _group_rank(ici_group, p, "ici")
    c1, c2 = phase1_capacity, phase2_capacity
    tok_scale = None
    if use_int8:
        x, tok_scale = wire_quant(x)
    pair_node, pair_ok1, send_token, counts1, drop1 = _phase1_plan(
        topk_idx, num_experts=num_experts, num_nodes=n_nodes, ranks_per_node=p, c1=c1)

    # ---- the node hop: one row a (token, node) ----
    has = send_token >= 0
    tok = torch.where(has, send_token, 0)
    send_x = torch.where(has[..., None], x[tok], torch.zeros((), dtype=x.dtype, device=x.device))
    send_tk = torch.where(has[..., None], topk_idx.to(torch.int32)[tok], -1)
    send_sc = torch.where(has, tok_scale[tok], 0.0)[..., None] if use_int8 else None
    dcn_stats = None
    if dcn_transport == "monitored":
        recv_x1, recv_tk, recv_sc1, dcn_stats = _node_hop_monitored(
            send_x, send_tk, send_sc, counts1, node_group, dcn_max_poll_rounds, _dcn_inject_fault)
    else:
        recv_x1, recv_tk = _a2a(send_x, node_group), _a2a(send_tk, node_group)
        recv_sc1 = _a2a(send_sc, node_group) if use_int8 else None
    live_row = (recv_tk >= 0).any(dim=-1)          # [N, C1]

    # ---- the intra-node hop: the proxy's fan-out ----
    plan2 = _phase2_plan(recv_tk.reshape(n_nodes * c1, k), live_row, num_experts=num_experts,
                         num_nodes=n_nodes, ranks_per_node=p, my_node=my_node, my_ici=my_ici,
                         c2=c2, seg_capacity=seg_capacity)
    row_id = plan2["row_id"]
    slot2 = torch.where(plan2["ok"], plan2["dst_p"] * c2 + plan2["send_slot"], p * c2)
    send2 = _scatter_rows(p * c2, slot2, recv_x1.reshape(n_nodes * c1, hidden)[row_id])
    meta2 = _scatter_rows(p * c2, slot2, plan2["dest_slot"].to(torch.int32), -1)
    recv_x2 = _a2a(send2.reshape(p, c2, hidden), ici_group)
    recv_meta2 = _a2a(meta2.reshape(p, c2), ici_group).reshape(-1).long()
    n_slots = e_local * num_ranks * seg_capacity
    packed = _scatter_rows(n_slots, recv_meta2, recv_x2.reshape(-1, hidden))
    recv_scales = None
    if use_int8:
        sc2 = _scatter_rows(p * c2, slot2, recv_sc1.reshape(-1)[row_id])
        recv_sc2 = _a2a(sc2.reshape(p, c2), ici_group).reshape(-1)
        recv_scales = _scatter_rows(n_slots, recv_meta2, recv_sc2).reshape(
            e_local, num_ranks * seg_capacity)

    # per-(dst ici, slot, src node) counts → the receiver's count matrix [R, E_local]
    dest = plan2["dest_slot"]
    cnt_key = torch.where(plan2["ok"], (plan2["dst_p"] * e_local
                                        + torch.where(dest >= 0, dest // (num_ranks * seg_capacity),
                                                      0)) * n_nodes + row_id // c1,
                          p * e_local * n_nodes)
    cnt = torch.zeros(p * e_local * n_nodes + 1, dtype=torch.int32, device=x.device)
    cnt = cnt.scatter_add_(0, cnt_key, torch.ones_like(cnt_key, dtype=torch.int32))
    cnt_back = _a2a(cnt[:-1].reshape(p, e_local * n_nodes), ici_group).reshape(
        p, e_local, n_nodes)                           # [P (proxy), E_local, N]
    # entry (p', slot, s): rows from global rank s·P + p' into my slot
    matrix = cnt_back.permute(2, 0, 1).reshape(num_ranks, e_local)

    handle = LayeredHandle(send_token=send_token, pair_node=pair_node, pair_ok1=pair_ok1,
                           p2_gather=plan2["gather"], p2_ok=plan2["ok"], p2_dest=dest,
                           p2_dst_p=plan2["dst_p"], p2_send_slot=plan2["send_slot"])
    out = {
        "recv_x": packed.reshape(e_local, num_ranks * seg_capacity, hidden),
        "recv_count": matrix.sum(0, dtype=torch.int32),
        "recv_count_matrix": matrix,
        "dcn_rows": counts1,
        "num_dropped": drop1 + plan2["n_dropped"],
        "handle": handle,
    }
    if use_int8:
        out["recv_scales"] = recv_scales
    if monitor:
        ici_rows = torch.zeros(p + 1, dtype=torch.int32, device=x.device).scatter_add_(
            0, torch.where(plan2["ok"], plan2["dst_p"], p),
            torch.ones_like(plan2["dst_p"], dtype=torch.int32))[:p]
        out["stats"] = {"dcn_send_rows": counts1, "ici_send_rows": ici_rows,
                        "dropped_phase1": drop1, "dropped_phase2": plan2["n_dropped"]}
        if dcn_stats is not None:
            out["stats"].update(dcn_wait_cost=dcn_stats[:, 0],
                                dcn_timeout_flags=dcn_stats[:, 1] | dcn_stats[:, 4],
                                dcn_abort_observed=dcn_stats[:, 2])
    return out


def dispatch_layered_normal(x, topk_idx, **kw) -> dict:
    """Layered normal-mode (prefill) dispatch: :func:`dispatch_layered`'s
    route (its keyword arguments), then the packed layout compacted into
    ``ep_core.dispatch_ragged_core``'s contract: ``recv_x_sorted
    [E_local·R·seg, H]`` grouped by local expert (zero past the live rows),
    ``recv_scales_sorted`` (int8), ``group_sizes [E_local]``,
    ``recv_count_matrix``, ``dcn_rows``, ``num_dropped``, ``handle`` (for
    :func:`combine_layered_normal`) and, monitored, ``stats``."""
    res = dispatch_layered(x, topk_idx, **kw)
    rows, scales, tgt = packed_to_sorted(res["recv_x"], res.get("recv_scales"),
                                         res["recv_count_matrix"])
    out = {
        "recv_x_sorted": rows,
        "group_sizes": res["recv_count"],
        "recv_count_matrix": res["recv_count_matrix"],
        "dcn_rows": res["dcn_rows"],
        "num_dropped": res["num_dropped"],
        "handle": (res["handle"], tgt),
    }
    if scales is not None:
        out["recv_scales_sorted"] = scales
    if "stats" in res:
        out["stats"] = res["stats"]
    return out


def combine_layered_normal(y_sorted, topk_weights, handle, *, node_group, ici_group,
                           num_nodes: int, ranks_per_node: int, seg_capacity: int,
                           num_tokens: int, out_dtype=None) -> torch.Tensor:
    """Normal-mode combine: the expert outputs in the sorted layout put back
    into the packed one, then :func:`combine_layered`."""
    lhandle, tgt = handle
    e_local = tgt.numel() // (num_nodes * ranks_per_node * seg_capacity)
    return combine_layered(sorted_to_packed(y_sorted, tgt, e_local), topk_weights, lhandle,
                           node_group=node_group, ici_group=ici_group, num_nodes=num_nodes,
                           ranks_per_node=ranks_per_node, seg_capacity=seg_capacity,
                           num_tokens=num_tokens, out_dtype=out_dtype)


def combine_layered(y, topk_weights, handle: LayeredHandle, *, node_group, ici_group,
                    num_nodes: int, ranks_per_node: int, seg_capacity: int, num_tokens: int,
                    out_dtype=None) -> torch.Tensor:
    """Two-tier combine: the expert outputs ``y [E_local, R·seg, H]`` go over
    the intra-node hop to the proxy, which sums each node's part in f32
    before the node hop (one row a (token, node)); the source adds its nodes'
    parts → ``[T, H]`` in ``out_dtype`` (y's by default).  Both sums run in
    a fixed order (JAX's scatter-adds leave it open)."""
    e_local, slots, hidden = y.shape
    n_nodes, p = num_nodes, ranks_per_node
    if slots != n_nodes * p * seg_capacity:
        raise ValueError(f"y has {slots} slots an expert, want {n_nodes * p} x {seg_capacity}")
    node_group = _node(node_group)
    t, k = topk_weights.shape
    c1 = handle.send_token.shape[1]
    has = handle.send_token >= 0
    tok = torch.where(has, handle.send_token, 0)
    # the weights forward over the node hop (K floats a row)
    w_recv = _a2a(torch.where(has[..., None], topk_weights.float()[tok], 0.0), node_group)
    # the outputs back over the intra-node hop, grouped by proxy
    y_by_proxy = y.reshape(e_local, n_nodes, p, seg_capacity, hidden).permute(2, 0, 1, 3, 4)
    y_back = _a2a(y_by_proxy.contiguous(), ici_group).reshape(-1, hidden)
    picked = y_back[handle.p2_gather].float()
    w_pair = torch.where(handle.p2_ok, w_recv.reshape(-1), 0.0)
    # a row's k pairs are adjacent: their sum is a reduction over k, in order
    # (no atomic adds, so the card's result does not vary from call to call)
    partial = (picked * w_pair[:, None]).reshape(n_nodes, c1, k, hidden).sum(dim=2)
    back = _a2a(partial, node_group)               # [N, C1, H] at the source
    # each token has at most one row a node: gather them, then sum over the nodes
    pos = torch.full((n_nodes, t + 1), c1, dtype=torch.long, device=y.device).scatter_(
        1, torch.where(has, handle.send_token, t),
        torch.arange(c1, device=y.device).expand(n_nodes, c1))[:, :t]
    back = torch.cat([back, back.new_zeros((n_nodes, 1, hidden))], dim=1)
    out = torch.gather(back, 1, pos[..., None].expand(-1, -1, hidden)).sum(dim=0)
    return out.to(out_dtype or y.dtype)
