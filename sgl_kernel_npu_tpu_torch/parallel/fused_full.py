"""The single-kernel fused MoE (K16b): one-sided dispatch → GMM1 → SwiGLU +
requant → GMM2 → combine return → weighted top-k reduce, one launch a call.

Counterpart of ``sgl_kernel_npu_tpu/parallel/fused_full.py``
(:func:`fused_deep_moe_full_rank`, behind ``Buffer.fused_deep_moe(...,
single_kernel=True)``), in its compact (live rows) mode.  The count
exchange runs first, on K15a over the window (JAX's all-gather of the
``[R, E_local]`` counts: every rank sends its counts to every rank); every
offset follows from the counts on the device (no host sync): this rank's
send rows packed (destination, expert)-major, each destination's receive
rows (expert, source)-major, each expert's 64-row tiles.  Then
``csrc/fused_full.cu`` runs the whole chain on those tables.  On the CPU
(and with ``plain=True``) :func:`fused_deep_moe_full_plain` computes the
same function step by step on the same layout, the rows moved by
``all_to_all_single`` with their counts.

Departures (ROADMAP §C): rows are packed back to back (JAX's 8-row
alignment is a Mosaic rule); JAX's tile arguments (``tm``, ``tk1``,
``tn1``, ``tk2``, ``tn2``, ``tn3``), ``static_shapes``, ``phases``,
``debug_outputs``, ``collective_id`` and ``interpret`` describe a TPU
schedule or its simulator and are not taken; the gate / up packing must be
full width (``moe_pack_tn``; a narrower packing runs unfused, on K8a's
``dequant_swiglu``); the weighted reduce keeps the f32
router weights where JAX splits them into bf16 hi + lo products.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.distributed as dist

from sgl_kernel_npu_tpu_torch.ops.grouped_matmul import TILE_M, _offsets, grouped_matmul_plain
from sgl_kernel_npu_tpu_torch.ops.quant import quant_per_token_ref, wire_quant
from sgl_kernel_npu_tpu_torch.parallel.ep_core import make_routing_plan
from sgl_kernel_npu_tpu_torch.parallel.pallas_a2a import (
    MAX_SEGMENTS,
    group_info,
    pallas_all_to_all,
    pallas_all_to_all_plain,
    window,
)
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda, round_up
from sgl_kernel_npu_tpu_torch.utils.counters import counted


class Layout(NamedTuple):
    """The compact layout of one call, from the exchanged counts."""

    counts_all: torch.Tensor   # [S, D, E] rows rank S sends rank D for its local expert E
    row_tok: torch.Tensor      # [T K] token of each send row (compact, (dst, expert) order)
    seg_cnt: torch.Tensor      # [R E] rows of each (destination, expert) segment
    seg_off: torch.Tensor      # [R E] its first send row
    seg_dst: torch.Tensor      # [R E] its first row in the destination's receive layout
    offsets: torch.Tensor      # [E + 1] this rank's receive rows of each expert
    tile_off: torch.Tensor     # [E + 1] prefix sums of their 64-row tiles
    pair_pos: torch.Tensor     # [T K] each (token, k) pair's send / return row, -1 dropped


def _excl_cumsum(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(v, dim) - v


def make_layout(plan, counts_all: torch.Tensor, me: int) -> Layout:
    """Every table of :class:`Layout` from the routing plan and the counts
    of every rank (device tensors, no host sync)."""
    r, _, e = counts_all.shape
    n = plan.ok.numel()
    cnt = counts_all[me].reshape(-1).long()                              # [D E]
    per_dst = counts_all.permute(1, 2, 0).reshape(r, e * r).long()       # [D, (E, S)]
    recv_base = _excl_cumsum(per_dst).reshape(r, e, r)                   # [D, E, S]
    send_pos = torch.where(plan.ok, plan.send_pos, n)
    row_tok = torch.zeros(n + 1, dtype=torch.long, device=cnt.device).scatter_(
        0, send_pos, plan.src_token)[:n]
    rows_e = counts_all[:, me, :].sum(0, dtype=torch.int32)
    return Layout(
        counts_all=counts_all, row_tok=row_tok.to(torch.int32), seg_cnt=cnt.to(torch.int32),
        seg_off=_excl_cumsum(cnt).to(torch.int32),
        seg_dst=recv_base[:, :, me].reshape(-1).to(torch.int32),
        offsets=_offsets(rows_e), tile_off=_offsets(torch.div(rows_e + TILE_M - 1, TILE_M,
                                                             rounding_mode="floor")),
        pair_pos=torch.where(plan.ok, plan.send_pos, -1).to(torch.int32))


def _weigh(ret: torch.Tensor, lay: Layout, topk_weights: torch.Tensor) -> torch.Tensor:
    """``Σ_k w[t, k] · ret[pair_pos[t, k]]`` in f32, k in order, over the
    surviving pairs, then bf16."""
    t, k = topk_weights.shape
    pos = lay.pair_pos.reshape(t, k).long()
    w = topk_weights.float()
    out = torch.zeros((t, ret.shape[1]), dtype=torch.float32, device=ret.device)
    for j in range(k):
        live = pos[:, j] >= 0
        y = ret[pos[:, j].clamp(min=0)].float()
        out = out + torch.where(live[:, None], w[:, j, None] * y, 0.0)
    return out.to(torch.bfloat16)


def _exchange_rows(rows: torch.Tensor, send: list, recv: list, group) -> torch.Tensor:
    out = rows.new_empty((sum(recv),) + tuple(rows.shape[1:]))
    dist.all_to_all_single(out, rows.contiguous(), output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out


def fused_deep_moe_full_plain(xq, scale, topk_weights, w1, sw1, w2, sw2, lay: Layout, *,
                              group=None) -> torch.Tensor:
    """The plain version of K16b on :func:`make_layout`'s layout: this
    rank's int8 rows (``xq [T, H]``, ``scale [T]``) in send order go to
    their destinations (``all_to_all_single`` with the segments' counts),
    are placed (expert, source)-major, run :func:`grouped_matmul_plain`'s
    ``dequant_swiglu_quant`` then ``dequant`` (bf16), go back to their
    sources in send order, and are weighed (:func:`_weigh`).  Syncs on the
    counts."""
    _, me = group_info(group)
    c = lay.counts_all
    r, _, e = c.shape
    n_send = c[me].sum(1).tolist()
    c_in = c[:, me, :].tolist()                       # [S][E] rows from source S for expert E
    n_recv = [sum(v) for v in c_in]
    rows = lay.row_tok[: sum(n_send)].long()
    rx = _exchange_rows(xq[rows], n_send, n_recv, group)
    rs = _exchange_rows(scale[rows], n_send, n_recv, group)
    # a source's block holds its segments for experts 0, 1, ... in order
    src0 = [sum(n_recv[:s]) for s in range(r)]
    order = [i for g in range(e) for s in range(r)
             for i in range(src0[s] + sum(c_in[s][:g]), src0[s] + sum(c_in[s][: g + 1]))]
    perm = torch.tensor(order, dtype=torch.long, device=xq.device)
    gs = c[:, me, :].sum(0, dtype=torch.int32)
    h1, hs = grouped_matmul_plain(rx[perm], w1, gs, rs[perm], sw1,
                                  epilogue="dequant_swiglu_quant")
    y = grouped_matmul_plain(h1, w2, gs, hs, sw2, epilogue="dequant")
    back = torch.empty_like(y)
    back[perm] = y
    ret = _exchange_rows(back, n_recv, n_send, group)
    return _weigh(ret, lay, topk_weights)


class _Args(ctypes.Structure):
    """``csrc/fused_full.cu``'s Args: every field 8 bytes."""

    _fields_ = [(name, ctypes.c_longlong) for name in (
        "peers", "me", "R", "epoch", "half", "E", "T", "K", "H", "I", "off_x",
        "off_s", "off_m", "off_ret", "xq", "xscale", "row_tok", "seg_cnt", "seg_off", "seg_dst",
        "offsets", "tile_off", "w1", "sw1", "w2", "sw2", "act", "amax", "h1", "hs", "pair_pos",
        "pair_w", "out")]


def _window_offsets(h: int, cap_recv: int, cap_send: int) -> dict:
    """Byte offsets of K16b's regions in a data half, and its size."""
    sizes = (("off_x", cap_recv * h), ("off_s", cap_recv * 4), ("off_m", cap_recv * 8),
             ("off_ret", cap_send * h * 2))
    off, at = {}, 0
    for name, size in sizes:
        off[name] = at
        at += round_up(size, 256)
    return off, at


def _check_shapes(x, w1, sw1, w2, sw2, e_local):
    t, h = x.shape
    n1 = w1.shape[-1]
    i = n1 // 2
    if (x.dtype not in (torch.bfloat16, torch.float32) or w1.shape != (e_local, h, n1)
            or w2.shape != (e_local, i, h) or sw1.shape != (e_local, n1)
            or sw2.shape != (e_local, h) or w1.dtype != torch.int8 or w2.dtype != torch.int8
            or h % 128 or i % 64):
        raise ValueError(
            f"fused_deep_moe_full_rank takes x [T, H] bf16 / f32, w1 [E_local, H, 2I] int8, "
            f"w2 [E_local, I, H] int8 and f32 scales with H % 128 == 0 and I % 64 == 0; got x "
            f"{x.dtype} {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}, "
            f"sw1 {tuple(sw1.shape)}, sw2 {tuple(sw2.shape)}")


@counted
def fused_deep_moe_full_rank(x, topk_idx, topk_weights, w1, sw1, w2, sw2, *, group=None,
                             num_experts: int, num_ranks: int, seg_capacity: int,
                             plain: bool = False):
    """The expert-parallel W8A8 MoE of this rank's tokens in one launch
    (K16b).  ``x [T, H]``, ``topk_idx`` / ``topk_weights [T, K]`` (-1:
    inactive), this rank's experts ``w1 [E_local, H, 2I]`` int8 (gate ‖ up
    at full width), ``sw1 [E_local, 2I]``, ``w2 [E_local, I, H]``, ``sw2
    [E_local, H]``; a (expert, source) segment holds at most
    ``seg_capacity`` rows (JAX's pair capacity ``E_local · seg``).  Returns
    ``(combined [T, H] bf16, recv_count [E_local]`` (the rows this rank's
    experts received), ``num_dropped [])``.  CUDA tensors launch the count
    exchange (K15a), the wire quant (K5) and ``csrc/fused_full.cu``; CPU
    tensors, or ``plain``, take :func:`fused_deep_moe_full_plain`."""
    size, me = group_info(group)
    if size != num_ranks:
        raise ValueError(f"num_ranks {num_ranks} but the group has {size} ranks")
    e_local = num_experts // num_ranks
    t, h = x.shape
    k = topk_idx.shape[1]
    i = w1.shape[-1] // 2
    kernel = on_cuda(x, topk_idx, topk_weights, w1, sw1, w2, sw2) and not plain
    plan = make_routing_plan(topk_idx, num_experts=num_experts, num_ranks=num_ranks,
                             my_rank=me, pair_capacity=e_local * seg_capacity,
                             seg_capacity=seg_capacity)
    cnt = plan.counts_per_expert.reshape(num_ranks, e_local).to(torch.int32)
    every = cnt[None].expand(num_ranks, num_ranks, e_local).contiguous()
    counts_all = (pallas_all_to_all if kernel else pallas_all_to_all_plain)(every, group=group)
    lay = make_layout(plan, counts_all, me)
    recv_count = counts_all[:, me, :].sum(0, dtype=torch.int32)
    if not kernel:
        xq, scale = quant_per_token_ref(x)
        out = fused_deep_moe_full_plain(xq, scale, topk_weights, w1, sw1, w2, sw2, lay,
                                        group=group)
        return out, recv_count, plan.num_dropped
    _check_shapes(x, w1, sw1, w2, sw2, e_local)
    xq, scale = wire_quant(x.contiguous())
    dev = x.device
    cap_send = t * k
    cap_recv = num_ranks * min(t * k, e_local * seg_capacity)
    if num_ranks * e_local > MAX_SEGMENTS:
        raise ValueError(f"{num_ranks} ranks x {e_local} local experts exceed the window's "
                         f"{MAX_SEGMENTS} arrival flags")
    off, half = _window_offsets(h, cap_recv, cap_send)
    win = window(group, dev)
    win.ensure(half)
    act = torch.empty((cap_recv, i), dtype=torch.float32, device=dev)
    amax = torch.zeros(cap_recv, dtype=torch.int32, device=dev)
    h1 = torch.empty((cap_recv, i), dtype=torch.int8, device=dev)
    hs = torch.empty(cap_recv, dtype=torch.float32, device=dev)
    pair_w = topk_weights.float().contiguous()
    out = torch.empty((t, h), dtype=torch.bfloat16, device=dev)
    ws = [w.contiguous() for w in (w1, sw1.float(), w2, sw2.float())]
    args = _Args(
        peers=win.peers.data_ptr(), me=me, R=num_ranks, epoch=win.next_epoch(), half=win.half,
        E=e_local, T=t, K=k, H=h, I=i, **off, xq=xq.data_ptr(), xscale=scale.data_ptr(),
        row_tok=lay.row_tok.data_ptr(), seg_cnt=lay.seg_cnt.data_ptr(),
        seg_off=lay.seg_off.data_ptr(), seg_dst=lay.seg_dst.data_ptr(),
        offsets=lay.offsets.data_ptr(), tile_off=lay.tile_off.data_ptr(),
        w1=ws[0].data_ptr(), sw1=ws[1].data_ptr(), w2=ws[2].data_ptr(), sw2=ws[3].data_ptr(),
        act=act.data_ptr(), amax=amax.data_ptr(), h1=h1.data_ptr(), hs=hs.data_ptr(),
        pair_pos=lay.pair_pos.data_ptr(), pair_w=pair_w.data_ptr(), out=out.data_ptr())
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.fused_full_launch(ctypes.addressof(args), cuda_lib.stream_ptr(x)),
                   "fused_deep_moe_full_rank")
    fused_deep_moe_full_rank.launches += 1
    return out, recv_count, plan.num_dropped
