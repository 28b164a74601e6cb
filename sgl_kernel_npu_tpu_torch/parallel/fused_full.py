"""The single-kernel fused MoE (K16b): one-sided dispatch → GMM1 → SwiGLU +
requant → GMM2 → combine return → weighted top-k reduce, one launch a call.

Counterpart of ``sgl_kernel_npu_tpu/parallel/fused_full.py``
(:func:`fused_deep_moe_full_rank`, behind ``Buffer.fused_deep_moe(...,
single_kernel=True)``), in its compact (live rows) mode.  The count
exchange runs first, on K15a over the window (JAX's all-gather of the
``[R, E_local]`` counts: every rank sends its counts to every rank); every
offset follows from the counts on the device (no host sync): this rank's
send rows packed (destination, expert)-major, each destination's receive
rows (expert, source)-major, each expert's 128-row work items.  Then
``csrc/fused_full.cu`` runs the whole chain on those tables.  On the CPU
(and with ``plain=True``) :func:`fused_deep_moe_full_plain` computes the
same function step by step on the same layout, the rows moved by
``all_to_all_single`` with their counts; :func:`fused_deep_moe_full_tiled_plain`
is the kernel's walk on the same steps, for tests.

Departures (ROADMAP §C): rows are packed back to back (JAX's 8-row
alignment is a Mosaic rule); JAX's tile arguments (``tm``, ``tk1``,
``tk2``, ``tn2``, ``tn3``), ``static_shapes``, ``phases``,
``debug_outputs``, ``collective_id`` and ``interpret`` describe a TPU
schedule or its simulator and are not taken; ``tn1``, the gate / up pack
width, is a layout and is taken (``pack_tn``; on the card its half must be
a multiple of 16); the weighted reduce keeps the f32 router weights where
JAX splits them into bf16 hi + lo products.
"""

from __future__ import annotations

import bisect
import ctypes
from typing import NamedTuple

import torch
import torch.distributed as dist

from sgl_kernel_npu_tpu_torch.ops.grouped_matmul import (
    TILE_M_WG,
    _gate_col,
    _offsets,
    _row_groups,
    _tile_offsets,
    grouped_matmul_plain,
)
from sgl_kernel_npu_tpu_torch.ops.quant import (
    quant_per_token_ref,
    row_scale,
    saturate_int8,
    wire_quant,
)
from sgl_kernel_npu_tpu_torch.parallel.ep_core import make_routing_plan
from sgl_kernel_npu_tpu_torch.parallel.fused_moe import pack_width
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
    tile_off: torch.Tensor     # [E + 1] prefix sums of their 128-row work items
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
        offsets=_offsets(rows_e), tile_off=_tile_offsets(rows_e, TILE_M_WG),
        pair_pos=torch.where(plan.ok, plan.send_pos, -1).to(torch.int32))


def _weigh(ret: torch.Tensor, lay: Layout, topk_weights: torch.Tensor) -> torch.Tensor:
    """``Σ_k w[t, k] · ret[pair_pos[t, k]]`` in f32, k in order, over the
    surviving pairs, each step rounded once (the kernel's fused multiply-add:
    the product and the sum exact in f64), then bf16."""
    t, k = topk_weights.shape
    pos = lay.pair_pos.reshape(t, k).long()
    w = topk_weights.float().double()
    out = torch.zeros((t, ret.shape[1]), dtype=torch.float32, device=ret.device)
    for j in range(k):
        live = pos[:, j] >= 0
        y = ret[pos[:, j].clamp(min=0)].double()
        out = torch.where(live[:, None], (out.double() + w[:, j, None] * y).float(), out)
    return out.to(torch.bfloat16)


def _exchange_rows(rows: torch.Tensor, send: list, recv: list, group) -> torch.Tensor:
    out = rows.new_empty((sum(recv),) + tuple(rows.shape[1:]))
    dist.all_to_all_single(out, rows.contiguous(), output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out


def _swiglu(y: torch.Tensor, ht: int) -> torch.Tensor:
    """SwiGLU of the dequantized ``y [rows, 2I]`` (f32) packed in slabs of
    ``2 ht`` columns ``[gate ht | up ht]``, as the kernel computes it: ``d0 ·
    (1 / (1 + exp(-d0))) · d1``."""
    rows, n = y.shape
    slabs = y.reshape(rows, n // (2 * ht), 2, ht)
    d0, d1 = slabs[:, :, 0], slabs[:, :, 1]
    return (d0 * (1.0 / (1.0 + torch.exp(-d0))) * d1).reshape(rows, n // 2)


def _requant(act: torch.Tensor):
    """The per-row int8 requant of the SwiGLU activation (f32): scale
    ``max(amax / 127, 1e-12)`` by true division, round half to even,
    saturate."""
    scale = torch.clamp_min(row_scale(act), 1e-12)
    return saturate_int8(act / scale[:, None]), scale


def _run_experts(xq, scale, topk_weights, lay: Layout, group, experts):
    """The steps around the experts, as the kernel orders them: this rank's
    int8 rows (``xq [T, H]``, ``scale [T]``) in send order go to their
    destinations (``all_to_all_single`` with the segments' counts) and are
    placed (expert, source)-major, as in the receive window; ``experts(rows,
    scales, group_sizes)`` → bf16 rows; they go back to their sources in send
    order and are weighed (:func:`_weigh`).  Syncs on the counts."""
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
    y = experts(rx[perm], rs[perm], c[:, me, :].sum(0, dtype=torch.int32))
    back = torch.empty_like(y)
    back[perm] = y
    ret = _exchange_rows(back, n_recv, n_send, group)
    return _weigh(ret, lay, topk_weights)


def fused_deep_moe_full_plain(xq, scale, topk_weights, w1, sw1, w2, sw2, lay: Layout, *,
                              tn: int | None = None, group=None) -> torch.Tensor:
    """The plain version of K16b on :func:`make_layout`'s layout
    (:func:`_run_experts`): :func:`grouped_matmul_plain`'s ``dequant`` to
    f32, SwiGLU on the gate / up packing of width ``tn`` (None: full width;
    :func:`_swiglu`), the per-row requant (:func:`_requant`), then
    ``dequant`` (bf16)."""
    ht = (tn or w1.shape[-1]) // 2

    def experts(x, sx, gs):
        y = grouped_matmul_plain(x, w1, gs, sx, sw1, epilogue="dequant", out_dtype=torch.float32)
        h1, hs = _requant(_swiglu(y, ht))
        return grouped_matmul_plain(h1, w2, gs, hs, sw2, epilogue="dequant")

    return _run_experts(xq, scale, topk_weights, lay, group, experts)


def _tiled_sums(x, w, tile_off: list, offsets: list, ht: int | None) -> torch.Tensor:
    """The exact sums of K16b's GEMM units (``csrc/gmm_int8_ring.cuh``) in
    f32, each at its column of ``[rows, N]``; NaN where no unit writes.
    Items of ``TILE_M_WG`` rows of one expert from its first row (each
    item's expert found as the kernel's binary search finds it); an item's
    column tiles (128 columns, or with ``ht`` 64 gate columns and their 64 up
    columns paired by the slabs of a packing of half width ``ht``) in one
    product.  The kernel adds the products tile by tile over stages of 128
    k; exact integer sums (f64 here) do not depend on that order."""
    s, n = x.shape[0], w.shape[2]
    groups = len(offsets) - 1
    j = torch.arange(n // 2 if ht else n, device=x.device)
    cols = torch.cat([_gate_col(j, ht), _gate_col(j, ht) + ht]) if ht else j
    out = torch.full((s, n), float("nan"), dtype=torch.float32, device=x.device)
    for item in range(tile_off[-1]):
        g = bisect.bisect_right(tile_off, item, 0, groups) - 1
        r0 = offsets[g] + (item - tile_off[g]) * TILE_M_WG
        r1 = min(r0 + TILE_M_WG, offsets[g + 1])
        out[r0:r1, cols] = (x[r0:r1].double() @ w[g][:, cols].double()).float()
    return out


def fused_deep_moe_full_tiled_plain(xq, scale, topk_weights, w1, sw1, w2, sw2, lay: Layout, *,
                                    tn: int | None = None, group=None) -> torch.Tensor:
    """K16b's walk on the CPU, for tests: :func:`fused_deep_moe_full_plain`'s
    steps with each GEMM's sums taken unit by unit as the kernel takes them
    (:func:`_tiled_sums` on the layout's 128-row items, GMM1's column tiles
    paired by the pack width), then the same f32 epilogues in the same
    order: ``× scale_x[row] × scale_w[g, col]``, SwiGLU by slabs, the per-row
    requant, ``dequant`` to bf16 → bit-equal to the plain version.  On the
    card its operations are the kernel's, one by one (CUDA's ``expf``, true
    divisions, round half to even, the reduce's fused multiply-add)."""
    n1 = w1.shape[-1]
    ht = (tn or n1) // 2
    tile_off, offsets = lay.tile_off.tolist(), lay.offsets.tolist()

    def experts(x, sx, gs):
        g = _row_groups(gs, x.shape[0])
        y1 = _tiled_sums(x, w1, tile_off, offsets, ht) * sx.float()[:, None] * sw1.float()[g]
        h1, hs = _requant(_swiglu(y1, ht))
        y2 = _tiled_sums(h1, w2, tile_off, offsets, None) * hs[:, None] * sw2.float()[g]
        return y2.to(torch.bfloat16)

    return _run_experts(xq, scale, topk_weights, lay, group, experts)


class _Args(ctypes.Structure):
    """``csrc/fused_full.cu``'s Args: every field 8 bytes."""

    _fields_ = [(name, ctypes.c_longlong) for name in (
        "peers", "mine", "me", "R", "epoch", "half", "E", "T", "K", "H", "I", "ht", "cap", "off_x",
        "off_s", "off_m", "off_ret", "xq", "xscale", "row_tok", "seg_cnt", "seg_off", "seg_dst",
        "offsets", "tile_off", "w1", "sw1", "w2", "sw2", "act", "amax", "h1", "hs", "pair_pos",
        "pair_w", "out", "stamps")]


def _window_offsets(h: int, cap_recv: int, cap_send: int) -> dict:
    """Byte offsets of K16b's regions in a data half, and its size."""
    sizes = (("off_x", cap_recv * h), ("off_s", cap_recv * 4), ("off_m", cap_recv * 8),
             ("off_ret", cap_send * h * 2))
    off, at = {}, 0
    for name, size in sizes:
        off[name] = at
        at += round_up(size, 256)
    return off, at


PHASE_STAMPS = 11   # csrc/fused_full.cu STAMPS


def fused_full_blocks() -> int:
    """The blocks of K16b's co-resident grid on the current card."""
    return cuda_lib.load_library().fused_full_blocks()


def full_layout(topk_idx, *, group, num_experts: int, num_ranks: int, seg_capacity: int,
                kernel: bool = False):
    """The routing plan and the :class:`Layout` of a call: the count exchange
    on K15a where ``kernel``, else on its plain version."""
    _, me = group_info(group)
    e_local = num_experts // num_ranks
    plan = make_routing_plan(topk_idx, num_experts=num_experts, num_ranks=num_ranks,
                             my_rank=me, pair_capacity=e_local * seg_capacity,
                             seg_capacity=seg_capacity)
    cnt = plan.counts_per_expert.reshape(num_ranks, e_local).to(torch.int32)
    every = cnt[None].expand(num_ranks, num_ranks, e_local).contiguous()
    counts_all = (pallas_all_to_all if kernel else pallas_all_to_all_plain)(every, group=group)
    return plan, make_layout(plan, counts_all, me)


def _check_shapes(x, w1, sw1, w2, sw2, e_local, tn):
    t, h = x.shape
    n1 = w1.shape[-1]
    i = n1 // 2
    if (x.dtype not in (torch.bfloat16, torch.float32) or w1.shape != (e_local, h, n1)
            or w2.shape != (e_local, i, h) or sw1.shape != (e_local, n1)
            or sw2.shape != (e_local, h) or w1.dtype != torch.int8 or w2.dtype != torch.int8
            or h % 128 or i % 64 or tn % 32 or n1 % tn):
        raise ValueError(
            f"fused_deep_moe_full_rank takes x [T, H] bf16 / f32, w1 [E_local, H, 2I] int8, "
            f"w2 [E_local, I, H] int8 and f32 scales with H % 128 == 0 and I % 64 == 0, gate / "
            f"up packed at a width dividing 2I and a multiple of 32; got x {x.dtype} "
            f"{tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}, sw1 "
            f"{tuple(sw1.shape)}, sw2 {tuple(sw2.shape)}, pack width {tn}")


@counted
def fused_deep_moe_full_rank(x, topk_idx, topk_weights, w1, sw1, w2, sw2, *, group=None,
                             num_experts: int, num_ranks: int, seg_capacity: int,
                             pack_tn: int | None = None, plain: bool = False,
                             phase_stamps: torch.Tensor | None = None):
    """The expert-parallel W8A8 MoE of this rank's tokens in one launch
    (K16b).  ``x [T, H]``, ``topk_idx`` / ``topk_weights [T, K]`` (-1:
    inactive), this rank's experts ``w1 [E_local, H, 2I]`` int8 (gate / up
    packed at width ``pack_tn``, :func:`~sgl_kernel_npu_tpu_torch.parallel.fused_moe.pack_width`:
    full width by default), ``sw1 [E_local, 2I]``, ``w2 [E_local, I, H]``,
    ``sw2 [E_local, H]``; a (expert, source) segment holds at most
    ``seg_capacity`` rows (JAX's pair capacity ``E_local · seg``).  Returns
    ``(combined [T, H] bf16, recv_count [E_local]`` (the rows this rank's
    experts received), ``num_dropped [])``.  CUDA tensors launch the count
    exchange (K15a), the wire quant (K5) and ``csrc/fused_full.cu``; CPU
    tensors, or ``plain``, take :func:`fused_deep_moe_full_plain`.
    ``phase_stamps`` (int64 ``[fused_full_blocks(), 11]`` on the card) takes
    each block's phase times (the kernel's ``STAMPS``; for measurement)."""
    size, me = group_info(group)
    if size != num_ranks:
        raise ValueError(f"num_ranks {num_ranks} but the group has {size} ranks")
    e_local = num_experts // num_ranks
    t, h = x.shape
    k = topk_idx.shape[1]
    i = w1.shape[-1] // 2
    tn = pack_width(w1.shape[-1], pack_tn)
    if w1.shape[-1] % tn or tn % 2:
        raise ValueError(f"fused_deep_moe_full_rank: pack width {tn} must be even and divide "
                         f"2I = {w1.shape[-1]}")
    kernel = on_cuda(x, topk_idx, topk_weights, w1, sw1, w2, sw2) and not plain
    plan, lay = full_layout(topk_idx, group=group, num_experts=num_experts, num_ranks=num_ranks,
                            seg_capacity=seg_capacity, kernel=kernel)
    recv_count = lay.counts_all[:, me, :].sum(0, dtype=torch.int32)
    if not kernel:
        xq, scale = quant_per_token_ref(x)
        out = fused_deep_moe_full_plain(xq, scale, topk_weights, w1, sw1, w2, sw2, lay, tn=tn,
                                        group=group)
        return out, recv_count, plan.num_dropped
    _check_shapes(x, w1, sw1, w2, sw2, e_local, tn)
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
        peers=win.peers.data_ptr(), mine=win.base, me=me, R=num_ranks, epoch=win.next_epoch(),
        half=win.half, E=e_local, T=t, K=k, H=h, I=i, ht=tn // 2, cap=cap_recv, **off,
        xq=xq.data_ptr(), xscale=scale.data_ptr(), row_tok=lay.row_tok.data_ptr(),
        seg_cnt=lay.seg_cnt.data_ptr(), seg_off=lay.seg_off.data_ptr(),
        seg_dst=lay.seg_dst.data_ptr(), offsets=lay.offsets.data_ptr(),
        tile_off=lay.tile_off.data_ptr(), w1=ws[0].data_ptr(), sw1=ws[1].data_ptr(),
        w2=ws[2].data_ptr(), sw2=ws[3].data_ptr(), act=act.data_ptr(), amax=amax.data_ptr(),
        h1=h1.data_ptr(), hs=hs.data_ptr(), pair_pos=lay.pair_pos.data_ptr(),
        pair_w=pair_w.data_ptr(), out=out.data_ptr(),
        stamps=0 if phase_stamps is None else phase_stamps.data_ptr())
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.fused_full_launch(ctypes.addressof(args), cuda_lib.stream_ptr(x)),
                   "fused_deep_moe_full_rank")
    fused_deep_moe_full_rank.launches += 1
    return out, recv_count, plan.num_dropped
