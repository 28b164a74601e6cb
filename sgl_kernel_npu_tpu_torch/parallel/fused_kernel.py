"""The fused one-sided dispatch + dequantizing W8A8 GEMM1 (K16a).

Counterpart of ``sgl_kernel_npu_tpu/parallel/fused_kernel.py``:

- :func:`fused_dispatch_gmm1_rank` (K16a, ``csrc/fused_kernel.cu``): this
  rank's int8 rows ``xsend [R, E_local·seg, H]``, pre-placed by destination
  at ``[dst, e·seg + slot]``, land in every destination's window by source,
  and each destination multiplies the rows its experts received by ``w1``
  and dequantizes them: ``out [E_local, R·seg, N]`` bf16 with ``out[e, s·seg
  + i] = bf16(acc · sx[e, s·seg + i] · sw1[e, :])``.  One launch a call.
- :func:`fused_dispatch_gmm1`, the routed wrapper: per-token int8 quant, the
  routing plan, the placement, the row scales' all-to-all and the kernel;
  it returns JAX's padded low-latency layout, which
  ``ep_core.combine_core`` consumes, with the handle ``(gather_idx, ok,
  None, None)``.  Nothing in the JAX package calls it: it is an op.

CPU tensors (and ``plain=True``) take :func:`fused_dispatch_gmm1_rank_plain`:
``all_to_all_single`` of ``xsend`` by source, then ``gmm_dequant_ref`` per
expert, cast to bf16.  :func:`fused_dispatch_gmm1_rank_tiled_plain` walks
the kernel's units (:func:`gemm1_units`) on the CPU, for tests: bit-equal to
the plain version.

Departures: the TPU's chunk-major window ``[NK, R, ER, tk]``, its
per-chunk semaphores and ``_fused_tiles`` (the tile selector) are a TPU
schedule, so ``tk``, ``tn``, ``collective_id`` and ``interpret`` are not
taken; the kernel takes the senders' counts ``[R, E_local]`` (``counts``,
from the routing plan in the wrapper) and moves and multiplies only the
live rows of each segment, writing the zeros JAX's zero rows give past them.
``fused_dispatch_gmm1`` returns ``plan.counts_per_expert``, this rank's
SEND counts, as JAX's does (ROADMAP §C, "Found in the reference").
"""

from __future__ import annotations

import ctypes

import torch

from sgl_kernel_npu_tpu_torch.ops.quant import quant_per_token, quant_per_token_ref
from sgl_kernel_npu_tpu_torch.parallel.ep_core import DispatchHandle, all_to_all, make_routing_plan
from sgl_kernel_npu_tpu_torch.parallel.pallas_a2a import (
    MAX_SEGMENTS,
    group_info,
    pallas_all_to_all_plain,
    window,
)
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda, round_up
from sgl_kernel_npu_tpu_torch.utils.counters import counted


class _Args(ctypes.Structure):
    """``csrc/fused_kernel.cu``'s Args: every field 8 bytes."""

    _fields_ = [(name, ctypes.c_longlong) for name in (
        "peers", "mine", "me", "R", "epoch", "half", "E", "seg", "H", "N", "off_x", "off_c",
        "xsend", "counts", "w1", "sw1", "sx", "out", "ticket")]


ITEM_ROWS = 128    # rows of a unit's item (csrc/gmm_int8_ring.cuh QM)
UNIT_COLS = 128    # columns of a unit (QN)
_TICKETS: dict = {}


def _ticket(t: torch.Tensor) -> torch.Tensor:
    """The kernel's unit counter on t's device and stream: zero, and set back
    to zero by every launch (after its grid sync), so only a first use writes
    it."""
    key = (t.device, cuda_lib.stream_ptr(t))
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=t.device)
    return _TICKETS[key]


def gemm1_units(e_local: int, num_ranks: int, seg: int, n: int) -> list[tuple]:
    """The kernel's GEMM1 units in ticket order: ``(e, s, r0, tile_rows,
    bx)``, expert e's rows from source s, the segment's rows ``r0 ..
    r0 + tile_rows`` (items of ``ITEM_ROWS`` aligned to the segment's first
    row) times column tile bx of ``UNIT_COLS`` columns.  Its output rows are
    ``(e R + s) seg + r0 + i``: the window's rows, expert-major."""
    tiles, ct = -(-seg // ITEM_ROWS), -(-n // UNIT_COLS)
    units = []
    for w in range(e_local * num_ranks * tiles * ct):
        item, bx = divmod(w, ct)
        e, s, t = item // (num_ranks * tiles), (item // tiles) % num_ranks, item % tiles
        units.append((e, s, t * ITEM_ROWS, min(ITEM_ROWS, seg - t * ITEM_ROWS), bx))
    return units


def _check(xsend, w1, sw1, sx, num_ranks, seg):
    r, er, h = xsend.shape
    e, h_w, n = w1.shape
    if (r != num_ranks or er != e * seg or h_w != h or sw1.shape != (e, n)
            or sx.shape != (e, num_ranks * seg)):
        raise ValueError(f"fused_dispatch_gmm1_rank takes xsend [R, E·seg, H], w1 [E, H, N], "
                         f"sw1 [E, N] and sx [E, R·seg] (R {num_ranks}, seg {seg}); got "
                         f"{tuple(xsend.shape)}, {tuple(w1.shape)}, {tuple(sw1.shape)}, "
                         f"{tuple(sx.shape)}")


def fused_dispatch_gmm1_rank_plain(xsend, w1, sw1, sx, *, group=None, num_ranks: int,
                                   seg: int, counts=None):
    """The plain version of :func:`fused_dispatch_gmm1_rank`: the blocks of
    ``xsend`` exchanged by ``all_to_all_single`` (block d to rank d; with
    ``counts``, rows past a segment's count zeroed first), the rows of
    expert e from source s placed at ``[e, s·seg + i]``, then per expert the
    exact int8 product times ``sx`` and ``sw1``, cast to bf16."""
    _check(xsend, w1, sw1, sx, num_ranks, seg)
    e_local, h, n = w1.shape
    if counts is not None:
        live = torch.arange(seg, device=xsend.device)[None, None, :] < counts[:, :, None]
        xsend = torch.where(live.reshape(num_ranks, e_local * seg, 1), xsend, 0)
    recv = pallas_all_to_all_plain(xsend.contiguous(), group=group)      # [R src, E·seg, H]
    rows = recv.reshape(num_ranks, e_local, seg, h).transpose(0, 1).reshape(
        e_local, num_ranks * seg, h)
    out = torch.empty((e_local, num_ranks * seg, n), dtype=torch.bfloat16, device=xsend.device)
    for e in range(e_local):
        acc = (rows[e].double() @ w1[e].double()).float()
        out[e] = (acc * sx[e].float()[:, None] * sw1[e].float()[None, :]).to(torch.bfloat16)
    return out


def fused_dispatch_gmm1_rank_tiled_plain(xsend, w1, sw1, sx, *, group=None, num_ranks: int,
                                         seg: int, counts=None):
    """The CUDA kernel's walk on the CPU, for tests (no caller on the main
    path) → :func:`fused_dispatch_gmm1_rank`'s output.  The blocks of
    ``xsend`` and the send counts exchanged as the kernel's sends land them:
    the received rows in the window's expert-major order (row ``(e R + s) seg
    + i``) with the count that came with each (source, expert) segment; then
    each unit of :func:`gemm1_units`: zeros for its rows past the count (all
    of them in a dead segment), and for its live rows the exact sum over
    stages of 128 k, rounded to f32 once, ``× sx[row] × sw1[e, col]``, cast
    to bf16.  Rows past a count are never read, whatever ``xsend`` holds
    there."""
    _check(xsend, w1, sw1, sx, num_ranks, seg)
    e_local, h, n = w1.shape
    r = num_ranks
    sent = (torch.full((r, e_local), seg, dtype=torch.int32) if counts is None
            else counts.to(torch.int32).clamp(0, seg).cpu())
    rcnt = pallas_all_to_all_plain(sent.to(xsend.device), group=group).cpu()   # [R src, E]
    recv = pallas_all_to_all_plain(xsend.contiguous(), group=group)          # [R src, E·seg, H]
    win = recv.reshape(r, e_local, seg, h).transpose(0, 1).reshape(e_local * r * seg, h)
    sxf = sx.float().reshape(-1)
    out = torch.empty((e_local * r * seg, n), dtype=torch.bfloat16, device=xsend.device)
    for e, s, r0, tile_rows, bx in gemm1_units(e_local, r, seg, n):
        rows = min(max(int(rcnt[s, e]) - r0, 0), tile_rows)
        row0 = (e * r + s) * seg + r0
        cols = slice(bx * UNIT_COLS, min((bx + 1) * UNIT_COLS, n))
        out[row0 + rows:row0 + tile_rows, cols] = 0
        if rows:
            acc = torch.zeros((rows, cols.stop - cols.start), dtype=torch.float64)
            for k0 in range(0, h, 128):                              # exact: int8 sums in f64
                acc += (win[row0:row0 + rows, k0:k0 + 128].double()
                        @ w1[e, k0:k0 + 128, cols].double())
            d = acc.float() * sxf[row0:row0 + rows, None] * sw1[e, cols].float()[None, :]
            out[row0:row0 + rows, cols] = d.to(torch.bfloat16)
    return out.reshape(e_local, r * seg, n)


@counted
def fused_dispatch_gmm1_rank(xsend, w1, sw1, sx, *, group=None, num_ranks: int, seg: int,
                             counts=None, plain: bool = False):
    """One-sided dispatch + dequantizing GEMM1 of this rank (K16a).

    ``xsend [R, E_local·seg, H]`` int8, this rank's rows placed at ``[dst,
    e·seg + slot]`` (zeros elsewhere), ``w1 [E_local, H, N]`` int8, ``sw1
    [E_local, N]`` and ``sx [E_local, R·seg]`` f32 (the received rows'
    scales) → ``out [E_local, R·seg, N]`` bf16.  ``counts [R, E_local]``
    (optional): the live rows of each of this rank's (destination, expert)
    segments; the rows past them are taken as zeros.  CUDA tensors launch
    ``csrc/fused_kernel.cu`` on the group's window; CPU tensors, or
    ``plain``, take :func:`fused_dispatch_gmm1_rank_plain`."""
    size, me = group_info(group)
    if size != num_ranks:
        raise ValueError(f"num_ranks {num_ranks} but the group has {size} ranks")
    tensors = (xsend, w1, sw1, sx, *(() if counts is None else (counts,)))
    if plain or not on_cuda(*tensors):
        return fused_dispatch_gmm1_rank_plain(xsend, w1, sw1, sx, group=group,
                                              num_ranks=num_ranks, seg=seg, counts=counts)
    _check(xsend, w1, sw1, sx, num_ranks, seg)
    e_local, h, n = w1.shape
    if xsend.dtype != torch.int8 or w1.dtype != torch.int8 or h % 16 or n % 16:
        raise ValueError(f"fused_dispatch_gmm1_rank takes int8 rows and weights with H % 16 == "
                         f"0 and N % 16 == 0; got {xsend.dtype}, {w1.dtype} [{e_local}, {h}, "
                         f"{n}]")
    if num_ranks * e_local > MAX_SEGMENTS:
        raise ValueError(f"{num_ranks} ranks x {e_local} local experts exceed the window's "
                         f"{MAX_SEGMENTS} arrival flags")
    dev = xsend.device
    ws = [w1.contiguous(), sw1.float().contiguous(), sx.float().contiguous()]
    if ws[0].data_ptr() % 16:
        raise ValueError("fused_dispatch_gmm1_rank reads w1 by TMA: it must start 16-byte aligned")
    off_c = round_up(num_ranks * e_local * seg * h, 256)
    win = window(group, dev)
    win.ensure(off_c + num_ranks * e_local * 4)
    xs = xsend.contiguous()
    cnt = None if counts is None else counts.to(torch.int32).contiguous()
    out = torch.empty((e_local, num_ranks * seg, n), dtype=torch.bfloat16, device=dev)
    args = _Args(peers=win.peers.data_ptr(), mine=win.base, me=me, R=num_ranks,
                 epoch=win.next_epoch(), half=win.half, E=e_local, seg=seg, H=h, N=n, off_x=0,
                 off_c=off_c, xsend=xs.data_ptr(), counts=0 if cnt is None else cnt.data_ptr(),
                 w1=ws[0].data_ptr(), sw1=ws[1].data_ptr(), sx=ws[2].data_ptr(),
                 out=out.data_ptr(), ticket=_ticket(xs).data_ptr())
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.fused_kernel_launch(ctypes.addressof(args), cuda_lib.stream_ptr(xs)),
                   "fused_dispatch_gmm1_rank")
    fused_dispatch_gmm1_rank.launches += 1
    return out


def placed_rows(x, topk_idx, *, group=None, num_experts: int, num_ranks: int,
                seg_capacity: int, plain: bool = False):
    """The sender side of :func:`fused_dispatch_gmm1`: per-token int8 quant
    (K5, or its plain version with ``plain`` or on the CPU), the routing plan
    with ``pair_capacity = E_local·seg``, each surviving (token, k) pair's
    row placed at ``(dst, e·seg + slot)`` with ``sp = (dest_slot // (R·seg))
    ·seg + dest_slot % seg``, and the row scales' all-to-all.  Returns
    ``(xsend [R, E_local·seg, H] int8, sx [E_local, R·seg], plan)``."""
    _, me = group_info(group)
    h = x.shape[1]
    e_local = num_experts // num_ranks
    seg = seg_capacity
    er = e_local * seg
    plan = make_routing_plan(topk_idx, num_experts=num_experts, num_ranks=num_ranks,
                             my_rank=me, pair_capacity=er, seg_capacity=seg)
    xq, scale = (quant_per_token_ref if plain or not on_cuda(x) else quant_per_token)(x)
    sp = (plan.dest_slot // (num_ranks * seg)) * seg + plan.dest_slot % seg
    sp = torch.where(plan.ok, sp, er).long()
    dst = torch.where(plan.ok, plan.dst_rank, num_ranks).long()
    xsend = torch.zeros((num_ranks + 1, er + 1, h), dtype=torch.int8, device=x.device)
    xsend[dst, sp] = xq[plan.src_token]
    ssend = torch.zeros((num_ranks + 1, er + 1), dtype=torch.float32, device=x.device)
    ssend[dst, sp] = scale[plan.src_token]
    srecv = all_to_all(ssend[:num_ranks, :er].contiguous(), group)      # [R src, E·seg]
    sx = srecv.reshape(num_ranks, e_local, seg).transpose(0, 1).reshape(e_local, num_ranks * seg)
    return xsend[:num_ranks, :er], sx, plan


def fused_dispatch_gmm1(x, topk_idx, w1, sw1, *, group=None, num_experts: int,
                        num_ranks: int, seg_capacity: int, plain: bool = False):
    """The routed fused dispatch → GEMM1 of this rank's tokens (JAX's
    ``fused_dispatch_gmm1``): :func:`placed_rows`, then
    :func:`fused_dispatch_gmm1_rank` with the plan's send counts.  ``x [T,
    H]``, ``topk_idx [T, K]`` (global expert ids, -1 inactive), this rank's
    ``w1 [E_local, H, N]`` and ``sw1 [E_local, N]``; ``plain`` runs the
    plain versions.  Returns ``(out [E_local, R·seg, N] bf16, counts [E]``
    (this rank's send counts, as JAX's), ``handle)``."""
    t, k = topk_idx.shape
    e_local = num_experts // num_ranks
    kernel = on_cuda(x, topk_idx, w1, sw1) and not plain
    xsend, sx, plan = placed_rows(x, topk_idx, group=group, num_experts=num_experts,
                                  num_ranks=num_ranks, seg_capacity=seg_capacity,
                                  plain=not kernel)
    out = fused_dispatch_gmm1_rank(
        xsend, w1, sw1, sx, group=group, num_ranks=num_ranks, seg=seg_capacity,
        counts=plan.counts_per_expert.reshape(num_ranks, e_local), plain=not kernel)
    handle = DispatchHandle(plan.gather_idx.reshape(t, k), plan.ok.reshape(t, k), None, None)
    return out, plan.counts_per_expert, handle
