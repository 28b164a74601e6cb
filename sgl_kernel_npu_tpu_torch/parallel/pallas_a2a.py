"""One-sided window all-to-alls over a process group (K15a, K15b / K15c).

Counterpart of ``sgl_kernel_npu_tpu/parallel/pallas_a2a.py``, with its
module and function names.  JAX's kernels run inside ``shard_map`` over a
mesh axis and write their blocks into the peers' output buffers by remote
DMA; the port binds a ``torch.distributed`` process group to a
:class:`SymmetricWindow` (device memory on every rank, each rank's mapped
into every other's by CUDA IPC) and its kernels (``csrc/a2a.cu``) write
into the peers' windows and copy what arrived into a fresh output.  The
group carries the IPC handles only: counts and payloads move through the
windows, so a gloo group serves as well as NCCL.

- :func:`pallas_all_to_all` (K15a): ``x [R, ...]`` of any dtype →
  ``out[s]`` = rank s's ``x[me]`` (``lax.all_to_all(tiled=True)``).
- :func:`pallas_ragged_all_to_all` (K15b): ``x [R, C, ...]`` and ``counts
  [R]`` → ``(recv [R, C, ...], recv_counts [R])``: only the first
  ``counts[d]`` rows of block d cross, rows of ``recv[s]`` past
  ``recv_counts[s]`` are undefined.  ``monitor=True`` (K15c) bounds each
  wait by ``max_poll_rounds`` polls and also returns ``stats [R, 6]``
  (JAX's columns: 0 polls until the source's flag, 1 timeout, 2 abort seen,
  3 = col 0, 4 payload missing, 5 zero); ``inject_send_fault`` mutes this
  rank's sends (the timeout test).  Poll counts are the card's, not the TPU's.

CUDA tensors launch the kernels; CPU tensors take the plain versions on
``all_to_all_single`` over the group (:func:`pallas_all_to_all_plain`,
:func:`pallas_ragged_all_to_all_plain`).  A peer window that cannot be
opened raises: nothing falls back to the collective on the card.  JAX's
``axis_name``, ``collective_id``, ``interpret``, ``static_chunks``,
``force_sem_read`` and ``mesh_axes`` describe a TPU schedule or its
simulator and are not taken (ROADMAP §C).
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import cdiv, on_cuda, round_up
from sgl_kernel_npu_tpu_torch.utils.counters import counted

MAX_RANKS = 64             # csrc/window.cuh RMAX
MAX_SEGMENTS = MAX_RANKS * 256   # csrc/window.cuh: K16b's (source, expert) arrival flags
HEADER_BYTES = 2048 + 8 * MAX_SEGMENTS   # csrc/window.cuh DATA: the flags before the data
COUNTS_BYTES = 256         # csrc/a2a.cu: counts [RMAX] int32 at the start of a data half
FIXED_CHUNK = 1 << 16      # bytes a block copies at a time in K15a (one block up to this)
STATS_COLS = 6


def group_info(group) -> tuple[int, int]:
    """(size, this rank) of a process group (None: the default group)."""
    return dist.get_world_size(group), dist.get_rank(group)


class SymmetricWindow:
    """A window on every rank of ``group``: ``HEADER_BYTES`` of flags (each
    an epoch, never data) and two data halves of ``half`` bytes (the calls
    of even and odd epoch), each rank's allocation opened by every other
    rank through CUDA IPC.  ``peers``
    holds the base pointer of every rank's window in this process (its own:
    the allocation itself) as a device int64 tensor.  :meth:`ensure` grows
    it; every rank must call it with the same size, as every rank calls the
    same exchanges with the same shapes."""

    def __init__(self, group, device: torch.device):
        self.group, self.device = group, device
        self.size, self.rank = group_info(group)
        if self.size > MAX_RANKS:
            raise ValueError(f"a window serves at most {MAX_RANKS} ranks, the group has "
                             f"{self.size}")
        self.half = 0
        self.epoch = 0
        self.base = None
        self.opened: list[int] = []
        self.peers = None

    def ensure(self, half_bytes: int) -> None:
        """Make each data half at least ``half_bytes`` (collective)."""
        if half_bytes > self.half:
            self._allocate(round_up(max(half_bytes, 2 * self.half), 1 << 20))

    def next_epoch(self) -> int:
        self.epoch += 1
        return self.epoch

    def _gather(self, obj) -> list:
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def _allocate(self, half: int) -> None:
        lib = cuda_lib.load_library()
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device):
            base = ctypes.c_void_p()
            cuda_lib.check(lib, lib.window_alloc(HEADER_BYTES + 2 * half, ctypes.byref(base)),
                           "window_alloc")
            handle = ctypes.create_string_buffer(64)
            if self.size > 1:
                cuda_lib.check(lib, lib.window_ipc_handle(base, handle), "window_ipc_handle")
            handles = self._gather(handle.raw)
            peers, opened = [], []
            for r, h in enumerate(handles):
                if r == self.rank:      # a process cannot open its own handle
                    peers.append(base.value)
                    continue
                p = ctypes.c_void_p()
                rc = lib.window_ipc_open(ctypes.create_string_buffer(h, 64), ctypes.byref(p))
                if rc != 0:
                    raise RuntimeError(
                        f"rank {self.rank} cannot open rank {r}'s window by CUDA IPC: error "
                        f"{rc} ({lib.sgl_cuda_error_string(rc).decode()}); the one-sided "
                        "transports need every peer's window (no fallback)")
                peers.append(p.value)
                opened.append(p.value)
            self._gather(None)          # every rank holds the new windows
            for p in self.opened:
                cuda_lib.check(lib, lib.window_ipc_close(ctypes.c_void_p(p)), "window_ipc_close")
            self._gather(None)          # no rank still maps an old window
            if self.base is not None:
                cuda_lib.check(lib, lib.window_free(ctypes.c_void_p(self.base)), "window_free")
        self.base, self.opened, self.half = base.value, opened, half
        self.peers = torch.tensor([p - (1 << 64) if p >= 1 << 63 else p for p in peers],
                                  dtype=torch.int64, device=self.device)


_WINDOWS: dict = {}


def window(group, device: torch.device) -> SymmetricWindow:
    """The window of ``group`` on ``device`` (made on first use)."""
    key = (id(group if group is not None else dist.group.WORLD), device.index)
    win = _WINDOWS.get(key)
    if win is None:
        win = _WINDOWS[key] = SymmetricWindow(group, device)
    return win


def _check_ranks(x: torch.Tensor, group, num_ranks) -> tuple[int, int]:
    size, me = group_info(group)
    if num_ranks not in (None, size) or x.dim() < 1 or x.shape[0] != size:
        raise ValueError(f"x {tuple(x.shape)} needs one block per rank of the group ({size} "
                         f"ranks; num_ranks {num_ranks})")
    return size, me


def a2a_blocks(num_ranks: int, block_bytes: int, chunk_bytes: int) -> int:
    """Blocks of one launch of ``csrc/a2a.cu``: one a chunk of the capacity
    the host knows (``num_ranks`` blocks of ``block_bytes``), at least one.
    One block runs without grid syncs or a cooperative launch (K15a's
    per-expert counts, any payload up to one chunk); the kernel caps a larger
    grid at the co-resident one."""
    return max(1, cdiv(num_ranks * block_bytes, chunk_bytes))


def _launch(x: torch.Tensor, out: torch.Tensor, counts, group, *, rows: int, row_bytes: int,
            chunk_bytes: int, monitor: bool = False, max_polls: int = 0,
            fault: bool = False):
    """One launch of ``csrc/a2a.cu`` → ``(recv_counts [R] int32, stats [R, 6] | None)``."""
    size, me = group_info(group)
    win = window(group, x.device)
    block = rows * row_bytes
    win.ensure(COUNTS_BYTES + size * round_up(block, 256))
    recv_counts = torch.empty(size, dtype=torch.int32, device=x.device)
    stats = torch.empty((size, STATS_COLS), dtype=torch.int32, device=x.device) if monitor else None
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.a2a_launch(
        win.peers.data_ptr(), me, size, win.next_epoch(), win.half, x.data_ptr(), block,
        row_bytes, rows, chunk_bytes, None if counts is None else counts.data_ptr(),
        out.data_ptr(), recv_counts.data_ptr(), None if stats is None else stats.data_ptr(),
        int(monitor), max_polls, int(fault), a2a_blocks(size, block, chunk_bytes),
        cuda_lib.stream_ptr(x)), "pallas all-to-all")
    return recv_counts, stats


# ---------------------------------------------------------------------------
# K15a
# ---------------------------------------------------------------------------

def pallas_all_to_all_plain(x: torch.Tensor, *, group=None) -> torch.Tensor:
    """The plain version of :func:`pallas_all_to_all`: ``all_to_all_single``
    over the group."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


@counted
def pallas_all_to_all(x: torch.Tensor, *, group=None, num_ranks: int | None = None):
    """Window all-to-all (K15a): ``x [R, ...]`` (any dtype) → ``out [R, ...]``
    with ``out[s]`` = rank s's ``x[me]``, the blocks moved as bytes.  CUDA
    tensors launch ``csrc/a2a.cu``; CPU tensors take
    :func:`pallas_all_to_all_plain`."""
    _check_ranks(x, group, num_ranks)
    if not on_cuda(x):
        return pallas_all_to_all_plain(x, group=group)
    x = x.contiguous()
    out = torch.empty_like(x)
    _launch(x, out, None, group, rows=1, row_bytes=x[0].numel() * x.element_size(),
            chunk_bytes=FIXED_CHUNK)
    pallas_all_to_all.launches += 1
    return out


# ---------------------------------------------------------------------------
# K15b / K15c
# ---------------------------------------------------------------------------

def _ragged_args(x, counts, group, num_ranks, chunk_rows, monitor, inject_send_fault):
    size, _ = _check_ranks(x, group, num_ranks)
    if x.dim() < 2 or counts.shape != (size,):
        raise ValueError(f"pallas_ragged_all_to_all takes x [R, C, ...] and counts [R]; got "
                         f"{tuple(x.shape)} and {tuple(counts.shape)}")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    if inject_send_fault and not monitor:
        raise ValueError("inject_send_fault needs monitor=True: a muted rank with unbounded "
                         "waits would hang its peers")
    return size


def pallas_ragged_all_to_all_plain(x: torch.Tensor, counts: torch.Tensor, *, group=None,
                                   monitor: bool = False, max_poll_rounds: int = 5_000_000,
                                   inject_send_fault: bool = False):
    """The plain version of :func:`pallas_ragged_all_to_all` on
    ``all_to_all_single``: the counts, then every row (rows past a count
    are whatever the sender held).  With ``monitor`` the ranks also exchange
    whether they are muted: a muted source's count is 0 and its stats row
    reads a timeout after ``max_poll_rounds`` polls; every other row is 0
    (the no-fault stats of JAX's blocking waits)."""
    size = counts.shape[0]
    c = x.shape[1]
    cnt = counts.to(torch.int32).clamp(0, c)
    if inject_send_fault:
        cnt = torch.zeros_like(cnt)
    recv_counts = pallas_all_to_all_plain(cnt.contiguous(), group=group)
    recv = pallas_all_to_all_plain(x, group=group)
    if not monitor:
        return recv, recv_counts
    muted = pallas_all_to_all_plain(
        torch.full((size,), int(inject_send_fault), dtype=torch.int32, device=x.device),
        group=group).bool()
    stats = torch.zeros((size, STATS_COLS), dtype=torch.int32, device=x.device)
    stats[muted, 0] = stats[muted, 3] = max_poll_rounds
    stats[muted, 1] = stats[muted, 4] = 1
    return recv, torch.where(muted, 0, recv_counts), stats


@counted
def pallas_ragged_all_to_all(x: torch.Tensor, counts: torch.Tensor, *, group=None,
                             num_ranks: int | None = None, chunk_rows: int = 32,
                             monitor: bool = False, max_poll_rounds: int = 5_000_000,
                             inject_send_fault: bool = False):
    """Ragged window all-to-all (K15b): ``x [R, C, ...]``, ``counts [R]``
    live rows per destination → ``(recv [R, C, ...], recv_counts [R])``,
    only the live rows crossing, in ``chunk_rows`` pieces; rows of
    ``recv[s]`` past ``recv_counts[s]`` are undefined.  ``monitor`` runs
    K15c (:func:`pallas_ragged_all_to_all_monitored`, counted there) and
    also returns ``stats [R, 6]``.  CUDA tensors launch ``csrc/a2a.cu``; CPU
    tensors take :func:`pallas_ragged_all_to_all_plain`."""
    _ragged_args(x, counts, group, num_ranks, chunk_rows, monitor, inject_send_fault)
    if monitor:
        return pallas_ragged_all_to_all_monitored(
            x, counts, group=group, chunk_rows=chunk_rows, max_poll_rounds=max_poll_rounds,
            inject_send_fault=inject_send_fault)
    if not on_cuda(x, counts):
        return pallas_ragged_all_to_all_plain(x, counts, group=group)
    out, recv_counts = _ragged_launch(x, counts, group, chunk_rows)
    pallas_ragged_all_to_all.launches += 1
    return out, recv_counts


@counted
def pallas_ragged_all_to_all_monitored(x: torch.Tensor, counts: torch.Tensor, *, group=None,
                                       chunk_rows: int = 32, max_poll_rounds: int = 5_000_000,
                                       inject_send_fault: bool = False):
    """K15c, the monitored :func:`pallas_ragged_all_to_all`: K15b's kernel
    with bounded waits → ``(recv, recv_counts, stats [R, 6])``; a source
    whose flag does not arrive within ``max_poll_rounds`` polls times out
    (count 0, the abort broadcast to every peer) and the call returns."""
    _ragged_args(x, counts, group, None, chunk_rows, True, inject_send_fault)
    if not on_cuda(x, counts):
        return pallas_ragged_all_to_all_plain(x, counts, group=group, monitor=True,
                                              max_poll_rounds=max_poll_rounds,
                                              inject_send_fault=inject_send_fault)
    out, recv_counts, stats = _ragged_launch(x, counts, group, chunk_rows, True,
                                             max_poll_rounds, inject_send_fault)
    pallas_ragged_all_to_all_monitored.launches += 1
    return out, recv_counts, stats


def _ragged_launch(x, counts, group, chunk_rows, monitor=False, max_polls=0, fault=False):
    x = x.contiguous()
    out = torch.empty_like(x)
    rows = x.shape[1]
    row_bytes = x[0].numel() // max(rows, 1) * x.element_size()
    recv_counts, stats = _launch(
        x, out, counts.to(torch.int32).contiguous(), group, rows=rows, row_bytes=row_bytes,
        chunk_bytes=max(1, min(chunk_rows, rows) * row_bytes), monitor=monitor,
        max_polls=max_polls, fault=fault)
    return (out, recv_counts, stats) if monitor else (out, recv_counts)
