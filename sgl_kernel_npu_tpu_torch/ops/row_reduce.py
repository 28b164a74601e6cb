"""Launch plan of the row-reduction kernels: K5 (``quant_per_token``) and K6a
(``rms_norm``), both on ``csrc/row_reduce.cuh``.

A row of ``hidden`` elements is cut into vectors of 16 bytes (or of one
element, where the width or an address does not allow 16-byte accesses).
At decode-sized row counts a row is split across a thread-block cluster of
``cluster`` blocks, so that ``rows x cluster`` blocks fill the SMs; at chunk
sizes ``cluster`` is 1.  Block ``r`` of a row's cluster takes the span of
vectors ``[r per, (r + 1) per)``, ``per = ceil(nvec / cluster)``; its thread
``t`` holds the span's vectors ``t, t + threads, ...`` (``vecs`` of them) in
registers.  :func:`row_vectors` gives that map, which the kernels, the CPU
mirror ``ops/norm.rms_norm_rows_plain`` and the tests share.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

MAX_THREADS = 512     # a block (csrc/row_reduce.cuh rowr::MAX_THREADS)
VMAX = 8              # vectors a thread holds in registers (rowr::VMAX); more stream
MAX_CLUSTER = 8       # the portable cluster size
SPLIT_BYTES = 16384   # a decode row wider than this splits across a cluster ...
BLOCK_BYTES = 8192    # ... into blocks of at most this much of it
ONE_VEC = 384         # a block keeps up to this many vectors one a thread, else two
CHUNK_BLOCKS = 2      # chunk sizes: more rows than CHUNK_BLOCKS x SMs, two rows a block


class RowPlan(NamedTuple):
    cluster: int         # blocks a row (a thread-block cluster when > 1)
    threads: int         # a block, a multiple of 32
    vecs: int            # vectors a thread
    elems: int           # elements a vector: 16 bytes' worth, or 1
    block_rows: int = 1  # rows a block takes one after another (cluster 1)


def _row_plan(rows: int, hidden: int, elem_bytes: int, sms: int,
              aligned: bool = True) -> RowPlan:
    """The launch of a row reduction over ``[rows, hidden]`` of
    ``elem_bytes``-byte elements on a card of ``sms`` SMs; ``aligned``: every
    row's tensor starts 16-byte aligned (else the element path).  The
    constants are the fastest of a sweep on the H100 at K5's and K6a's main
    path shapes (PERF.md §6)."""
    n = 16 // elem_bytes
    elems = n if aligned and hidden % n == 0 else 1
    nvec = hidden // elems
    row_bytes = hidden * elem_bytes
    cluster = 1
    while (cluster < MAX_CLUSTER and rows * cluster < sms and row_bytes > SPLIT_BYTES
           and row_bytes > BLOCK_BYTES * cluster):
        cluster *= 2
    chunk = rows > CHUNK_BLOCKS * sms
    per = -(-nvec // cluster)
    target = per if per <= ONE_VEC and not chunk else -(-per // 2)
    threads = min(MAX_THREADS, max(32, -(-target // 32) * 32))
    return RowPlan(cluster, threads, -(-per // threads), elems, 2 if chunk else 1)


def row_vectors(plan: RowPlan, hidden: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(index, live)``, both ``[cluster, vecs, threads]``: the row's vector
    index of thread ``t``'s ``v``-th vector in the block of rank ``r``, and
    whether it lies inside the block's span (and the row)."""
    nvec = hidden // plan.elems
    per = -(-nvec // plan.cluster)
    r = torch.arange(plan.cluster)[:, None, None]
    j = (torch.arange(plan.vecs)[None, :, None] * plan.threads
         + torch.arange(plan.threads)[None, None, :])
    index = r * per + j
    return index, (j < per) & (index < nvec)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_plan(x: torch.Tensor, *tensors: torch.Tensor) -> RowPlan:
    """The plan of a launch over ``x [rows, hidden]`` on its card: 16-byte
    vectors where ``x`` and ``tensors`` (the other rows and vectors the kernel
    moves) start 16-byte aligned."""
    rows, hidden = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *tensors))
    return _row_plan(rows, hidden, x.element_size(), _sm_count(x.device), aligned)
