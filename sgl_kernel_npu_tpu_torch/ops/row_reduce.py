"""Launch plan of the row-reduction kernels on ``csrc/row_reduce.cuh``: K5
(``quant_per_token``), K6a (``rms_norm``), K6b / K6c (``add_rms_norm_bias``,
``add_gemma_rms_norm``), K6d (``l1_norm``) and K7a (``swiglu_quant``).

A row of ``hidden`` elements is cut into vectors of 16 bytes (or of one
element, where the width or an address does not allow 16-byte accesses).
At decode-sized row counts a row is split across a thread-block cluster of
``cluster`` blocks, so that ``rows x cluster`` blocks fill the SMs; at chunk
sizes ``cluster`` is 1.  Block ``r`` of a row's cluster takes the span of
vectors ``[r per, (r + 1) per)``, ``per = ceil(nvec / cluster)``; its thread
``t`` holds the span's vectors ``t, t + threads, ...`` (``vecs`` of them) in
registers.  :func:`row_vectors` gives that map, which the kernels, the CPU
mirrors ``ops/norm.rms_norm_rows_plain`` / ``add_rms_norm_rows_plain`` /
``l1_norm_rows_plain`` and the tests share.  K6b / K6c read two inputs an
output vector (x and the residual), K7a too (its gate ‖ up: vector ``j``
reads 16 bytes at column ``j N`` of each half of the row); their plan
(``inputs = 2``) splits on the input's bytes and keeps one vector a thread
further.  K6d (:func:`l1_plan`) writes f32: its vectors are 16 bytes of the
output, so that each warp's loads and stores are whole contiguous spans.
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
# two inputs an output vector (K6b / K6c, K7a): one vector a thread up to
# MAX_THREADS of them at any row count, four rows a block at chunk sizes
TWO_INPUT_BLOCK_ROWS = 4
# K6d writes f32 from bf16 or f32: its vectors are 16 bytes of the output (4
# elements: an 8-byte load of bf16), four a thread at chunk sizes
L1_ELEM_BYTES, L1_CHUNK_VECS = 4, 4


class RowPlan(NamedTuple):
    cluster: int         # blocks a row (a thread-block cluster when > 1)
    threads: int         # a block, a multiple of 32
    vecs: int            # vectors a thread
    elems: int           # elements a vector: 16 bytes' worth, or 1
    block_rows: int = 1  # rows a block takes one after another (cluster 1)


def _row_plan(rows: int, hidden: int, elem_bytes: int, sms: int,
              aligned: bool = True, inputs: int = 1, chunk_vecs: int = 2) -> RowPlan:
    """The launch of a row reduction over ``[rows, hidden]`` of
    ``elem_bytes``-byte elements on a card of ``sms`` SMs; ``aligned``: every
    row's tensor starts 16-byte aligned (else the element path); ``inputs``:
    input spans of ``hidden`` read for each output row (1, or 2 for K6b /
    K6c and K7a), whose bytes decide the split; ``chunk_vecs``: vectors a
    thread at chunk sizes (one input).  The constants are the fastest of a
    sweep on the H100 at K5's, K6a's, K6b's, K6d's and K7a's main path shapes
    (PERF.md §6)."""
    n = 16 // elem_bytes
    elems = n if aligned and hidden % n == 0 else 1
    nvec = hidden // elems
    row_bytes = inputs * hidden * elem_bytes
    cluster = 1
    while (cluster < MAX_CLUSTER and rows * cluster < sms and row_bytes > SPLIT_BYTES
           and row_bytes > BLOCK_BYTES * cluster):
        cluster *= 2
    chunk = rows > CHUNK_BLOCKS * sms
    per = -(-nvec // cluster)
    one = per <= MAX_THREADS if inputs > 1 else per <= ONE_VEC and not chunk
    target = per if one else -(-per // (chunk_vecs if chunk and inputs == 1 else 2))
    threads = min(MAX_THREADS, max(32, -(-target // 32) * 32))
    block_rows = (TWO_INPUT_BLOCK_ROWS if inputs > 1 else 2) if chunk else 1
    return RowPlan(cluster, threads, -(-per // threads), elems, block_rows)


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


def launch_plan(x: torch.Tensor, *tensors: torch.Tensor, halves: int = 1,
                inputs: int | None = None, elem_bytes: int | None = None,
                chunk_vecs: int = 2) -> RowPlan:
    """The plan of a launch over ``x [rows, halves x hidden]`` on its card
    (output rows of ``hidden``; ``inputs`` spans of it read an output row,
    ``halves`` unless given): vectors of 16 bytes of ``elem_bytes``-byte
    elements (x's unless given) where each of ``x``'s ``halves`` spans and
    ``tensors`` (the other rows and vectors the kernel moves) start 16-byte
    aligned; ``chunk_vecs`` as :func:`_row_plan`'s."""
    rows, width = x.shape
    hidden = width // halves
    starts = [x.data_ptr() + k * hidden * x.element_size() for k in range(halves)]
    aligned = all(p % 16 == 0 for p in starts + [t.data_ptr() for t in tensors])
    return _row_plan(rows, hidden, elem_bytes or x.element_size(), _sm_count(x.device), aligned,
                     halves if inputs is None else inputs, chunk_vecs)


def l1_plan(rows: int, hidden: int, sms: int, aligned: bool = True) -> RowPlan:
    """K6d's plan over ``[rows, hidden]`` (bf16 or f32 in, f32 out): vectors
    of 16 bytes of the output, four a thread at chunk sizes."""
    return _row_plan(rows, hidden, L1_ELEM_BYTES, sms, aligned, chunk_vecs=L1_CHUNK_VECS)
