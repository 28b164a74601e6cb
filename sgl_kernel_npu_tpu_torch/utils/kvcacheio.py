"""Host <-> device paged KV transfer (the L1 / L2 radix-cache offload).

Counterpart of ``sgl_kernel_npu_tpu/utils/kvcacheio.py``, the reference's
``transfer_kv_dim_exchange``: the device side is a per-layer list of
``[pages, ...]`` caches, the host side a page-major pool ``[host_pages,
num_layers, ...]``, so one host page holds every layer of a token page in
one contiguous block.

The device side moves pages with one gather or one scatter a layer.  The
host side moves them by DMA only: the named host pages are cut into runs of
consecutive ids (:func:`host_runs`) and each run is one ``copy_`` between
the device and the pool's rows, never a CPU gather or scatter of a page's
bytes.  Named host pages in one run (a whole pool, a fresh allocation) are
one copy.  A pool in pinned memory takes the copies asynchronously; each
transfer synchronises the stream before it returns.  Where JAX hands back
new device arrays, the port writes the device layers in place (the idiom of
its caches) and returns them.
"""

from __future__ import annotations

from enum import Enum

import numpy as np
import torch


class TransferDirection(Enum):
    H2D = 1
    D2H = 2


class TransferFlag(Enum):
    FAST2D = 2


def host_runs(host_idx) -> list[tuple[int, int, int]]:
    """``host_idx`` cut into runs of consecutive page ids: ``(i, j, h)`` says
    that positions ``i .. j-1`` name host pages ``h .. h + j - i - 1``."""
    h = np.asarray(host_idx, np.int64).reshape(-1)
    if h.size == 0:
        return []
    cuts = np.flatnonzero(np.diff(h) != 1) + 1
    starts, ends = np.concatenate(([0], cuts)), np.concatenate((cuts, [h.size]))
    return [(int(i), int(j), int(h[i])) for i, j in zip(starts, ends)]


def _check_ids(idx: np.ndarray, n: int, what: str) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(f"{what} page ids must lie in [0, {n}), got {idx.min()} to {idx.max()}")


def rows_to_host(pool: torch.Tensor, host_idx, rows: torch.Tensor) -> None:
    """``pool[host_idx] = rows``: one copy a run of ``host_idx``, asynchronous
    from a CUDA ``rows`` into a pinned ``pool`` (synchronise before the host
    reads the pool)."""
    h = np.asarray(host_idx, np.int64).reshape(-1)
    _check_ids(h, pool.shape[0], "host")
    if rows.shape[0] != h.size or rows.shape[1:] != pool.shape[1:]:
        raise ValueError(f"rows {tuple(rows.shape)} do not fit pool {tuple(pool.shape)} at "
                         f"{h.size} pages")
    for i, j, p in host_runs(h):
        pool[p : p + j - i].copy_(rows[i:j], non_blocking=True)


def rows_to_device(pool: torch.Tensor, host_idx, device) -> torch.Tensor:
    """``pool[host_idx]`` as a new tensor on ``device``: one copy a run of
    ``host_idx``, asynchronous from a pinned ``pool``."""
    h = np.asarray(host_idx, np.int64).reshape(-1)
    _check_ids(h, pool.shape[0], "host")
    out = torch.empty((h.size,) + tuple(pool.shape[1:]), dtype=pool.dtype, device=device)
    for i, j, p in host_runs(h):
        out[i:j].copy_(pool[p : p + j - i], non_blocking=True)
    return out


def synchronize(device: torch.device) -> None:
    """Wait for the copies queued on ``device``'s current stream (no-op on
    the CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def transfer_kv_dim_exchange(
    device_indices,
    host_indices,
    device_k: list[torch.Tensor],
    host_k: torch.Tensor,
    device_v: list[torch.Tensor] | None = None,
    host_v: torch.Tensor | None = None,
    *,
    page_size: int = 128,
    direction: TransferDirection = TransferDirection.H2D,
    flags: TransferFlag = TransferFlag.FAST2D,
):
    """Move KV pages between per-layer device caches and a page-major host
    pool (``page_size`` and ``flags`` keep the reference's signature; the
    layouts carry the page size).

    Args:
        device_indices / host_indices: page ids on each side, same length.
        device_k: per-layer list of ``[pages, ...]`` tensors.
        host_k: ``[host_pages, num_layers, ...]`` CPU pool (pinned for
            asynchronous copies from and to the card).

    D2H gathers the pages of every layer on the device and copies them into
    the pool's rows; H2D copies the pool's rows up once and scatters them
    into each layer, cast to its dtype.  Returns ``(device_k, host_k,
    device_v, host_v)``: the device layers and the host pools are updated in
    place.
    """
    d_idx = np.asarray(device_indices, np.int64).reshape(-1)
    h_idx = np.asarray(host_indices, np.int64).reshape(-1)
    if d_idx.shape != h_idx.shape:
        raise ValueError(f"{d_idx.size} device pages against {h_idx.size} host pages")

    def one(layers, pool):
        if pool is None or layers is None:
            return None
        if pool.shape[1] != len(layers):
            raise ValueError(f"host pool of {pool.shape[1]} layers for {len(layers)} device layers")
        dev = layers[0].device
        _check_ids(d_idx, layers[0].shape[0], "device")
        d = torch.from_numpy(d_idx).to(dev)
        if direction == TransferDirection.D2H:
            rows_to_host(pool, h_idx, torch.stack([layer.index_select(0, d) for layer in layers],
                                                  dim=1))
        else:
            pages = rows_to_device(pool, h_idx, dev)          # [n, layers, ...]
            for li, layer in enumerate(layers):
                layer.index_copy_(0, d, pages[:, li].to(layer.dtype))
        return dev

    devs = [one(device_k, host_k), one(device_v, host_v)]
    for dev in {d for d in devs if d is not None}:
        synchronize(dev)
    return device_k, host_k, device_v, host_v
