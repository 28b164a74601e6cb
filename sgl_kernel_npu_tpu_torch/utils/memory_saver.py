"""Pause and resume of device memory regions (a ``torch_memory_saver`` analogue).

Counterpart of ``sgl_kernel_npu_tpu/utils/memory_saver.py``: tagged regions
whose device memory can be released (``pause``) and restored (``resume``),
used for weight swapping and KV-cache eviction.

JAX drops the device array and hands back a fresh one on ``resume``.  The
port keeps the registered tensor object and releases its storage
(``untyped_storage().resize_(0)``); ``resume`` resizes the storage back and
copies the host backup in (zeros with ``cpu_backup=False``, the reference's
discard-and-recompute mode).  Code that holds the tensor, such as an
engine's cache list, works again after ``resume``.

On the card the regions of a tag live in a CUDA memory pool of the tag's
own (``torch.cuda.MemPool``; ``register`` moves the tensor's bytes there),
so their segments hold nothing else: a tensor made by the caching allocator
shares segments with others, and ``torch.cuda.empty_cache()`` hands a
segment back to CUDA only when all of it is free.  ``pause`` frees
every region of the tag, drops the pool and empties the cache, so the
regions' segments go back to CUDA (the caching allocator's segments:
a region under 10 MB shares a 20 MB one with the tag's others).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class _Region:
    tag: str
    tensor: torch.Tensor
    cpu_backup: bool
    nbytes: int
    paused: bool = False
    backup: torch.Tensor | None = None     # the host copy while paused


class MemorySaver:
    """Registry of pauseable device tensors."""

    def __init__(self):
        self._regions: dict[str, _Region] = {}
        self._pools: dict[tuple[str, torch.device], object] = {}   # (tag, card) → MemPool

    def _in_pool(self, tag: str, device: torch.device):
        """The context that routes this thread's allocations on ``device``
        into the tag's pool (made on first use)."""
        if (tag, device) not in self._pools:
            self._pools[tag, device] = torch.cuda.MemPool()
        return torch.cuda.use_mem_pool(self._pools[tag, device], device)

    def register(self, name: str, tensor: torch.Tensor, *, tag: str = "default",
                 cpu_backup: bool = True) -> torch.Tensor:
        """Register ``tensor`` (contiguous, the whole of its storage) under
        ``name``; returns it.  Views of it taken before keep its old bytes."""
        storage = tensor.untyped_storage()
        if tensor.storage_offset() or not tensor.is_contiguous() \
                or storage.nbytes() != tensor.nbytes or not storage.resizable():
            raise ValueError(f"region {name!r} must be a contiguous tensor owning the whole of a "
                             "resizable storage")
        if name in self._regions:
            raise ValueError(f"region {name!r} is registered already")
        region = _Region(tag, tensor, cpu_backup, tensor.nbytes)
        if tensor.is_cuda:
            with self._in_pool(tag, tensor.device):
                own = torch.empty_like(tensor)
            own.copy_(tensor)
            tensor.set_(own.untyped_storage(), 0, tensor.shape, tensor.stride())
        self._regions[name] = region
        return tensor

    def get(self, name: str) -> torch.Tensor:
        r = self._regions[name]
        if r.paused:
            raise RuntimeError(f"region {name!r} is paused")
        return r.tensor

    def _tagged(self, tag: str, paused: bool) -> list[_Region]:
        return [r for r in self._regions.values() if r.tag == tag and r.paused == paused]

    def pause(self, tag: str = "default") -> int:
        """Release the device memory of every live region tagged ``tag``
        (after copying it to the host where ``cpu_backup``); returns the bytes
        freed."""
        regions = self._tagged(tag, paused=False)
        for r in regions:
            if r.cpu_backup:
                r.backup = torch.empty(r.tensor.shape, dtype=r.tensor.dtype,
                                       pin_memory=r.tensor.is_cuda)
                r.backup.copy_(r.tensor, non_blocking=True)
        _synchronize(regions)
        for r in regions:
            r.tensor.untyped_storage().resize_(0)
            r.paused = True
        if any(r.tensor.is_cuda for r in regions):
            for key in [k for k in self._pools if k[0] == tag]:
                del self._pools[key]       # its segments are free: empty_cache takes them
            torch.cuda.empty_cache()
        return sum(r.nbytes for r in regions)

    def resume(self, tag: str = "default") -> None:
        """Give every paused region tagged ``tag`` its device memory back,
        holding its backup (zeros where ``cpu_backup=False``)."""
        regions = self._tagged(tag, paused=True)
        for r in regions:
            storage = r.tensor.untyped_storage()
            if r.tensor.is_cuda:
                with self._in_pool(tag, r.tensor.device):
                    storage.resize_(r.nbytes)
            else:
                storage.resize_(r.nbytes)
            if r.backup is not None:
                r.tensor.copy_(r.backup, non_blocking=True)
            else:
                r.tensor.zero_()
            r.paused = False
        _synchronize(regions)
        for r in regions:
            r.backup = None

    def device_bytes(self) -> int:
        """Bytes of the live (not paused) regions."""
        return sum(r.nbytes for r in self._regions.values() if not r.paused)


def _synchronize(regions: list[_Region]) -> None:
    for dev in {r.tensor.device for r in regions if r.tensor.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
