"""Paged KV-cache management: slot allocation, cache-location ops, cache writes."""

from sgl_kernel_npu_tpu_torch.ops.mem_cache.allocator import alloc_decode, alloc_extend
from sgl_kernel_npu_tpu_torch.ops.mem_cache.cache_ops import (
    assign_cache_op,
    cache_loc_assign,
    cache_loc_update,
)

__all__ = ["alloc_decode", "alloc_extend", "assign_cache_op", "cache_loc_assign",
           "cache_loc_update"]
