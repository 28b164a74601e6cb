"""Device-time breakdown of a region from a ``torch.profiler`` trace.

Counterpart of ``sgl_kernel_npu_tpu/utils/trace_profile.py`` (which reads
``jax.profiler`` traces): run a callable once under the profiler and sum the
device time of every kernel by name.  The device's busy share is the summed
kernel time over the region's wall time (one stream: kernels do not overlap).
"""

from __future__ import annotations

import time

import torch


def device_breakdown(fn, top: int = 12):
    """Run ``fn`` once under the profiler → ``(rows, busy_ms, wall_ms)`` with
    ``rows`` = ``[(kernel name, total ms, launches)]`` sorted by time, the
    first ``top`` of them.  Empty rows mean the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.key, e.self_device_time_total / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return rows[:top], busy_ms, wall_ms
