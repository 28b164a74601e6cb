"""Device-time breakdown of a region from a ``torch.profiler`` trace.

Counterpart of ``sgl_kernel_npu_tpu/utils/trace_profile.py`` (which reads
``jax.profiler`` traces): run a callable once under the profiler and sum the
device time of every kernel by name.  The device's busy share is the summed
kernel time over the region's wall time (one stream: kernels do not overlap).
"""

from __future__ import annotations

import collections
import ctypes
import time

import torch

# cudaGraphNodeType values of the CUDA runtime other than a kernel, for names
_NODE_TYPES = {1: "memcpy", 2: "memset", 3: "host", 4: "child graph", 5: "empty",
               6: "event wait", 7: "event record", 10: "mem alloc", 11: "mem free"}


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


_capture_stream = None


def graph_kernels(fn) -> list[tuple[str, int]]:
    """The device work one ``fn()`` enqueues, as ``[(name, count)]`` sorted
    by name: ``fn`` is called once on a side stream (so that scratch a
    wrapper keeps per stream exists), then captured there into a CUDA graph
    (not run) whose nodes are listed; a kernel by its symbol name (mangled
    where the runtime gives it so), any other node by its kind ("memset",
    "memcpy", ...).  Unlike a ``torch.profiler`` trace, which on some
    machines records none or part of a region's kernels, the graph holds
    every operation ``fn`` enqueued; ``fn`` must not synchronise with the
    host."""
    global _capture_stream
    if _capture_stream is None:
        _capture_stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(_capture_stream):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=_capture_stream, capture_error_mode="relaxed"):
        fn()
    rt = ctypes.CDLL("libcudart.so.12")       # the runtime PyTorch loaded
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _rt_check(rt.cudaGraphGetNodes(graph, None, ctypes.byref(n)), "cudaGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _rt_check(rt.cudaGraphGetNodes(graph, nodes, ctypes.byref(n)), "cudaGraphGetNodes")
    names = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        _rt_check(rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
                  "cudaGraphNodeGetType")
        if kind.value != 0:
            names[_NODE_TYPES.get(kind.value, f"node type {kind.value}")] += 1
            continue
        params = (ctypes.c_void_p * 16)()      # cudaKernelNodeParams: func first
        _rt_check(rt.cudaGraphKernelNodeGetParams(ctypes.c_void_p(node), params),
                  "cudaGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        rc = rt.cudaFuncGetName(ctypes.byref(name), ctypes.c_void_p(params[0]))
        names[name.value.decode() if rc == 0 and name.value else f"<kernel, name rc {rc}>"] += 1
    del g
    return sorted(names.items())


def _rt_check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA runtime error {rc}")
