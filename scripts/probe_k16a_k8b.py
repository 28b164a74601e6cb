#!/usr/bin/env python3
"""Time K16a (``fused_dispatch_gmm1_rank``) and K8b
(``grouped_matmul_combine``, with the split of a call into its two passes)
at the main path's shapes on one NVIDIA GPU, beside their bounds, with K8a's
int8 modes and K16b as guards.

    python3 scripts/probe_k16a_k8b.py [--out probe.json] [--only k16a|k8b|guard]

Run from a repository root (or with it on ``sys.path``): the cases go through
that tree's package and ``chip_smoke`` helpers (the timer evicts the L2 before
every launch and takes the median), so the same script times two trees in one
call: unpack the parent with ``git archive`` into a git-ignored directory and
run parent, change, change, parent.  Random inputs from seeds, DeepSeek-V3's
widths (layer 0's W8A8 experts of ``chip_smoke``'s weights), a one-rank NCCL
group (``chip_smoke.ep_group``):

- K16a through ``fused_dispatch_gmm1`` at 8 and 64 tokens of random top-8
  routing, seg 128 (``chip_smoke.check_fused_dispatch``: held to its plain
  version, bit-equal to K8a ``dequant`` on the placed rows, timed beside its
  bound and the unfused form), and the output digests (SHA-256 of the bits)
  of routed calls at 8 and 64 tokens with seg 128, 8 and 70;
- K8b through ``_gmm_moe``'s dispatch branch at 8, 64 and 512 tokens
  (``chip_smoke.check_dispatch_branch``: held to its plain version, timed
  beside its bound and K4), then on the same rows: each CUDA kernel of one
  call timed alone (the call captured into a CUDA graph, each kernel node
  relaunched from a graph of its own, L2 evicted and the device spun before
  each; the medians), and the digests of the expert rows ``d`` (the call's
  bf16 scratch) and of the output;
- guards: K8a's int8 modes, a layer's two at a 2048-token chunk (GMM1
  ``dequant_swiglu_quant`` and GMM2 ``dequant``, times and digests), and
  K16b (``Buffer.fused_deep_moe(single_kernel=True)``) at 64 tokens (time
  and digest).

Prints one line a case (chip_smoke's log) and the card, and writes the
numbers as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path.cwd()))

import chip_smoke as cs  # noqa: E402  (exits without a GPU)
import torch  # noqa: E402


def _rt_check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA runtime error {rc}")


def kernel_times(fn, iters: int = 10) -> list[tuple[str, float]]:
    """``[(kernel name, median ms)]`` of every kernel one ``fn()`` enqueues, in
    launch order: ``fn`` is run once on a side stream, captured there into a
    CUDA graph, and each kernel node is copied into a graph of its own and
    launched ``iters`` times between CUDA events, the L2 evicted and the
    device spun before each (``chip_smoke.time_ms``'s rule).  The nodes run in
    capture order, so a kernel reads what the one before it wrote."""
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=stream, capture_error_mode="relaxed"):
        fn()
    rt = ctypes.CDLL("libcudart.so.12")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _rt_check(rt.cudaGraphGetNodes(graph, None, ctypes.byref(n)), "cudaGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _rt_check(rt.cudaGraphGetNodes(graph, nodes, ctypes.byref(n)), "cudaGraphGetNodes")
    if cs._flush_buf is None:
        cs._flush_buf = torch.ones(16 << 20, dtype=torch.int32, device=cs.DEV)
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        _rt_check(rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
                  "cudaGraphNodeGetType")
        if kind.value != 0:                       # not a kernel
            continue
        params = (ctypes.c_void_p * 16)()          # cudaKernelNodeParams: func first
        _rt_check(rt.cudaGraphKernelNodeGetParams(ctypes.c_void_p(node), params),
                  "cudaGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        rc = rt.cudaFuncGetName(ctypes.byref(name), ctypes.c_void_p(params[0]))
        label = name.value.decode() if rc == 0 and name.value else "<kernel>"
        one, node1, exe = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
        _rt_check(rt.cudaGraphCreate(ctypes.byref(one), ctypes.c_uint(0)), "cudaGraphCreate")
        _rt_check(rt.cudaGraphAddKernelNode(ctypes.byref(node1), one, None, ctypes.c_size_t(0),
                                            params), "cudaGraphAddKernelNode")
        _rt_check(rt.cudaGraphInstantiateWithFlags(ctypes.byref(exe), one,
                                                   ctypes.c_ulonglong(0)),
                  "cudaGraphInstantiateWithFlags")
        events = []
        with torch.cuda.stream(stream):
            for _ in range(iters):
                cs._flush_buf.sum()
                torch.cuda._sleep(cs.SPIN_CYCLES)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _rt_check(rt.cudaGraphLaunch(exe, ctypes.c_void_p(stream.cuda_stream)),
                          "cudaGraphLaunch")
                end.record()
                events.append((start, end))
        torch.cuda.synchronize()
        out.append((label, statistics.median(s.elapsed_time(e) for s, e in events)))
        rt.cudaGraphExecDestroy(exe)
        rt.cudaGraphDestroy(one)
    del g
    return out


@contextlib.contextmanager
def scratch_of(shape: tuple, dtype):
    """Records every tensor of ``shape`` and ``dtype`` that ``torch.empty``
    makes inside the block (a wrapper's scratch, such as K8b's ``d``)."""
    seen, real = [], torch.empty

    def empty(*args, **kw):
        t = real(*args, **kw)
        if tuple(t.shape) == tuple(shape) and t.dtype == dtype:
            seen.append(t)
        return t

    torch.empty = empty
    try:
        yield seen
    finally:
        torch.empty = real


def k16a(moe0):
    from sgl_kernel_npu_tpu_torch.parallel import fused_kernel

    group = cs.dist.group.WORLD
    w1, s1, _, _ = moe0
    out = {}
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + 20)
    for n in (8, 64):
        out[f"{n} tokens"] = cs.check_fused_dispatch(gen, group, moe0, n, True)[0]
    digests = {}
    for n, seg in ((8, 128), (64, 128), (8, 8), (64, 70)):
        g = torch.Generator(device=cs.DEV).manual_seed(16 + n + seg)
        x = cs.randn(g, (n, cs.CFG.hidden))
        idx, _ = cs.deep_routing(g, n)
        y = fused_kernel.fused_dispatch_gmm1(x, idx, w1, s1, group=group,
                                             num_experts=cs.CFG.num_experts, num_ranks=1,
                                             seg_capacity=seg)[0]
        digests[f"{n} tokens seg {seg}"] = cs.digest(y)
    out["digests"] = digests
    cs.log(f"  K16a digests {json.dumps(digests)}")
    return out


def k8b(moe0):
    from sgl_kernel_npu_tpu_torch.ops import grouped_matmul as gmm

    w1, s1, w2, s2 = moe0
    out = {}
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + 19)
    for n in (8, 64, 512):
        r = dict(cs.check_dispatch_branch(gen, moe0, n, True)[1])
        g = torch.Generator(device=cs.DEV).manual_seed(800 + n)
        x = cs.randn(g, (n, cs.CFG.hidden))
        idx, w = cs.deep_routing(g, n)
        xq_tok, sx_tok, gs, dest, tok = cs.m._moe_rows(x, idx, cs.CFG.num_experts)
        h1, hs = gmm.grouped_matmul(xq_tok, w1, gs, sx_tok[tok.long()], s1,
                                    epilogue="dequant_swiglu_quant",
                                    dispatch_p=gmm.dispatch_onehot(tok, n))
        m_hi, m_lo = gmm.combine_masks(dest, w, tok.numel())
        call = lambda: gmm.grouped_matmul_combine(h1, w2, gs, hs, s2, m_hi, m_lo)  # noqa: E731
        with scratch_of((tok.numel(), w2.shape[2]), torch.bfloat16) as seen:
            y = call()
        torch.cuda.synchronize()
        kt = kernel_times(call)
        r.update(call_ms=cs.time_ms(call, 10), kernels=kt, d_digest=cs.digest(seen[0]),
                 out_digest=cs.digest(y))
        names = "; ".join(f"{k[:60]} {t:.4f}" for k, t in kt)
        cs.log(f"  K8b {n} tokens: {r['call_ms']:.4f} ms a call; alone: {names}; digests d "
               f"{r['d_digest']}, out {r['out_digest']}")
        out[f"{n} tokens"] = r
    return out


def guards(moe0):
    w1, s1, w2, s2 = moe0
    out = {}
    gen = torch.Generator(device=cs.DEV).manual_seed(2048)
    gs, tok, _ = cs.routing(gen, cs.LONG_CHUNK, cs.CFG.topk, cs.CFG.num_experts)
    x = cs.randn(gen, (cs.LONG_CHUNK, cs.CFG.hidden), torch.float32)
    sx = torch.clamp_min(cs.quant.row_scale(x), 1e-12)
    xq = cs.quant.saturate_int8(x / sx[:, None])
    xg, sxg = xq[tok.long()], sx[tok.long()]
    gm = cs.grouped_matmul.grouped_matmul
    g1 = lambda: gm(xg, w1, gs, sxg, s1, epilogue="dequant_swiglu_quant")  # noqa: E731
    h1, hs = g1()
    g2 = lambda: gm(h1, w2, gs, hs, s2, epilogue="dequant")  # noqa: E731
    y = g2()
    k = out["K8a 2048 tokens"] = dict(gmm1_ms=cs.time_ms(g1, 10), gmm2_ms=cs.time_ms(g2, 10),
                                      digests=[cs.digest(h1), cs.digest(hs), cs.digest(y)])
    cs.log(f"  K8a int8, a layer's two at 2048 tokens: {k['gmm1_ms'] + k['gmm2_ms']:.4f} ms "
           f"(GMM1 {k['gmm1_ms']:.4f}, GMM2 {k['gmm2_ms']:.4f}); digests {k['digests']}")
    g = torch.Generator(device=cs.DEV).manual_seed(1064)
    x = cs.randn(g, (64, cs.CFG.hidden))
    idx, w = cs.deep_routing(g, 64)
    buf = cs.Buffer(cs.dist.group.WORLD, cs.CFG.num_experts,
                    cs.EPConfig(comm_backend="pallas_ragged"))
    call = lambda: buf.fused_deep_moe(x, idx, w, *moe0, single_kernel=True)  # noqa: E731
    got = call()[0]
    k = out["K16b 64 tokens"] = dict(ms=cs.time_ms(call, 10), digest=cs.digest(got))
    cs.log(f"  K16b 64 tokens: {k['ms']:.4f} ms; digest {k['digest']}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the numbers here as JSON")
    ap.add_argument("--only", choices=("k16a", "k8b", "guard"), default=None,
                    help="these cases alone")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(card)
    cs.cuda_lib.load_library()
    res = {"card": card}
    cs.ep_group()
    moe0 = cs.m.init_quantized_experts(dataclasses.replace(cs.CFG, num_layers=1),
                                       cs.SEED + 1)[0]
    if args.only in (None, "k16a"):
        res["k16a"] = k16a(moe0)
    if args.only in (None, "k8b"):
        res["k8b"] = k8b(moe0)
    if args.only in (None, "guard"):
        res["guard"] = guards(moe0)
    cs.dist.destroy_process_group()
    cs.log(card)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1, default=str))


if __name__ == "__main__":
    main()
