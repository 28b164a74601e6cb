#!/usr/bin/env python3
"""Where the time of the expert-parallel exchange calls goes on one NVIDIA GPU:
host wall time against device time, and the device time by kernel.

    python3 scripts/probe_ep_modes.py [--out probe.json]

Run from a repository root (or with it on ``sys.path``).  One NCCL rank over
an in-process store; ``chip_smoke``'s setup (DeepSeek-V3's widths, seeds).
Calls, each on the ``"xla"`` and ``"pallas_ragged"`` transports:

- ``Buffer.low_latency_dispatch`` (int8) and ``low_latency_combine`` (bf16)
  at the reference's decode default: 128 tokens x 7168, top-8 of 256, about
  a quarter of the slots -1 (``chip_smoke.ll_inputs``);
- ``Buffer.dispatch`` / ``combine`` on the same tokens;
- ``Buffer.dispatch`` of a 2048-token chunk in one round and in four
  (``rounds=4``).

Each call is measured three ways: the host's wall time of a call between two
``torch.cuda.synchronize()`` (median of 10); the device time by CUDA events
after a spin of ~50 ms, so that the host has enqueued the whole call before
the start event runs (median of 5); and ``torch.profiler`` over one call:
the CUDA kernels it launched, their summed device time and the largest.
Prints one line a call with the card's name and power limit, and writes the
numbers as JSON.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path.cwd()))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sgl_kernel_npu_tpu_torch.config import EPConfig  # noqa: E402
from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer  # noqa: E402

LONG_SPIN = 100_000_000          # ~50 ms at the H100's boost clock


def wall_ms(fn, iters=10) -> float:
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernels(fn) -> dict:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    return {"launches": sum(r[1] for r in rows), "kernel_ms": sum(r[2] for r in rows),
            "top": [(k[:60], n, round(ms, 4)) for k, n, ms in rows[:4]]}


def measure(label, fn, card) -> dict:
    res = {"wall_ms": wall_ms(fn), "device_ms": cs.time_ms(fn, 5, spin=LONG_SPIN), **kernels(fn)}
    cs.log(f"{card}, {label}: wall {res['wall_ms']:.4f} ms a call, device {res['device_ms']:.4f} "
           f"ms (events after a 50 ms spin), {res['launches']} CUDA kernels summing "
           f"{res['kernel_ms']:.4f} ms (profiler); the largest four: {res['top']}")
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.cuda_lib.load_library()
    cs.ep_group()
    group = torch.distributed.group.WORLD
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + 23)
    x, idx, w = cs.ll_inputs(gen, cs.LL_TOKENS)
    xl = cs.randn(gen, (cs.MR_TOKENS, cs.CFG.hidden))
    idl, _ = cs.deep_routing(gen, cs.MR_TOKENS)
    out = {"card": card}
    for backend in ("xla", "pallas_ragged"):
        buf = Buffer(group, cs.CFG.num_experts, EPConfig(comm_backend=backend))
        rx, sc, _, h, _ = buf.low_latency_dispatch(x, idx)
        y = cs.ll_expert_step(rx, sc)
        xs, _, _, hn, _ = buf.dispatch(x, idx)
        ys = xs.to(torch.bfloat16)
        calls = {"low_latency_dispatch": lambda: buf.low_latency_dispatch(x, idx),
                 "low_latency_combine": lambda: buf.low_latency_combine(y, w, h),
                 "dispatch": lambda: buf.dispatch(x, idx),
                 "combine": lambda: buf.combine(ys, w, hn),
                 "dispatch_2048_one_round": lambda: buf.dispatch(xl, idl, rounds=1),
                 "dispatch_2048_four_rounds": lambda: buf.dispatch(xl, idl, rounds=4)}
        for name, fn in calls.items():
            out[f"{backend}:{name}"] = measure(f"{backend} {name}", fn, card)
        del rx, sc, y, h
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
