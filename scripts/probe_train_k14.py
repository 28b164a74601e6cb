#!/usr/bin/env python3
"""Time the MLA training backward, K14b (``mla_flash_bwd_dq``) and K14c
(``mla_flash_bwd_dk``), at the training path's shapes on one NVIDIA GPU,
beside their bounds and SDPA's backward, with K14a (``mla_flash_fwd``) as the
yardstick that must not move; and K16b (``fused_deep_moe_full_rank``) at a
64-token chunk.

    python3 scripts/probe_train_k14.py [--out probe.json] [--only k14|k16b]

Run from a repository root (or with it on ``sys.path``): the cases go
through that tree's ``chip_smoke`` checks and timer (the L2 evicted before
every launch), so the same script times two trees in one call.  Random
inputs from a seed, DeepSeek-V3's widths (128 heads, latent 512 + rope 64):

- chip_smoke [4h]'s shape, B 2 x S 520: ``check_mla_train`` (each kernel
  held to its plain version, timed beside its bound, its plain version and
  SDPA's forward / backward);
- a long-context training shape, B 1 x S 4096: K14a-c timed beside their
  bounds (no plain version: its [H, S, S] scores take ~35 GB);
- where the tree cuts K14c's rows into bands (``mla_train.dk_bands``),
  K14c at both shapes also at twice the committed bands a chunk (half as
  long, twice as many items) beside the committed ones, its output within
  chip_smoke's tolerance of the committed split's;
- K14a's output digest (SHA-256 of its bits) on a fixed case from a CPU
  seed, which the two trees must share, and K14b's / K14c's;
- K16b at 64 tokens of random top-8 routing on one layer's W8A8 experts
  (chip_smoke [4k]'s ``check_fused_full``: held to its plain version and the
  unfused form, timed beside its bound: the touched experts' weights read
  once) on a one-rank NCCL group.

Prints one line a case (chip_smoke's log) and the card, and writes the
numbers as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path.cwd()))

import chip_smoke as cs  # noqa: E402  (exits without a GPU)
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

LONG = (1, 4096, 128)


def inputs(gen, b, s, h):
    r = lambda *sh: cs.randn(gen, sh)  # noqa: E731
    x = (r(b, s, h, 512), r(b, s, h, 64), r(b, s, 512), r(b, s, 64))
    out, lse = cs.mt.mla_flash_fwd(*x, cs.CFG.sm_scale)
    do = r(b, s, h, 512)
    delta = (do.float() * out.float()).sum(-1)
    return x, (*x, do, lse, delta, cs.CFG.sm_scale)


def bounds(b, s, h):
    """chip_smoke's bounds of K14a, K14b, K14c (``check_mla_train``)."""
    return [cs.train_bound(b, s, h, 2 * (576 + 512), 2 * 576 + 2 * 512 + 4, 2 * 576),
            cs.train_bound(b, s, h, 2 * (576 + 512 + 576), 2 * 576 * 2 + 2 * 512 + 8, 2 * 576),
            cs.train_bound(b, s, h, 2 * (576 + 512 + 576 + 512), 2 * 576 + 2 * 512 + 8,
                           2 * 576 * 2)]


def long_context(gen):
    b, s, h = LONG
    x, args = inputs(gen, b, s, h)
    mt, sc = cs.mt, cs.CFG.sm_scale
    fns = {"mla_flash_fwd": lambda: mt.mla_flash_fwd(*x, sc),
           "mla_flash_bwd_dq": lambda: mt.mla_flash_bwd_dq(*args),
           "mla_flash_bwd_dk": lambda: mt.mla_flash_bwd_dk(*args)}
    out = {}
    for (name, fn), (bms, by) in zip(fns.items(), bounds(b, s, h)):
        out[name] = dict(ms=cs.time_ms(fn, 10), bound_ms=bms, bound_by=by)
        cs.log(f"  B {b} S {s} H {h} {name}: {out[name]['ms']:.4f} ms (bound {bms:.4f} {by})")
    return out, args


def other_split(args, label):
    """K14c at twice the committed bands a key chunk's width: times and the
    largest difference of dK_lat / dK_pe, relative to the tensor's largest
    |value|."""
    mt = cs.mt
    if not hasattr(mt, "dk_bands"):
        return None
    b, s, h = args[0].shape[:3]
    bands = mt.dk_bands
    u = 2 * bands(b, s, h, mt._sm_count(cs.DEV.index or 0))
    if 2 * h % u:
        return None
    want = mt.mla_flash_bwd_dk(*args)
    mt.dk_bands = lambda *a: u
    try:
        got = mt.mla_flash_bwd_dk(*args)
        ms = cs.time_ms(lambda: mt.mla_flash_bwd_dk(*args), 10)
    finally:
        mt.dk_bands = bands
    err = max(cs.max_abs(a, w) / float(w.float().abs().max()) for a, w in zip(got, want))
    cs.log(f"  {label}: K14c at {u} bands a chunk ({b * mt.dk_items(s, h, u)} items) "
           f"{ms:.4f} ms; against the committed split max |diff| / max |dK| {err:.3e} "
           f"(tol 1e-2)")
    if err > 1e-2:
        raise AssertionError("K14c's output moves with its split")
    return dict(bands=u, ms=ms, rel_diff=err)


def digests():
    """K14a-c's output bits at B 2 x S 520 x 128 heads from a CPU seed."""
    g = torch.Generator().manual_seed(14)
    b, s, h = cs.TRAIN_B, cs.TRAIN_S, cs.CFG.num_heads
    r = lambda *sh: torch.randn(sh, generator=g).to(cs.DEV, torch.bfloat16)  # noqa: E731
    x = (r(b, s, h, 512), r(b, s, h, 64), r(b, s, 512), r(b, s, 64))
    sc, mt = cs.CFG.sm_scale, cs.mt
    out, lse = mt.mla_flash_fwd(*x, sc)
    do = r(b, s, h, 512)
    args = (*x, do, lse, (do.float() * out.float()).sum(-1), sc)
    res = {"K14a out": out, "K14a lse": lse, "K14b": torch.cat(
        [t.flatten() for t in mt.mla_flash_bwd_dq(*args)]), "K14c": torch.cat(
        [t.flatten() for t in mt.mla_flash_bwd_dk(*args)])}
    d = {k: hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                           ).hexdigest()[:16] for k, t in res.items()}
    cs.log(f"  digests: {d}")
    return d


def k16b(gen):
    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    moe = cs.m.init_quantized_experts(dataclasses.replace(cs.CFG, num_layers=1), cs.SEED + 1)
    res = cs.check_fused_full(gen, dist.group.WORLD, moe[0], cs.PREFILL_CHUNK, True)
    del moe
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the numbers here as JSON")
    ap.add_argument("--only", choices=("k14", "k16b"), default=None,
                    help="these cases alone")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(card)
    cs.cuda_lib.load_library()
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    res = {"card": card}
    if args.only in (None, "k14"):
        res["digests"] = digests()
        b, s, h = cs.TRAIN_B, cs.TRAIN_S, cs.CFG.num_heads
        res["[4h]"] = dict(zip(cs.TRAIN_KERNELS, cs.check_mla_train(gen, b, s, h, True)))
        _, a4h = inputs(gen, b, s, h)
        res["[4h] K14c split"] = other_split(a4h, f"B {b} S {s} H {h}")
        del a4h
        res["long"], along = long_context(gen)
        res["long K14c split"] = other_split(along, "B {} S {} H {}".format(*LONG))
        del along
        torch.cuda.empty_cache()
    if args.only in (None, "k16b"):
        res["K16b 64 tokens"] = k16b(gen)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1, default=str))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
