#!/usr/bin/env python3
"""Time K12d (``attention_sinks_prefill_pallas``) and K1 (``quant_matmul``)
at the main path's shapes on one NVIDIA GPU, beside their bounds, plain
versions and library calls.

    python3 scripts/probe_prefill_k12d_k1.py [--out probe.json]

Run from a repository root (or with it on ``sys.path``): the cases go
through that tree's ``chip_smoke.check_paged_prefill`` and
``chip_smoke.check_quant_matmul`` (held to the plain version, then timed
with the L2 evicted before every launch), so the same script times two
trees in one call.  Random inputs from a seed:

- K12d on a 512-row chunk at context 1024, page 16: Llama-3.1-8B's heads
  (32 / 8 x 128, no sinks, no window) and GPT-OSS-20B's (64 / 8 x 64, sinks)
  on its full layer and its window-128 layer, each on a bf16 and an int8
  cache (per-kv-head scales);
- K1 at DeepSeek-V3's widths: a layer's five W8A8 GEMMs at 8 rows (wdqkv,
  wuq, wo, shared gate || up, shared down), wo at a 64-row chunk, wdqkv and
  wuq at a 2048-row chunk.

Prints one line a case (chip_smoke's log) and the card, and writes the
numbers as JSON.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path.cwd()))

import chip_smoke as cs  # noqa: E402  (exits without a GPU)
import torch  # noqa: E402

LLAMA = (32, 8, 128)
GPT = (64, 8, 64)
# DeepSeek-V3's W8A8 GEMMs as [N, K]: the fused prologue's two, the W8A8
# layer's three
K1_SHAPES = {"wdqkv": (2112, 7168), "wuq": (24576, 1536), "wo": (7168, 16384),
             "ws_gate_up": (4096, 7168), "ws_down": (7168, 2048)}


def k12d_cases(gen):
    out = {}
    for kind in ("bf16", "int8"):
        out[f"llama {kind}"] = cs.check_paged_prefill(gen, [512], [1024], 0, 0, True, heads=LLAMA,
                                                      kind=kind, with_sinks=False)
        for window in (0, 128):
            out[f"gpt-oss window {window} {kind}"] = cs.check_paged_prefill(
                gen, [512], [1024], window, 0, True, heads=GPT, kind=kind)
    return out


def k1_cases(gen):
    w = {}
    for name, (n, k) in K1_SHAPES.items():
        w[name] = (torch.randint(-128, 128, (n, k), generator=gen, device=cs.DEV,
                                 dtype=torch.int8),
                   torch.rand(n, generator=gen, device=cs.DEV) / 1000,
                   torch.randint(-1000, 1000, (n,), generator=gen, device=cs.DEV,
                                 dtype=torch.int32) if name in ("wdqkv", "wuq") else None)
    out = {f"{name} at 8 rows": cs.check_quant_matmul(gen, name, *w[name], 8, timed=True)
           for name in K1_SHAPES}
    out["wo at 64 rows"] = cs.check_quant_matmul(gen, "wo", *w["wo"], 64, timed=True)
    for name in ("wdqkv", "wuq"):
        out[f"{name} at 2048 rows"] = cs.check_quant_matmul(gen, name, *w[name], 2048,
                                                            timed=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the numbers here as JSON")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(card)
    cs.cuda_lib.load_library()
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    res = {"card": card, "k12d": k12d_cases(gen), "k1": k1_cases(gen)}
    dec = [res["k1"][f"{name} at 8 rows"] for name in K1_SHAPES]
    for key in ("ms", "library_ms", "bound_ms"):
        cs.log(f"  K1, a layer's five at 8 rows, {key}: {sum(r[key] for r in dec):.4f}")
    pre = [res["k1"][f"{name} at 2048 rows"] for name in ("wdqkv", "wuq")]
    for key in ("ms", "library_ms", "bound_ms"):
        cs.log(f"  K1, wdqkv + wuq at 2048 rows, {key}: {sum(r[key] for r in pre):.4f}")
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
