#!/usr/bin/env python3
"""Time K9a (``mla_prefill_pallas``) and K8a's int8 modes (``grouped_matmul``)
at the main path's shapes on one NVIDIA GPU, beside their bounds, plain
versions and library calls.

    python3 scripts/probe_prefill_k9a_k8a.py [--out probe.json]

Run from a repository root (or with it on ``sys.path``): the cases go
through that tree's ``chip_smoke`` checks (each held to its plain version,
then timed with the L2 evicted before every launch), so the same script
times two trees in one call.  Random inputs from a seed, DeepSeek-V3's
widths (layer 0's W8A8 experts of ``chip_smoke``'s weights):

- K9a on 128 heads: a 2048-row chunk at context 4096 (page 128, a 33-page
  table: [4c]'s call) and a 64-row chunk at context 700 (chip_smoke's small
  shape), each on a bf16 and an int8 latent; yardstick SDPA;
- K8a int8: a layer's two at a 2048-token chunk (GMM1
  ``dequant_swiglu_quant`` + GMM2 ``dequant``, 16384 rows of top-8 routing
  over 256 experts), ``dequant_swiglu`` to f32 on the experts repacked at
  pack width 1024, ``dequant`` to f32 and ``none`` at GMM2's shape (the
  same 16384 rows), ``dispatch_p`` into ``dequant_swiglu_quant`` at 512
  tokens (with K8b at the same routing, which keeps its own tile);
- kernels that keep the 64-row tile or the 16-row body, as yardsticks of
  the card's state: K2 at [4c]'s decode contexts on the int8 latent, K8b
  at 512 tokens, and on a one-rank NCCL group (``chip_smoke.ep_group``)
  K16b at 2048 tokens and K16a at 8.

Prints one line a case (chip_smoke's log) and the card, and writes the
numbers as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path.cwd()))

import chip_smoke as cs  # noqa: E402  (exits without a GPU)
import torch  # noqa: E402


def k9a_cases(gen):
    cfg = cs.CFG
    out = {}
    for kind, int8 in (("bf16", False), ("int8", True)):
        out[f"2048 x 4096 {kind}"] = cs.check_mla_prefill(
            gen, cfg.num_heads, cfg.page_size, [cs.LONG_CHUNK], [2 * cs.LONG_CHUNK], 0, True, int8,
            cs.LONG_PAGES_PER_REQ)
        out[f"64 x 700 {kind}"] = cs.check_mla_prefill(gen, cfg.num_heads, cfg.page_size,
                                                       [cs.PREFILL_CHUNK], [700], 0, True, int8)
    return out


def k8a_cases(gen, moe0):
    out = {}
    g1, g2 = cs.check_grouped_matmul(gen, moe0, cs.LONG_CHUNK, cs.CFG.topk, True)
    out["GMM1 dequant_swiglu_quant 2048 tokens"], out["GMM2 dequant 2048 tokens"] = g1, g2
    moe_n = cs.narrow_packing(moe0)
    swiglu, f32, none, _ = cs.check_k8a_modes(gen, moe0, moe_n)
    del moe_n
    out["dequant_swiglu tn 1024 f32 16384 rows"] = swiglu
    out["dequant f32 16384 rows"] = f32
    out["none int8 16384 rows"] = none
    k8d, k8b, _ = cs.check_dispatch_branch(gen, moe0, 512, True)
    out["dispatch_p 512 tokens"], out["K8b 512 tokens"] = k8d, k8b
    return out


def k16_cases(gen, moe0):
    cs.ep_group()
    group = cs.dist.group.WORLD
    try:
        return {"K16b 2048 tokens": cs.check_fused_full(gen, group, moe0, 2048, True),
                "K16a 8 tokens": cs.check_fused_dispatch(gen, group, moe0, 8, True)[0]}
    finally:
        cs.dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the numbers here as JSON")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(card)
    cs.cuda_lib.load_library()
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    res = {"card": card, "k9a": k9a_cases(gen)}
    long_ctx = [n + cs.NEW_TOKENS for n in cs.LONG_PROMPT_LENS]
    res["k2"] = cs.check_decode_mla(gen, len(long_ctx), cs.CFG.num_heads, cs.CFG.page_size,
                                    long_ctx, cs.MAX_BATCH - len(long_ctx), True, True,
                                    cs.LONG_PAGES_PER_REQ)
    moe0 = cs.m.init_quantized_experts(dataclasses.replace(cs.CFG, num_layers=1), cs.SEED + 1)[0]
    res["k8a"] = k8a_cases(gen, moe0)
    res["k16"] = k16_cases(gen, moe0)
    layer = [res["k8a"][f"GMM{i} {m} 2048 tokens"] for i, m in ((1, "dequant_swiglu_quant"),
                                                                  (2, "dequant"))]
    for key in ("ms", "bound_ms"):
        cs.log(f"  K8a, a layer's two at 2048 tokens, {key}: {sum(r[key] for r in layer):.4f}")
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
