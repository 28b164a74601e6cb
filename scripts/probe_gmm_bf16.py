#!/usr/bin/env python3
"""Time K8a's bf16 modes (``grouped_matmul_float`` / ``grouped_matmul_dx``,
``sgl_kernel_npu_tpu_torch/csrc/grouped_matmul.cu``) at the main path's
shapes and at uniform group sizes, on one NVIDIA GPU.

    python3 scripts/probe_gmm_bf16.py [--out probe_gmm_bf16.json] [--skip-training]

Each case goes through ``chip_smoke.check_grouped_bf16``: held to its plain
version, then timed with the L2 evicted before every launch, beside
``torch._grouped_mm`` and the bytes bound.  Random bf16 weights and rows
from a seed:

- GPT-OSS-20B, a layer's two products at a 512-token chunk (2048 rows,
  top-4 of 32 experts, chip_smoke's routing): gate | up [32, 2880, 5760],
  down [32, 2880, 2880];
- the same two products with every group at 64 rows (one work item of the
  first design and of the second) and at 96 rows (two items of 64 rows, one
  of 128): what the item size costs;
- the routed GPT-OSS products again with the rows gathered by an identity
  ``dispatch_p`` (cp.async in place of TMA for the rows);
- DeepSeek-V3 training (8320 rows, top-8 of 256): the three forward
  products and the three dx (``rhs_contract_last``).

Run from the repository root or with it on ``sys.path``.  Prints one line a
case and writes them all as JSON.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402  (exits without a GPU)
import torch  # noqa: E402


def gpt_cases(gen):
    cfg = cs.CFG_GPT
    rows = cs.GPT_CHUNK * cfg.topk
    w1 = cs.randn(gen, (cfg.num_experts, cfg.hidden, 2 * cfg.intermediate), scale=0.02)
    w2 = cs.randn(gen, (cfg.num_experts, cfg.intermediate, cfg.hidden), scale=0.02)
    x1, x2 = cs.randn(gen, (rows, cfg.hidden)), cs.randn(gen, (rows, cfg.intermediate))
    routed, _, _ = cs.routing(gen, cs.GPT_CHUNK, cfg.topk, cfg.num_experts)
    for name, gs in (("routed", routed),
                     ("64 rows a group", torch.full_like(routed, 64)),
                     ("96 rows a group", torch.full_like(routed, 96))):
        n = int(gs.sum())
        yield (f"GPT-OSS-20B gate | up, {name}", x1[:n] if n <= rows else cs.randn(
            gen, (n, cfg.hidden)), w1, gs, False)
        yield (f"GPT-OSS-20B down, {name}", x2[:n] if n <= rows else cs.randn(
            gen, (n, cfg.intermediate)), w2, gs, False)


def training_cases(gen):
    c = cs.CFG_TRAIN
    gs, _, _ = cs.routing(gen, cs.TRAIN_B * cs.TRAIN_S, c.topk, c.num_experts)
    rows = cs.TRAIN_B * cs.TRAIN_S * c.topk
    xh, xi = cs.randn(gen, (rows, c.hidden)), cs.randn(gen, (rows, c.moe_intermediate))
    w_in = cs.randn(gen, (c.num_experts, c.hidden, c.moe_intermediate), scale=0.02)
    w_out = cs.randn(gen, (c.num_experts, c.moe_intermediate, c.hidden), scale=0.02)
    yield "DeepSeek-V3 training gate (up alike)", xh, w_in, gs, False
    yield "DeepSeek-V3 training down", xi, w_out, gs, False
    yield "DeepSeek-V3 training dx through gate (up alike)", xi, w_in, gs, True
    yield "DeepSeek-V3 training dx through down", xh, w_out, gs, True


def gathered(label, x, w, gs):
    """The same product with the rows gathered by an identity ``dispatch_p``
    (the kernel's cp.async path in place of the rows' TMA boxes, after the
    prologue that scans P), bit-equal to the contiguous rows' product."""
    from sgl_kernel_npu_tpu_torch.ops import grouped_matmul as gm

    p = gm.dispatch_onehot(torch.arange(x.shape[0], device=cs.DEV, dtype=torch.int32),
                           x.shape[0], torch.bfloat16)
    y, y_ref = gm.grouped_matmul_float(x, w, gs, dispatch_p=p), gm.grouped_matmul_float(x, w, gs)
    torch.cuda.synchronize()
    if not torch.equal(y, y_ref):
        raise AssertionError(f"{label}: the gathered rows' product differs from the TMA rows'")
    ms = cs.time_ms(lambda: gm.grouped_matmul_float(x, w, gs, dispatch_p=p), 10)
    cs.log(f"    rows gathered by dispatch_p: {ms:.4f} ms (bit-equal to the contiguous rows)")
    return dict(case=f"{label}, dispatch_p", ms=ms)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="probe_gmm_bf16.json")
    ap.add_argument("--skip-training", action="store_true")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + 31)
    results = []
    cases = [gpt_cases(gen)] + ([] if args.skip_training else [training_cases(gen)])
    for group in cases:
        for label, x, w, gs, contract_last in group:
            res = cs.check_grouped_bf16(label, x, w, gs, contract_last, True)
            results.append(dict(case=label, **res))
            if label.startswith("GPT-OSS-20B") and "routed" in label:
                results.append(gathered(label, x, w, gs))
    pathlib.Path(args.out).write_text(json.dumps(dict(card=card, results=results), indent=1))
    print(card)


if __name__ == "__main__":
    main()
