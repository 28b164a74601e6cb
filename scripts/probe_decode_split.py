#!/usr/bin/env python3
"""Time the paged decode kernel of ``sgl_kernel_npu_tpu_torch/csrc/sinks_attention.cu``
at several split sizes, on one NVIDIA GPU.

    python3 scripts/probe_decode_split.py [--out probe_decode_split.json]

Cases (page 16, random caches from a seed, ``chip_smoke.check_paged_decode``:
each call held to its plain version, then timed with the L2 evicted before
every launch, beside SDPA over the gathered keys and the bytes bound):

- K11a at Llama-3.1-8B's heads (32 / 8 x 128) over [4e]'s decode rows (316-2016
  keys and 3 pad rows, a 128-page table), bf16 and int8;
- the same rows and one more at 32768 keys on a 2048-page table, bf16;
- K12a at GPT-OSS-20B's heads (64 / 8 x 64), full attention and window 128,
  bf16.

The split size (keys a block) is set by replacing
``decode_attention.decode_split_size``; a row never takes more than
``DECODE_MAX_SPLITS`` splits, so a split is at least ``ceil(keys /
DECODE_MAX_SPLITS)`` rounded up to a chunk of 64.  Prints one line a (case,
split) and writes them all as JSON.
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

from sgl_kernel_npu_tpu_torch.ops.attention import decode_attention as da  # noqa: E402
from sgl_kernel_npu_tpu_torch.utils.common import cdiv, round_up  # noqa: E402

SPLITS = (128, 256, 512, 1024, 2048, 4096)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="probe_decode_split.json")
    out = pathlib.Path(ap.parse_args().out)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    llama = (cs.CFG_LLAMA.num_heads, cs.CFG_LLAMA.num_kv_heads, cs.CFG_LLAMA.head_dim)
    rows = [n + cs.NEW_TOKENS for n in cs.GPT_PROMPT_LENS]
    pads = cs.MAX_BATCH - len(rows)
    cases = [
        ("K11a bf16, [4f] rows", rows, 0, dict(heads=llama, with_sinks=False)),
        ("K11a int8, [4f] rows", rows, 0, dict(heads=llama, kind="int8", with_sinks=False)),
        ("K11a bf16, [4f] rows + 32768", rows + [cs.LONG_DECODE_KEYS], 0,
         dict(heads=llama, with_sinks=False, table_pages=cs.LONG_DECODE_KEYS // 16)),
        ("K12a bf16, full layer", rows, 0, {}),
        ("K12a bf16, window 128", rows, cs.CFG_GPT.sliding_window, {}),
    ]
    chosen = da.decode_split_size
    results = []
    try:
        for label, ctx, window, kw in cases:
            table_keys = kw.get("table_pages", cs.GPT_PAGES_PER_REQ) * 16
            keys = min(window, table_keys) if window else table_keys
            least = round_up(cdiv(keys, da.DECODE_MAX_SPLITS), da.DECODE_CHUNK)
            for split in sorted({max(s, least) for s in SPLITS if s < 2 * keys}):
                da.decode_split_size = lambda tk, w, split=split: split
                gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + 7)
                r = cs.check_paged_decode(gen, ctx, window, pads, True, **kw)
                results.append(dict(case=label, split=split, default=chosen(table_keys, window),
                                    **r))
                cs.log(f"  -> {label}: split {split} ({cdiv(keys, split)} splits; default "
                       f"{chosen(table_keys, window)}): {r['ms']:.4f} ms, SDPA "
                       f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f}")
    finally:
        da.decode_split_size = chosen
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "results": results}, indent=1))
    print(card)


if __name__ == "__main__":
    main()
