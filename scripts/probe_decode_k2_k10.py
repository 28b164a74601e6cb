#!/usr/bin/env python3
"""Time K2 (``decode_mla``) and K10 (``lightning_indexer_scores_prefill_pallas``)
at the main path's shapes on one NVIDIA GPU, beside their bounds, plain
versions and library calls, with K9a and K9b as yardsticks that must not move.

    python3 scripts/probe_decode_k2_k10.py [--out probe.json] [--only k2|k10|latency]

Run from a repository root (or with it on ``sys.path``): the cases go
through that tree's ``chip_smoke`` checks (each held to its plain version,
then timed with the L2 evicted before every launch), so the same script
times two trees in one call.  Random inputs from a seed, DeepSeek-V3's
widths (128 heads, latent 512 + rope 64, page 128):

- K2 at chip_smoke [3]'s decode shape (8 rows of 112-716 keys on a 6-page
  table), bf16 and int8 latent, and on the int8 latent at [4c]'s decode
  contexts (5 rows of 916-4016 keys and 3 pad rows on a 33-page table);
  yardstick SDPA.  Where the tree has K2's split size
  (``decode_attention.MLA_SPLIT``), each case at splits of 64, 128, 256
  and 512 keys (a table of 4224 keys needs at least 320: 16 splits a row
  at most), then the committed one;
- K10 at [4d]'s shape (2048 tokens at context 4096, 64 heads x 128, a
  33-page table) and its decode shape (8 rows of one token); where the tree
  has K10's key splits (``lightning_indexer.LI_BLOCKS``), each also with
  the other choice of splitting (none at the decode shape, 3 splits at
  [4d]'s);
- yardsticks: K9a at 2048 x 4096 (bf16 and int8) and K9b on that chunk over
  the pages K10's scores select (bf16 and int8), plus a SHA-256 digest of
  each one's output on a fixed case (the two trees' must be equal).

``--only latency``: K2's fixed cost, one row of 64 heads (one block a
split) at contexts 1, 128 (one split), 716 (6 splits) and 4016 (13) on a
33-page table, bf16, beside a one-element ``torch.add`` (a launch), each
timed as the rest (chip_smoke's ``time_ms``).

Prints one line a case (chip_smoke's log) and the card, and writes the
numbers as JSON.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path.cwd()))

import chip_smoke as cs  # noqa: E402  (exits without a GPU)
import torch  # noqa: E402

CTX_DECODE = [716, 612, 556, 470, 320, 166, 112, 400]   # chip_smoke [3]'s decode rows
SPLITS = (64, 128, 256, 512)


def k2_cases(gen):
    cfg, da = cs.CFG, cs.da
    long_ctx = [n + cs.NEW_TOKENS for n in cs.LONG_PROMPT_LENS]
    cases = {
        "[3] bf16": lambda: cs.check_decode_mla(gen, cs.MAX_BATCH, cfg.num_heads, cfg.page_size,
                                                CTX_DECODE, 0, True),
        "[3] int8": lambda: cs.check_decode_mla(gen, cs.MAX_BATCH, cfg.num_heads, cfg.page_size,
                                                CTX_DECODE, 0, True, True),
        "[4c] int8": lambda: cs.check_decode_mla(gen, len(long_ctx), cfg.num_heads,
                                                 cfg.page_size, long_ctx,
                                                 cs.MAX_BATCH - len(long_ctx), True, True,
                                                 cs.LONG_PAGES_PER_REQ),
    }
    out = {}
    committed = getattr(da, "MLA_SPLIT", None)
    for name, run in cases.items():
        if committed is not None:
            for split in SPLITS:
                da.MLA_SPLIT = split
                cs.log(f"  K2 split {split}")
                out[f"{name} split {split}"] = run()
            da.MLA_SPLIT = committed
        out[name] = run()
    return out


def k10_cases(gen):
    li = cs.li
    page, pages, chunk = cs.CFG.page_size, cs.LONG_PAGES_PER_REQ, cs.LONG_CHUNK
    long_ctx = [n + cs.NEW_TOKENS for n in cs.LONG_PROMPT_LENS]
    full = lambda: cs.check_indexer(gen, "full width", [chunk], [2 * chunk], chunk,  # noqa: E731
                                    page, pages, True)
    dec = lambda: cs.check_indexer(gen, "decode shape", [1] * cs.MAX_BATCH,  # noqa: E731
                                   long_ctx + [1] * (cs.MAX_BATCH - len(long_ctx)), 1, page,
                                   pages, True)
    out = {}
    committed = getattr(li, "LI_BLOCKS", None)
    if committed is not None:
        li.LI_BLOCKS = 3 * 256
        out["[4d] 3 key splits"] = full()[2]
        li.LI_BLOCKS = 1
        out["decode shape, no key split"] = dec()[2]
        li.LI_BLOCKS = committed
    scores, (_, _, _, lq, lk, _), out["[4d]"] = full()
    out["decode shape"] = dec()[2]
    return out, scores, lq, lk


def yardsticks(gen, scores, lq, lk):
    cfg, mp = cs.CFG, cs.mp
    page, pages, chunk = cfg.page_size, cs.LONG_PAGES_PER_REQ, cs.LONG_CHUNK
    out = {}
    for kind, int8 in (("bf16", False), ("int8", True)):
        out[f"K9a 2048 x 4096 {kind}"] = cs.check_mla_prefill(
            gen, cfg.num_heads, page, [chunk], [2 * chunk], 0, True, int8, pages)
    page_scores = scores.reshape(1, chunk, pages, page).amax(-1)
    pos_sel = mp.select_prefill_pages(page_scores, lq, lk, cq=64, page_size=page,
                                      num_sel=cs.DSA_PAGES)
    for kind, int8 in (("bf16", False), ("int8", True)):
        out[f"K9b 2048 x 16 pages {kind}"] = cs.check_block_sparse(
            gen, "2048-row chunk at context 4096, pages from K10", cfg.num_heads, page, [chunk],
            [2 * chunk], pages, pos_sel, 64, True, int8=int8)
    return out


def digests():
    """K9a's and K9b's output bits on a fixed case from a CPU seed (heads
    128, page 16, requests of 1, 70 and 130 tokens at contexts 1, 90 and
    400), bf16 and int8."""
    cfg, mp = cs.CFG, cs.mp
    g = torch.Generator().manual_seed(3)
    seq, ctx, page, max_pages = [1, 70, 130], [1, 90, 400], 16, 25
    r = lambda *sh: torch.randn(sh, generator=g).to(cs.DEV, torch.bfloat16)  # noqa: E731
    kn, kr = r(3 * max_pages, 1, page, 512), r(3 * max_pages, 1, 64, page)
    q = r(sum(seq), cfg.num_heads, 576)
    bt = torch.arange(3 * max_pages, dtype=torch.int32, device=cs.DEV).reshape(3, max_pages)
    seq_t = torch.tensor(seq, dtype=torch.int32, device=cs.DEV)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=cs.DEV)
    sel = torch.randint(-1, 25, (3, 3, 8), generator=g).to(cs.DEV, torch.int32)
    out = {}
    for kind, int8 in (("bf16", False), ("int8", True)):
        kc = torch.clamp(torch.round(kn.float() * 32), -128, 127).to(torch.int8) if int8 else kn
        ks = 1 / 32 if int8 else None
        a = mp.mla_prefill_pallas(q, kc, kr, seq_t, bt, ctx_t, 0.07, max_q=130, k_scale=ks)
        b = mp.mla_prefill_block_sparse(q, kc, kr, seq_t, bt, ctx_t, 0.07, sel, max_q=130,
                                        q_chunk=64, k_scale=ks)
        for name, t in (("K9a", a), ("K9b", b)):
            out[f"{name} {kind}"] = hashlib.sha256(
                t.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
    cs.log(f"  digests: {out}")
    return out


def k2_latency(gen):
    da, page, pages = cs.da, cs.CFG.page_size, cs.LONG_PAGES_PER_REQ
    kn, kr = cs.paged_cache(gen, pages + 1, page)
    bt = torch.arange(1, pages + 1, dtype=torch.int32, device=cs.DEV)[None]
    q = cs.randn(gen, (1, 64, 576))
    one = torch.zeros(1, device=cs.DEV)
    out = {"torch.add of one element": cs.time_ms(lambda: one.add(1), 50)}
    for ctx in (1, 128, 716, 4016):
        c = torch.tensor([ctx], dtype=torch.int32, device=cs.DEV)
        out[f"K2 one row, 64 heads, ctx {ctx}"] = cs.time_ms(
            lambda: da.decode_mla(q, kn, kr, c, cs.CFG.sm_scale, bt), 50)
    for name, ms in out.items():
        cs.log(f"  {name}: {ms:.4f} ms")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the numbers here as JSON")
    ap.add_argument("--only", choices=("k2", "k10", "latency"), default=None,
                    help="these cases alone (no yardsticks)")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(card)
    cs.cuda_lib.load_library()
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    res = {"card": card}
    if args.only is None:
        res["digests"] = digests()
    if args.only == "latency":
        res["latency"] = k2_latency(gen)
    if args.only in (None, "k2"):
        res["k2"] = k2_cases(gen)
    if args.only in (None, "k10"):
        res["k10"], scores, lq, lk = k10_cases(gen)
        if args.only is None:
            res["yardsticks"] = yardsticks(gen, scores, lq, lk)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
