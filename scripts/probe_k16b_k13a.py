#!/usr/bin/env python3
"""Time K16b (``fused_deep_moe_full_rank``) and K13a / K13b (``bgmv_fused`` /
``sgmv_fused``) at the main path's shapes on one NVIDIA GPU, beside their
bounds, plain versions and the unfused MoE, with K8a's int8 modes, K8b and
K16a as yardsticks.

    python3 scripts/probe_k16b_k13a.py [--out probe.json] [--only k16b|k13|yard|qwen]

Run from a repository root (or with it on ``sys.path``): the cases go through
that tree's package and ``chip_smoke`` helpers (the timer evicts the L2 before
every launch and takes the median), so the same script times two trees in one
call: unpack the parent with ``git archive`` into a git-ignored directory and
run parent, change, change, parent.  Random inputs from seeds, DeepSeek-V3's
widths (layer 0's W8A8 experts of ``chip_smoke``'s weights), a one-rank NCCL
group (``chip_smoke.ep_group``):

- K16b through ``Buffer.fused_deep_moe(single_kernel=True)`` at 8, 64, 512
  and 2048 tokens of random top-8 routing: its time, the unfused form's and
  ``_gmm_moe``'s on the same rows, its bound (the touched experts' weights
  read once), its output digest (SHA-256 of the bits), and its time with
  every pair dead (the fixed cost: count exchange, quant, barriers, syncs);
  where the tree's kernel stamps its phases (``phase_stamps``), the split of
  a call into entry, sends, GMM1, requant, GMM2, returns and reduce, and
  how far apart the blocks finish their GEMM units (the medians of 5
  stamped calls; ``%globaltimer``);
- K13a at T 8 and 512 over 4 and 64 adapters and K13b at chip_smoke's
  512-row shape (``check_bgmv`` / ``check_sgmv``: held to the plain version,
  timed beside the bound);
- yardsticks: K8a's int8 modes, a layer's two at a 2048-token chunk (GMM1
  ``dequant_swiglu_quant`` and GMM2 ``dequant``, times and digests), K8b
  at 8, 64 and 512 tokens (``check_dispatch_branch``), K16a at 8 tokens
  (``check_fused_dispatch``) and its digest.

``--only qwen`` times K16b at Qwen3-Next-80B-A3B's widths instead (512
experts top-10, H 2048, I 512: layer 0's W8A8 experts of weights drawn at
``chip_smoke.CFG_QWEN``'s widths) at 4 and 512 tokens, with its phases,
its fixed cost and the unfused form (``_gmm_moe`` is DeepSeek-V3's: not
timed there).

Prints one line a case (chip_smoke's log) and the card, and writes the
numbers as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path.cwd()))

import chip_smoke as cs  # noqa: E402  (exits without a GPU)
import torch  # noqa: E402

SIZES = (8, 64, 512, 2048)
PHASES = ("entry", "sends", "GMM1", "GMM1 sync", "requant", "GMM2", "returns", "reduce")


def digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def phase_split(ff, x, idx, w, moe0, seg, n_exp=cs.CFG.num_experts) -> dict | None:
    """K16b's phases from its stamps (ms; None where the tree has none)."""
    if not hasattr(ff, "fused_full_blocks"):
        return None
    st = torch.zeros((ff.fused_full_blocks(), ff.PHASE_STAMPS), dtype=torch.int64, device=cs.DEV)
    runs = []
    for _ in range(5):
        cs._flush_buf.sum()
        ff.fused_deep_moe_full_rank(x, idx, w, *moe0, group=cs.dist.group.WORLD,
                                    num_experts=n_exp, num_ranks=1,
                                    seg_capacity=seg, phase_stamps=st)
        torch.cuda.synchronize()
        s = st.double().cpu() / 1e6
        b0 = s[0]
        runs.append([b0[1] - s[:, 0].min(), s[:, 2].max() - b0[1],
                     s[:, 3].max() - s[:, 2].max(), b0[4] - s[:, 3].max(),
                     s[:, 5].max() - b0[4], s[:, 7].max() - b0[6], b0[9] - s[:, 7].max(),
                     s[:, 10].max() - b0[9], s[:, 10].max() - s[:, 0].min(),
                     s[:, 3].max() - s[:, 3].min(), s[:, 7].max() - s[:, 7].min()])
    med = [statistics.median(float(r[i]) for r in runs) for i in range(len(runs[0]))]
    return {**dict(zip(PHASES, med)), "kernel": med[-3], "GMM1 end spread": med[-2],
            "GMM2 end spread": med[-1]}


def k16b(moe0, sizes=SIZES, topk=cs.CFG.topk, gmm_moe=True):
    from sgl_kernel_npu_tpu_torch.parallel import fused_full as ff

    group = cs.dist.group.WORLD
    w1, _, w2, _ = moe0
    n_exp, h, n1, i = w1.shape[0], w1.shape[1], w1.shape[2], w2.shape[1]
    out = {}
    for n in sizes:
        gen = torch.Generator(device=cs.DEV).manual_seed(1000 + n)
        x = cs.randn(gen, (n, h))
        idx, w = cs.deep_routing(gen, n, n_exp, topk)
        buf = cs.Buffer(group, n_exp, cs.EPConfig(comm_backend="pallas_ragged"))
        call = lambda ix=idx, **kw: buf.fused_deep_moe(x, ix, w, *moe0,  # noqa: E731
                                                       single_kernel=True, **kw)
        got, cnt, drop = call()
        dead = torch.full_like(idx, -1)
        touched, rows = int((cnt > 0).sum()), int(cnt.sum())
        bms, by = cs.bound(touched * (h * n1 + i * h + 4 * (n1 + h)) + n * h * 2 * 2,
                           2 * rows * (h * n1 + i * h), cs.INT8_OPS)
        r = dict(digest=digest(got), experts=touched, drops=int(drop), bound_ms=bms, bound_by=by,
                 ms=cs.time_ms(call, 10), dead_ms=cs.time_ms(lambda: call(dead), 10),
                 unfused_ms=cs.time_ms(lambda: buf.fused_deep_moe(x, idx, w, *moe0), 10),
                 gmm_moe_ms=(cs.time_ms(lambda: cs.m._gmm_moe(cs.CFG, moe0, x, idx, w), 5)
                             if gmm_moe else None),
                 phases=phase_split(ff, x, idx, w, moe0,
                                    max(buf.config.num_max_dispatch_tokens_per_rank, n), n_exp))
        cs.log(f"  K16b {n} tokens over {touched} of {n_exp} experts: {r['ms']:.4f} ms (all "
               f"pairs dead {r['dead_ms']:.4f}; unfused {r['unfused_ms']:.4f}; _gmm_moe "
               f"{r['gmm_moe_ms']}; bound {bms:.4f} {by}); digest {r['digest']}; phases "
               f"{json.dumps(r['phases'])}")
        out[f"{n} tokens"] = r
    return out


def k13(gen):
    out = {}
    for t, l in ((8, 4), (512, 4), (8, 64), (512, 64)):
        out[f"K13a T {t} over {l}"] = cs.check_bgmv(gen, t, l, True)
    out["K13b"] = cs.check_sgmv(gen)
    return out


def yardsticks(moe0):
    group = cs.dist.group.WORLD
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
    out["K8a 2048 tokens"] = dict(
        gmm1_ms=cs.time_ms(g1, 10), gmm2_ms=cs.time_ms(g2, 10),
        digests=[digest(h1), digest(hs), digest(y)])
    k = out["K8a 2048 tokens"]
    cs.log(f"  K8a int8, a layer's two at 2048 tokens: {k['gmm1_ms'] + k['gmm2_ms']:.4f} ms "
           f"(GMM1 {k['gmm1_ms']:.4f}, GMM2 {k['gmm2_ms']:.4f}); digests {k['digests']}")
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + 19)
    for n in (8, 64, 512):
        out[f"K8b {n} tokens"] = cs.check_dispatch_branch(gen, moe0, n, True)[1]
    out["K16a 8 tokens"] = cs.check_fused_dispatch(gen, group, moe0, 8, True)[0]
    from sgl_kernel_npu_tpu_torch.parallel import fused_kernel

    g = torch.Generator(device=cs.DEV).manual_seed(16)
    x8 = cs.randn(g, (8, cs.CFG.hidden))
    idx8, _ = cs.deep_routing(g, 8)
    y16a = fused_kernel.fused_dispatch_gmm1(x8, idx8, w1, s1, group=group,
                                            num_experts=cs.CFG.num_experts, num_ranks=1,
                                            seg_capacity=8)[0]
    out["K16a 8 tokens"]["digest"] = digest(y16a)
    cs.log(f"  K16a digest {out['K16a 8 tokens']['digest']}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the numbers here as JSON")
    ap.add_argument("--only", choices=("k16b", "k13", "yard", "qwen"), default=None,
                    help="these cases alone")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(card)
    cs.cuda_lib.load_library()
    res = {"card": card}
    if args.only in (None, "k13"):
        res["k13"] = k13(torch.Generator(device=cs.DEV).manual_seed(cs.SEED + 9))
    if args.only in (None, "k16b", "yard"):
        cs.ep_group()
        moe0 = cs.m.init_quantized_experts(dataclasses.replace(cs.CFG, num_layers=1),
                                           cs.SEED + 1)[0]
        if args.only in (None, "k16b"):
            res["k16b"] = k16b(moe0)
        if args.only in (None, "yard"):
            res["yard"] = yardsticks(moe0)
        cs.dist.destroy_process_group()
    if args.only == "qwen":
        cs.ep_group()
        cfg = dataclasses.replace(cs.CFG_QWEN, num_layers=1)
        moe0 = cs.qn.quantize_hybrid_moe_weights(
            cfg, cs.qn.init_hybrid_weights(cfg, cs.SEED, torch.bfloat16))[0]
        res["k16b_qwen"] = k16b(moe0, (cs.QWEN_BATCH, cs.QWEN_CHUNK), cfg.moe_topk, False)
        cs.dist.destroy_process_group()
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1, default=str))


if __name__ == "__main__":
    main()
