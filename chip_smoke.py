#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sgl_kernel_npu_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

Phases (any failure raises and the script exits non-zero without a result):

1. Build the hand-written kernels from ``sgl_kernel_npu_tpu_torch/csrc`` with
   nvcc for sm_90a; print the build time and the card's name and power limit.
2. Hold each kernel (decode_mla, mla_prefill_pallas, gmm1_ring,
   gmm2_combine_ring) against its plain PyTorch version on the card, at the
   main path's full-width shapes and at one small ragged case; time the
   kernel, the plain version and, where one exists, a single PyTorch call
   computing the same function (CUDA events, L2 flushed before each launch);
   compute each kernel's bound from the bytes and operations of its inputs.
3. Serve DeepSeek-V3 at its published widths (depth cut from 61 to 2 layers,
   random weights from a seed) through ``Engine`` + ``deepseek_adapter`` with
   W8A8 routed experts: 6 requests of 96-700 prompt tokens (two share a
   256-token prefix, served so that the second reuses it from the radix
   cache), 16 new tokens each.  Launch counts are reset just before and read
   just after; every kernel must have run, every request finished and every
   page come back.  Then one decode step on a live batch runs through the
   kernels and through the plain versions, and their logits are compared.
4. Print the kernels' JSON line, the card line, and last the result line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device is available")

from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as m  # noqa: E402
from sgl_kernel_npu_tpu_torch.ops import gmm_ring  # noqa: E402
from sgl_kernel_npu_tpu_torch.ops.attention import decode_attention as da  # noqa: E402
from sgl_kernel_npu_tpu_torch.ops.attention import mla_prefill as mp  # noqa: E402
from sgl_kernel_npu_tpu_torch.runtime.engine import Engine, deepseek_adapter  # noqa: E402
from sgl_kernel_npu_tpu_torch.utils import counters, cuda_lib, trace_profile  # noqa: E402

SEED = 0
DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # dense tensor-core peaks, H100 SXM data sheet
INT8_OPS = 1979e12

# deepseek-ai/DeepSeek-V3 config.json: hidden 7168, 128 heads, kv_lora_rank 512,
# q_lora_rank 1536, qk_nope 128, qk_rope 64, v_head 128, vocab 129280, 256 routed
# experts top-8, moe_intermediate 2048, 1 shared expert, sigmoid routing with
# e_score_correction_bias, n_group 8, topk_group 4, routed_scaling_factor 2.5,
# norm_topk_prob true, rope_theta 10000 (the default of ops/rope.py).  Cut: 61
# layers -> 2 (and every layer is MoE, as in the JAX model).  bf16 weights and
# caches, page 128.
FULL_LAYERS = 61
CFG = m.DeepSeekV3Config(
    vocab_size=129280, hidden=7168, num_layers=2, num_heads=128, kv_lora_rank=512,
    qk_rope_dim=64, qk_nope_dim=128, q_lora_rank=1536, v_head_dim=128,
    num_experts=256, num_shared_experts=1, topk=8, moe_intermediate=2048,
    page_size=128, router_scoring="sigmoid_v3", n_group=8,
    topk_group=4, routed_scaling_factor=2.5, norm_topk_prob=True)

MAX_BATCH, PREFILL_CHUNK, MAX_PAGES_PER_REQ, NUM_PAGES = 8, 64, 8, 64
PROMPT_LENS = [96, 700, 150, 450, 520, 300]     # the 2nd and 6th share 256 tokens
SHARED_PREFIX = 256
NEW_TOKENS = 16

_flush_buf = None


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after a
    64 MB write that evicts the 50 MB L2 (the main path finds these inputs
    cold: a layer's weights and cache were last touched a layer ago)."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        _flush_buf.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def attention_close(got: torch.Tensor, want: torch.Tensor) -> tuple[float, bool]:
    """Max |err| and whether |err| <= 2e-2 + 2e-2 |plain| everywhere: the
    kernels round the output and the softmax probabilities (for P @ V) to
    bf16, the plain versions compute in f32 and round the output."""
    diff = (got.float() - want.float()).abs()
    return max_abs(got, want), bool((diff <= 2e-2 + 2e-2 * want.float().abs()).all())


def randn(gen, shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_cache(gen, n_pages, page):
    kn = randn(gen, (n_pages, 1, page, 512))
    kr = randn(gen, (n_pages, 1, 64, page))
    return kn, kr


def check_decode_mla(gen, b, heads, page, ctx_list, pad_rows, timed):
    max_pages = max(-(-c // page) for c in ctx_list)
    n_pages = b * max_pages + 1
    kn, kr = paged_cache(gen, n_pages, page)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(b)) + 1
    bt = torch.zeros((b + pad_rows, max_pages), dtype=torch.int32)
    bt[:b] = perm[: b * max_pages].reshape(b, max_pages)
    bt = bt.to(DEV)
    ctx = torch.tensor(ctx_list + [1] * pad_rows, dtype=torch.int32, device=DEV)
    q = randn(gen, (b + pad_rows, heads, 576))
    scale = CFG.sm_scale
    args = (q, kn, kr, ctx, scale, bt)
    got, want = da.decode_mla(*args), da.decode_mla_ref(*args)
    torch.cuda.synchronize()
    err, ok = attention_close(got, want)
    log(f"  decode_mla B={b}+{pad_rows} pad H={heads} page={page} ctx={ctx_list}: "
        f"max|err| {err:.3e} (tol 2e-2 + 2e-2 |plain|)")
    if not ok:
        raise AssertionError(f"decode_mla disagrees with its plain version: {err}")
    if not timed:
        return None
    ms = time_ms(lambda: da.decode_mla(*args), 50)
    plain_ms = time_ms(lambda: da.decode_mla_ref(*args), 10)
    # one PyTorch call for the same function: SDPA over the cache gathered to
    # dense [B, 1, L, 576] beforehand (the gather is not timed)
    max_len = max_pages * page
    kd = da._gather_pages(kn, bt, max_len)                           # [B, 1, L, 512]
    krd = da._gather_pages(kr.transpose(-1, -2), bt, max_len)
    kcat = torch.cat([kd, krd], dim=-1)
    mask = (torch.arange(max_len, device=DEV)[None, :] < ctx[:, None])[:, None, None, :]
    lib_fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q[:, :, None, :], kcat, kd, attn_mask=mask, scale=scale, enable_gqa=True)
    library_ms = time_ms(lib_fn, 50)
    keys = sum(ctx_list)
    nbytes = q.numel() * 2 + keys * 576 * 2 + got.numel() * 2 + bt.numel() * 4 + ctx.numel() * 4
    ops = keys * heads * (576 + 512) * 2
    return err, ms, plain_ms, library_ms, *bound(nbytes, ops, BF16_FLOPS)


def check_mla_prefill(gen, heads, page, seq_list, ctx_list, pad_rows, timed):
    bsz = len(seq_list)
    max_pages = max(-(-c // page) for c in ctx_list)
    n_pages = bsz * max_pages
    kn, kr = paged_cache(gen, n_pages, page)
    bt = torch.arange(n_pages, dtype=torch.int32, device=DEV).reshape(bsz, max_pages)
    seq = torch.tensor(seq_list, dtype=torch.int32, device=DEV)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=DEV)
    s = sum(seq_list) + pad_rows
    q = randn(gen, (s, heads, 576))
    scale = CFG.sm_scale
    got = mp.mla_prefill_pallas(q, kn, kr, seq, bt, ctx, scale, max_q=max(seq_list))
    want = mp.mla_prefill_ref(q, kn, kr, seq, bt, ctx, scale)
    torch.cuda.synchronize()
    err, ok = attention_close(got, want)
    log(f"  mla_prefill H={heads} page={page} seq={seq_list} ctx={ctx_list} +{pad_rows} "
        f"pad rows: max|err| {err:.3e} (tol 2e-2 + 2e-2 |plain|)")
    if not ok:
        raise AssertionError(f"mla_prefill disagrees with its plain version: {err}")
    if pad_rows and not bool((got[-pad_rows:] == 0).all()):
        raise AssertionError("mla_prefill pad rows are not zero")
    if not timed:
        return None
    ms = time_ms(lambda: mp.mla_prefill_pallas(q, kn, kr, seq, bt, ctx, scale,
                                               max_q=max(seq_list)), 20)
    plain_ms = time_ms(lambda: mp.mla_prefill_ref(q, kn, kr, seq, bt, ctx, scale), 5)
    # one request: SDPA over its dense cache with the causal offset mask
    sl, cl = seq_list[0], ctx_list[0]
    kd = da._gather_pages(kn, bt[:1], cl)
    kcat = torch.cat([kd, da._gather_pages(kr.transpose(-1, -2), bt[:1], cl)], dim=-1)
    qpos = cl - sl + torch.arange(sl, device=DEV)
    mask = (torch.arange(cl, device=DEV)[None, :] <= qpos[:, None])[None, None]
    qh = q[:sl].transpose(0, 1)[None]                                  # [1, H, S, 576]
    lib_fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kcat, kd, attn_mask=mask, scale=scale, enable_gqa=True)
    library_ms = time_ms(lib_fn, 20) if bsz == 1 else None
    nbytes = (q.numel() * 2 + got.numel() * 2
              + sum(ctx_list) * 576 * 2 + bt.numel() * 4)
    ops = sum(heads * (c - sq + j + 1) * (576 + 512) * 2
              for sq, c in zip(seq_list, ctx_list) for j in range(sq))
    return err, ms, plain_ms, library_ms, *bound(nbytes, ops, BF16_FLOPS)


def routing(gen, n_tok, topk, n_exp):
    """Distinct experts per token, uniformly at random (what a random router gives)."""
    scores = torch.rand((n_tok, n_exp), generator=gen, device=DEV)
    idx = torch.topk(scores, topk, dim=-1).indices
    flat = idx.reshape(-1)
    gsizes = torch.bincount(flat, minlength=n_exp).to(torch.int32)
    src = torch.argsort(flat, stable=True).to(torch.int32)
    dest = torch.empty_like(src)
    dest[src.long()] = torch.arange(flat.numel(), dtype=torch.int32, device=DEV)
    return gsizes, src // topk, dest.reshape(n_tok, topk)


def check_gmm(gen, moe, n_tok, topk, timed, label):
    """gmm1_ring then gmm2_combine_ring on one layer's experts."""
    w1, s1, w2, s2 = moe
    n_exp, k, n = w1.shape
    gsizes, tok_of_row, dest = routing(gen, n_tok, topk, n_exp)
    x = randn(gen, (n_tok, k), torch.float32)
    sx = torch.clamp_min(x.abs().amax(-1) / 127.0, 1e-12)
    xq = torch.clamp(torch.round(x / sx[:, None]), -128, 127).to(torch.int8)
    topw = torch.rand((n_tok, topk), generator=gen, device=DEV)
    h1, hs = gmm_ring.gmm1_ring(xq, tok_of_row, w1, gsizes, sx, s1)
    h1_p, hs_p = gmm_ring.gmm1_ring_ref(xq, tok_of_row, w1, gsizes, sx, s1)
    out = gmm_ring.gmm2_combine_ring(h1_p, w2, gsizes, hs_p, s2, dest, topw)
    out_p = gmm_ring.gmm2_combine_ring_ref(h1_p, w2, gsizes, hs_p, s2, dest, topw)
    torch.cuda.synchronize()
    err1 = max_abs(h1, h1_p)
    err_s = float(((hs - hs_p).abs() / hs_p.abs().clamp_min(1e-30)).max())
    err2 = max_abs(out, out_p)
    tol2 = 1e-5 * float(out_p.abs().max())
    touched = int((gsizes > 0).sum())
    log(f"  {label}: {n_tok} tokens x top-{topk} = {tok_of_row.numel()} rows over "
        f"{touched} experts: gmm1 max|h1 err| {err1:.0f} int8 levels (tol 1), hs rel err "
        f"{err_s:.2e} (tol 1e-5); gmm2 max|err| {err2:.3e} (tol {tol2:.3e}: f32 sums "
        f"in another order)")
    if not (err1 <= 1 and err_s <= 1e-5 and err2 <= tol2):
        raise AssertionError(f"gmm ring kernels disagree: {err1}, {err_s}, {err2}")
    if not timed:
        return None
    s_rows = tok_of_row.numel()
    i = n // 2
    r1 = dict(
        ms=time_ms(lambda: gmm_ring.gmm1_ring(xq, tok_of_row, w1, gsizes, sx, s1), 20),
        plain_ms=time_ms(lambda: gmm_ring.gmm1_ring_ref(xq, tok_of_row, w1, gsizes, sx,
                                                        s1), 3),
        err=err1)
    r1["bound_ms"], r1["bound_by"] = bound(
        touched * k * n + touched * n * 4 + xq.numel() + n_tok * 4 + s_rows * 4
        + s_rows * i + s_rows * 4, 2 * s_rows * k * n, INT8_OPS)
    r2 = dict(
        ms=time_ms(lambda: gmm_ring.gmm2_combine_ring(h1_p, w2, gsizes, hs_p, s2, dest,
                                                      topw), 20),
        plain_ms=time_ms(lambda: gmm_ring.gmm2_combine_ring_ref(h1_p, w2, gsizes, hs_p, s2,
                                                                dest, topw), 3),
        err=err2)
    h = w2.shape[2]
    r2["bound_ms"], r2["bound_by"] = bound(
        touched * i * h + touched * h * 4 + h1_p.numel() + s_rows * 4 + dest.numel() * 8
        + n_tok * h * 4, 2 * s_rows * i * h, INT8_OPS)
    return r1, r2


def check_gmm_small(gen):
    """Ragged: 8 experts with empty groups, 6 rows (far below any tile) and a
    pad row whose token id is n_tok."""
    g, k, n, h = 8, 256, 512, 256
    w1 = torch.randint(-127, 128, (g, k, n), generator=gen, device=DEV, dtype=torch.int8)
    w2 = torch.randint(-127, 128, (g, n // 2, h), generator=gen, device=DEV,
                       dtype=torch.int8)
    s1 = torch.rand((g, n), generator=gen, device=DEV) / 100
    s2 = torch.rand((g, h), generator=gen, device=DEV) / 100
    gsizes = torch.tensor([0, 2, 0, 0, 3, 0, 1, 0], dtype=torch.int32, device=DEV)
    tok = torch.tensor([0, 2, 1, 3, 0, 2], dtype=torch.int32, device=DEV)   # 3 = pad (n_tok)
    xq = torch.randint(-127, 128, (3, k), generator=gen, device=DEV, dtype=torch.int8)
    sx = torch.rand(3, generator=gen, device=DEV) / 50
    h1, hs = gmm_ring.gmm1_ring(xq, tok, w1, gsizes, sx, s1)
    h1_p, hs_p = gmm_ring.gmm1_ring_ref(xq, tok, w1, gsizes, sx, s1)
    dest = torch.tensor([[0, 4], [2, 5], [1, 3]], dtype=torch.int32, device=DEV)
    topw = torch.rand((3, 2), generator=gen, device=DEV)
    init = torch.randn((3, h), generator=gen, device=DEV)
    out = gmm_ring.gmm2_combine_ring(h1_p, w2, gsizes, hs_p, s2, dest, topw, init=init)
    out_p = gmm_ring.gmm2_combine_ring_ref(h1_p, w2, gsizes, hs_p, s2, dest, topw, init=init)
    torch.cuda.synchronize()
    err1, err2 = max_abs(h1, h1_p), max_abs(out, out_p)
    log(f"  gmm small ragged (groups {gsizes.tolist()}, pad row, init): gmm1 max|h1 err| "
        f"{err1:.0f} (tol 1), gmm2 max|err| {err2:.3e} (tol 1e-4)")
    if not (err1 <= 1 and bool((h1[3] == 0).all()) and err2 <= 1e-4):
        raise AssertionError(f"gmm small case disagrees: {err1}, {err2}")


# ---------------------------------------------------------------------------
# phase 3: serve
# ---------------------------------------------------------------------------

class StepTimer:
    """Wall time of the adapter's prefill and decode calls (synchronized)."""

    def __init__(self, adapter):
        self.t = {"prefill": 0.0, "decode": 0.0}
        for name in self.t:
            setattr(adapter, f"{name}_step", self._wrap(name, getattr(adapter, f"{name}_step")))

    def _wrap(self, name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.t[name] += time.perf_counter() - t0
            return out
        return run


def prompts(gen):
    ids = [torch.randint(0, CFG.vocab_size, (n,), generator=gen).tolist() for n in PROMPT_LENS]
    ids[5][:SHARED_PREFIX] = ids[1][:SHARED_PREFIX]
    return ids


def serve(params, moe):
    adapter = deepseek_adapter(CFG, params, torch.bfloat16, moe_weights_q=moe)
    timer = StepTimer(adapter)
    eng = Engine(adapter, NUM_PAGES, max_batch=MAX_BATCH, max_pages_per_req=MAX_PAGES_PER_REQ,
                 prefill_chunk=PREFILL_CHUNK)
    ps = prompts(torch.Generator().manual_seed(SEED))
    counters.reset()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, NEW_TOKENS) for p in ps[:5]]
    # the prefix-sharing 6th request arrives once the 2nd is through prefill,
    # so its admission finds the shared pages in the radix cache
    while not any(r.rid == rids[1] and r.pos >= r.prompt_len for r in eng.running) \
            and rids[1] not in eng.finished:
        eng.step()
    rids.append(eng.add_request(ps[5], NEW_TOKENS))
    while eng.waiting or eng.running:
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    outs = [eng.finished[r] for r in rids]
    if not all(len(o) == NEW_TOKENS and all(0 <= t < CFG.vocab_size for t in o) for o in outs):
        raise AssertionError(f"unfinished or invalid outputs: {[len(o) for o in outs]}")
    if eng.cm.free_pages + eng.cm.cached_pages != NUM_PAGES:
        raise AssertionError("KV pages leaked")
    if eng.stats["cached_tokens"] < SHARED_PREFIX:
        raise AssertionError(f"radix reuse missed: {eng.stats['cached_tokens']} cached tokens")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    dec_tokens = len(rids) * (NEW_TOKENS - 1)      # the first token comes from prefill
    log(f"  served {len(rids)} requests (prompts {PROMPT_LENS}, {NEW_TOKENS} new tokens "
        f"each) in {wall:.2f} s wall; prefill {eng.stats['prefill_tokens']} tokens in "
        f"{timer.t['prefill']:.3f} s = {eng.stats['prefill_tokens'] / timer.t['prefill']:.1f} "
        f"tok/s; decode {dec_tokens} tokens in {eng.stats['decode_steps']} steps, "
        f"{timer.t['decode']:.3f} s = {dec_tokens / timer.t['decode']:.1f} tok/s; "
        f"radix cached tokens {eng.stats['cached_tokens']}; all pages returned")
    log(f"  launches on the main path: {json.dumps(launches)} over "
        f"{eng.stats['decode_steps']} decode steps and "
        f"{launches['mla_prefill_pallas'] // CFG.num_layers} prefill chunks")
    return eng, ps, launches


def compare_plain_decode(eng, ps, params, moe):
    """One decode step on a live batch, through the kernels and through the
    plain versions (each run writes the same KV rows itself before it reads).

    Routing is discrete: a row whose top-k expert set differs between the two
    runs in any layer (a near-tie moved by one bf16 rounding) takes other
    experts and its logits move by far more than rounding.  So the check
    compares the rows whose routing agrees in every layer, and requires at
    least half of the rows to be such rows."""
    for p in ps:
        eng.add_request(p, 32)
    while any(r.pos < r.prompt_len for r in eng.running) or eng.waiting:
        eng.step()
    live = [r for r in eng.running if not r.done]
    n = len(live)
    batch = eng.decode_inputs(live)
    plain = lambda x, pos, c, bt, ctx, slots: m.decode_step(  # noqa: E731
        CFG, params, x, pos, c, bt, ctx, slots, moe_weights_q=moe, plain=True)
    routes, router = [], m._router

    def recording_router(cfg, lw, x):
        ids, w = router(cfg, lw, x)
        routes.append(torch.sort(ids[:n], dim=-1).values)
        return ids, w

    m._router = recording_router
    try:
        got = eng.decode_logits(batch)[:n].float()
        routes_k = routes[:]
        routes.clear()
        want = eng.decode_logits(batch, plain)[:n].float()
        routes_p = routes[:]
    finally:
        m._router = router
    if not bool(torch.isfinite(got).all()) or got.shape != (n, CFG.vocab_size):
        raise AssertionError("kernel-path logits are not finite or mis-shaped")
    same = torch.stack([(a == b).all(-1) for a, b in zip(routes_k, routes_p)]).all(0)
    err_row = (got - want).abs().amax(-1)
    rel_row = err_row / want.abs().amax(-1)
    top2 = torch.topk(want, 2, dim=-1).values
    clear = same & ((top2[:, 0] - top2[:, 1]) > 2 * err_row)
    agree = got.argmax(-1) == want.argmax(-1)
    rel_same = float(rel_row[same].max()) if bool(same.any()) else float("nan")
    tol = 5e-2
    log(f"  decode step on {n} live rows, kernels vs plain versions: routing agrees in "
        f"every layer on {int(same.sum())}/{n} rows; on those, logits max rel err "
        f"{rel_same:.3e} (tol {tol}: bf16 activations, int8 requant flips); all rows "
        f"{float(rel_row.max()):.3e}; top-1 agrees on {int(agree.sum())}/{n} rows, "
        f"required on the {int(clear.sum())} routing-agreeing rows whose top-2 margin "
        f"exceeds 2x their error")
    if not (2 * int(same.sum()) >= n and rel_same <= tol and bool(agree[clear].all())):
        raise AssertionError(f"kernel decode disagrees with the plain path: {rel_same}")
    return batch


def profile_steps(eng, batch, prompt):
    """Device time by kernel of one decode call on the live batch, and of one
    mixed engine tick (that decode plus a 64-token prefill chunk)."""
    regions = [("decode step", lambda: eng.decode_logits(batch))]
    eng.add_request(prompt, 1)
    regions.append(("mixed tick (decode + prefill chunk)", eng.step))
    for label, fn in regions:
        rows, busy, wall = trace_profile.device_breakdown(fn)
        log(f"  {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall:.1f} %)")
        for name, ms, count in rows:
            log(f"    {ms:9.3f} ms  x{count:<4d} {name[:110]}")


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(f"[1] build  (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)})")
    t0 = time.perf_counter()
    cuda_lib.load_library()
    built = (f"nvcc build {cuda_lib.build_seconds:.1f} s" if cuda_lib.build_seconds
             else "already built in this checkout")
    log(f"  kernels loaded in {time.perf_counter() - t0:.1f} s ({built})")
    log(f"  card: {card}")

    log(f"[2] weights: DeepSeek-V3 widths, {CFG.num_layers} of {FULL_LAYERS} layers, "
        f"seed {SEED}")
    t0 = time.perf_counter()
    params = m.init_weights(CFG, SEED, torch.bfloat16, with_experts=False)
    moe = m.init_quantized_experts(CFG, SEED + 1)
    torch.cuda.synchronize()
    log(f"  made in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")

    log("[3] kernels against their plain versions")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    ctx_decode = [716, 612, 556, 470, 320, 166, 112, 400]     # 8 sequences, page 128
    dec = check_decode_mla(gen, MAX_BATCH, CFG.num_heads, CFG.page_size, ctx_decode, 0, True)
    check_decode_mla(gen, 3, CFG.num_heads, 16, [1, 17, 40], 2, False)
    pre = check_mla_prefill(gen, CFG.num_heads, CFG.page_size, [PREFILL_CHUNK], [700], 0, True)
    check_mla_prefill(gen, CFG.num_heads, 16, [1, 5], [1, 30], 2, False)
    g1, g2 = check_gmm(gen, moe[0], MAX_BATCH, CFG.topk, True, "gmm decode shape")
    check_gmm(gen, moe[0], PREFILL_CHUNK, CFG.topk, False, "gmm prefill-chunk shape")
    check_gmm_small(gen)

    log("[4] serve through Engine + deepseek_adapter(moe_weights_q=...)")
    eng, ps, launches = serve(params, moe)
    batch = compare_plain_decode(eng, ps, params, moe)
    log("[5] device time by kernel (torch.profiler)")
    profile_steps(eng, batch, ps[3][:200])

    src = "sgl_kernel_npu_tpu_torch/csrc/"
    tpu = "sgl_kernel_npu_tpu/ops/"
    rows = [
        ("decode_mla", src + "decode_mla.cu", tpu + "attention/decode_attention.py:346", dec),
        ("mla_prefill_pallas", src + "mla_prefill.cu", tpu + "attention/mla_prefill.py:201",
         pre),
        ("gmm1_ring", src + "gmm_ring.cu", tpu + "gmm_ring.py:282",
         (g1["err"], g1["ms"], g1["plain_ms"], None, g1["bound_ms"], g1["bound_by"])),
        ("gmm2_combine_ring", src + "gmm_ring.cu", tpu + "gmm_ring.py:487",
         (g2["err"], g2["ms"], g2["plain_ms"], None, g2["bound_ms"], g2["bound_by"])),
    ]
    kernels = [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    } for name, source, replaces, (err, ms, plain_ms, library_ms, bound_ms, bound_by) in rows]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
