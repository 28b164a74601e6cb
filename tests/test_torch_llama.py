"""Port parity: Llama (``models/llama.py``) decode_step / prefill_step, W8A8,
the int8 KV cache, multi-LoRA, the weight converters, calibration and the
engine.

Two layers at hidden 256, 8 q / 2 kv heads of 32 (JAX's default config); the
JAX weights cross over through ``from_jax_params`` (an untied head added),
its quantized weights through ``w8a8.from_jax_weights_q``, its LoRA adapters
(``init_lora``: q and o, adapter 0 zero) through ``from_jax_lora``.  The JAX side runs
its Pallas kernels in interpret mode, the port its plain versions.
Tolerances: f32 within 1e-5 of the largest value (sums in another order),
1e-4 where int8 levels or W8A8 take part (a rounding tie moves a value one
step), bf16 within 2e-2; quantized weights bit-equal; int8 cache levels
equal; the engines' greedy tokens equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, port_config, tt
from sgl_kernel_npu_tpu.models import llama as jm
from sgl_kernel_npu_tpu.models import w8a8 as jw
from sgl_kernel_npu_tpu_torch.models import llama as tm
from sgl_kernel_npu_tpu_torch.models import w8a8 as tw
from sgl_kernel_npu_tpu_torch.runtime.engine import Engine, llama_adapter

PAGE = 16
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _setup(dt: str, seed: int = 0, **fields):
    """JAX config and weights (an untied head drawn from numpy) and the
    port's copies."""
    jdt, tdt, _ = DTYPES[dt]
    jcfg = jm.LlamaConfig(num_layers=2, page_size=PAGE, vocab_size=64, **fields)
    init = jax.jit(jm.init_weights, static_argnums=(1, 2))
    params = jax.tree.map(np.asarray, init(jax.random.key(seed), jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    params["w_lm"] = (rng.standard_normal((jcfg.hidden, 64)) * 0.02).astype(np.float32)
    jparams = jax.tree.map(lambda a: jx(a, jdt), params)
    tparams = tm.from_jax_params(params, device="cpu", dtype=tdt)
    return jcfg, port_config(jcfg, tm.LlamaConfig), jparams, tparams, params, rng


def _jit(fn, cfg, **kw):
    return jax.jit(functools.partial(fn, cfg, **kw))


def _close(got, want, rel):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=rel * np.abs(want).max())


def _caches(rng, cfg, num_pages, jdt, tdt):
    """Per-layer caches of random history (int8 levels on the int8 path)."""
    shape = (num_pages, cfg.num_kv_heads, PAGE, cfg.head_dim)
    out_j, out_t = [], []
    for _ in range(cfg.num_layers):
        pair = [rng.standard_normal(shape).astype(np.float32) * 0.5 for _ in range(2)]
        if cfg.kv_cache_dtype == "int8":
            pair = [np.clip(np.round(a * 64), -128, 127).astype(np.int8) for a in pair]
            out_j.append(tuple(jx(a) for a in pair))
            out_t.append(tuple(tt(a) for a in pair))
        else:
            out_j.append(tuple(jx(a, jdt) for a in pair))
            out_t.append(tuple(tt(a, tdt) for a in pair))
    return out_j, out_t


def _steps(jcfg, tcfg, jp, tp, rng, jdt, tdt, rel, kw_j=None, kw_t=None, lora=None):
    """A decode step (contexts 1, 7, 20, 33; a pad row with slot -1), then a
    packed prefill of three requests (12 tokens at context 30, 1 at 1, 5 at
    21) and two pad rows on the caches it left: hidden states compared, the
    caches returned.  ``lora`` (JAX's and the port's adapters) gives the
    decode rows adapters 1, 2, 0, 1 and the prefill requests 2, 1, 0 (pad
    rows 0)."""
    kw_j, kw_t = kw_j or {}, kw_t or {}
    dec_j, dec_t, pre_j, pre_t = kw_j, kw_t, kw_j, kw_t
    if lora is not None:
        ids = np.asarray([1, 2, 0, 1], np.int32)
        pids = np.asarray([2] * 12 + [1] + [0] * 5 + [0, 0], np.int32)
        dec_j = {**kw_j, "lora": lora[0], "lora_idx": jx(ids)}
        dec_t = {**kw_t, "lora": lora[1], "lora_idx": tt(ids)}
        pre_j = {**kw_j, "lora": lora[0], "lora_idx": jx(pids)}
        pre_t = {**kw_t, "lora": lora[1], "lora_idx": tt(pids)}
    kv_j, kv_t = _caches(rng, jcfg, 17, jdt, tdt)
    bt = np.arange(1, 17, dtype=np.int32).reshape(4, 4)
    ctx = np.asarray([1, 7, 20, 33], np.int32)
    pos = ctx - 1
    slots = (bt[np.arange(4), pos // PAGE] * PAGE + pos % PAGE).astype(np.int32)
    slots[0] = -1
    x = (rng.standard_normal((4, jcfg.hidden)) * 0.5).astype(np.float32)
    yj, kv_j = _jit(jm.decode_step, jcfg)(jp, jx(x, jdt), jx(pos), kv_j, jx(bt), jx(ctx),
                                          jx(slots), **dec_j)
    yt, kv_t = tm.decode_step(tcfg, tp, tt(x, tdt), tt(pos), kv_t, tt(bt), tt(ctx), tt(slots),
                              **dec_t)
    assert yt.dtype == tdt
    _close(yt, yj, rel)
    seq = np.asarray([12, 1, 5], np.int32)
    pctx = np.asarray([30, 1, 21], np.int32)
    rows = [(b, int(pctx[b] - seq[b] + t)) for b in range(3) for t in range(seq[b])]
    pslots = np.asarray([bt[b, p // PAGE] * PAGE + p % PAGE for b, p in rows] + [-1, -1],
                        np.int32)
    xp = (rng.standard_normal((len(pslots), jcfg.hidden)) * 0.5).astype(np.float32)
    hj, kv_j = _jit(jm.prefill_step, jcfg, max_q=16)(jp, jx(xp, jdt), jx(seq), kv_j, jx(bt[:3]),
                                                    jx(pctx), jx(pslots), **pre_j)
    ht, kv_t = tm.prefill_step(tcfg, tp, tt(xp, tdt), tt(seq), kv_t, tt(bt[:3]), tt(pctx),
                               tt(pslots), max_q=16, **pre_t)
    _close(ht[:18], hj[:18], rel)
    return kv_j, kv_t


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_decode_then_prefill_match_jax(dt):
    jdt, tdt, rel = DTYPES[dt]
    jcfg, tcfg, jp, tp, _, rng = _setup(dt)
    kv_j, kv_t = _steps(jcfg, tcfg, jp, tp, rng, jdt, tdt, rel)
    for (kj, vj), (kt, vt) in zip(kv_j, kv_t):
        _close(kt, kj, rel)
        _close(vt, vj, rel)


@pytest.mark.parametrize("scales", ["cfg", "per_head"])
def test_int8_cache_levels_match_jax(scales):
    """The int8 cache (f32): ``cfg.kv_scale`` or per-kv-head ``kv_scales``;
    hidden states within 1e-4 and the cache levels equal."""
    jcfg, tcfg, jp, tp, _, rng = _setup("f32", seed=1, kv_cache_dtype="int8")
    kw_j = kw_t = None
    if scales == "per_head":
        sc = [(rng.uniform(0.005, 0.02, 2).astype(np.float32),
               rng.uniform(0.005, 0.02, 2).astype(np.float32)) for _ in range(2)]
        kw_j = {"kv_scales": [(jx(a), jx(b)) for a, b in sc]}
        kw_t = {"kv_scales": [(tt(a), tt(b)) for a, b in sc]}
    kv_j, kv_t = _steps(jcfg, tcfg, jp, tp, rng, jnp.float32, torch.float32, 1e-4, kw_j, kw_t)
    for (kj, vj), (kt, vt) in zip(kv_j, kv_t):
        assert kt.dtype == vt.dtype == torch.int8
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_quantize_weights_bit_equal_to_jax():
    """gate ‖ up stacked, every projection: the same int8 matrices and
    scales as JAX's, bit for bit, through ``from_jax_weights_q``."""
    jcfg, tcfg, jp, tp, params, _ = _setup("f32", seed=2)
    want = tw.from_jax_weights_q(jax.tree.map(np.asarray, jm.quantize_weights(jcfg, jp)),
                                 device="cpu")
    got = tm.quantize_weights(tcfg, tp)
    for lg, lw in zip(got["layers"], want["layers"]):
        assert set(lg) == set(lw) == {"wq", "wk", "wv", "wo", "w_gate_up", "w_down"}
        for n in lg:
            assert torch.equal(lg[n][0], lw[n][0]) and torch.equal(lg[n][1], lw[n][1])


def test_w8a8_on_int8_cache_matches_jax():
    """W8A8 (``weights_q``: K5, K1, K7a) composed with the int8 cache, as
    JAX's ``test_llama_w8a8_composes_with_int8_kv``: the steps within 1e-4."""
    jcfg, tcfg, jp, tp, _, rng = _setup("f32", seed=3, kv_cache_dtype="int8")
    wq_j = jm.quantize_weights(jcfg, jp)
    wq_t = tw.from_jax_weights_q(jax.tree.map(np.asarray, wq_j), device="cpu")
    _steps(jcfg, tcfg, jp, tp, rng, jnp.float32, torch.float32, 1e-4, {"weights_q": wq_j},
           {"weights_q": wq_t})


def test_golden_prefill_and_lm_head_match_jax():
    """``use_pallas=False`` (the golden attention) on both sides, then the
    untied head."""
    jcfg, tcfg, jp, tp, _, rng = _setup("f32", seed=4)
    kv_j, kv_t = _caches(rng, jcfg, 5, jnp.float32, torch.float32)
    bt = np.arange(1, 5, dtype=np.int32).reshape(1, 4)
    x = (rng.standard_normal((10, jcfg.hidden)) * 0.5).astype(np.float32)
    slots = (bt[0, np.arange(30, 40) // PAGE] * PAGE + np.arange(30, 40) % PAGE).astype(np.int32)
    seq, ctx = np.asarray([10], np.int32), np.asarray([40], np.int32)
    hj, _ = _jit(jm.prefill_step, jcfg, use_pallas=False)(jp, jx(x), jx(seq), kv_j, jx(bt),
                                                          jx(ctx), jx(slots))
    ht, _ = tm.prefill_step(tcfg, tp, tt(x), tt(seq), kv_t, tt(bt), tt(ctx), tt(slots),
                            use_pallas=False)
    _close(ht, hj, 1e-5)
    assert tp["w_lm"].shape == (jcfg.hidden, 64)
    _close(tm.lm_head(tp, ht), jm.lm_head(jp, hj), 1e-5)


def test_calibrate_kv_scales_matches_jax():
    rng = np.random.default_rng(5)
    caches = [(rng.standard_normal((3, 2, PAGE, 8)).astype(np.float32) * s,
               rng.standard_normal((3, 2, PAGE, 8)).astype(np.float32)) for s in (0.5, 3.0)]
    caches[0][0][:, 1] = 0                     # a head never written: the 1e-6 floor
    want = jw.calibrate_kv_scales([(jx(k), jx(v)) for k, v in caches])
    got = tw.calibrate_kv_scales([(tt(k), tt(v)) for k, v in caches])
    for (kg, vg), (kw, vw) in zip(got, want):
        np.testing.assert_array_equal(kg.numpy(), np.asarray(kw))
        np.testing.assert_array_equal(vg.numpy(), np.asarray(vw))


@pytest.mark.parametrize("w8a8_int8", [False, True])
def test_engine_matches_jax_engine(w8a8_int8):
    """The port's Engine with llama_adapter and the JAX package's: the same
    greedy tokens for two prompts served together (chunked prefill of 8);
    float, then W8A8 on the int8 cache."""
    from sgl_kernel_npu_tpu.runtime.engine import Engine as JEngine
    from sgl_kernel_npu_tpu.runtime.engine import llama_adapter as jadapter

    fields = dict(kv_cache_dtype="int8", kv_scale=0.01) if w8a8_int8 else {}
    jcfg, tcfg, jp, tp, _, _ = _setup("f32", seed=6, **fields)
    wq_j = wq_t = None
    if w8a8_int8:
        wq_j = jm.quantize_weights(jcfg, jp)
        wq_t = tw.from_jax_weights_q(jax.tree.map(np.asarray, wq_j), device="cpu")
    prompts = [[5, 9, 2, 33, 17, 4, 8, 21, 60, 3, 11, 40, 7], [40, 41, 42, 43, 44]]
    kw = dict(num_pages=64, max_batch=2, max_pages_per_req=16, prefill_chunk=8)
    want = JEngine(jadapter(jcfg, jp, weights_q=wq_j), **kw).run(prompts, 5)
    eng = Engine(llama_adapter(tcfg, tp, weights_q=wq_t, device="cpu"), device="cpu", **kw)
    assert eng.run(prompts, 5) == want
    assert eng.cm.free_pages + eng.cm.cached_pages == 64


def _lora(jcfg, seed, num_adapters=3, rank=4, dtype=None):
    """JAX's ``init_lora`` adapters (numpy leaves) and the port's copies."""
    lora = jax.tree.map(np.asarray, jm.init_lora(jax.random.key(seed), jcfg, num_adapters, rank))
    return lora, tm.from_jax_lora(lora, device="cpu", dtype=dtype)


@pytest.mark.parametrize("mode", ["f32", "bf16", "w8a8"])
def test_lora_steps_match_jax(mode):
    """``lora`` / ``lora_idx`` through a decode step and a packed prefill
    (rows of adapters 0-2, pad rows 0): float in f32 and bf16, and under
    W8A8 ``weights_q`` in f32 (1e-4: int8 levels take part).  JAX's
    ``_lora_delta`` takes its jnp chain at these sizes, which rounds the
    shrink to x's type; the port keeps it in f32 (the same in f32, within
    bf16's 2e-2)."""
    dt = "bf16" if mode == "bf16" else "f32"
    jdt, tdt, rel = DTYPES[dt]
    jcfg, tcfg, jp, tp, _, rng = _setup(dt, seed=8)
    lora_np, lora_t = _lora(jcfg, 21, dtype=tdt)
    lora_j = jax.tree.map(lambda a: jx(a, jdt), lora_np)
    kw_j = kw_t = None
    if mode == "w8a8":
        rel = 1e-4
        wq_j = jm.quantize_weights(jcfg, jp)
        kw_j = {"weights_q": wq_j}
        kw_t = {"weights_q": tw.from_jax_weights_q(jax.tree.map(np.asarray, wq_j), device="cpu")}
    kv_j, kv_t = _steps(jcfg, tcfg, jp, tp, rng, jdt, tdt, rel, kw_j, kw_t, (lora_j, lora_t))
    for (kj, vj), (kt, vt) in zip(kv_j, kv_t):
        _close(kt, kj, rel)
        _close(vt, vj, rel)


def test_init_lora_shapes():
    """The port's ``init_lora``: JAX's shapes, adapter 0 all zeros, the
    others N(0, 0.1²)."""
    cfg = tm.LlamaConfig(num_layers=2)
    lora = tm.init_lora(3, cfg, 4, 8, torch.bfloat16, device="cpu")
    hq = cfg.num_heads * cfg.head_dim
    want = {"qA": (4, 8, cfg.hidden), "qB": (4, hq, 8), "oA": (4, 8, hq), "oB": (4, cfg.hidden, 8)}
    assert len(lora["layers"]) == 2
    for layer in lora["layers"]:
        assert {k: tuple(v.shape) for k, v in layer.items()} == want
        for v in layer.values():
            assert v.dtype == torch.bfloat16 and not v[0].any()
            assert 0.08 < float(v[1:].float().std()) < 0.12


def _lora_engines(jcfg, tcfg, jp, tp, lora_j, lora_t, **kw):
    from sgl_kernel_npu_tpu.runtime.engine import Engine as JEngine
    from sgl_kernel_npu_tpu.runtime.engine import llama_adapter as jadapter

    return (JEngine(jadapter(jcfg, jp, lora=lora_j), **kw),
            Engine(llama_adapter(tcfg, tp, lora=lora_t, device="cpu"), device="cpu", **kw))


def _serve(eng, requests):
    """Serve ``(prompt, lora_id)`` requests one after the other (each one
    finished before the next arrives) → their tokens and the engine's cached
    tokens."""
    out = []
    for prompt, lid in requests:
        rid = eng.add_request(prompt, 4, lora_id=lid)
        while eng.waiting or eng.running:
            eng.step()
        out.append(eng.finished[rid])
    return out, eng.stats["cached_tokens"]


def test_multi_lora_engine_matches_jax_engine():
    """Three requests with adapters 1, 2, 0 and distinct prompts served
    together (as JAX's ``test_multi_lora_serving``): the port's engine gives
    the JAX engine's greedy tokens, and adapters change them."""
    jcfg, tcfg, jp, tp, _, _ = _setup("f32", seed=9)
    lora_np, lora_t = _lora(jcfg, 21)
    prompts = [[5, 9, 2, 33, 17], [40, 41, 42, 43, 44], [7, 3, 2, 9, 1]]
    ids = [1, 2, 0]
    kw = dict(num_pages=64, max_batch=4, max_pages_per_req=16, prefill_chunk=8)
    engs = _lora_engines(jcfg, tcfg, jp, tp, jax.tree.map(jx, lora_np), lora_t, **kw)
    got = []
    for eng in engs:
        rids = [eng.add_request(p, 4, lora_id=i) for p, i in zip(prompts, ids)]
        while eng.waiting or eng.running:
            eng.step()
        got.append([eng.finished[r] for r in rids])
    assert got[1] == got[0]
    plain = Engine(llama_adapter(tcfg, tp, device="cpu"), device="cpu", **kw).run(prompts, 4)
    assert plain[2] == got[1][2] and plain[:2] != got[1][:2]


def test_lora_requests_share_no_cached_pages():
    """The prefix cache across adapters, where the port departs from JAX.
    JAX's radix is keyed by tokens alone, while LoRA on q and o makes every
    layer's K / V after the first depend on the adapter.  So when a request
    under adapter 2 follows one under adapter 1 with the same 40-token
    prompt, the JAX engine hands it adapter 1's cached pages (32 tokens) and
    its tokens differ from a direct adapter-2 run.  Parity with the JAX
    engine is therefore not asserted here: the port shares no pages across
    adapters and gives the direct run's tokens, and adapter-0 requests still
    share pages."""
    jcfg, tcfg, jp, tp, _, _ = _setup("f32", seed=10)
    lora_np, lora_t = _lora(jcfg, 21)
    lora_j = jax.tree.map(jx, lora_np)
    prompt = [int(t) for t in np.random.default_rng(12).integers(0, 64, 40)]
    kw = dict(num_pages=64, max_batch=4, max_pages_per_req=16, prefill_chunk=64)
    direct_j, direct_t = (_serve(e, [(prompt, 2)])[0][0]
                          for e in _lora_engines(jcfg, tcfg, jp, tp, lora_j, lora_t, **kw))
    assert direct_t == direct_j
    eng_j, eng_t = _lora_engines(jcfg, tcfg, jp, tp, lora_j, lora_t, **kw)
    (_, after_j), cached_j = _serve(eng_j, [(prompt, 1), (prompt, 2)])
    (_, after_t), cached_t = _serve(eng_t, [(prompt, 1), (prompt, 2)])
    assert cached_j == 32 and after_j != direct_j          # the reference's fault
    assert cached_t == 0 and after_t == direct_t
    assert eng_t.cm.free_pages + eng_t.cm.cached_pages == 64
    eng0 = _lora_engines(jcfg, tcfg, jp, tp, lora_j, lora_t, **kw)[1]
    (first, second), cached0 = _serve(eng0, [(prompt, 0), (prompt, 0)])
    assert cached0 == 32 and first == second


def test_lora_raises():
    """LoRA needs an adapter per row: the steps raise without a ``lora_idx``
    of the batch's length."""
    cfg = tm.LlamaConfig(num_layers=1, vocab_size=32)
    params = tm.init_weights(cfg, 0, device="cpu")
    caches = tm.init_kv_cache(cfg, 4, device="cpu")
    lora = tm.init_lora(0, cfg, 2, 4, device="cpu")
    x = torch.zeros((1, cfg.hidden))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    for step in (tm.decode_step, tm.prefill_step):
        for idx in (None, i32([0, 1])):
            with pytest.raises(ValueError, match="lora_idx"):
                step(cfg, params, x, i32([0]), caches, i32([[1]]), i32([1]), i32([16]),
                     lora=lora, lora_idx=idx)
