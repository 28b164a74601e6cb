"""Port parity: GPT-OSS decode_step / prefill_step, decode_step_ref and the
engine.

Two layers (one sliding-window layer of 8 keys, one full) at hidden 256, the
dense MLP and the MoE (4 experts, top-2, q / k / v / o biases), f32 and bf16;
the JAX weights (biases made nonzero) cross over through ``from_jax_params``.
The JAX side runs its Pallas kernels in interpret mode, the port its plain
versions.  Tolerances: f32 within 1e-5 of the largest value (sums in another
order), bf16 within 2e-2 (both round at every bf16 step, not at the same
places); the engines' greedy tokens equal.  The JAX functions run under
``jax.jit`` (one compile instead of op-by-op dispatch)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, port_config, tt
from sgl_kernel_npu_tpu.models import gpt_oss as jm
from sgl_kernel_npu_tpu_torch.models import gpt_oss as tm
from sgl_kernel_npu_tpu_torch.runtime.engine import Engine, gpt_oss_adapter

PAGE = 16
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
MOE = dict(num_experts=4, topk=2, attention_bias=True)
BIASES = ("bq", "bk", "bv", "bo", "router_b", "b_gate_up", "b_down")


def _setup(moe: bool, dt: str, seed: int = 0, **extra):
    """JAX config and weights (biases drawn nonzero) and the port's copies."""
    jdt, tdt, _ = DTYPES[dt]
    jcfg = jm.GptOssConfig(num_layers=2, page_size=PAGE, vocab_size=64, sliding_window=8,
                           **(MOE if moe else {}))
    init = jax.jit(jm.init_weights, static_argnums=(1, 2))
    params = jax.tree.map(np.asarray, init(jax.random.key(seed), jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    for lw in params["layers"]:
        for name in BIASES:
            if name in lw:
                lw[name] = (rng.standard_normal(lw[name].shape) * 0.05).astype(np.float32)
    params.update(extra)
    jparams = jax.tree.map(lambda a: jx(a, jdt) if isinstance(a, np.ndarray) else a, params)
    tparams = tm.from_jax_params(params, device="cpu", dtype=tdt)
    return jcfg, port_config(jcfg, tm.GptOssConfig), jparams, tparams, rng


def _jit(fn, cfg, **kw):
    return jax.jit(functools.partial(fn, cfg, **kw))


def _close(got, want, rel):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=rel * np.abs(want).max())


def _caches(rng, cfg, num_pages, jdt, tdt):
    """Per-layer K / V caches of random history, as JAX and as port tensors."""
    shape = (num_pages, cfg.num_kv_heads, PAGE, cfg.head_dim)
    kv = [(rng.standard_normal(shape).astype(np.float32) * 0.5,
           rng.standard_normal(shape).astype(np.float32) * 0.5) for _ in range(cfg.num_layers)]
    return ([(jx(k, jdt), jx(v, jdt)) for k, v in kv],
            [(tt(k, tdt), tt(v, tdt)) for k, v in kv])


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("moe", [False, True])
def test_decode_then_prefill_match_jax(moe, dt):
    """One decode step (contexts 1, 7, 20 and 33 over random history, a pad
    row with slot -1), then a packed prefill of three requests (12 tokens at
    context 30, 1 at context 1, 5 at context 21) and two pad rows on the
    caches the decode left: hidden states and caches compared."""
    _decode_then_prefill(moe, dt)


def _one_device_buffers(jcfg):
    """JAX's ``Buffer`` on a one-device mesh and the port's on a one-rank
    group, for ``jcfg.num_experts`` experts."""
    from jax.sharding import Mesh

    from _torch_parity import one_rank_group
    from sgl_kernel_npu_tpu.config import EPConfig as JEPConfig
    from sgl_kernel_npu_tpu.parallel.buffer import Buffer as JBuffer
    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer

    mesh1 = Mesh(np.array(jax.devices()[:1]), ("ep",))
    return (JBuffer(mesh1, "ep", num_experts=jcfg.num_experts, config=JEPConfig()),
            Buffer(one_rank_group(), num_experts=jcfg.num_experts, config=EPConfig()))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_ep_buffer_decode_then_prefill_match_jax(dt):
    """The same steps with the MoE expert parallel (``ep_buffer``: a JAX
    ``Buffer`` on a one-device mesh, the port's on a one-rank group): each
    token's top-2 experts through ``fused_oai_moe`` on its bf16 wire.
    Tolerance 2e-2 in both dtypes: the MoE rounds its input, activation and
    output to bf16 on both sides, from f32 sums in another order."""
    _decode_then_prefill(True, dt, ep=True)


def _decode_then_prefill(moe: bool, dt: str, ep: bool = False):
    jdt, tdt, rel = DTYPES[dt]
    jcfg, tcfg, jp, tp, rng = _setup(moe, dt)
    jkw, tkw = {}, {}
    if ep:
        jbuf, tbuf = _one_device_buffers(jcfg)
        jkw, tkw, rel = {"ep_buffer": jbuf}, {"ep_buffer": tbuf}, DTYPES["bf16"][2]
    kv_j, kv_t = _caches(rng, jcfg, 17, jdt, tdt)
    bt = np.arange(1, 17, dtype=np.int32).reshape(4, 4)
    ctx = np.asarray([1, 7, 20, 33], np.int32)
    pos = ctx - 1
    slots = (bt[np.arange(4), pos // PAGE] * PAGE + pos % PAGE).astype(np.int32)
    slots[0] = -1
    x = (rng.standard_normal((4, jcfg.hidden)) * 0.5).astype(np.float32)
    yj, kv_j = _jit(jm.decode_step, jcfg, **jkw)(jp, jx(x, jdt), jx(pos), kv_j, jx(bt),
                                                 jx(ctx), jx(slots))
    yt, kv_t = tm.decode_step(tcfg, tp, tt(x, tdt), tt(pos), kv_t, tt(bt), tt(ctx), tt(slots),
                              **tkw)
    assert yt.dtype == tdt
    _close(yt, yj, rel)

    seq = np.asarray([12, 1, 5], np.int32)
    pctx = np.asarray([30, 1, 21], np.int32)
    rows = [(b, int(pctx[b] - seq[b] + t)) for b in range(3) for t in range(seq[b])]
    pslots = np.asarray([bt[b, p // PAGE] * PAGE + p % PAGE for b, p in rows] + [-1, -1],
                        np.int32)
    xp = (rng.standard_normal((len(pslots), jcfg.hidden)) * 0.5).astype(np.float32)
    hj, kv_j = _jit(jm.prefill_step, jcfg, max_q=16, **jkw)(
        jp, jx(xp, jdt), jx(seq), kv_j, jx(bt[:3]), jx(pctx), jx(pslots))
    ht, kv_t = tm.prefill_step(tcfg, tp, tt(xp, tdt), tt(seq), kv_t, tt(bt[:3]), tt(pctx),
                               tt(pslots), max_q=16, **tkw)
    _close(ht[:18], hj[:18], rel)
    for (kj, vj), (kt, vt) in zip(kv_j, kv_t):
        _close(kt, kj, rel)
        _close(vt, vj, rel)


def test_prefill_golden_path_matches_jax():
    """``use_pallas=False``: the golden prefill attention on both sides."""
    jcfg, tcfg, jp, tp, rng = _setup(True, "f32", seed=1)
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


def test_decode_step_ref_matches_jax_and_decode_step():
    """JAX's golden (dense MLP, no biases) against the port's, and the
    port's decode_step on the same weights and caches."""
    jcfg, tcfg, jp, tp, rng = _setup(False, "f32", seed=2)
    kv_j, kv_t = _caches(rng, jcfg, 9, jnp.float32, torch.float32)
    kv_t2 = [(k.clone(), v.clone()) for k, v in kv_t]
    bt = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    ctx = np.asarray([9, 50], np.int32)
    pos = ctx - 1
    slots = (bt[np.arange(2), pos // PAGE] * PAGE + pos % PAGE).astype(np.int32)
    x = (rng.standard_normal((2, jcfg.hidden)) * 0.5).astype(np.float32)
    args_j = (jx(x), jx(pos), kv_j, jx(bt), jx(ctx), jx(slots))
    want, _ = _jit(jm.decode_step_ref, jcfg)(jp, *args_j)
    got, _ = tm.decode_step_ref(tcfg, tp, tt(x), tt(pos), kv_t, tt(bt), tt(ctx), tt(slots))
    _close(got, want, 1e-5)
    got2, _ = tm.decode_step(tcfg, tp, tt(x), tt(pos), kv_t2, tt(bt), tt(ctx), tt(slots))
    _close(got2, want, 1e-5)


def test_checkpoint_extras_match_jax():
    """An untied head (``w_lm``), a checkpoint's ``rms_eps`` (which the head
    reads, as JAX's does) and scaled rope tables (``rope_inv_freq``,
    ``rope_attention_scaling``) cross over and give JAX's logits."""
    jcfg0 = jm.GptOssConfig(num_layers=2, page_size=PAGE, vocab_size=64, sliding_window=8)
    rng = np.random.default_rng(5)
    inv_freq = (1.0 / 150000 ** (np.arange(0, jcfg0.head_dim, 2) / jcfg0.head_dim) * 0.7)
    extra = {"w_lm": (rng.standard_normal((jcfg0.hidden, 64)) * 0.02).astype(np.float32),
             "rms_eps": 1e-5, "rope_inv_freq": inv_freq.astype(np.float32),
             "rope_attention_scaling": np.float32(1.2)}
    jcfg, tcfg, jp, tp, rng = _setup(True, "f32", seed=3, **extra)
    assert tp["rms_eps"] == 1e-5 and tp["w_lm"].shape == (jcfg.hidden, 64)
    kv_j, kv_t = _caches(rng, jcfg, 3, jnp.float32, torch.float32)
    bt = np.asarray([[1, 2]], np.int32)
    x = (rng.standard_normal((6, jcfg.hidden)) * 0.5).astype(np.float32)
    slots = (bt[0, np.arange(20, 26) // PAGE] * PAGE + np.arange(20, 26) % PAGE).astype(np.int32)
    seq, ctx = np.asarray([6], np.int32), np.asarray([26], np.int32)
    hj, _ = _jit(jm.prefill_step, jcfg, max_q=6)(jp, jx(x), jx(seq), kv_j, jx(bt), jx(ctx),
                                                 jx(slots))
    ht, _ = tm.prefill_step(tcfg, tp, tt(x), tt(seq), kv_t, tt(bt), tt(ctx), tt(slots), max_q=6)
    _close(tm.lm_head(tp, ht), jm.lm_head(jp, hj), 1e-5)


def test_engine_matches_jax_engine():
    """The port's Engine with gpt_oss_adapter and the JAX package's: the same
    greedy tokens for two prompts served together (chunked prefill of 8, one
    crossing the 8-key window)."""
    from sgl_kernel_npu_tpu.runtime.engine import Engine as JEngine
    from sgl_kernel_npu_tpu.runtime.engine import gpt_oss_adapter as jadapter

    jcfg, tcfg, jp, tp, _ = _setup(True, "f32", seed=4)
    prompts = [[5, 9, 2, 33, 17, 4, 8, 21, 60, 3, 11, 40, 7], [40, 41, 42, 43, 44]]
    kw = dict(num_pages=64, max_batch=2, max_pages_per_req=16, prefill_chunk=8)
    want = JEngine(jadapter(jcfg, jp), **kw).run(prompts, 5)
    eng = Engine(gpt_oss_adapter(tcfg, tp, device="cpu"), device="cpu", **kw)
    assert eng.run(prompts, 5) == want
    assert eng.cm.free_pages + eng.cm.cached_pages == 64


def test_ep_engine_matches_jax_engine():
    """``gpt_oss_adapter(ep_buffer=...)`` through both engines (one-device
    ``Buffer``s): the same greedy tokens, the pages back."""
    from sgl_kernel_npu_tpu.runtime.engine import Engine as JEngine
    from sgl_kernel_npu_tpu.runtime.engine import gpt_oss_adapter as jadapter

    jcfg, tcfg, jp, tp, _ = _setup(True, "f32", seed=4)
    jbuf, tbuf = _one_device_buffers(jcfg)
    prompts = [[5, 9, 2, 33, 17, 4, 8, 21, 60, 3, 11, 40, 7], [40, 41, 42, 43, 44]]
    kw = dict(num_pages=64, max_batch=2, max_pages_per_req=16, prefill_chunk=8)
    want = JEngine(jadapter(jcfg, jp, ep_buffer=jbuf), **kw).run(prompts, 5)
    eng = Engine(gpt_oss_adapter(tcfg, tp, ep_buffer=tbuf, device="cpu"), device="cpu", **kw)
    assert eng.run(prompts, 5) == want
    assert eng.cm.free_pages + eng.cm.cached_pages == 64


def test_unported_switches_raise():
    """The ``Buffer`` switches GPT-OSS's expert-parallel serving could not
    take before are ported: a ``Buffer`` with the validated exchange or
    multi-round dispatch builds, and the low-latency (decode) mode and two
    rounds run (one rank: the dispatch returns every routed row); an
    unknown transport still raises."""
    from _torch_parity import one_rank_group
    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer

    group = one_rank_group()
    for cfg in (EPConfig(validate_comm=True), EPConfig(normal_round_tokens=64)):
        Buffer(group, num_experts=4, config=cfg)
    for backend in ("pallas", "pallas_ragged"):
        buf = Buffer(group, num_experts=4, config=EPConfig(comm_backend=backend))
    x, idx = torch.zeros((2, 8)), torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    rx, _, cnt, handle, _ = buf.low_latency_dispatch(x, idx)
    assert rx.shape == (4, 128, 8) and cnt.tolist() == [1, 1, 1, 1]
    buf.low_latency_combine(rx.float(), torch.ones((2, 2)), handle)
    _, _, gs, _, _ = buf.dispatch(x, idx, rounds=2)
    assert gs.tolist() == [1, 1, 1, 1]
    with pytest.raises(ValueError, match="unknown comm backend"):
        Buffer(group, num_experts=4, config=EPConfig(comm_backend="nccl"))


def test_adapters_default_cache_dtype():
    """``dtype=None``: an f32 cache on the CPU (JAX's default); the card's
    default, bf16, is the ``cuda`` tests'.  A named dtype is kept; the int8
    and packed caches ride on the config."""
    from sgl_kernel_npu_tpu_torch.models import llama as tl
    from sgl_kernel_npu_tpu_torch.runtime.engine import llama_adapter

    cfg = tm.GptOssConfig(num_layers=1, vocab_size=32)
    params = tm.init_weights(cfg, 0, device="cpu")
    assert gpt_oss_adapter(cfg, params, device="cpu").init_cache(2)[0][0].dtype == torch.float32
    bf = gpt_oss_adapter(cfg, params, torch.bfloat16, device="cpu").init_cache(2)[0][0]
    assert bf.dtype == torch.bfloat16
    c8 = gpt_oss_adapter(dataclasses.replace(cfg, kv_cache_dtype="int8", packed_kv=True), params,
                         device="cpu").init_cache(2)[0][0]
    assert c8.dtype == torch.int8 and c8.shape == (2, 1, cfg.page_size, 2 * cfg.head_dim)
    lcfg = tl.LlamaConfig(num_layers=1, vocab_size=32)
    lp = tl.init_weights(lcfg, 0, device="cpu")
    assert llama_adapter(lcfg, lp, device="cpu").init_cache(2)[0][0].dtype == torch.float32


# cache modes: (config fields, per-kv-head kv_scales passed to the steps)
MODES = {"int8": (dict(kv_cache_dtype="int8"), False),
         "packed": (dict(packed_kv=True), False),
         "packed_int8": (dict(packed_kv=True, kv_cache_dtype="int8"), True)}


def _mode_caches(rng, cfg, num_pages, jdt, tdt):
    """Random history in the mode's cache: packed rows, int8 levels."""
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    shape = (num_pages, hkv // 2, PAGE, 2 * d) if cfg.packed_kv else (num_pages, hkv, PAGE, d)
    out_j, out_t = [], []
    for _ in range(cfg.num_layers):
        pair = []
        for _ in range(2):
            a = rng.standard_normal(shape).astype(np.float32) * 0.5
            if cfg.kv_cache_dtype == "int8":
                a = np.clip(np.round(a * 64), -128, 127).astype(np.int8)
            pair.append(a)
        out_j.append(tuple(jx(a) if a.dtype == np.int8 else jx(a, jdt) for a in pair))
        out_t.append(tuple(tt(a) if a.dtype == np.int8 else tt(a, tdt) for a in pair))
    return out_j, out_t


@pytest.mark.parametrize("mode,dt", [("int8", "f32"), ("packed", "f32"), ("packed", "bf16"),
                                     ("packed_int8", "f32")])
def test_cache_modes_match_jax(mode, dt):
    """The int8 cache (``cfg.kv_scale``), the packed cache, and the packed
    int8 cache with per-kv-head ``kv_scales``: a decode step (a pad row) then
    a packed prefill of three requests on the caches it left, hidden states
    and caches against JAX's (its packed decode on the flat kernel, JAX's
    default).  int8 within 1e-4 (a rounding tie moves a level), levels of
    the new rows equal."""
    fields, per_head = MODES[mode]
    jdt, tdt, rel = DTYPES[dt]
    rel = 1e-4 if "int8" in mode else rel
    jcfg, tcfg, jp, tp, rng = _setup(False, dt, seed=6, **{})
    jcfg = dataclasses.replace(jcfg, **fields)
    tcfg = dataclasses.replace(tcfg, **fields)
    kv_j, kv_t = _mode_caches(rng, jcfg, 9, jdt, tdt)
    kw_j, kw_t = {}, {}
    if per_head:
        sc = [(rng.uniform(0.01, 0.03, 2).astype(np.float32),
               rng.uniform(0.01, 0.03, 2).astype(np.float32)) for _ in range(2)]
        kw_j = {"kv_scales": [(jx(a), jx(b)) for a, b in sc]}
        kw_t = {"kv_scales": [(tt(a), tt(b)) for a, b in sc]}
    bt = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    ctx = np.asarray([20, 33], np.int32)
    pos = ctx - 1
    slots = (bt[np.arange(2), pos // PAGE] * PAGE + pos % PAGE).astype(np.int32)
    bt3 = np.concatenate([bt, np.zeros((1, 4), np.int32)])
    ctx3, pos3 = np.append(ctx, 1), np.append(pos, 0)
    slots3 = np.append(slots, -1).astype(np.int32)
    x = (rng.standard_normal((3, jcfg.hidden)) * 0.5).astype(np.float32)
    yj, kv_j = _jit(jm.decode_step, jcfg)(jp, jx(x, jdt), jx(pos3), kv_j, jx(bt3), jx(ctx3),
                                          jx(slots3), **kw_j)
    yt, kv_t = tm.decode_step(tcfg, tp, tt(x, tdt), tt(pos3), kv_t, tt(bt3), tt(ctx3), tt(slots3),
                              **kw_t)
    _close(yt, yj, rel)
    seq = np.asarray([12, 1], np.int32)
    pctx = np.asarray([40, 1], np.int32)
    rows = [(b, int(pctx[b] - seq[b] + t)) for b in range(2) for t in range(seq[b])]
    pslots = np.asarray([bt[b, p // PAGE] * PAGE + p % PAGE for b, p in rows] + [-1], np.int32)
    xp = (rng.standard_normal((len(pslots), jcfg.hidden)) * 0.5).astype(np.float32)
    hj, kv_j = _jit(jm.prefill_step, jcfg, max_q=12)(jp, jx(xp, jdt), jx(seq), kv_j, jx(bt),
                                                    jx(pctx), jx(pslots), **kw_j)
    ht, kv_t = tm.prefill_step(tcfg, tp, tt(xp, tdt), tt(seq), kv_t, tt(bt), tt(pctx),
                               tt(pslots), max_q=12, **kw_t)
    _close(ht[:13], hj[:13], rel)
    for (kj, vj), (kt, vt) in zip(kv_j, kv_t):
        assert kt.dtype == (torch.int8 if "int8" in mode else tdt)
        if "int8" in mode:     # every level but a rare rounding tie
            for a, b in ((kt, kj), (vt, vj)):
                diff = np.abs(a.numpy().astype(int) - np.asarray(b).astype(int))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        else:
            _close(kt, kj, rel)
            _close(vt, vj, rel)


def _jax_weights_q(jcfg, params_np):
    """JAX's quantize_weights on the f32 weights → (jax tree, numpy tree)."""
    jparams = jax.tree.map(jx, params_np)
    wq = jm.quantize_weights(jcfg, jparams)
    return wq, jax.tree.map(np.asarray, wq)


@pytest.mark.parametrize("moe", [False, True])
def test_quantize_weights_bit_equal_to_jax(moe):
    """The port's quantize_weights on the same f32 weights: the same int8
    matrices and scales, bit for bit (every projection in dense mode, the
    attention ones only in MoE mode)."""
    from sgl_kernel_npu_tpu_torch.models.w8a8 import from_jax_weights_q

    jcfg, tcfg, _, tp, _ = _setup(moe, "f32", seed=8)
    params_np = {"layers": [{n: a.numpy() for n, a in lw.items()} for lw in tp["layers"]]}
    _, wq_np = _jax_weights_q(jcfg, params_np)
    got = tm.quantize_weights(tcfg, tp)
    want = from_jax_weights_q(wq_np, device="cpu")
    names = {"wq", "wk", "wv", "wo"} | (set() if moe else {"w_gate_up", "w_down"})
    for lg, lw in zip(got["layers"], want["layers"]):
        assert set(lg) == set(lw) == names
        for n in names:
            assert torch.equal(lg[n][0], lw[n][0]) and torch.equal(lg[n][1], lw[n][1])


def test_weights_q_engine_matches_jax_engine():
    """W8A8 (``weights_q``, dense mode: every projection on K5 / K1) through
    both engines: the same greedy tokens; and one decode step's hidden state
    within 1e-4 of JAX's."""
    from sgl_kernel_npu_tpu.runtime.engine import Engine as JEngine
    from sgl_kernel_npu_tpu.runtime.engine import gpt_oss_adapter as jadapter
    from sgl_kernel_npu_tpu_torch.models.w8a8 import from_jax_weights_q

    jcfg, tcfg, jp, tp, rng = _setup(False, "f32", seed=9)
    params_np = jax.tree.map(np.asarray, jp)
    wq_j, wq_np = _jax_weights_q(jcfg, params_np)
    wq_t = from_jax_weights_q(wq_np, device="cpu")
    prompts = [[5, 9, 2, 33, 17, 4, 8, 21, 60, 3, 11], [40, 41, 42, 43, 44]]
    kw = dict(num_pages=64, max_batch=2, max_pages_per_req=16, prefill_chunk=8)
    want = JEngine(jadapter(jcfg, jp, weights_q=wq_j), **kw).run(prompts, 4)
    eng = Engine(gpt_oss_adapter(tcfg, tp, weights_q=wq_t, device="cpu"), device="cpu", **kw)
    assert eng.run(prompts, 4) == want

    kv_j, kv_t = _caches(rng, jcfg, 5, jnp.float32, torch.float32)
    bt = np.arange(1, 5, dtype=np.int32).reshape(1, 4)
    x = (rng.standard_normal((1, jcfg.hidden)) * 0.5).astype(np.float32)
    args = (np.asarray([30], np.int32), bt, np.asarray([31], np.int32),
            np.asarray([bt[0, 1] * PAGE + 14], np.int32))
    yj, _ = _jit(jm.decode_step, jcfg)(jp, jx(x), *(jx(a) for a in args[:1]), kv_j,
                                       *(jx(a) for a in args[1:]), weights_q=wq_j)
    yt, _ = tm.decode_step(tcfg, tp, tt(x), tt(args[0]), kv_t, *(tt(a) for a in args[1:]),
                           weights_q=wq_t)
    _close(yt, yj, 1e-4)


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = tm.GptOssConfig(num_layers=1, vocab_size=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_weights(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_kv_cache(cfg, 4)
    params = tm.init_weights(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt_oss_adapter(cfg, params)
