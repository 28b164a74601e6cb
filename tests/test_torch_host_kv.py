"""Port: the engine's L2 host KV tier and prefill / decode disaggregation
(``HostKVPool``, the adapters' page hooks) against the JAX package's engine.

The port's Engine and JAX's serve the same prompts on the same weights
(Llama and DeepSeek-V3, f32 on the CPU): a finished prompt offloads its full
pages, a flood of other prompts evicts them from the small device radix, and
the prompt served again restores them from the host pool; and two engines
over one ``HostKVPool``, one prefilling and one decoding.  Held equal: the
greedy tokens; the stats ``host_offloaded_pages``, ``host_restored_tokens``,
``prefill_tokens`` and ``cached_tokens``; the host pool's rows of each
matched token span (1e-6 of the span's largest |value|: f32 caches
written by the two packages' own arithmetic); every page returned.  The page hooks round-trip every cache
layout bit-equal (the int8 latent beside the rope cache, DSA's index keys,
GPT-OSS's packed int8 cache); the tier's refusals and the LoRA departure
(a request with an adapter neither offloads nor restores) are pinned."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_config
from sgl_kernel_npu_tpu.models import deepseek_v3 as jdm
from sgl_kernel_npu_tpu.models import llama as jlm
from sgl_kernel_npu_tpu.runtime import engine as je
from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tdm
from sgl_kernel_npu_tpu_torch.models import gpt_oss as tgm
from sgl_kernel_npu_tpu_torch.models import llama as tlm
from sgl_kernel_npu_tpu_torch.runtime import engine as te

PROMPT = [5, 9, 2, 33, 17, 4, 8, 21, 60, 3]        # 2 full pages of 4 + a tail
FLOOD = [[[(base + i) % 61 for i in range(12)], [(base + 30 + i) % 61 for i in range(12)]]
         for base in range(0, 55, 9)]


@pytest.fixture(scope="module")
def llama():
    jcfg = jlm.LlamaConfig(vocab_size=61, num_layers=2, page_size=4)
    params = jlm.init_weights(jax.random.key(7), jcfg)
    tparams = tlm.from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    return (lambda: je.llama_adapter(jcfg, params),
            lambda: te.llama_adapter(port_config(jcfg, tlm.LlamaConfig), tparams, device="cpu"))


@pytest.fixture(scope="module")
def deepseek():
    jcfg = jdm.DeepSeekV3Config(num_layers=1, page_size=4, vocab_size=61)
    params = jdm.init_weights(jax.random.key(3), jcfg, jnp.float32)
    tparams, _, _, _ = tdm.from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    return (lambda: je.deepseek_adapter(jcfg, params),
            lambda: te.deepseek_adapter(port_config(jcfg, tdm.DeepSeekV3Config), tparams,
                                        device="cpu"))


def _pair(adapters, num_pages, **kw):
    jadapter, tadapter = adapters
    kw = {"max_batch": 2, "max_pages_per_req": 8, "prefill_chunk": 8, **kw}
    jpool, tpool = kw.pop("pools", (None, None))
    return (je.Engine(jadapter(), num_pages, host_pool=jpool, **kw),
            te.Engine(tadapter(), num_pages, host_pool=tpool, device="cpu", **kw))


STATS = ("host_offloaded_pages", "host_restored_tokens", "prefill_tokens", "cached_tokens")


def _rows(pool, pages) -> list[np.ndarray]:
    """The pool's rows at ``pages``, tensor by tensor (a dict layer's keys
    sorted, as JAX orders a pytree's)."""
    out = []
    for layer in pool:
        ts = [layer[k] for k in sorted(layer)] if isinstance(layer, dict) else list(layer)
        out += [np.asarray(t[np.asarray(pages, np.int64)], np.float32) for t in ts]
    return out


def _same_host_pools(jeng, teng, spans):
    """Both host radixes hold the same pages of each span, with equal rows."""
    for span in spans:
        toks = np.asarray(span, np.int32)
        jm_, jpages = jeng.host_cm.match(toks)
        tm_, tpages = teng.host_cm.match(toks)
        try:
            assert jm_ == tm_
            for got, want in zip(_rows(teng.host_pool, tpages), _rows(jeng.host_pool, jpages),
                                 strict=True):
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
        finally:
            for cm, m in ((jeng.host_cm, jm_), (teng.host_cm, tm_)):
                if m:
                    cm.release(toks[:m])


def _all_pages_back(eng, num_pages):
    assert eng.cm.free_pages + eng.cm.cached_pages == num_pages


@pytest.mark.parametrize("model", ["llama", "deepseek"])
def test_offload_evict_restore_matches_jax(model, request):
    """tests/test_engine.py's host-tier tests (Llama's and DeepSeek's dict
    caches): offload, eviction from the device radix by a flood of other
    prompts, restore; the port's engine against JAX's, step for step."""
    jeng, teng = _pair(request.getfixturevalue(model), 16, host_pool_pages=64)
    for batch in [[PROMPT]] + FLOOD + [[PROMPT]]:
        n_new = 4 if batch == [PROMPT] else 2
        assert teng.run(batch, n_new) == jeng.run(batch, n_new)
        assert {k: teng.stats[k] for k in STATS} == {k: jeng.stats[k] for k in STATS}
    assert teng.stats["host_offloaded_pages"] >= 2 and teng.stats["host_restored_tokens"] >= 8
    _same_host_pools(jeng, teng, [PROMPT[:8]] + [p[:8] for batch in FLOOD for p in batch])
    _all_pages_back(teng, 16)
    assert teng.host_cm.free_pages + teng.host_cm.cached_pages == 64


@pytest.mark.parametrize("model", ["llama", "deepseek"])
def test_prefill_decode_disaggregation_matches_jax(model, request):
    """tests/test_engine.py:127: a prefill engine serves the prompt for one
    token and offloads; a decode engine over the same ``HostKVPool``
    restores both full pages and prefills only the tail; its tokens equal
    JAX's pair's and a monolithic engine's."""
    adapters = request.getfixturevalue(model)
    pools = (je.HostKVPool(64, 4), te.HostKVPool(64, 4))
    jp, tp = _pair(adapters, 32, pools=pools)
    assert tp.run([PROMPT], 1) == jp.run([PROMPT], 1)
    assert tp.stats["host_offloaded_pages"] == jp.stats["host_offloaded_pages"] == 2
    jd, td = _pair(adapters, 32, pools=pools)
    got = td.run([PROMPT], 6)
    assert got == jd.run([PROMPT], 6)
    assert {k: td.stats[k] for k in STATS} == {k: jd.stats[k] for k in STATS}
    assert td.stats["host_restored_tokens"] == 8
    assert td.stats["prefill_tokens"] == len(PROMPT) - 8
    mono = te.Engine(adapters[1](), 32, max_batch=2, max_pages_per_req=8, prefill_chunk=8,
                     device="cpu")
    assert got == mono.run([PROMPT], 6)
    _same_host_pools(jp, tp, [PROMPT[:8]])
    for eng in (tp, td):
        _all_pages_back(eng, 32)


def _levels(shape, dtype, gen):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    return torch.randn(shape, generator=gen).to(dtype)


CACHES = {
    "deepseek int8 latent": lambda: tdm.init_kv_cache(
        tdm.DeepSeekV3Config(num_layers=2, page_size=4, kv_cache_dtype="int8"), 8,
        torch.bfloat16, device="cpu"),
    "deepseek dsa kidx": lambda: tdm.init_kv_cache(
        tdm.DeepSeekV3Config(num_layers=2, page_size=4, kv_cache_dtype="int8", sparse_count=8),
        8, torch.bfloat16, device="cpu"),
    "gpt-oss packed int8": lambda: tgm.init_kv_cache(
        tgm.GptOssConfig(num_layers=2, page_size=4, packed_kv=True, kv_cache_dtype="int8"), 8,
        device="cpu"),
    "llama bf16": lambda: tlm.init_kv_cache(
        tlm.LlamaConfig(num_layers=2, page_size=4), 8, torch.bfloat16, device="cpu"),
}


@pytest.mark.parametrize("layout", sorted(CACHES))
def test_page_hooks_round_trip(layout):
    """``paged_gather_pages`` then ``paged_scatter_pages`` onto other pages
    of a fresh cache: every tensor's named pages bit-equal, in its dtype
    (int8 levels beside a bf16 rope or index-key cache), the rest untouched."""
    gen = torch.Generator().manual_seed(0)
    src = CACHES[layout]()
    for t in te.cache_tensors(src):
        t.copy_(_levels(t.shape, t.dtype, gen))
    dst = CACHES[layout]()
    if "kidx" in layout:
        assert all("kidx" in layer for layer in dst)
    from_pages, to_pages = torch.tensor([3, 0, 5]), torch.tensor([1, 2, 7])
    payload = te.paged_gather_pages(src, from_pages)
    assert [p.dtype for p in te.cache_tensors(payload)] == [t.dtype
                                                            for t in te.cache_tensors(src)]
    te.paged_scatter_pages(dst, to_pages, payload)
    for s, d in zip(te.cache_tensors(src), te.cache_tensors(dst), strict=True):
        assert torch.equal(d[to_pages], s[from_pages])
        rest = torch.tensor([p for p in range(8) if p not in to_pages.tolist()])
        assert not d[rest].any()


@pytest.mark.parametrize("case", ["no hooks", "draft", "page size"])
def test_host_tier_refusals(case, llama):
    """JAX's refusals (engine.py:346-352), each a ValueError: an adapter
    without page hooks, the tier with a draft adapter, a pool whose page
    size differs from the engine's."""
    adapter = llama[1]()
    kw = {"host_pool_pages": 16}
    if case == "no hooks":
        adapter.gather_pages = None
    elif case == "draft":
        kw.update(spec_k=2, draft_adapter=llama[1]())
    else:
        kw = {"host_pool": te.HostKVPool(16, 8)}
    with pytest.raises(ValueError, match="gather/scatter_pages|speculative|page size"):
        te.Engine(adapter, 16, device="cpu", **kw)


def test_lora_request_neither_offloads_nor_restores():
    """The port's departure (ROADMAP §C): a request with ``lora_id != 0``
    computes its own K / V, so it neither offloads to the host pool nor
    restores from it; an adapter-0 request on the same prompt does both."""
    jcfg = jlm.LlamaConfig(vocab_size=61, num_layers=2, page_size=4)
    tcfg = port_config(jcfg, tlm.LlamaConfig)
    params = jax.tree.map(np.asarray, jlm.init_weights(jax.random.key(7), jcfg))
    tparams = tlm.from_jax_params(params, device="cpu")
    lora = tlm.from_jax_lora(jax.tree.map(np.asarray, jlm.init_lora(jax.random.key(1), jcfg, 2, 4)),
                             device="cpu")
    pool = te.HostKVPool(64, 4)

    def engine():
        return te.Engine(te.llama_adapter(tcfg, tparams, lora=lora, device="cpu"), 16,
                         max_batch=2, max_pages_per_req=8, prefill_chunk=8, host_pool=pool,
                         device="cpu")

    p = engine()
    p.add_request(PROMPT, 1, lora_id=1)
    while p.waiting or p.running:
        p.step()
    assert p.stats["host_offloaded_pages"] == 0 and pool.cm.cached_pages == 0
    p.run([PROMPT], 1)                                # adapter 0 offloads
    assert p.stats["host_offloaded_pages"] == 2
    d = engine()
    rid = d.add_request(PROMPT, 3, lora_id=1)
    while d.waiting or d.running:
        d.step()
    assert d.stats["host_restored_tokens"] == 0 and d.stats["prefill_tokens"] == len(PROMPT)
    solo = te.Engine(te.llama_adapter(tcfg, tparams, lora=lora, device="cpu"), 16, max_batch=2,
                     max_pages_per_req=8, prefill_chunk=8, device="cpu")
    want = solo.add_request(PROMPT, 3, lora_id=1)
    while solo.waiting or solo.running:
        solo.step()
    assert d.finished[rid] == solo.finished[want]
    d.run([PROMPT], 3)                                # adapter 0 restores
    assert d.stats["host_restored_tokens"] == 8
