"""Port: the serving engine with the DeepSeek-V3 W8A8 adapter on the CPU.

The port's Engine must equal the port's straight-line prefill + decode chain
token for token (same kernels' plain versions, same arithmetic); radix reuse
and page release must work; and teacher-forced on the port's tokens, the JAX
package's adapter path must give the same logits (tolerance 1% of max|logit|:
int8 requant flips and the JAX GMM2's bf16 expert outputs, as in
test_torch_deepseek_v3.py) and log-probabilities (atol 2e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, port_config
from sgl_kernel_npu_tpu.models import deepseek_v3 as jm
from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tm
from sgl_kernel_npu_tpu_torch.runtime.engine import Engine, deepseek_adapter

PROMPT = [5, 9, 2, 33, 17, 4, 8, 21, 60, 3]       # 10 tokens: 2.5 pages of 4


@pytest.fixture(scope="module")
def model():
    jcfg = jm.DeepSeekV3Config(num_layers=1, page_size=4, vocab_size=61)
    params = jm.init_weights(jax.random.key(3), jcfg, jnp.float32)
    moe_j = jm.quantize_moe_weights(jcfg, params)
    tparams, moe_t, _, _ = tm.from_jax_params(jax.tree.map(np.asarray, params),
                                              jax.tree.map(np.asarray, moe_j), device="cpu")
    tcfg = port_config(jcfg, tm.DeepSeekV3Config)
    return jcfg, params, moe_j, tcfg, tparams, moe_t


def _mla_wq(model):
    """The port's fused-prologue weights, calibrated on the prompt's embeddings."""
    _, _, _, tcfg, tparams, _ = model
    return tm.make_mla_preprocess_weights(
        tcfg, tparams, tm.embed(tparams, torch.tensor(PROMPT, dtype=torch.int32)))


def _engine(model, num_pages=64, mla_wq=None, **kw):
    _, _, _, tcfg, tparams, moe_t = model
    kw = {"max_batch": 2, "max_pages_per_req": 16, "prefill_chunk": 8, **kw}
    return Engine(deepseek_adapter(tcfg, tparams, moe_weights_q=moe_t, mla_wq=mla_wq,
                                   device="cpu"),
                  num_pages=num_pages, device="cpu", **kw)


def _chain(model, prompt, n_new, mla_wq=None):
    """Straight-line generation through the port's model functions: the whole
    prompt in one prefill, then one decode per token; returns (tokens, logits)."""
    _, _, _, cfg, params, moe = model
    caches = tm.init_kv_cache(cfg, 32, torch.float32, device="cpu")
    page = cfg.page_size
    bt = torch.arange(1, 17, dtype=torch.int32).reshape(1, 16)
    slot = lambda i: int(bt[0, i // page]) * page + i % page
    n = len(prompt)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    h, caches = tm.prefill_step(cfg, params, tm.embed(params, i32(prompt)), i32([n]), caches,
                                bt, i32([n]), i32([slot(i) for i in range(n)]), max_q=16,
                                moe_weights_q=moe, mla_wq=mla_wq)
    logits = [tm.lm_head(params, h[n - 1 : n])[0]]
    toks = [int(torch.argmax(logits[-1]))]
    for _ in range(n_new - 1):
        i = n + len(toks) - 1
        y, caches = tm.decode_step(cfg, params, tm.embed(params, i32([toks[-1]])), i32([i]),
                                   caches, bt, i32([i + 1]), i32([slot(i)]),
                                   moe_weights_q=moe, mla_wq=mla_wq)
        logits.append(tm.lm_head(params, y)[0])
        toks.append(int(torch.argmax(logits[-1])))
    return toks, torch.stack(logits)


@pytest.mark.parametrize("fused_prologue", [False, True])
def test_engine_matches_chain_batched_and_mixed(model, fused_prologue):
    """Two prompts served together, the second admitted while the first
    decodes (mixed prefill + decode ticks), each equal to its own chain;
    with the float MLA prologue and with the fused W8A8 one (``mla_wq``)."""
    mla_wq = _mla_wq(model) if fused_prologue else None
    p2 = [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51]
    eng = _engine(model, prefill_chunk=4, mla_wq=mla_wq)
    r1 = eng.add_request(PROMPT, 6)
    while not any(r.pos >= r.prompt_len for r in eng.running):
        eng.step()
    r2 = eng.add_request(p2, 4)
    while eng.waiting or eng.running:
        eng.step()
    assert eng.finished[r1] == _chain(model, PROMPT, 6, mla_wq)[0]
    assert eng.finished[r2] == _chain(model, p2, 4, mla_wq)[0]
    assert eng.cm.free_pages + eng.cm.cached_pages == 64


def test_radix_reuse_and_page_release(model):
    shared = [5, 9, 2, 33, 17, 4, 8, 21]            # 2 full pages
    p1, p2 = shared + [60, 3], shared + [11, 12, 13]
    eng = _engine(model)
    out1 = eng.run([p1], 3)[0]
    pre1 = eng.stats["prefill_tokens"]
    assert eng.cm.cached_pages >= 2
    out2 = eng.run([p2], 3)[0]
    assert eng.stats["cached_tokens"] >= 8
    assert eng.stats["prefill_tokens"] - pre1 == len(p2) - 8   # only the tail
    assert out1 == _chain(model, p1, 3)[0] and out2 == _chain(model, p2, 3)[0]
    got = eng.run([p1, p1], 2)                      # identical in-flight prompts
    assert got[0] == got[1] == out1[:2]
    assert eng.cm.free_pages + eng.cm.cached_pages == 64


def test_teacher_forced_logits_match_jax_adapter(model):
    from sgl_kernel_npu_tpu.ops.sampling import token_logprobs as jlogprobs
    from sgl_kernel_npu_tpu.runtime.engine import deepseek_adapter as jadapter

    jcfg, params, moe_j, _, _, _ = model
    n_new = 4
    eng = _engine(model)
    rid = eng.add_request(PROMPT, n_new, logprobs=True)
    while eng.waiting or eng.running:
        eng.step()
    toks, lps = eng.finished[rid], eng.logprobs[rid]
    chain_toks, chain_logits = _chain(model, PROMPT, n_new)
    assert toks == chain_toks

    a = jadapter(jcfg, params, moe_weights_q=moe_j)
    caches = a.init_cache(32, 2)
    page = jcfg.page_size
    bt = np.arange(1, 17, dtype=np.int32).reshape(1, 16)
    slot = lambda i: int(bt[0, i // page]) * page + i % page
    n = len(PROMPT)
    h, caches = a.prefill_step(a.embed(jx(np.asarray(PROMPT, np.int32))),
                               jx(np.asarray([n], np.int32)), caches, jx(bt),
                               jx(np.asarray([n], np.int32)),
                               jx(np.asarray([slot(i) for i in range(n)], np.int32)),
                               None, None)
    logits = [a.lm_head(h[n - 1 : n])[0]]
    for t, tok in enumerate(toks[:-1]):             # feed the port's tokens
        i = n + t
        y, caches = a.decode_step(a.embed(jx(np.asarray([tok], np.int32))),
                                  jx(np.asarray([i], np.int32)), caches, jx(bt),
                                  jx(np.asarray([i + 1], np.int32)),
                                  jx(np.asarray([slot(i)], np.int32)), None, None)
        logits.append(a.lm_head(y)[0])
    want = np.stack([np32(x) for x in logits])
    np.testing.assert_allclose(np32(chain_logits), want, rtol=0,
                               atol=0.01 * np.abs(want).max())
    want_lp = np32(jlogprobs(jnp.asarray(want), jnp.asarray(toks, jnp.int32)))
    np.testing.assert_allclose(np.asarray(lps), want_lp, atol=2e-2)


def test_ep_engine_tokens_match_jax_ep_engine(model):
    """Expert-parallel serving: the port's ``Engine`` over
    ``deepseek_adapter(ep_buffer=Buffer(<one-rank group>, comm_backend=
    "pallas_ragged"))`` emits the JAX EP engine's greedy tokens (its
    ``Buffer`` on a one-device mesh), as JAX's own suite holds its EP engine
    to its single-chip one; and the port's EP tokens equal its single-GPU
    W8A8 engine's."""
    from sgl_kernel_npu_tpu.config import EPConfig as JEPConfig
    from sgl_kernel_npu_tpu.parallel.buffer import Buffer as JBuffer
    from sgl_kernel_npu_tpu.runtime.engine import Engine as JEngine
    from sgl_kernel_npu_tpu.runtime.engine import deepseek_adapter as jadapter

    from _torch_parity import one_rank_group
    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer

    jcfg, params, moe_j, tcfg, tparams, moe_t = model
    prompts, n_new = [PROMPT, [40, 41, 42, 43, 44]], 4
    mesh1 = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("ep",))
    jbuf = JBuffer(mesh1, "ep", jcfg.num_experts, JEPConfig(num_max_dispatch_tokens_per_rank=8))
    want = JEngine(jadapter(jcfg, params, moe_weights_q=moe_j, ep_buffer=jbuf), num_pages=64,
                   max_batch=8, max_pages_per_req=16, prefill_chunk=8).run(prompts, n_new)
    buf = Buffer(one_rank_group(), tcfg.num_experts, EPConfig(
        num_max_dispatch_tokens_per_rank=8, comm_backend="pallas_ragged"))
    ep = Engine(deepseek_adapter(tcfg, tparams, moe_weights_q=moe_t, ep_buffer=buf,
                                 device="cpu"),
                num_pages=64, max_batch=8, max_pages_per_req=16, prefill_chunk=8, device="cpu")
    got = ep.run(prompts, n_new)
    assert got == want
    assert got == _engine(model, max_batch=8).run(prompts, n_new)


def test_engine_tokens_match_jax_engine_at_dispatch_widths():
    """At ``moe_intermediate=96`` (2I % 256 != 0) every MoE call of at most
    512 tokens takes ``_gmm_moe``'s dispatch_p + K8b branch on both sides:
    the port's ``Engine`` emits the JAX engine's greedy tokens."""
    from sgl_kernel_npu_tpu.runtime.engine import Engine as JEngine
    from sgl_kernel_npu_tpu.runtime.engine import deepseek_adapter as jadapter

    jcfg = jm.DeepSeekV3Config(num_layers=1, page_size=4, vocab_size=61, moe_intermediate=96)
    params = jm.init_weights(jax.random.key(4), jcfg, jnp.float32)
    moe_j = jm.quantize_moe_weights(jcfg, params)
    tparams, moe_t, _, _ = tm.from_jax_params(jax.tree.map(np.asarray, params),
                                              jax.tree.map(np.asarray, moe_j), device="cpu")
    prompts, n_new = [PROMPT, [40, 41, 42, 43, 44]], 3
    kw = dict(num_pages=64, max_batch=8, max_pages_per_req=16, prefill_chunk=8)
    want = JEngine(jadapter(jcfg, params, moe_weights_q=moe_j), **kw).run(prompts, n_new)
    got = Engine(deepseek_adapter(port_config(jcfg, tm.DeepSeekV3Config), tparams,
                                  moe_weights_q=moe_t, device="cpu"),
                 device="cpu", **kw).run(prompts, n_new)
    assert got == want
