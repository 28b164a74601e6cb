"""Port parity: Qwen3-Next's hybrid under W8A8, through chunked prefill and
the engine: the W8A8 steps, a prompt prefilled in chunks resumes its GDN
state, and ``Engine`` +
``qwen3_hybrid_adapter`` gives the JAX engine's tokens where the JAX engine
is right and departs where it is not; what it still refuses.

The widths and helpers of ``tests/_torch_qwen3.py``.  Tolerances: the
port's chunked against its one-shot prefill within 2e-3 of the largest
value (JAX's own test holds its at 2e-3); W8A8 steps within 2e-3 of
JAX's (a rounding tie moves a level), the quantized weights bit-equal; the
engines' greedy tokens equal."""

import functools

import jax
import numpy as np
import pytest
import torch

from _torch_parity import tt
from sgl_kernel_npu_tpu_torch.models import qwen3_next as tm
from sgl_kernel_npu_tpu_torch.models import w8a8 as tw
from sgl_kernel_npu_tpu_torch.runtime.engine import Engine, llama_adapter, qwen3_hybrid_adapter
from _torch_qwen3 import FULL, _cfgs, _close, _params, _slots, run_steps
from sgl_kernel_npu_tpu.models import qwen3_next as jm


def test_hybrid_w8a8_steps_match_jax():
    """``weights_q`` (``quantize_hybrid_weights``: attention q / k / v / o,
    GDN qkvz / out, the dense MLP pair; bit-equal to JAX's) through a decode
    step and a prefill chunk, as ``test_hybrid_steps_match_jax``."""
    jcfg, tcfg = _cfgs(num_layers=2)
    jp, tp = _params(jcfg, 3)
    wq_j = jm.quantize_hybrid_weights(jcfg, jp)
    wq_t = tm.quantize_hybrid_weights(tcfg, tp)
    ref = tw.from_jax_weights_q(jax.tree.map(np.asarray, wq_j), device="cpu")
    for lg, lw in zip(wq_t["layers"], ref["layers"]):
        assert set(lg) == set(lw)
        for n in lg:
            assert torch.equal(lg[n][0], lw[n][0]) and torch.equal(lg[n][1], lw[n][1])
    run_steps(jcfg, tcfg, jp, tp, 4, None, torch.float32, 2e-3, {"weights_q": wq_j},
              {"weights_q": wq_t})


def test_hybrid_chunked_prefill_resumes_state():
    """A 16-token prompt prefilled as 6 tokens (padded to 8) then 10 equals
    one 16-token prefill, hidden states and caches alike (JAX's
    ``test_hybrid_chunked_prefill_resumes_state``, whose one-shot prefill
    ``test_hybrid_steps_match_jax`` holds to JAX's); the snapshot / restore
    hooks round-trip the state."""
    _, tcfg = _cfgs(num_layers=2, **FULL)
    tp = tm.init_hybrid_weights(tcfg, 9, device="cpu")
    rng = np.random.default_rng(1)
    n = 16
    bt = np.arange(1, 5, dtype=np.int32).reshape(1, 4)
    x = (rng.standard_normal((n, tcfg.hidden)) * 0.5).astype(np.float32)
    si = tt(np.asarray([0], np.int32))
    all_slots = _slots(bt[0], range(n))
    i32 = lambda v: tt(np.asarray(v, np.int32))  # noqa: E731
    c_full = tm.init_hybrid_cache(tcfg, 32, 2, device="cpu")
    full, _ = tm.hybrid_prefill_step(tcfg, tp, tt(x), i32([n]), c_full, tt(bt), i32([n]),
                                     tt(all_slots), si, max_q=16)
    c = tm.init_hybrid_cache(tcfg, 32, 2, device="cpu")
    x1 = np.concatenate([x[:6], np.ones((2, tcfg.hidden), np.float32)])
    sl1 = np.concatenate([all_slots[:6], np.full(2, -1, np.int32)])
    h1, c = tm.hybrid_prefill_step(tcfg, tp, tt(x1), i32([6]), c, tt(bt), i32([6]), tt(sl1), si,
                                   max_q=8)
    snap = tm.hybrid_state_snapshot(tcfg, c, si)
    h2, c = tm.hybrid_prefill_step(tcfg, tp, tt(x[6:]), i32([10]), c, tt(bt), i32([16]),
                                   tt(all_slots[6:]), si, max_q=16)
    _close(h1[:6], full[:6], 2e-3)
    _close(h2, full[6:], 2e-3)
    for lf, lc in zip(c_full, c):
        for k in lf:
            _close(lc[k], lf[k], 2e-3)
    tm.hybrid_state_restore(tcfg, c, snap, si)          # back to after the first chunk
    assert torch.equal(c[0]["conv"][:1], snap[0][0]) and torch.equal(c[0]["ssm"][:1], snap[0][1])


def _jax_engine(jcfg, jp, prompts, n_new, **kw):
    from sgl_kernel_npu_tpu.runtime.engine import Engine as JEngine
    from sgl_kernel_npu_tpu.runtime.engine import qwen3_hybrid_adapter as jadapter

    with jax.default_matmul_precision("float32"):
        eng = JEngine(jadapter(jcfg, jp), **kw)
        return eng.run(prompts, n_new), eng


def _prompts():
    rng = np.random.default_rng(21)
    return [[int(t) for t in rng.integers(0, 61, n)] for n in (13, 9, 20)]


KW = dict(num_pages=64, max_pages_per_req=16, prefill_chunk=8)


@functools.lru_cache(maxsize=None)
def _engine_setup():
    """The hybrid (dense MLP, an untied head) served by the JAX engine with
    a slot for each of three distinct prompts, where it is right: each
    prompt's greedy tokens."""
    jcfg, tcfg = _cfgs(num_layers=2, attn_gate=True, qk_norm=True, rotary_dim=16)
    jp, tp = _params(jcfg, 5, w_lm=True)
    want, _ = _jax_engine(jcfg, jp, _prompts(), 5, max_batch=3, **KW)
    return jcfg, tcfg, jp, tp, want


def test_hybrid_engine_matches_jax_engine():
    """Three distinct prompts with a slot each (JAX's engine is right
    there): the port's greedy tokens equal JAX's; every page and state slot
    comes back."""
    _, tcfg, _, tp, want = _engine_setup()
    eng = Engine(qwen3_hybrid_adapter(tcfg, tp, device="cpu"), device="cpu", max_batch=3, **KW)
    assert eng.run(_prompts(), 5) == want
    assert eng.cm.free_pages == 64 and sorted(eng._free_state_slots) == [0, 1, 2]
    assert eng.stats["cached_tokens"] == 0


def test_hybrid_engine_departures():
    """The two departures from the JAX engine, on one slot: prompt A, then
    B (B's slot last held A's state), then A again (its first 19 tokens
    are in the radix).  The port's tokens equal each prompt served alone by
    a fresh JAX engine (``_engine_setup``'s), with no cached tokens; the JAX
    engine's differ for B (the reused slot leaks A's state) and for the
    repeated A (the radix hit skips the recurrence over the matched
    tokens), as ``test_lora_requests_share_no_cached_pages`` shows for
    LoRA."""
    jcfg, tcfg, jp, tp, want = _engine_setup()
    a, b, _ = _prompts()
    fresh = {0: want[0], 1: want[1]}
    eng = Engine(qwen3_hybrid_adapter(tcfg, tp, device="cpu"), device="cpu", max_batch=1, **KW)
    got = eng.run([a, b, a], 5)
    assert got == [fresh[0], fresh[1], fresh[0]]
    assert eng.stats["cached_tokens"] == 0 and eng.cm.cached_pages == 0
    jgot, jeng = _jax_engine(jcfg, jp, [a, b, a], 5, max_batch=1, **KW)
    assert jgot[0] == fresh[0]
    assert jgot[1] != fresh[1] and jgot[2] != fresh[0]
    assert jeng.stats["cached_tokens"] > 0


def test_hybrid_refusals():
    """What the hybrid still refuses: ``moe_weights_q`` without
    ``ep_buffer`` and the reverse (``ValueError`` naming the other, at the
    adapter and the steps; JAX serves the dense MoE there), the host tier
    (no page hooks to offload with; ``ValueError``, as JAX) and tree
    speculation of a hybrid target (``ValueError``, as JAX)."""
    jcfg, tcfg = _cfgs(num_layers=2, moe_experts=4, moe_topk=2)
    tp = tm.init_hybrid_weights(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="moe_weights_q with ep_buffer"):
        qwen3_hybrid_adapter(tcfg, tp, moe_weights_q=[None, None], device="cpu")
    with pytest.raises(ValueError, match="ep_buffer with moe_weights_q"):
        qwen3_hybrid_adapter(tcfg, tp, ep_buffer=object(), device="cpu")
    caches = tm.init_hybrid_cache(tcfg, 4, 2, device="cpu")
    z = torch.zeros((1, tcfg.hidden))
    i = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="ep_buffer with moe_weights_q"):
        tm.hybrid_decode_step(tcfg, tp, z, i, caches, i[None], i + 1, i, i, ep_buffer=object())
    with pytest.raises(ValueError, match="moe_weights_q with ep_buffer"):
        tm.hybrid_prefill_step(tcfg, tp, z, i + 1, caches, i[None], i + 1, i, i,
                               moe_weights_q=[None, None])
    adapter = qwen3_hybrid_adapter(tcfg, tp, device="cpu")
    with pytest.raises(ValueError, match="gather/scatter_pages"):
        Engine(adapter, 16, host_pool_pages=8, device="cpu")
    from sgl_kernel_npu_tpu_torch.models import llama as tl

    dcfg = tl.LlamaConfig(vocab_size=tcfg.vocab_size, num_layers=1, page_size=tcfg.page_size)
    draft = llama_adapter(dcfg, tl.init_weights(dcfg, 1, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="tree speculation"):
        Engine(adapter, 16, spec_k=2, draft_adapter=draft, spec_tree_width=2, device="cpu")
