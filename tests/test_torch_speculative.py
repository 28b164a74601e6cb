"""Port parity: the speculative ops (``ops/speculative.py``) and the engine's
speculative decoding, chain and tree (``runtime/engine.py``).

``build_tree_efficient`` (every mask mode) and ``verify_tree_greedy`` equal
JAX's on random trees, bit for bit.  The engine's speculative tokens equal
the port's plain greedy tokens and the JAX engine's (greedy verification
changes no token): on JAX's tiny Llama with an untied head and a draft of
the target's weights with 50 % noise (some drafts accepted, some rejected),
chain and tree at widths 1-3, the chain's acceptance counts equal the JAX
speculative engine's; on JAX's tiny DeepSeek-V3 with the 1-layer self-draft
of ``tests/test_spec_e2e.py`` (float experts, against the JAX engine's
tokens; W8A8 experts, against the port's plain engine); an oracle draft (the
target itself) accepts every draft token.  No page leaks; the JAX engine's
refusals are ``ValueError``s (a target with recurrent state or one-request
prefill under chain speculation: ``tests/test_torch_qwen3_next_ep_spec.py``).  The tree is compared with the port's plain engine and JAX's ops,
not with JAX's tree engine (slow to trace on the CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_config
from sgl_kernel_npu_tpu.models import deepseek_v3 as jdm
from sgl_kernel_npu_tpu.models import llama as jlm
from sgl_kernel_npu_tpu.ops import speculative as js
from sgl_kernel_npu_tpu.runtime.engine import Engine as JEngine
from sgl_kernel_npu_tpu.runtime.engine import deepseek_adapter as jdeepseek
from sgl_kernel_npu_tpu.runtime.engine import llama_adapter as jllama
from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tdm
from sgl_kernel_npu_tpu_torch.models import llama as tlm
from sgl_kernel_npu_tpu_torch.ops import speculative as ts
from sgl_kernel_npu_tpu_torch.runtime.engine import (
    Engine,
    SamplingParams,
    deepseek_adapter,
    llama_adapter,
)


def _random_tree(rng, bs, topk, d, p):
    """EAGLE-style inputs: ``selected_index`` into a ``p x topk`` grid and a
    parent list whose tokens are mostly selected ones (some not: invalid
    parents)."""
    sel = rng.integers(0, p * topk, (bs, d - 1)).astype(np.int32)
    pick = sel[np.arange(bs)[:, None], rng.integers(0, d - 1, (bs, p))]
    parents = np.where(rng.random((bs, p)) < 0.7, pick, 999).astype(np.int32)
    return parents, sel, rng.integers(0, 50, bs).astype(np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_build_tree_matches_jax(seed):
    """Positions, retrieve indices, child / sibling links and each mask mode
    (QLEN_ONLY, the bit-packed one, FULL_MASK) equal JAX's, dtypes too."""
    rng = np.random.default_rng(seed)
    bs, topk, d, p = 3, int(rng.integers(1, 5)), int(rng.integers(2, 13)), int(rng.integers(1, 9))
    parents, sel, seq = _random_tree(rng, bs, topk, d, p)
    for mode in ts.TreeMaskMode:
        kw = dict(topk=topk, draft_token_num=d, tree_mask_mode=int(mode),
                  prefix_len=40 if mode == ts.TreeMaskMode.FULL_MASK else None)
        want = js.build_tree_efficient(jnp.asarray(parents), jnp.asarray(sel), jnp.asarray(seq),
                                       **kw)
        got = ts.build_tree_efficient(torch.from_numpy(parents), torch.from_numpy(sel),
                                      torch.from_numpy(seq), **kw)
        for w, g in zip(want, got):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w), mode


def test_build_tree_known_tree():
    """tests/test_speculative.py's tree: root → {1, 2}; 2 → {3}; 3 → {4}."""
    parents = torch.tensor([[999, 1, 999, 2, 999, 999, 999, 999]], dtype=torch.int32)
    sel = torch.tensor([[0, 1, 2, 6]], dtype=torch.int32)
    pos, _, nt, ns, mask = ts.build_tree_efficient(parents, sel, torch.tensor([10]), topk=2,
                                                   draft_token_num=5)
    assert nt[0].tolist() == [1, -1, 3, 4, -1] and ns[0].tolist() == [-1, 2, -1, -1, -1]
    assert pos.tolist() == [10, 11, 11, 12, 13]
    assert torch.nonzero(mask[0, 4])[:, 0].tolist() == [0, 2, 3, 4]
    with pytest.raises(ValueError):
        ts.build_tree_efficient(parents, sel, torch.tensor([10]), topk=2, draft_token_num=5,
                                tree_mask_mode=int(ts.TreeMaskMode.FULL_MASK))


@pytest.mark.parametrize("seed", range(4))
def test_verify_tree_greedy_matches_jax(seed):
    """Random trees (from ``build_tree_efficient``) with tokens from a small
    alphabet, so that walks accept through siblings and stop anywhere; a
    chain; the branching tree of tests/test_speculative.py."""
    rng = np.random.default_rng(seed)
    bs, topk, d, p = 4, int(rng.integers(1, 4)), int(rng.integers(2, 13)), int(rng.integers(1, 9))
    parents, sel, seq = _random_tree(rng, bs, topk, d, p)
    _, ridx, nt, ns, _ = js.build_tree_efficient(jnp.asarray(parents), jnp.asarray(sel),
                                                 jnp.asarray(seq), topk=topk, draft_token_num=d)
    chain_nt = np.tile(np.asarray([*range(1, d), -1], np.int32), (bs, 1))
    branch_nt = np.tile(np.asarray([1, 3, 4, -1, -1, -1], np.int32), (bs, 1))
    branch_ns = np.tile(np.asarray([-1, 2, -1, -1, 5, -1], np.int32), (bs, 1))
    trees = [(np.array(ridx), np.array(nt), np.array(ns), d),
             (np.array(ridx), chain_nt, np.full((bs, d), -1, np.int32), d),
             (np.arange(bs * 6, dtype=np.int32).reshape(bs, 6), branch_nt, branch_ns, 6)]
    for r, n_t, n_s, dd in trees:
        cand = rng.integers(0, 3, (bs, dd)).astype(np.int32)
        tgt = rng.integers(0, 3, (bs, dd)).astype(np.int32)
        want = js.verify_tree_greedy(*(jnp.asarray(a) for a in (cand, r, n_t, n_s, tgt)))
        got = ts.verify_tree_greedy(*(torch.from_numpy(a) for a in (cand, r, n_t, n_s, tgt)))
        for w, g in zip(want, got):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)


# --- the engine ------------------------------------------------------------

@pytest.fixture(scope="module")
def llama():
    """JAX's tiny Llama (tests/test_spec_e2e.py's config) with an untied head,
    and a draft of the same weights each times (1 + N(0, 0.5²))."""
    jcfg = jlm.LlamaConfig(vocab_size=61, num_layers=2, page_size=4)
    pn = jax.tree.map(np.asarray, jlm.init_weights(jax.random.key(11), jcfg))
    pn["w_lm"] = (np.random.default_rng(11).standard_normal((jcfg.hidden, 61)) * 0.05
                  ).astype(np.float32)
    rng = np.random.default_rng(5)
    dn = jax.tree.map(lambda a: (a * (1 + 0.5 * rng.standard_normal(a.shape))).astype(np.float32),
                      pn)
    tcfg = port_config(jcfg, tlm.LlamaConfig)
    return (jcfg, jax.tree.map(jnp.asarray, pn), jax.tree.map(jnp.asarray, dn), tcfg,
            tlm.from_jax_params(pn, device="cpu"), tlm.from_jax_params(dn, device="cpu"))


PROMPTS = [[5, 9, 2, 33, 17, 4], [40, 41, 42], [7, 3, 60, 21], [11, 12]]
KW = dict(num_pages=96, max_batch=8, max_pages_per_req=16, prefill_chunk=8)


def _port(llama, draft=None, **kw):
    _, _, _, tcfg, tp, _ = llama
    d = None if draft is None else llama_adapter(tcfg, draft, device="cpu")
    return Engine(llama_adapter(tcfg, tp, device="cpu"), draft_adapter=d, device="cpu",
                  **{**KW, **kw})


@pytest.fixture(scope="module")
def llama_plain(llama):
    return _port(llama).run(PROMPTS, 12)


SPEC_STATS = ("spec_rounds", "spec_accepted", "decode_steps", "prefill_tokens")


@pytest.fixture(scope="module")
def jax_chain(llama):
    """The JAX engine's chain speculation (k = 2) on the noisy draft: its
    tokens and its counts."""
    jcfg, pj, dj = llama[:3]
    je = JEngine(jllama(jcfg, pj), spec_k=2, draft_adapter=jllama(jcfg, dj), **KW)
    return je.run(PROMPTS, 12), dict(je.stats)


def test_chain_matches_plain_and_jax_engines(llama, llama_plain, jax_chain):
    """Chain speculation (k = 2): the port's plain greedy tokens and the
    JAX speculative engine's (JAX's own tests hold those to its plain
    engine's), with its acceptance counts (the same rounds and accepted
    drafts)."""
    tokens, stats = jax_chain
    assert tokens == llama_plain
    eng = _port(llama, llama[5], spec_k=2)
    assert eng.run(PROMPTS, 12) == llama_plain
    assert 0 < eng.stats["spec_accepted"] < 2 * eng.stats["spec_rounds"] * len(PROMPTS)
    for key in SPEC_STATS:
        assert eng.stats[key] == stats[key], key
    assert eng.cm.free_pages + eng.cm.cached_pages == KW["num_pages"]


@pytest.mark.parametrize("width", [1, 2, 3])
def test_tree_matches_plain(llama, llama_plain, jax_chain, width):
    """Tree speculation (k = 2, root branching top-``width``, copy-on-write
    suffix pages): the plain greedy tokens, no page leak; width 1 is the JAX
    engine's chain round for round (its counts), wider trees accept more
    drafts."""
    stats = jax_chain[1]
    eng = _port(llama, llama[5], spec_k=2, spec_tree_width=width)
    assert eng.run(PROMPTS, 12) == llama_plain
    assert eng.cm.free_pages + eng.cm.cached_pages == KW["num_pages"]
    if width == 1:
        for key in SPEC_STATS:
            assert eng.stats[key] == stats[key], key
    else:
        assert eng.stats["spec_accepted"] > stats["spec_accepted"]


@pytest.mark.parametrize("width", [1, 2])
def test_oracle_draft_accepts_every_token(llama, llama_plain, width):
    """Draft = target: every round accepts all k drafts (k = 3), so each
    request's 11 decoded tokens take 3 rounds of 4 (the last cut to 3) and
    9 accepted drafts; the plain tokens; a shared prompt's cached pages
    reused."""
    tp = llama[4]
    eng = _port(llama, tp, spec_k=3, spec_tree_width=width)
    assert eng.run(PROMPTS, 12) == llama_plain
    assert eng.stats["spec_accepted"] == 9 * len(PROMPTS)
    assert eng.run([PROMPTS[0] + [1, 2, 3]], 5)[0] == _port(llama).run(
        [PROMPTS[0] + [1, 2, 3]], 5)[0]
    assert eng.stats["cached_tokens"] >= 4
    assert eng.cm.free_pages + eng.cm.cached_pages == KW["num_pages"]


def test_stop_token_and_unmixed_under_speculation(llama, llama_plain):
    """A stop token ends its request at its first occurrence even inside an
    accepted chain; ``mixed=False`` gives the same tokens."""
    dp = llama[5]
    stop = llama_plain[0][5]
    eng = _port(llama, dp, spec_k=2, spec_tree_width=2, mixed=False)
    rids = [eng.add_request(p, 12, stop_tokens=[stop] if i == 0 else ()) for i, p in
            enumerate(PROMPTS)]
    while eng.waiting or eng.running:
        eng.step()
    got = [eng.finished[r] for r in rids]
    assert got[0] == llama_plain[0][: llama_plain[0].index(stop) + 1]
    assert got[1:] == llama_plain[1:]


@pytest.fixture(scope="module")
def deepseek():
    """JAX's tiny DeepSeek-V3 of tests/test_spec_e2e.py (2 layers, page 4)
    and the port's copy, its float experts and their W8A8 quantization."""
    jcfg = jdm.DeepSeekV3Config(num_layers=2, page_size=4, vocab_size=61)
    params = jdm.init_weights(jax.random.key(41), jcfg, jnp.float32)
    tp, _, _, _ = tdm.from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    tcfg = port_config(jcfg, tdm.DeepSeekV3Config)
    return jcfg, params, tcfg, tp, tdm.quantize_moe_weights(tcfg, tp)


def _deepseek_draft(tcfg, tp, moe=None):
    """The 1-layer self-draft: the target's config at one layer, its embed,
    final norm, head and first layer's tensors (shared, not copied)."""
    return deepseek_adapter(dataclasses.replace(tcfg, num_layers=1),
                            dict(tp, layers=tp["layers"][:1]),
                            moe_weights_q=None if moe is None else moe[:1], device="cpu")


@pytest.mark.parametrize("width", [1, 2])
def test_deepseek_self_draft_matches(deepseek, width):
    """tests/test_spec_e2e.py's self-draft recipe (float experts): the JAX
    engine's greedy tokens, chain and tree; with the W8A8 experts (the
    card's main path) and a 1-layer W8A8 draft, and with the oracle draft,
    the port's plain engine's."""
    jcfg, params, tcfg, tp, moe = deepseek
    prompt = [5, 9, 2, 33, 17, 4]
    kw = dict(num_pages=64, max_batch=2, max_pages_per_req=16, prefill_chunk=8, device="cpu")
    if width == 1:
        want = JEngine(jdeepseek(jcfg, params), num_pages=64, max_batch=2, max_pages_per_req=16,
                       prefill_chunk=8).run([prompt], 6)[0]
        assert Engine(deepseek_adapter(tcfg, tp, device="cpu"), **kw).run([prompt], 6)[0] == want
    else:
        want = Engine(deepseek_adapter(tcfg, tp, device="cpu"), **kw).run([prompt], 6)[0]
    eng = Engine(deepseek_adapter(tcfg, tp, device="cpu"), spec_k=2, spec_tree_width=width,
                 draft_adapter=_deepseek_draft(tcfg, tp), **kw)
    assert eng.run([prompt], 6)[0] == want and eng.stats["spec_rounds"] > 0
    plain = Engine(deepseek_adapter(tcfg, tp, moe_weights_q=moe, device="cpu"), **kw).run(
        [prompt, [40, 41, 42]], 7)
    for draft in (_deepseek_draft(tcfg, tp, moe),
                  deepseek_adapter(tcfg, tp, moe_weights_q=moe, device="cpu")):
        eng = Engine(deepseek_adapter(tcfg, tp, moe_weights_q=moe, device="cpu"), spec_k=2,
                     spec_tree_width=width, draft_adapter=draft, **kw)
        assert eng.run([prompt, [40, 41, 42]], 7) == plain
        assert eng.cm.free_pages + eng.cm.cached_pages == 64
    assert eng.stats["spec_accepted"] >= 2 * 2 * (eng.stats["spec_rounds"] - 1)


def test_refusals(llama):
    """The JAX engine's ``ValueError``s; a target with recurrent state or
    one-request prefill is refused tree speculation (``ValueError``, as
    JAX) and builds for the chain (a verify a request, as JAX's)."""
    _, _, _, tcfg, tp, dp = llama
    target, draft = llama_adapter(tcfg, tp, device="cpu"), llama_adapter(tcfg, dp, device="cpu")
    kw = dict(num_pages=32, device="cpu")
    bad = [dict(spec_k=2), dict(spec_k=0, draft_adapter=draft),
           dict(spec_k=2, draft_adapter=dataclasses.replace(draft, page_size=8)),
           dict(spec_k=2, draft_adapter=dataclasses.replace(draft, snapshot_state=lambda c, s: c)),
           dict(spec_tree_width=2),
           dict(spec_k=2, draft_adapter=draft, spec_tree_width=9, max_batch=8)]
    for extra in bad:
        with pytest.raises(ValueError):
            Engine(target, **kw, **extra)
    for t in (dataclasses.replace(target, prefill_single=True),
              dataclasses.replace(target, snapshot_state=lambda c, s: c)):
        with pytest.raises(ValueError):
            Engine(t, spec_k=2, draft_adapter=draft, spec_tree_width=2, **kw)
        assert Engine(t, spec_k=2, draft_adapter=draft, **kw).spec_k == 2   # chain: builds
    eng = Engine(target, spec_k=2, draft_adapter=draft, **kw)
    with pytest.raises(ValueError):
        eng.add_request([1, 2, 3], 4, sampling=SamplingParams(temperature=1.0))
    with pytest.raises(ValueError):
        eng.add_request([1, 2, 3], 4, logprobs=True)
    eng.add_request([1, 2, 3], 4, sampling=SamplingParams(temperature=0.0))
