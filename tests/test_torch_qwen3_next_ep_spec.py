"""Port parity: Qwen3-Next's hybrid with the expert-parallel W8A8 MoE
(``moe_weights_q`` + ``ep_buffer``) and under speculative decoding.

The widths of ``tests/_torch_qwen3.py`` at hidden 128 with 8 experts top-2
of intermediate 64.  The port's ``Buffer`` runs on a one-rank gloo group of
the test process (``_torch_parity.one_rank_group``), JAX's on a one-device
mesh.  Tolerances: ``quantize_hybrid_moe_weights`` bit-equal to JAX's; the
EP steps (hidden states and every cache) within 1 % of the largest |value|
(both sides requantize the expert activations to int8: a boundary value can
move a level, as ``test_torch_deepseek_v3.py``'s EP cases); the engines'
greedy tokens equal.  Speculation: a hybrid target's tokens under
``spec_k=2`` (the float target, and the W8A8 target with the EP MoE) equal
the port's plain engine's and JAX's speculative engine's, with JAX's
acceptance counts; the replay draft makes both the rolled-back and the
fully accepted rounds happen."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_rank_group
from _torch_qwen3 import _cfgs, jax_steps, port_steps, step_inputs
from sgl_kernel_npu_tpu.config import EPConfig as JEPConfig
from sgl_kernel_npu_tpu.models import qwen3_next as jm
from sgl_kernel_npu_tpu.parallel.buffer import Buffer as JBuffer
from sgl_kernel_npu_tpu.runtime import engine as je
from sgl_kernel_npu_tpu_torch.config import EPConfig
from sgl_kernel_npu_tpu_torch.models import llama as tl
from sgl_kernel_npu_tpu_torch.models import qwen3_next as tm
from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer
from sgl_kernel_npu_tpu_torch.runtime.engine import (
    Engine,
    ModelAdapter,
    llama_adapter,
    qwen3_hybrid_adapter,
)

EP = dict(hidden=128, moe_experts=8, moe_topk=2, moe_intermediate=64,
          shared_expert_intermediate=64)
KW = dict(num_pages=64, max_pages_per_req=16, prefill_chunk=8)
N_NEW = 6


def _jbuffer(jcfg):
    mesh1 = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("ep",))
    return JBuffer(mesh1, "ep", jcfg.moe_experts, JEPConfig())


@pytest.fixture(scope="module")
def ep_model():
    """The hybrid with the MoE on every layer (gated attention, q / k norms,
    partial rotary): the port's random weights (JAX's shapes and scales,
    drawn by torch: quicker than JAX's op-by-op draw) and JAX's copies, and
    both sides' W8A8 experts (the port's converted from JAX's)."""
    jcfg, tcfg = _cfgs(num_layers=2, attn_gate=True, qk_norm=True, rotary_dim=16, **EP)
    tp = tm.init_hybrid_weights(tcfg, 6, device="cpu")
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items() if k != "layers"}
    jp["layers"] = [{k: v if k == "kind" else jnp.asarray(v.numpy()) for k, v in lw.items()}
                    for lw in tp["layers"]]
    wq_j = jm.quantize_hybrid_moe_weights(jcfg, jp)
    wq_t = tm.from_jax_moe_weights_q(jax.tree.map(np.asarray, wq_j), device="cpu")
    return jcfg, tcfg, jp, tp, wq_j, wq_t


def test_quantize_hybrid_moe_weights_bit_equal(ep_model):
    """The port's ``quantize_hybrid_moe_weights`` on the converted weights
    equals JAX's per layer, bit for bit, at the default and a narrow
    packing."""
    jcfg, tcfg, jp, tp, wq_j, wq_t = ep_model
    for tn, want in ((None, wq_t), (64, tm.from_jax_moe_weights_q(
            jax.tree.map(np.asarray, jm.quantize_hybrid_moe_weights(jcfg, jp, tn=64)),
            device="cpu"))):
        got = tm.quantize_hybrid_moe_weights(tcfg, tp, tn=tn)
        assert len(got) == len(want) == jcfg.num_layers
        for lg, lw in zip(got, want):
            assert len(lg) == 4
            for a, b in zip(lg, lw):
                assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture(scope="module")
def ep_steps_golden(ep_model):
    """``run_steps``' inputs and JAX's EP decode step and prefill chunk on
    them (its ``Buffer`` on a one-device mesh)."""
    jcfg, _, jp, _, wq_j, _ = ep_model
    inp = step_inputs(jcfg, 8, None, torch.float32)
    return inp, jax_steps(jcfg, jp, inp, None, {"moe_weights_q": wq_j,
                                                 "ep_buffer": _jbuffer(jcfg)})


@pytest.mark.parametrize("backend", ["xla", "pallas_ragged"])
def test_ep_steps_match_jax(ep_model, ep_steps_golden, backend):
    """A decode step and a prefill chunk with the routed experts on
    ``Buffer.fused_deep_moe`` (the port on the collective or the window
    transport) against JAX's hybrid steps with its ``Buffer``: hidden
    states and every cache within 1 % of the largest |value|."""
    _, tcfg, _, tp, _, wq_t = ep_model
    inp, want = ep_steps_golden
    buf = Buffer(one_rank_group(), tcfg.moe_experts, EPConfig(comm_backend=backend))
    port_steps(tcfg, tp, inp, want, torch.float32, 1e-2,
               {"moe_weights_q": wq_t, "ep_buffer": buf})


def _prompts(n, seed=21, vocab=61):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, m)] for m in (7, 11, 5)[:n]]


@pytest.fixture(scope="module")
def jax_ep_engine(ep_model):
    """JAX's engine with the EP MoE on three distinct prompts, a state slot
    each (no slot reused, where JAX's engine is right): the tokens."""
    jcfg, _, jp, _, wq_j, _ = ep_model
    with jax.default_matmul_precision("float32"):
        eng = je.Engine(je.qwen3_hybrid_adapter(jcfg, jp, moe_weights_q=wq_j,
                                                ep_buffer=_jbuffer(jcfg)), max_batch=3, **KW)
        return eng.run(_prompts(3), 5)


def test_ep_engine_matches_jax_engine(ep_model, jax_ep_engine):
    """``Engine`` + ``qwen3_hybrid_adapter(moe_weights_q=..., ep_buffer=...)``
    gives JAX's EP engine's greedy tokens; every page and slot comes back.
    (With ``weights_q`` as well, the port's plain engine is held to JAX's
    engine by ``test_hybrid_spec_matches_plain_and_jax[w8a8_ep]``.)"""
    _, tcfg, _, tp, _, wq_t = ep_model
    buf = Buffer(one_rank_group(), tcfg.moe_experts, EPConfig(comm_backend="pallas_ragged"))
    eng = Engine(qwen3_hybrid_adapter(tcfg, tp, moe_weights_q=wq_t, ep_buffer=buf,
                                      device="cpu"), device="cpu", max_batch=3, **KW)
    assert eng.run(_prompts(3), 5) == jax_ep_engine
    assert eng.cm.free_pages == KW["num_pages"] and sorted(eng._free_state_slots) == [0, 1, 2]


# ---------------------------------------------------------------------------
# speculative decoding of a hybrid target
# ---------------------------------------------------------------------------

SPEC_PROMPTS = ([5, 9, 2, 33, 17, 4, 8, 21], [40, 3, 3, 11, 52])
WRONG_EVERY = 4        # the replay draft's wrong guesses: positions p % 4 == 0


def _replay_table(prompts, outs, vocab):
    """``table[p, tok]``: the token the plain run gives after ``tok`` at
    position p (every ``WRONG_EVERY``-th position another token), so that
    rounds both accept every draft and reject some; a (position, token) no
    plain sequence holds gives token 0.  The draft is keyed on what a row
    feeds, so it serves every request of a batch."""
    table = np.zeros((64, vocab), np.int32)
    seen = {}
    for p, o in zip(prompts, outs):
        seq = list(p) + list(o)
        for i in range(len(seq) - 1):
            nxt = seq[i + 1] if i % WRONG_EVERY else (seq[i + 1] + 1) % vocab
            assert seen.setdefault((i, seq[i]), nxt) == nxt, "two sequences disagree"
            table[i, seq[i]] = nxt
    return table


def _port_replay_draft(table, vocab, page):
    tab = torch.from_numpy(table).long()

    def decode(x, pos, c, bt, ctx, slots, si, li):
        return tab[pos.long(), x.long()], c

    return ModelAdapter(
        page_size=page, device=torch.device("cpu"), embed=lambda ids: ids,
        lm_head=lambda h: torch.nn.functional.one_hot(h, vocab).float(),
        prefill_step=lambda x, sl, c, bt, ctx, slots, si, li: (x, c),
        decode_step=decode, init_cache=lambda n, s=0: [])


def _jax_replay_draft(table, vocab, page):
    tab = jnp.asarray(table)

    def decode(x, pos, c, bt, ctx, slots, si, li):
        return tab[pos, x], c

    return je.ModelAdapter(
        page_size=page, embed=lambda ids: ids,
        lm_head=lambda h: jax.nn.one_hot(h, vocab, dtype=jnp.float32),
        prefill_step=lambda x, sl, c, bt, ctx, slots, si, li: (x, c),
        decode_step=decode, init_cache=lambda n, s_: [])


def _target_kw(ep_model, target):
    """The hybrid adapter's keywords, the port's and JAX's: ``"float"`` (the
    MoE in float on every expert) or ``"w8a8_ep"`` (the projections W8A8,
    the routed experts on each side's ``Buffer``)."""
    jcfg, tcfg, jp, tp, wq_j, wq_t = ep_model
    if target == "float":
        return {}, {}
    return (dict(weights_q=tm.quantize_hybrid_weights(tcfg, tp), moe_weights_q=wq_t,
                 ep_buffer=Buffer(one_rank_group(), tcfg.moe_experts,
                                  EPConfig(comm_backend="pallas_ragged"))),
            dict(weights_q=jm.quantize_hybrid_weights(jcfg, jp), moe_weights_q=wq_j,
                 ep_buffer=_jbuffer(jcfg)))


@pytest.fixture(scope="module", params=["float", "w8a8_ep"])
def spec_runs(request, ep_model):
    """The hybrid target served plain by the port, then under ``spec_k=2``
    with the replay draft by the port and by JAX's speculative engine (its
    ``test_hybrid_engine_spec_decode`` setup with this draft): tokens,
    stats and the port's adapter keywords."""
    jcfg, tcfg, jp, tp, _, _ = ep_model
    tkw, jkw = _target_kw(ep_model, request.param)
    kw = dict(max_batch=2, **KW)
    prompts = [list(p) for p in SPEC_PROMPTS]
    plain = Engine(qwen3_hybrid_adapter(tcfg, tp, device="cpu", **tkw), device="cpu", **kw)
    want = plain.run(prompts, N_NEW)
    tables = _replay_table(prompts, want, tcfg.vocab_size)
    eng = Engine(qwen3_hybrid_adapter(tcfg, tp, device="cpu", **tkw), device="cpu", spec_k=2,
                 draft_adapter=_port_replay_draft(tables, tcfg.vocab_size, tcfg.page_size), **kw)
    got = eng.run(prompts, N_NEW)
    with jax.default_matmul_precision("float32"):
        jeng = je.Engine(je.qwen3_hybrid_adapter(jcfg, jp, **jkw), spec_k=2,
                         draft_adapter=_jax_replay_draft(tables, jcfg.vocab_size,
                                                         jcfg.page_size), **kw)
        jgot = jeng.run(prompts, N_NEW)
    return want, got, eng, jgot, jeng, tkw


def test_hybrid_spec_matches_plain_and_jax(spec_runs):
    """Chain speculation of the hybrid (a verify a request, the GDN pools
    snapshotted first, restored and caught up on the accepted rows when a
    draft is rejected) gives exactly the plain engine's tokens and JAX's
    speculative engine's, with JAX's rounds and accepted drafts; rounds that
    accepted every draft (no rollback) and rounds that rejected one
    (rollback) both happened; no page or state slot leaks.  On the W8A8 +
    EP target this also holds the port's plain engine to JAX's engine."""
    want, got, eng, jgot, jeng, _ = spec_runs
    assert got == want == jgot
    st = eng.stats
    assert st["spec_rounds"] == jeng.stats["spec_rounds"] > 0
    assert st["spec_accepted"] == jeng.stats["spec_accepted"]
    # each round serves both requests while both run: a round accepting every
    # draft of both adds 2 k, one with a rejection less; both kinds occurred
    assert 0 < st["spec_accepted"] < 2 * eng.spec_k * st["spec_rounds"]
    assert eng.cm.free_pages == KW["num_pages"] and sorted(eng._free_state_slots) == [0, 1]


def test_hybrid_spec_rolls_back_and_keeps(ep_model, spec_runs, monkeypatch):
    """Both branches of the round, counted: with the same draft a restore
    follows exactly the request-rounds that accepted fewer than k drafts,
    and none follows those that accepted all k (besides the one a request's
    admission makes, zeroing its slot)."""
    want, _, eng0, _, _, tkw = spec_runs
    _, tcfg, _, tp, _, _ = ep_model
    prompts = [list(p) for p in SPEC_PROMPTS]
    tables = _replay_table(prompts, want, tcfg.vocab_size)
    adapter = qwen3_hybrid_adapter(tcfg, tp, device="cpu", **tkw)
    restores = []
    adapter = dataclasses.replace(
        adapter, restore_state=lambda c, s, si: restores.append(int(si[0])) or
        tm.hybrid_state_restore(tcfg, c, s, si))
    eng = Engine(adapter, device="cpu", spec_k=2, max_batch=2,
                 draft_adapter=_port_replay_draft(tables, tcfg.vocab_size, tcfg.page_size),
                 **KW)
    accepted = []
    commit = eng._commit

    def counting(r, new):
        accepted.append(len(new) - 1)
        commit(r, new)

    monkeypatch.setattr(eng, "_commit", counting)
    assert eng.run(prompts, N_NEW) == want
    assert sum(accepted) == eng0.stats["spec_accepted"]
    partial = sum(n < eng.spec_k for n in accepted)
    assert len(restores) == len(prompts) + partial and 0 < partial < len(accepted)


def test_prefill_single_target_matches_plain():
    """A paged-KV target marked ``prefill_single`` without the snapshot
    hooks (JAX's one-request verify, nothing to roll back) under
    ``spec_k=2`` with a 1-layer draft gives its plain engine's tokens."""
    cfg = tl.LlamaConfig(vocab_size=61, num_layers=2, page_size=4)
    dcfg = dataclasses.replace(cfg, num_layers=1)
    target = dataclasses.replace(llama_adapter(cfg, tl.init_weights(cfg, 2, device="cpu"),
                                               device="cpu"), prefill_single=True)
    draft = llama_adapter(dcfg, tl.init_weights(dcfg, 3, device="cpu"), device="cpu")
    prompts = [list(p) for p in SPEC_PROMPTS]
    want = Engine(target, device="cpu", max_batch=2, **KW).run(prompts, N_NEW)
    eng = Engine(target, device="cpu", spec_k=2, draft_adapter=draft, max_batch=2, **KW)
    assert eng.run(prompts, N_NEW) == want
    assert eng.stats["spec_rounds"] > 0
    assert eng.cm.free_pages + eng.cm.cached_pages == KW["num_pages"]
