"""Port parity: Llama's context- and pipeline-parallel serving
(``models.llama.prefill_step_cp``, ``models/llama_pp.py``,
``llama_cp_adapter`` / ``llama_pp_adapter``) on gloo ranks against the JAX
package on the virtual CPU mesh, in JAX's engine setup (``tests/
test_engine.py``: 2 layers at hidden 256, vocabulary 61, page 4, weights
from ``jax.random.key(7)``).

One spawn of four rank processes (``tests/_torch_mr_ranks.py``, task
``"llama"``); JAX's goldens are made once a module while the ranks run.
CP: one 13-token prompt in 16 rows (3 pad rows at slot -1) through
``prefill_step_cp`` on rings of 4, 2 and 1 ranks against JAX's on a
4-device ``cp`` mesh, on the float and the int8 cache: the rows and every
rank's cache (JAX's cache is replicated: all 13 rows on every device; the
port's ranks all-gather K / V before the write).  PP: a packed prefill of
two requests (5 and 3 tokens, 2 pad rows), then a decode step, through 2
stages against JAX's on a 2-device ``pp`` mesh: the live rows and each
stage's cache (JAX's stage-major pool at that stage).  Engines: the CP
engine on 4 ranks and the PP engine on 2 serve JAX's two prompts, the
tokens equal to the JAX engines'.  Every rank's rows and caches have the
same bits.  A CP engine serves a prompt that shares two pages with a
finished one without a prefix match, its tokens equal to JAX's one-device
engine's.  Tolerances: f32 within 1e-5 of the largest value (sums in
another order); int8 cache levels equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_mr_ranks import start_ranks
from _torch_parity import np32, port_config
from sgl_kernel_npu_tpu.models import llama as jm
from sgl_kernel_npu_tpu.models import llama_pp as jpp
from sgl_kernel_npu_tpu.runtime.engine import Engine as JEngine
from sgl_kernel_npu_tpu.runtime.engine import llama_adapter as j_one
from sgl_kernel_npu_tpu.runtime.engine import llama_cp_adapter as j_cp
from sgl_kernel_npu_tpu.runtime.engine import llama_pp_adapter as j_pp
from sgl_kernel_npu_tpu_torch.models import llama as tm
from sgl_kernel_npu_tpu_torch.models import llama_pp as tpp
from sgl_kernel_npu_tpu_torch.runtime.engine import llama_cp_adapter

WORLD = 4
CP_SIZES = (4, 2, 1)
S, LIVE, PAGES = 16, 13, 9
PROMPTS = [[5, 9, 2, 33, 17, 4, 8, 21, 60, 3], [40, 41, 42, 43, 44]]
ENGINE = dict(prompts=PROMPTS, new_tokens=3, cp_ranks=4, pp_ranks=2,
              reuse_prompts=[PROMPTS[0], PROMPTS[0][:8] + [7, 11, 13, 19]],   # 2 pages shared
              cp_kw=dict(num_pages=64, max_batch=2, max_pages_per_req=16, prefill_chunk=16),
              pp_kw=dict(num_pages=64, max_batch=2, max_pages_per_req=16, prefill_chunk=8))


def _cfg():
    return jm.LlamaConfig(vocab_size=61, num_layers=2, page_size=4)


def _mesh(n, axis):
    return Mesh(np.array(jax.devices()[:n]), (axis,))


def _cp_inputs(cfg, rng):
    bt = np.arange(1, PAGES, dtype=np.int32)[None]
    slots = np.full((S,), -1, np.int32)
    slots[:LIVE] = bt[0, np.arange(LIVE) // cfg.page_size] * cfg.page_size + np.arange(LIVE) % 4
    caches = {kind: jax.tree.map(np.asarray, jm.init_kv_cache(
        dataclasses.replace(cfg, kv_cache_dtype=kind), PAGES)) for kind in ("bf16", "int8")}
    return dict(x=rng.standard_normal((S, cfg.hidden)).astype(np.float32) * 0.5,
                seq=np.asarray([LIVE], np.int32), bt=bt, slots=slots, caches=caches)


def _pp_inputs(cfg, rng):
    page = cfg.page_size
    bt = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    seq = np.asarray([5, 3], np.int32)
    slot = lambda b, i: int(bt[b, i // page]) * page + i % page          # noqa: E731
    slots_pre = np.asarray([slot(0, i) for i in range(5)] + [slot(1, i) for i in range(3)]
                           + [-1, -1], np.int32)
    return dict(stages=2, num_pages=8, bt=bt, seq=seq, ctx_pre=seq.copy(), slots_pre=slots_pre,
                x_pre=rng.standard_normal((10, cfg.hidden)).astype(np.float32) * 0.5,
                x_dec=rng.standard_normal((2, cfg.hidden)).astype(np.float32) * 0.5,
                pos=seq.copy(), ctx_dec=seq + 1,
                slots_dec=np.asarray([slot(0, 5), slot(1, 3)], np.int32))


def _jax_cp(cfg, params, cp):
    mesh = _mesh(WORLD, "cp")
    out = {}
    for kind in ("bf16", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kind)
        caches = jax.tree.map(jnp.asarray, cp["caches"][kind])
        seq = jnp.asarray(cp["seq"])
        h, caches = jm.prefill_step_cp(c, params, jnp.asarray(cp["x"]), seq, caches,
                                       jnp.asarray(cp["bt"]), seq, jnp.asarray(cp["slots"]),
                                       mesh=mesh)
        out[kind] = {"h": np32(h), "caches": jax.tree.map(np.asarray, caches)}
    return out


def _jax_pp(cfg, params, pp):
    mesh = _mesh(pp["stages"], "pp")
    stacked = jpp.stack_stage_params(cfg, params, pp["stages"])
    caches = jpp.init_kv_cache_pp(cfg, pp["num_pages"], pp["stages"])
    j = {k: jnp.asarray(v) for k, v in pp.items() if isinstance(v, np.ndarray)}
    h_pre, caches = jpp.prefill_step_pp(cfg, stacked, j["x_pre"], j["seq"], caches, j["bt"],
                                        j["ctx_pre"], j["slots_pre"], mesh=mesh)
    h_dec, caches = jpp.decode_step_pp(cfg, stacked, j["x_dec"], j["pos"], caches, j["bt"],
                                       j["ctx_dec"], j["slots_dec"], mesh=mesh)
    return {"prefill": np32(h_pre), "decode": np32(h_dec),
            "caches": jax.tree.map(np.asarray, caches)}


def _jax_engines(cfg, params):
    kw = ENGINE
    cp = JEngine(j_cp(cfg, params, _mesh(kw["cp_ranks"], "cp")), **kw["cp_kw"])
    pp = JEngine(j_pp(cfg, params, _mesh(kw["pp_ranks"], "pp")), **kw["pp_kw"])
    one = JEngine(j_one(cfg, params), **kw["cp_kw"])
    reuse = [one.run([p], kw["new_tokens"])[0] for p in kw["reuse_prompts"]]
    return {"cp": cp.run(PROMPTS, kw["new_tokens"]), "pp": pp.run(PROMPTS, kw["new_tokens"]),
            "reuse": {"tokens": reuse, "cached": one.stats["cached_tokens"]}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = _cfg()
    params = jm.init_weights(jax.random.key(7), cfg)
    params_np = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(28)
    cp, pp = _cp_inputs(cfg, rng), _pp_inputs(cfg, rng)
    wait = start_ranks(tmp_path_factory.mktemp("llama"), {
        "task": "llama", "world": WORLD,
        "cfg": dataclasses.asdict(port_config(cfg, tm.LlamaConfig)),
        "params": params_np, "cp": cp, "cp_sizes": CP_SIZES, "pp": pp, "engine": ENGINE})
    want = {"cp": _jax_cp(cfg, params, cp), "pp": _jax_pp(cfg, params, pp),
            "engine": _jax_engines(cfg, params)}
    return cp, pp, want, wait()


def _close(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("size", CP_SIZES)
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_prefill_step_cp_rows_and_every_rank_cache_match_jax(runs, kind, size):
    _, _, want, outs = runs
    ranks = [out["cp"][kind, size] for out in outs]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["h"], ranks[0]["h"])
    _close(ranks[0]["h"], want["cp"][kind]["h"])
    for got in ranks:                     # every rank holds every row
        for layer, wlayer in zip(got["caches"], want["cp"][kind]["caches"]):
            for g, w in zip(layer, wlayer):
                if kind == "int8":
                    np.testing.assert_array_equal(g, w)
                else:
                    _close(g, w)


def test_prefill_step_pp_and_decode_step_pp_match_jax(runs):
    _, pp, want, outs = runs
    for r in range(2, WORLD):             # the second half's two stages, the same bits
        for key in ("prefill", "decode"):
            np.testing.assert_array_equal(outs[r]["pp"][key], outs[r - 2]["pp"][key])
    np.testing.assert_array_equal(outs[1]["pp"]["prefill"], outs[0]["pp"]["prefill"])
    live = int(pp["seq"].sum())           # JAX's golden prefill attends the pad rows too
    _close(outs[0]["pp"]["prefill"][:live], want["pp"]["prefill"][:live])
    _close(outs[0]["pp"]["decode"], want["pp"]["decode"])
    for stage in range(2):
        got = outs[stage]["pp"]["caches"]
        assert len(got) == 1
        for i, (k, v) in enumerate(got):
            _close(k, want["pp"]["caches"]["k"][stage, i])
            _close(v, want["pp"]["caches"]["v"][stage, i])


@pytest.mark.parametrize("layout", ["cp", "pp"])
def test_parallel_engines_match_jax_engines(runs, layout):
    _, _, want, outs = runs
    size = ENGINE[layout + "_ranks"]
    for r in range(size):
        assert outs[r]["engine"][layout] == want["engine"][layout]


def test_stack_stage_params_and_pp_cache_match_jax():
    cfg = _cfg()
    params = jax.tree.map(np.asarray, jm.init_weights(jax.random.key(7), cfg))
    want = jax.tree.map(np.asarray, jpp.stack_stage_params(cfg, params, 2))
    tparams = tm.from_jax_params(params, device="cpu")
    got = tpp.stack_stage_params(port_config(cfg, tm.LlamaConfig), tparams, 2)
    np.testing.assert_array_equal(got["ln_f"].numpy(), want["ln_f"])
    for name, w in want["stages"].items():
        np.testing.assert_array_equal(got["stages"][name].numpy(), w)
        one = tpp.stack_stage_params(port_config(cfg, tm.LlamaConfig), tparams, 2, rank=1)
        np.testing.assert_array_equal(one["stages"][name][0].numpy(), w[1])
    jc = jpp.init_kv_cache_pp(cfg, 8, 2)
    tc = tpp.init_kv_cache_pp(port_config(cfg, tm.LlamaConfig), 8, 2, device="cpu")
    assert [tuple(t.shape) for t in tc[0]] == [jc["k"].shape[2:], jc["v"].shape[2:]]
    assert len(tc) == jc["k"].shape[1]
    with pytest.raises(ValueError, match="stages"):
        tpp.stack_stage_params(port_config(cfg, tm.LlamaConfig), tparams, 3)


def test_cp_engine_takes_no_prefix_match(runs):
    """A request that shares two pages with a finished one: the CP engines
    (every rank of the ring of 4) match no prefix, since the CP prefill
    starts every prompt at position 0, and their tokens equal JAX's
    one-device engine's, which reuses the pages."""
    _, _, want, outs = runs
    assert want["engine"]["reuse"]["cached"] >= 8
    for r in range(ENGINE["cp_ranks"]):
        got = outs[r]["engine"]["cp_reuse"]
        assert got["tokens"] == want["engine"]["reuse"]["tokens"]
        assert got["cached"] == 0


def test_cp_refuses_what_it_cannot_prefill(runs):
    """A prompt longer than ``prefill_chunk`` (at ``add_request``), a chunk
    that continues a prompt, rows the ring cannot split (on every rank of
    the ring of 4) and speculative decoding raise ``ValueError`` (JAX's
    only document the restriction)."""
    from sgl_kernel_npu_tpu_torch.runtime.engine import Engine

    cfg = port_config(_cfg(), tm.LlamaConfig)
    params = tm.init_weights(cfg, 0, device="cpu")
    adapter = llama_cp_adapter(cfg, params, None, device="cpu")
    eng = Engine(adapter, device="cpu", **{**ENGINE["cp_kw"], "prefill_chunk": 8})
    with pytest.raises(ValueError, match="exceeds prefill_chunk 8"):
        eng.add_request(PROMPTS[0], 2)     # 10 tokens, chunks of 8
    assert not eng.waiting
    x = torch.zeros((8, cfg.hidden))
    seq = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(ValueError, match="context_lens == seq_lens"):
        tm.prefill_step_cp(cfg, params, x, seq, eng.caches, torch.ones((1, 4), dtype=torch.int32),
                           seq + 4, torch.full((8,), -1, dtype=torch.int32), group=None)
    with pytest.raises(ValueError, match="speculative"):
        Engine(adapter, device="cpu", spec_k=2, draft_adapter=adapter, **ENGINE["cp_kw"])
    for out in runs[3]:
        assert "do not divide by the ring of 4" in out["cp_refusal"]
