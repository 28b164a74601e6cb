"""Port parity: the counter-based PRNG (``utils/prng.py``), the sampler and
penalties (``ops/sampling.py``) and the engine's sampled decoding, stop
tokens and prefill-first scheduling (``runtime/engine.py``).

The same numpy inputs go to the JAX package and to the port on the CPU.
Tolerances: the PRNG's bits, keys and uniforms are equal; its Gumbel values
``-log(-log(u))`` within 2⁻²¹ + 4 ulps (``log`` is each library's own: XLA's
f32 ``log`` is not always correctly rounded, nor is torch's, and the inner
one's ulp becomes an absolute error of the outer); ``apply_penalties`` and
``apply_token_mask`` equal.  ``sample_tokens`` gives JAX's tokens wherever
the row's margins exceed 1e-5: its top-p keeps a token while the mass before
it is ``< top_p`` and torch's f32 cumsum rounds otherwise than XLA's, min-p
compares ``prob < min_p · pmax`` on each library's softmax, and the Gumbel
argmax compares sums that carry the ``log``'s ulp, so a row whose mass, prob
or Gumbel gap lies within 1e-5 of its boundary may differ; at most a tenth
of a test's rows are left out.  The engine on JAX's tiny Llama of
``tests/test_sampling.py`` gives the JAX engine's tokens, step by step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_config
from sgl_kernel_npu_tpu.models import llama as jm
from sgl_kernel_npu_tpu.ops import sampling as js
from sgl_kernel_npu_tpu.runtime.engine import Engine as JEngine
from sgl_kernel_npu_tpu.runtime.engine import SamplingParams as JSamplingParams
from sgl_kernel_npu_tpu.runtime.engine import llama_adapter as jadapter
from sgl_kernel_npu_tpu_torch.models import llama as tm
from sgl_kernel_npu_tpu_torch.ops import sampling as ts
from sgl_kernel_npu_tpu_torch.runtime.engine import Engine, SamplingParams, llama_adapter
from sgl_kernel_npu_tpu_torch.utils import prng

TINY = float(np.finfo(np.float32).tiny)


def _jax_key(seed: int, step: int):
    return jax.random.fold_in(jax.random.key(np.int32(seed)), np.uint32(step))


def _port_key(seed: int, step: int):
    return prng.fold_in(prng.key(torch.tensor([seed], dtype=torch.int32)),
                        torch.tensor([step], dtype=torch.int64))


@pytest.mark.parametrize("seed,step,v", [(0, 0, 7), (11, 3, 61), (-5, 7, 1000),
                                         (2 ** 31 - 1, 2 ** 32 - 1, 33), (123456, 9, 129280)])
def test_prng_matches_jax(seed, step, v):
    """Keys, bits and uniforms bit-equal to ``jax.random``'s, Gumbels within
    2⁻²¹ + 4 ulps, for positive, negative and largest seeds and steps and a
    DeepSeek-sized vocabulary."""
    kj, kt = _jax_key(seed, step), _port_key(seed, step)
    assert np.array_equal(np.asarray(jax.random.key_data(kj)).astype(np.int64),
                          [int(kt[0]), int(kt[1])])
    bits = np.asarray(jax.random.bits(kj, (v,), jnp.uint32)).astype(np.int64)
    assert np.array_equal(prng.random_bits(kt, v)[0].numpy(), bits)
    u = np.asarray(jax.random.uniform(kj, (v,), jnp.float32, minval=TINY, maxval=1.0))
    assert np.array_equal(prng.uniform(kt, v, TINY)[0].numpy(), u)
    u0 = np.asarray(jax.random.uniform(kj, (v,), jnp.float32))
    assert np.array_equal(prng.uniform(kt, v)[0].numpy(), u0)
    g = np.asarray(jax.random.gumbel(kj, (v,), jnp.float32))
    got = prng.gumbel(kt, v)[0].numpy()
    assert np.all(np.abs(got - g) <= 2.0 ** -21 + 4 * np.spacing(np.abs(g)))


def test_prng_rows_are_independent_keys():
    """A batch of keys draws each row's own stream: row b of a batched call
    equals a call on key b alone."""
    seeds = torch.tensor([3, 3, 9, -1], dtype=torch.int32)
    steps = torch.tensor([0, 1, 0, 5])
    k = prng.fold_in(prng.key(seeds), steps)
    batch = prng.random_bits(k, 50)
    for b in range(4):
        one = prng.random_bits(_port_key(int(seeds[b]), int(steps[b])), 50)[0]
        assert torch.equal(batch[b], one)
    assert not torch.equal(batch[0], batch[1])


# (temperature, top_k, top_p, min_p) choices of each case's rows
CASES = {
    "greedy and sampled": ([0.0, 1.0], [0], [1.0], [0.0]),
    "temperature": ([0.3, 0.7, 1.5], [0], [1.0], [0.0]),
    "top_k": ([1.0], [1, 5, 40], [1.0], [0.0]),
    "top_p": ([1.0], [0], [0.3, 0.8, 0.95], [0.0]),
    "min_p": ([1.0], [0], [1.0], [0.02, 0.1, 0.5]),
    "composed": ([0.0, 0.8, 1.2], [0, 20, 50], [0.9, 1.0], [0.0, 0.05]),
}


def _margins(logits, temp, tk, tp, mp, seeds, steps):
    """Each row's smallest distance (f64) of a top-p mass, a min-p
    probability and the Gumbel argmax from its boundary, on JAX's values."""
    scaled = logits / np.maximum(temp, np.float32(1e-6))[:, None]
    out = np.full(len(logits), np.inf)
    pre = np.asarray(js._filter_logits(jnp.asarray(scaled), jnp.asarray(tk), jnp.asarray(tp),
                                       jnp.zeros_like(jnp.asarray(mp))))
    filt = np.asarray(js._filter_logits(*(jnp.asarray(a) for a in (scaled, tk, tp, mp))))
    gumbels = np.asarray(jax.vmap(lambda s, t: jax.random.gumbel(
        jax.random.fold_in(jax.random.key(s), t), (logits.shape[1],), jnp.float32))(
            jnp.asarray(seeds), jnp.asarray(steps)))
    for b in range(len(logits)):
        row = scaled[b].astype(np.float64)
        if tp[b] < 1:
            srt = np.sort(row)[::-1]
            p = np.exp(srt - srt[0])
            p /= p.sum()
            out[b] = min(out[b], np.abs(np.cumsum(p) - p - tp[b]).min())
        if mp[b] > 0:
            keep = np.isfinite(pre[b])
            pr = np.where(keep, np.exp(row - row[keep].max()), 0.0)
            pr /= pr.sum()
            out[b] = min(out[b], np.abs(pr[keep] - mp[b] * pr.max()).min())
        if temp[b] > 0:
            s = np.sort((filt[b] + gumbels[b])[np.isfinite(filt[b])])[::-1]
            if len(s) > 1:
                out[b] = min(out[b], s[0] - s[1])
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_tokens_matches_jax(case):
    """JAX's tokens for the same f32 logits, seeds and steps over a mixed
    batch of 48 rows, each filter alone and composed, greedy rows the
    argmax; rows within 1e-5 of a boundary are left out (module
    docstring), at most a tenth of them."""
    temps, tks, tps, mps = CASES[case]
    rng = np.random.default_rng(len(case))
    b, v = 48, 257
    logits = (rng.standard_normal((b, v)) * 2).astype(np.float32)
    seeds = rng.integers(-1000, 1000, b).astype(np.int32)
    steps = rng.integers(0, 100, b).astype(np.int32)
    temp = rng.choice(temps, b).astype(np.float32)
    tk = rng.choice(tks, b).astype(np.int32)
    tp = rng.choice(tps, b).astype(np.float32)
    mp = rng.choice(mps, b).astype(np.float32)
    args = (logits, seeds, steps, temp, tk, tp, mp)
    want = np.asarray(js.sample_tokens(*(jnp.asarray(a) for a in args)))
    got = ts.sample_tokens(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.int32
    clear = _margins(logits, temp, tk, tp, mp, seeds, steps) > 1e-5
    assert clear.mean() >= 0.9
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    greedy = temp <= 0
    np.testing.assert_array_equal(got.numpy()[greedy], logits.argmax(-1)[greedy])


def test_filter_logits_matches_jax():
    """The filtered logits themselves on rows far from every boundary:
    equal to JAX's, -inf where it masks."""
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((16, 64)) * 3).astype(np.float32)
    tk = rng.choice([0, 3, 30], 16).astype(np.int32)
    tp = rng.choice([1.0, 0.6], 16).astype(np.float32)
    mp = rng.choice([0.0, 0.1], 16).astype(np.float32)
    want = np.asarray(js._filter_logits(*(jnp.asarray(a) for a in (logits, tk, tp, mp))))
    got = ts._filter_logits(*(torch.from_numpy(a) for a in (logits, tk, tp, mp))).numpy()
    np.testing.assert_array_equal(got, want)


def test_apply_penalties_exact():
    """Repetition (divided when positive, else multiplied), presence and
    frequency on a seen token, bit-equal to JAX's; ``[B, 1]`` zero counts
    leave the logits as they are; bf16 logits come back bf16."""
    rng = np.random.default_rng(2)
    b, v = 6, 97
    logits = (rng.standard_normal((b, v)) * 2).astype(np.float32)
    counts = rng.integers(0, 3, (b, v)).astype(np.int32)
    rep = rng.uniform(0.5, 2.0, b).astype(np.float32)
    pres = rng.uniform(0, 1, b).astype(np.float32)
    freq = rng.uniform(0, 1, b).astype(np.float32)
    args = (logits, counts, rep, pres, freq)
    want = np.asarray(js.apply_penalties(*(jnp.asarray(a) for a in args)))
    got = ts.apply_penalties(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got.numpy(), want)
    zero = ts.apply_penalties(torch.from_numpy(logits), torch.zeros((b, 1), dtype=torch.int32),
                              *(torch.from_numpy(a) for a in (rep, pres, freq)))
    assert torch.equal(zero, torch.from_numpy(logits))
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    wb = js.apply_penalties(jnp.asarray(logits).astype(jnp.bfloat16),
                            *(jnp.asarray(a) for a in args[1:]))
    gb = ts.apply_penalties(lb, *(torch.from_numpy(a) for a in args[1:]))
    assert gb.dtype == torch.bfloat16
    np.testing.assert_array_equal(gb.float().numpy(), np.asarray(wb, np.float32))


def test_token_mask_and_logprobs():
    """``apply_token_mask`` with a ``[V]`` and a ``[B, V]`` mask, and
    ``token_logprobs``, against JAX's."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 12)).astype(np.float32)
    m1 = np.zeros(12, bool)
    m1[[2, 5]] = True
    m2 = rng.random((3, 12)) < 0.5
    for m in (m1, m2):
        want = np.asarray(js.apply_token_mask(jnp.asarray(logits), jnp.asarray(m)))
        got = ts.apply_token_mask(torch.from_numpy(logits), torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, want)
    toks = np.asarray([3, 7, 0], np.int32)
    np.testing.assert_allclose(
        ts.token_logprobs(torch.from_numpy(logits), torch.from_numpy(toks)).numpy(),
        np.asarray(js.token_logprobs(jnp.asarray(logits), jnp.asarray(toks))), rtol=1e-6)


# --- the engine on tests/test_sampling.py's tiny Llama ---------------------

@pytest.fixture(scope="module")
def llama():
    jcfg = jm.LlamaConfig(num_layers=1, vocab_size=61)
    params = jm.init_weights(jax.random.key(23), jcfg)
    tparams = tm.from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, port_config(jcfg, tm.LlamaConfig), tparams


def _engines(llama, **kw):
    jcfg, params, tcfg, tparams = llama
    kw = {"num_pages": 64, **kw}
    return (JEngine(jadapter(jcfg, params), **kw),
            Engine(llama_adapter(tcfg, tparams, device="cpu"), device="cpu", **kw))


def _trace(eng, requests):
    """Serve ``requests`` (``add_request`` keyword dicts) one tick at a time
    → each tick's generated tokens of every request, and the finished
    requests' tokens and log-probabilities."""
    rids = [eng.add_request(**r) for r in requests]
    ticks = []
    while eng.waiting or eng.running:
        eng.step()
        live = {r.rid: tuple(r.out_tokens) for r in eng.running}
        ticks.append([live.get(rid, tuple(eng.finished.get(rid, ()))) for rid in rids])
    return ticks, [eng.finished[r] for r in rids], [eng.logprobs.get(r) for r in rids]


SAMPLINGS = {
    "temperature, top-k": dict(temperature=1.2, top_k=20, seed=11),
    "composed with penalties": dict(temperature=0.8, top_k=10, top_p=0.9, min_p=0.05, seed=3,
                                    repetition_penalty=1.1, presence_penalty=0.2,
                                    frequency_penalty=0.1),
    "repetition forbids repeats": dict(temperature=1.0, seed=3, repetition_penalty=1e9,
                                       presence_penalty=100.0),
}


@pytest.mark.parametrize("name", sorted(SAMPLINGS))
def test_engine_sampled_tokens_match_jax_engine(llama, name):
    """Two prompts served with the same ``SamplingParams``: the JAX engine's
    tokens tick by tick, seeded runs reproducible."""
    sp = SAMPLINGS[name]
    prompts = [[1, 5, 9, 2], [7, 3]]
    je, te = _engines(llama)
    want = je.run(prompts, 8, sampling=JSamplingParams(**sp))
    got = te.run(prompts, 8, sampling=SamplingParams(**sp))
    assert got == want and all(len(o) == 8 for o in got)
    assert _engines(llama)[1].run(prompts, 8, sampling=SamplingParams(**sp)) == got
    if name == "repetition forbids repeats":
        assert all(len(set(o)) == len(o) and not set(o) & set(p) for o, p in zip(got, prompts))


def test_engine_mixed_batch_logprobs_and_stop_tokens(llama):
    """Greedy, sampled, penalized and stop-token requests in one batch, with
    log-probabilities: the JAX engine's tokens at every tick and its
    log-probabilities (atol 1e-5); the stop token ends its request AT its
    first occurrence; the greedy rows equal a greedy-only run's."""
    greedy = _engines(llama)[1].run([[1, 5, 9, 2]], 8)[0]
    stop = greedy[2]
    reqs = [dict(prompt=[1, 5, 9, 2], max_new_tokens=8, logprobs=True),
            dict(prompt=[7, 3, 11], max_new_tokens=7, logprobs=True,
                 sampling=dict(temperature=0.9, top_k=15, seed=5)),
            dict(prompt=[1, 5, 9, 2], max_new_tokens=8, stop_tokens=[stop]),
            dict(prompt=[30, 31, 32, 33, 34], max_new_tokens=6,
                 sampling=dict(temperature=1.1, top_p=0.8, min_p=0.02, seed=9,
                               frequency_penalty=0.5))]
    je, te = _engines(llama, max_batch=4, prefill_chunk=4)

    def conv(cls):
        return [{**r, "sampling": cls(**r["sampling"])} if "sampling" in r else r for r in reqs]

    jt, jtoks, jlps = _trace(je, conv(JSamplingParams))
    tt_, ttoks, tlps = _trace(te, conv(SamplingParams))
    assert tt_ == jt and ttoks == jtoks
    for a, b in zip(tlps, jlps):
        if b is not None:
            np.testing.assert_allclose(a, b, atol=1e-5)
    assert ttoks[0] == greedy and ttoks[2] == greedy[: greedy.index(stop) + 1]
    assert te.cm.free_pages + te.cm.cached_pages == 64


def test_engine_unmixed_scheduling_matches_jax(llama):
    """``mixed=False`` (prefill first): a request admitted while another
    decodes stalls it until its prompt is prefilled, tick by tick as the
    JAX engine; the tokens equal the mixed engine's."""
    reqs = [dict(prompt=[1, 5, 9, 2], max_new_tokens=6),
            dict(prompt=list(range(3, 20)), max_new_tokens=4,
                 sampling=SamplingParams(temperature=1.0, seed=2)),
            dict(prompt=[7, 3], max_new_tokens=5)]
    jreqs = [{**r, "sampling": JSamplingParams(temperature=1.0, seed=2)} if "sampling" in r else r
             for r in reqs]
    je, te = _engines(llama, max_batch=2, prefill_chunk=4, mixed=False)
    jt, jtoks, _ = _trace(je, jreqs)
    tt_, ttoks, _ = _trace(te, reqs)
    assert tt_ == jt and ttoks == jtoks
    mixed = _engines(llama, max_batch=2, prefill_chunk=4)[1]
    assert _trace(mixed, reqs)[1] == ttoks
    # while the 17-token prompt prefills (5 ticks), the first request holds still
    held = [t[0] for t in tt_ if 0 < len(t[0]) < 6]
    assert any(held[i] == held[i + 1] for i in range(len(held) - 1))
