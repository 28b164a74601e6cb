"""Port parity: sinks attention, decode (K12a) and varlen prefill (K12d).

The same numpy queries, paged caches and sinks go through the JAX package
(its Pallas kernels in interpret mode on the CPU, and its goldens) and
through the port's wrappers on CPU tensors, which take the plain versions.
The cases hold the edges: a context of 1, a sliding window whose first key
lies inside a page of 16 or on a page boundary, a window crossing pages in
prefill, ragged requests, pad rows (the engine's: rows past the requests,
exactly 0 in both), and ``sinks=None``.  Tolerances: f32 within 1e-5 of the
output's largest value (f32 sums in another order), bf16 within 2e-2 (the
JAX kernels round P to bf16 for P V, the plain versions do not)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops.attention import sinks_attention as js
from sgl_kernel_npu_tpu_torch.ops.attention import sinks_attention as ts

PAGE = 16
# the JAX prefill wrapper compiled once per case (scale, window, head counts, max_q static)
JAX_PREFILL = jax.jit(js.attention_sinks_prefill_pallas, static_argnums=(7, 8, 9, 10),
                      static_argnames=("max_q",))
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _close(got, want, rel):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=rel * np.abs(want).max())


def _inputs(rng, n_rows, ctx_max, hq=8, hkv=2, d=32, n_tables=None):
    """Random caches of ``n_tables`` block tables (permuted pages, page 0
    unused) covering ``ctx_max`` keys, queries and f32 sinks."""
    n_tables = n_tables or n_rows
    max_pages = -(-ctx_max // PAGE)
    n_pages = n_tables * max_pages + 1
    kc = rng.standard_normal((n_pages, hkv, PAGE, d)).astype(np.float32)
    vc = rng.standard_normal((n_pages, hkv, PAGE, d)).astype(np.float32)
    bt = (rng.permutation(n_pages - 1)[: n_tables * max_pages] + 1).reshape(
        n_tables, max_pages).astype(np.int32)
    q = rng.standard_normal((n_rows, hq * d)).astype(np.float32)
    sinks = rng.standard_normal(hq).astype(np.float32) * 2
    return q, kc, vc, bt, sinks


@pytest.mark.parametrize("window,page_size", [(0, 16), (8, 16), (128, 16), (5, 4)])
def test_decode_page_bounds_match_jax(window, page_size):
    for ctx in (1, 2, 15, 16, 17, 31, 32, 33, 100, 200):
        want = js._decode_page_bounds(jnp.int32(ctx), window=window, page_size=page_size,
                                      max_pages=8)
        got = ts._decode_page_bounds(ctx, window=window, page_size=page_size, max_pages=8)
        assert got == tuple(int(w) for w in want), (ctx, got, want)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("window", [0, 8])
def test_attention_sinks_matches_jax(window, dt):
    """Contexts 1 (the new token alone), 16 and 17 (a page and one more), 37
    (window 8: first key 29, inside the second page), 40 (first key 32, a page
    boundary) and 60, then an engine pad row (ctx 1, block table of zeros)."""
    jdt, tdt, rel = DTYPES[dt]
    rng = np.random.default_rng(window + len(dt))
    ctx = np.asarray([1, 16, 17, 37, 40, 60, 1], np.int32)
    q, kc, vc, bt, sinks = _inputs(rng, len(ctx), int(ctx.max()))
    bt[-1] = 0
    args_j = (jx(q, jdt), jx(kc, jdt), jx(vc, jdt), jx(sinks), jx(bt), jx(ctx), 0.17, window, 8, 2)
    args_t = (tt(q, tdt), tt(kc, tdt), tt(vc, tdt), tt(sinks), tt(bt), tt(ctx), 0.17, window, 8, 2)
    want = js.attention_sinks(*args_j)
    got = ts.attention_sinks(*args_t)
    assert got.dtype == tdt and got.shape == q.shape
    _close(got, want, rel)
    _close(ts.attention_sinks_ref(*args_t), js.attention_sinks_ref(*args_j), rel)


def _prefill_case(rng, window):
    """Three requests (20 new tokens at context 45, 1 at context 1, 5 at
    context 30) and three pad rows; the pad rows fall inside the last
    request's max_q, where the JAX kernel's dense layout writes them as dead
    rows (0)."""
    seq = np.asarray([20, 1, 5], np.int32)
    ctx = np.asarray([45, 1, 30], np.int32)
    q, kc, vc, bt, sinks = _inputs(rng, int(seq.sum()) + 3, int(ctx.max()), n_tables=3)
    return q, kc, vc, bt, sinks, seq, ctx


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("window,with_sinks", [(0, True), (6, True), (24, True), (0, False),
                                               (6, False)])
def test_attention_sinks_prefill_matches_jax_kernel(window, with_sinks, dt):
    """The port's prefill (its plain version on the CPU) against the JAX
    Pallas kernel: causal, windows of 6 (crossing a page of 16 for most rows)
    and 24, with sinks and without (Llama's later prefill); pad rows exactly
    0 in both."""
    jdt, tdt, rel = DTYPES[dt]
    rng = np.random.default_rng(window + 2 * with_sinks + len(dt))
    q, kc, vc, bt, sinks, seq, ctx = _prefill_case(rng, window)
    sk_j, sk_t = (jx(sinks), tt(sinks)) if with_sinks else (None, None)
    want = JAX_PREFILL(
        jx(q, jdt), jx(kc, jdt), jx(vc, jdt), sk_j, jx(seq), jx(bt), jx(ctx), 0.17, window, 8, 2,
        max_q=20)
    got = ts.attention_sinks_prefill_pallas(
        tt(q, tdt), tt(kc, tdt), tt(vc, tdt), sk_t, tt(seq), tt(bt), tt(ctx), 0.17, window, 8, 2,
        max_q=20)
    assert got.dtype == tdt and got.shape == q.shape
    _close(got, want, rel)
    assert not np32(want)[-3:].any() and not np32(got)[-3:].any()


@pytest.mark.parametrize("window", [0, 6])
def test_attention_sinks_prefill_golden_matches_jax(window):
    """The goldens (f32) agree on every row, pad rows included (both attend
    them as the last request's later tokens)."""
    rng = np.random.default_rng(11 + window)
    q, kc, vc, bt, sinks, seq, ctx = _prefill_case(rng, window)
    want = js.attention_sinks_prefill(jx(q), jx(kc), jx(vc), jx(sinks), jx(seq), jx(bt), jx(ctx),
                                      0.17, window, 8, 2)
    got = ts.attention_sinks_prefill(tt(q), tt(kc), tt(vc), tt(sinks), tt(seq), tt(bt), tt(ctx),
                                     0.17, window, 8, 2)
    _close(got, want, 1e-5)
    live = int(seq.sum())
    plain = ts.attention_sinks_prefill_plain(tt(q), tt(kc), tt(vc), tt(sinks), tt(seq), tt(bt),
                                             tt(ctx), 0.17, window, 8, 2)
    _close(plain[:live], want[:live], 1e-5)


def test_int8_cache_not_ported():
    rng = np.random.default_rng(0)
    q, kc, vc, bt, sinks = _inputs(rng, 2, 20)
    ctx = torch.tensor([3, 20], dtype=torch.int32)
    k8, v8 = tt(kc).to(torch.int8), tt(vc).to(torch.int8)
    with pytest.raises(NotImplementedError, match="int8"):
        ts.attention_sinks(tt(q), k8, v8, tt(sinks), tt(bt), ctx, 0.1, 0, 8, 2)
    with pytest.raises(NotImplementedError, match="int8"):
        ts.attention_sinks_prefill_pallas(tt(q), tt(kc), tt(vc), tt(sinks), ctx[:1], tt(bt[:1]),
                                          ctx[1:], 0.1, 0, 8, 2, k_scale=0.5)
