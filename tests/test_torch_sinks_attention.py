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
    """The int8 cache runs: on int8 levels the plain versions (the wrappers'
    fold of the scales into q and the output) and the goldens (levels
    dequantized after the gather) agree within bf16 rounding, decode and
    prefill."""
    rng = np.random.default_rng(0)
    q, kc, vc, bt, sinks = _inputs(rng, 2, 20)
    ctx = torch.tensor([3, 20], dtype=torch.int32)
    k8, v8 = _levels(kc), _levels(vc)
    sc = dict(k_scale=torch.tensor([0.02, 0.05]), v_scale=0.03)
    args = (tt(q, torch.bfloat16), tt(k8), tt(v8), tt(sinks), tt(bt), ctx, 0.1, 0, 8, 2)
    _close(ts.attention_sinks(*args, **sc), ts.attention_sinks_ref(*args, **sc), 2e-2)
    pre = (tt(q, torch.bfloat16), tt(k8), tt(v8), tt(sinks), ctx[:1], tt(bt[:1]), ctx[1:], 0.1,
           0, 8, 2)
    _close(ts.attention_sinks_prefill_pallas(*pre, **sc)[:2],
           ts.attention_sinks_prefill(*pre, **sc)[:2], 2e-2)


def _levels(x):
    """int8 levels of a cache of N(0, 1) values at scale 1/32."""
    return np.clip(np.round(x * 32), -128, 127).astype(np.int8)


# int8 scales: a scalar, or one per kv head (numpy; made tensors / jax arrays per side)
SCALES = {"scalar": (1 / 32, 0.04), "per_head": ([1 / 32, 0.027], [0.04, 0.011])}


def _scales(kind):
    ks, vs = SCALES[kind]
    as_np = lambda s: s if np.isscalar(s) else np.asarray(s, np.float32)  # noqa: E731
    ks, vs = as_np(ks), as_np(vs)
    jax_sc = {n: s if np.isscalar(s) else jx(s) for n, s in (("k_scale", ks), ("v_scale", vs))}
    port_sc = {n: s if np.isscalar(s) else tt(s) for n, s in (("k_scale", ks), ("v_scale", vs))}
    return jax_sc, port_sc


INT8_DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16,
                                                                   2e-2)}


@pytest.mark.parametrize("dt", sorted(INT8_DTYPES))
@pytest.mark.parametrize("window,kind", [(0, "scalar"), (8, "per_head")])
def test_attention_sinks_int8_matches_jax(window, kind, dt):
    """int8 K / V levels: the port's decode (plain, the wrapper's fold)
    against the JAX kernel (its fold), and the goldens (dequantize) against
    each other, at the contexts of ``test_attention_sinks_matches_jax``."""
    jdt, tdt, rel = INT8_DTYPES[dt]
    rng = np.random.default_rng(window + len(kind) + len(dt))
    ctx = np.asarray([1, 16, 17, 37, 40, 60, 1], np.int32)
    q, kc, vc, bt, sinks = _inputs(rng, len(ctx), int(ctx.max()))
    bt[-1] = 0
    k8, v8 = _levels(kc), _levels(vc)
    sc_j, sc_t = _scales(kind)
    args_j = (jx(q, jdt), jx(k8), jx(v8), jx(sinks), jx(bt), jx(ctx), 0.17, window, 8, 2)
    args_t = (tt(q, tdt), tt(k8), tt(v8), tt(sinks), tt(bt), tt(ctx), 0.17, window, 8, 2)
    got = ts.attention_sinks(*args_t, **sc_t)
    assert got.dtype == tdt
    _close(got, js.attention_sinks(*args_j, **sc_j), rel)
    _close(ts.attention_sinks_ref(*args_t, **sc_t), js.attention_sinks_ref(*args_j, **sc_j), rel)


def test_pack_kv_sinks_matches_jax_and_reads_back():
    """``pack_kv_sinks`` equals JAX's (head 2j in lanes [0, d), 2j + 1 in
    [d, 2d)), and a gather of the packed cache by strides gives the plain
    layout's keys."""
    from sgl_kernel_npu_tpu_torch.ops.attention.decode_attention import _gather_pages

    rng = np.random.default_rng(1)
    cache = rng.standard_normal((5, 4, PAGE, 8)).astype(np.float32)
    packed = ts.pack_kv_sinks(tt(cache))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(js.pack_kv_sinks(jx(cache))))
    bt = tt(np.asarray([[3, 1], [4, 0]], np.int32))
    assert torch.equal(_gather_pages(packed, bt, 20, 2), _gather_pages(tt(cache), bt, 20))
    with pytest.raises(ValueError, match="even"):
        ts.pack_kv_sinks(tt(cache[:, :3]))


# (query dtype, cache kind): a float cache in the query's dtype, or int8 levels
PACKED_CASES = [("f32", "float"), ("bf16", "float"), ("f32", "int8"), ("bf16", "int8")]


def _packed_case(rng, n_rows, ctx_max, kind, n_tables=None):
    """Inputs at 8 q / 4 kv heads (2 packed rows) x 32: the caches packed
    (int8 levels for ``kind`` int8)."""
    q, kc, vc, bt, sinks = _inputs(rng, n_rows, ctx_max, hkv=4, n_tables=n_tables)
    if kind == "int8":
        kc, vc = _levels(kc), _levels(vc)
    pack = lambda c: np.asarray(js.pack_kv_sinks(jx(c)))  # noqa: E731
    return q, kc, vc, pack(kc), pack(vc), bt, sinks


@pytest.mark.parametrize("impl", ["flat", "blockspec"])
@pytest.mark.parametrize("dt,kind", PACKED_CASES)
def test_attention_sinks_packed_matches_jax(dt, kind, impl):
    """Decode over the packed cache (K12b ``blockspec``, K12c ``flat``, JAX's
    kernels in interpret mode at up to 3 pages) against the port's, which
    also equals its decode over the same cache unpacked; window 8 (first
    key inside a page), contexts 1 to 40 and a pad row; int8 with
    per-kv-head scales."""
    jdt, tdt, rel = (INT8_DTYPES if kind == "int8" else DTYPES)[dt]
    cdt_j, cdt_t = (None, None) if kind == "int8" else (jdt, tdt)
    rng = np.random.default_rng(len(dt) + len(kind) + len(impl))
    ctx = np.asarray([1, 17, 40, 1], np.int32)
    q, kc, vc, kp, vp, bt, sinks = _packed_case(rng, len(ctx), int(ctx.max()), kind)
    bt[-1] = 0
    sc = {}
    if kind == "int8":
        s = np.asarray([1 / 32, 0.027, 0.05, 0.02], np.float32)
        sc = {"k_scale": s, "v_scale": s[::-1].copy()}
    sc_j = {n: jx(s) for n, s in sc.items()}
    sc_t = {n: tt(s) for n, s in sc.items()}
    tail = (jx(sinks), jx(bt), jx(ctx), 0.17, 8, 8, 4)
    want = js.attention_sinks_packed(jx(q, jdt), jx(kp, cdt_j), jx(vp, cdt_j), *tail, impl=impl,
                                     **sc_j)
    tail_t = (tt(sinks), tt(bt), tt(ctx), 0.17, 8, 8, 4)
    got = ts.attention_sinks_packed(tt(q, tdt), tt(kp, cdt_t), tt(vp, cdt_t), *tail_t, impl=impl,
                                    **sc_t)
    assert got.dtype == tdt and got.shape == q.shape
    _close(got, want, rel)
    unpacked = ts.attention_sinks(tt(q, tdt), tt(kc, cdt_t), tt(vc, cdt_t), *tail_t, **sc_t)
    assert torch.equal(got, unpacked)


@pytest.mark.parametrize("dt", sorted(INT8_DTYPES))
@pytest.mark.parametrize("window,with_sinks", [(6, True), (0, False)])
def test_attention_sinks_prefill_int8_matches_jax_kernel(window, with_sinks, dt):
    """K12d on int8 levels with per-kv-head scales: the port (plain, the
    wrapper's fold) against the JAX kernel (its fold), pad rows exactly 0;
    with sinks and a window of 6, and without either (Llama's prefill)."""
    jdt, tdt, rel = INT8_DTYPES[dt]
    rng = np.random.default_rng(window + with_sinks + len(dt))
    q, kc, vc, bt, sinks, seq, ctx = _prefill_case(rng, window)
    k8, v8 = _levels(kc), _levels(vc)
    sc_j, sc_t = _scales("per_head")
    sk_j, sk_t = (jx(sinks), tt(sinks)) if with_sinks else (None, None)
    want = JAX_PREFILL(jx(q, jdt), jx(k8), jx(v8), sk_j, jx(seq), jx(bt), jx(ctx), 0.17, window,
                       8, 2, max_q=20, **sc_j)
    got = ts.attention_sinks_prefill_pallas(tt(q, tdt), tt(k8), tt(v8), sk_t, tt(seq), tt(bt),
                                            tt(ctx), 0.17, window, 8, 2, max_q=20, **sc_t)
    _close(got, want, rel)
    assert not np32(want)[-3:].any() and not np32(got)[-3:].any()
    golden = ts.attention_sinks_prefill(tt(q, tdt), tt(k8), tt(v8), sk_t, tt(seq), tt(bt),
                                        tt(ctx), 0.17, window, 8, 2, **sc_t)
    live = int(seq.sum())
    _close(golden[:live], js.attention_sinks_prefill(
        jx(q, jdt), jx(k8), jx(v8), sk_j, jx(seq), jx(bt), jx(ctx), 0.17, window, 8, 2,
        **sc_j)[:live], rel)


JAX_PREFILL_PACKED = jax.jit(js.attention_sinks_prefill_packed, static_argnums=(7, 8, 9, 10),
                             static_argnames=("max_q",))


@pytest.mark.parametrize("dt,kind", PACKED_CASES[::3])
def test_attention_sinks_prefill_packed_matches_jax(dt, kind):
    """Prefill over the packed cache: JAX's zero-interleaved queries on its
    prefill kernel against the port's strided reads (K12d with
    ``packed``), which also equal its prefill over the same cache unpacked;
    three requests, a window of 6, pad rows 0; int8 with per-kv-head
    scales."""
    jdt, tdt, rel = (INT8_DTYPES if kind == "int8" else DTYPES)[dt]
    cdt_j, cdt_t = (None, None) if kind == "int8" else (jdt, tdt)
    rng = np.random.default_rng(7 + len(kind))
    seq = np.asarray([20, 1, 5], np.int32)
    ctx = np.asarray([45, 1, 30], np.int32)
    q, kc, vc, kp, vp, bt, sinks = _packed_case(rng, int(seq.sum()) + 3, int(ctx.max()), kind,
                                                n_tables=3)
    sc = {}
    if kind == "int8":
        s = np.asarray([1 / 32, 0.027, 0.05, 0.02], np.float32)
        sc = {"k_scale": s, "v_scale": s[::-1].copy()}
    sc_j = {n: jx(s) for n, s in sc.items()}
    sc_t = {n: tt(s) for n, s in sc.items()}
    want = JAX_PREFILL_PACKED(jx(q, jdt), jx(kp, cdt_j), jx(vp, cdt_j), jx(sinks), jx(seq),
                              jx(bt), jx(ctx), 0.17, 6, 8, 4, max_q=20, **sc_j)
    tail = (tt(sinks), tt(seq), tt(bt), tt(ctx), 0.17, 6, 8, 4)
    got = ts.attention_sinks_prefill_packed(tt(q, tdt), tt(kp, cdt_t), tt(vp, cdt_t), *tail,
                                            max_q=20, **sc_t)
    _close(got, want, rel)
    assert not got[-3:].any()
    unpacked = ts.attention_sinks_prefill_pallas(tt(q, tdt), tt(kc, cdt_t), tt(vc, cdt_t), *tail,
                                                 max_q=20, **sc_t)
    assert torch.equal(got, unpacked)
