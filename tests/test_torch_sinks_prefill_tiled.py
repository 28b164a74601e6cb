"""Port parity: the CPU mirror of the CUDA K12d's walk
(``attention_sinks_prefill_tiled_plain``: blocks of 64 flat rows ``j G + h``
of one request and kv head, 64-key chunks aligned to 64 from the block's
first row's window start to its last live row's causal end, a base-2 online
softmax, P rounded at the running max, the in-kernel int8 fold's two
roundings) against JAX's ``attention_sinks_prefill_pallas`` (its Pallas
kernel in interpret mode, as ``tests/test_torch_sinks_attention.py`` runs
it) and against the port's ``attention_sinks_prefill_plain``.

Each case packs requests of 1, 63, 64, 65 and 130 new tokens (contexts 1,
63, 100, 129 and 260: chunk edges of rows and of keys) and 3 pad rows, at
groups 1, 4, 8, 12 (a block boundary inside a token: 64 = 5 x 12 + 4) and
16, page 16, with sinks and without, a window of 6 (its first key inside a
page) and of 40.  Tolerances: f32 within 1e-5 of the output's largest value
(f32 sums in another order), bf16 and int8 levels within 2e-2 of it (P
rounded to bf16 at another running max, the output rounded once, the JAX
kernel rounds P as well); pad rows exactly 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops.attention import sinks_attention as js
from sgl_kernel_npu_tpu_torch.ops.attention import sinks_attention as ts

PAGE = 16
SEQ, CTX = [1, 63, 64, 65, 130], [1, 63, 100, 129, 260]
PAD = 3
JAX_PREFILL = jax.jit(js.attention_sinks_prefill_pallas, static_argnums=(7, 8, 9, 10),
                      static_argnames=("max_q",))
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# (window, sinks): full attention with sinks (GPT-OSS), a window starting
# inside a page, a window of several chunks, neither (Llama)
MODES = [(0, True), (6, True), (40, True), (0, False)]


def _close(got, want, rel):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=rel * np.abs(want).max())


def _case(rng, group, hkv=2, d=32):
    """``SEQ`` / ``CTX`` packed with ``PAD`` pad rows, permuted pages."""
    hq = group * hkv
    max_pages = -(-max(CTX) // PAGE)
    n_pages = len(SEQ) * max_pages + 1
    kc = rng.standard_normal((n_pages, hkv, PAGE, d)).astype(np.float32)
    vc = rng.standard_normal((n_pages, hkv, PAGE, d)).astype(np.float32)
    bt = (rng.permutation(n_pages - 1)[: len(SEQ) * max_pages] + 1).reshape(
        len(SEQ), max_pages).astype(np.int32)
    q = rng.standard_normal((sum(SEQ) + PAD, hq * d)).astype(np.float32)
    sinks = rng.standard_normal(hq).astype(np.float32) * 2
    return q, kc, vc, bt, sinks, np.asarray(SEQ, np.int32), np.asarray(CTX, np.int32), hq, hkv


def _levels(x):
    """int8 levels of a cache of N(0, 1) values at scale 1/32."""
    return np.clip(np.round(x * 32), -128, 127).astype(np.int8)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("window,with_sinks", MODES)
@pytest.mark.parametrize("group", [1, 4, 8, 12, 16])
def test_tiled_walk_matches_jax_kernel(group, window, with_sinks, dt):
    jdt, tdt, rel = DTYPES[dt]
    rng = np.random.default_rng(group + window + 2 * with_sinks + len(dt))
    q, kc, vc, bt, sinks, seq, ctx, hq, hkv = _case(rng, group)
    sk_j, sk_t = (jx(sinks), tt(sinks)) if with_sinks else (None, None)
    want = JAX_PREFILL(jx(q, jdt), jx(kc, jdt), jx(vc, jdt), sk_j, jx(seq), jx(bt), jx(ctx), 0.17,
                       window, hq, hkv, max_q=max(SEQ))
    args = (tt(q, tdt), tt(kc, tdt), tt(vc, tdt), sk_t, tt(seq), tt(bt), tt(ctx), 0.17, window,
            hq, hkv)
    got = ts.attention_sinks_prefill_tiled_plain(*args)
    assert got.dtype == tdt and got.shape == q.shape
    _close(got, want, rel)
    _close(got, ts.attention_sinks_prefill_plain(*args), rel)
    assert not np32(got)[-PAD:].any()


@pytest.mark.parametrize("scales", ["scalar", "per_head"])
@pytest.mark.parametrize("window,with_sinks", [(0, True), (6, False)])
@pytest.mark.parametrize("group", [4, 12])
def test_tiled_walk_int8_fold_matches_jax_kernel(group, window, with_sinks, scales):
    """int8 levels with a scalar or per-kv-head scales: the mirror folds
    k_scale into q and v_scale into the output with the kernel's roundings,
    JAX's wrapper the same way."""
    rng = np.random.default_rng(7 * group + window + len(scales))
    q, kc, vc, bt, sinks, seq, ctx, hq, hkv = _case(rng, group)
    kc, vc = _levels(kc), _levels(vc)
    ks, vs = (1 / 32, 0.04) if scales == "scalar" else (np.asarray([1 / 32, 0.027], np.float32),
                                                       np.asarray([0.04, 0.011], np.float32))
    sk_j, sk_t = (jx(sinks), tt(sinks)) if with_sinks else (None, None)
    want = JAX_PREFILL(jx(q, jnp.bfloat16), jx(kc), jx(vc), sk_j, jx(seq), jx(bt), jx(ctx), 0.17,
                       window, hq, hkv, max_q=max(SEQ),
                       k_scale=ks if np.isscalar(ks) else jx(ks),
                       v_scale=vs if np.isscalar(vs) else jx(vs))
    sc = dict(k_scale=ks if np.isscalar(ks) else tt(ks), v_scale=vs if np.isscalar(vs) else tt(vs))
    args = (tt(q, torch.bfloat16), tt(kc), tt(vc), sk_t, tt(seq), tt(bt), tt(ctx), 0.17, window,
            hq, hkv)
    got = ts.attention_sinks_prefill_tiled_plain(*args, **sc)
    _close(got, want, 2e-2)
    _close(got, ts.attention_sinks_prefill_plain(*args, **sc), 2e-2)
    assert not np32(got)[-PAD:].any()


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("group", [4, 12])
def test_tiled_walk_packed_equals_unpacked(group, kind):
    """The packed layout (``pack_kv_sinks``) walks the same keys as the
    plain one, read by strides: the same bits, and the plain version's
    values."""
    rng = np.random.default_rng(group + len(kind))
    q, kc, vc, bt, sinks, seq, ctx, hq, hkv = _case(rng, group)
    sc = {}
    if kind == "int8":
        kc, vc = _levels(kc), _levels(vc)
        sc = dict(k_scale=torch.tensor([1 / 32, 0.027]), v_scale=torch.tensor([0.04, 0.011]))
    kc_t, vc_t = (tt(c) if kind == "int8" else tt(c, torch.bfloat16) for c in (kc, vc))
    args = (tt(q, torch.bfloat16), kc_t, vc_t, tt(sinks), tt(seq), tt(bt), tt(ctx), 0.17, 6, hq,
            hkv)
    plain = ts.attention_sinks_prefill_tiled_plain(*args, **sc)
    packed = ts.attention_sinks_prefill_tiled_plain(
        *args[:1], ts.pack_kv_sinks(kc_t), ts.pack_kv_sinks(vc_t), *args[3:], packed=True, **sc)
    assert torch.equal(packed, plain)
    _close(packed, ts.attention_sinks_prefill_plain(*args, **sc), 2e-2)


def test_tiled_walk_starts_at_the_window_chunk():
    """Blocks start at the chunk that holds their first row's window start:
    with a window of 40, the 130-token request at context 260 (its first row
    at position 130 sees keys 91 and up) walks from the chunk of keys 64-127
    in every block, so NaN in its keys and values 0-63 leaves its rows
    bit-equal, at group 12 (a block boundary inside a token)."""
    rng = np.random.default_rng(3)
    q, kc, vc, bt, sinks, seq, ctx, hq, hkv = _case(rng, 12)
    args = (tt(q, torch.bfloat16), tt(kc, torch.bfloat16), tt(vc, torch.bfloat16), tt(sinks),
            tt(seq), tt(bt), tt(ctx), 0.17, 40, hq, hkv)
    base = ts.attention_sinks_prefill_tiled_plain(*args)
    kz, vz = args[1].clone(), args[2].clone()
    for page in bt[4, : 64 // PAGE]:
        kz[page] = float("nan")
        vz[page] = float("nan")
    walked = ts.attention_sinks_prefill_tiled_plain(args[0], kz, vz, *args[3:])
    start = sum(SEQ[:4])
    assert torch.equal(walked[start : start + SEQ[4]], base[start : start + SEQ[4]])
