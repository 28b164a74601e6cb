"""Port parity: DeepSeek-V3.2 sparse attention (DSA) — the block-sparse MLA
prefill (K9b), the sparse decodes, the model's DSA steps and the engine.

The JAX kernels (K9b, K10, K2 and the MoE GEMMs) run in Pallas interpret mode;
the port takes its plain path on CPU tensors.  Tolerances: attention in f32
2e-4 (as ``tests/test_dsa.py``), with bf16 q / latent or int8 levels 3e-2 (as
``test_torch_decode_mla.py``: the JAX kernels' bf16 P·V and output; on int8 the
JAX wrapper folds ``k_scale`` into a bf16 q); model hidden states within 1% of
max|hidden| on the float prologue (as ``test_torch_deepseek_v3.py``) and 2% on
every row through the fused W8A8 prologue with the JAX run's routing replayed
(as ``test_torch_int8_cache.py``); engine tokens equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, port_config, tt
from sgl_kernel_npu_tpu.models import deepseek_v3 as jm
from sgl_kernel_npu_tpu.ops.attention import decode_attention as jda
from sgl_kernel_npu_tpu.ops.attention import mla_prefill as jpf
from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tm
from sgl_kernel_npu_tpu_torch.ops.attention import decode_attention as tda
from sgl_kernel_npu_tpu_torch.ops.attention import mla_prefill as tpf
from sgl_kernel_npu_tpu_torch.runtime.engine import Engine, deepseek_adapter

KS = 1.0 / 32


def _paged(rng, n_pages, page, lat=64, rope=32, int8=False):
    if int8:
        kn = rng.integers(-127, 128, (n_pages, 1, page, lat)).astype(np.int8)
    else:
        kn = (rng.standard_normal((n_pages, 1, page, lat)) * 0.5).astype(np.float32)
    kr = (rng.standard_normal((n_pages, 1, rope, page)) * 0.5).astype(np.float32)
    return kn, kr


# pos_sel [B=2, chunks=2, P=4] at page 16, chunks of 8 tokens: request 0's rows
# sit at positions 44..59 (its second chunk straddles pages 2 and 3), walked
# dead page first; request 1's rows at 12..16: chunk 0 names only page 1, so
# its first rows (positions 12..15) see none of their pages' keys (the JAX
# kernel averages the walked latents), and chunk 1 is past its tokens
POS_SEL = [[[3, 2, 1, 0], [3, -1, 0, -1]], [[1, -1, -1, 1], [-1, -1, -1, -1]]]


def _block_sparse_inputs(rng, dtype, lat=64, rope=32, heads=4):
    seq, ctx, page, max_pages = np.asarray([16, 5], np.int32), np.asarray([60, 17], np.int32), 16, 4
    kn, kr = _paged(rng, 2 * max_pages, page, lat, rope, int8=dtype == "int8")
    bt = rng.permutation(2 * max_pages).reshape(2, max_pages).astype(np.int32)
    q = (rng.standard_normal((int(seq.sum()) + 2, heads, lat + rope)) * 0.5).astype(np.float32)
    return q, kn, kr, seq, bt, ctx, np.asarray(POS_SEL, np.int32)


@pytest.mark.parametrize(
    "dtype,heads", [(d, h) for h in (4, 64) for d in ("float32", "bfloat16", "int8")],
    ids=["float32", "bfloat16", "int8", "float32-64heads", "bfloat16-64heads", "int8-64heads"])
def test_mla_prefill_block_sparse_matches_jax_kernel(dtype, heads):
    """Dead slots, a dead page walked before the live ones
    (``tests/test_dsa.py``), a chunk straddling two pages, rows that see no
    key of their pages, a dead chunk and two pad rows; at 4 heads and at 64
    (the CUDA kernel's rows a block: one token's heads)."""
    rng = np.random.default_rng(0)
    lat, rope = (512, 64) if dtype == "int8" else (64, 32)
    q, kn, kr, seq, bt, ctx, pos = _block_sparse_inputs(rng, dtype, lat, rope, heads)
    fdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    ks = KS if dtype == "int8" else None
    kn_j = jx(kn) if dtype == "int8" else jx(kn, fdt[0])
    kn_t = tt(kn) if dtype == "int8" else tt(kn, fdt[1])
    want = np32(jpf.mla_prefill_block_sparse(
        jx(q, fdt[0]), kn_j, jx(kr, fdt[0]), jx(seq), jx(bt), jx(ctx), 0.1, jx(pos), max_q=16,
        q_chunk=8, k_scale=ks))
    got = tpf.mla_prefill_block_sparse(tt(q, fdt[1]), kn_t, tt(kr, fdt[1]), tt(seq), tt(bt),
                                       tt(ctx), 0.1, tt(pos), max_q=16, q_chunk=8, k_scale=ks)
    assert got.dtype == fdt[1]
    tol = 2e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(np32(got), want, atol=tol, rtol=0 if dtype == "float32" else tol)
    assert not np32(got)[-2:].any()


def _sparse_block_rows(heads, cq, max_q, y, x):
    """The live (token, head) rows of K9b's block (x head tile, y token tile)
    for one request of ``max_q`` tokens: the kernel's map
    (``csrc/mla_prefill.cu`` ``mla_prefill_sparse_kernel``, ``mla_sparse.cuh``
    ``row_live``), row r = token j0 + r // hb, head x hb + r % hb."""
    tq, hb, tiles = tpf.sparse_tiling(heads, cq)
    chunk = y // tiles
    j0 = chunk * cq + (y % tiles) * tq
    jend = min(j0 + tq, (chunk + 1) * cq, max_q)
    return [(j0 + r // hb, x * hb + r % hb) for r in range(tpf.SPARSE_ROWS)
            if r < tq * hb and j0 + r // hb < jend and x * hb + r % hb < heads]


@pytest.mark.parametrize("cq", [8, 16, 64])
@pytest.mark.parametrize("heads", [1, 8, 64, 128])
def test_block_sparse_tiling_covers_every_row_once(heads, cq):
    """K9b's tiling (``sparse_tiling``) under the kernel's row map: over a
    request of ``max_q`` tokens, every live (token, head) row lies in exactly
    one block, no block holds tokens of two q-chunks, and a block holds at
    most 64 rows."""
    max_q = 3 * cq - 5                              # a partial last chunk
    tq, hb, tiles = tpf.sparse_tiling(heads, cq)
    assert tq * hb <= tpf.SPARSE_ROWS and tiles * tq >= cq
    seen = []
    for y in range(-(-max_q // cq) * tiles):
        for x in range(-(-heads // hb)):
            rows = _sparse_block_rows(heads, cq, max_q, y, x)
            assert len({j // cq for j, _ in rows}) <= 1
            seen += rows
    assert sorted(seen) == [(j, h) for j in range(max_q) for h in range(heads)]


@pytest.mark.parametrize("ks", [KS, 0.0123, 1 / 64])
def test_block_sparse_one_pass_fold_is_bit_equal(ks):
    """The int8 ``k_scale`` fold of the MLA wrappers (K2, K9a, K9b), one pass
    over q, and the in-place unfold of their output: bit-equal to the JAX
    wrapper's ``(x.astype(f32) * ks).astype(bf16)`` on q's nope part and on
    the output (``decode_attention.py:317``, ``:355``)."""
    rng = np.random.default_rng(3)
    q = (rng.standard_normal((40, 5, 576)) * 3).astype(np.float32)
    out = (rng.standard_normal((40, 5, 512)) * 40).astype(np.float32)
    jq, jout = jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(out).astype(jnp.bfloat16)
    jks = jnp.float32(ks)
    want_q = jnp.concatenate(
        [(jq[..., :512].astype(jnp.float32) * jks).astype(jnp.bfloat16), jq[..., 512:]], -1)
    want_out = (jout.astype(jnp.float32) * jks).astype(jnp.bfloat16)
    got_q = tda.fold_q_scale(torch.from_numpy(q).to(torch.bfloat16), ks)
    got_out = tda.unfold_out_scale(torch.from_numpy(out).to(torch.bfloat16), ks)
    np.testing.assert_array_equal(got_q.float().numpy(), np.asarray(want_q, np.float32))
    np.testing.assert_array_equal(got_out.float().numpy(), np.asarray(want_out, np.float32))


def test_mla_prefill_block_sparse_all_pages_equals_dense():
    """Every causal page selected, in reverse order: the dense prefill."""
    rng = np.random.default_rng(1)
    seq, ctx, page = np.asarray([16, 5], np.int32), np.asarray([60, 17], np.int32), 16
    kn, kr = _paged(rng, 8, page)
    bt = np.arange(8, dtype=np.int32).reshape(2, 4)
    q = (rng.standard_normal((21, 4, 96)) * 0.5).astype(np.float32)
    pos = np.asarray([[[3, 2, 1, 0]], [[1, 0, -1, -1]]], np.int32)
    got = tpf.mla_prefill_block_sparse(tt(q), tt(kn), tt(kr), tt(seq), tt(bt), tt(ctx), 0.1,
                                       tt(pos), max_q=16, q_chunk=16)
    want = tpf.mla_prefill_ref(tt(q), tt(kn), tt(kr), tt(seq), tt(bt), tt(ctx), 0.1)
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_decode_mla_block_sparse_matches_jax(dtype):
    """Page mode's decode: 2 of 4 pages by page-max score, the last (partial)
    page forced in, pages sorted; a row with fewer valid pages than the
    budget and an engine pad row (context 1, block table of zeros)."""
    rng = np.random.default_rng(2)
    lat, rope = (512, 64) if dtype == "int8" else (64, 32)
    b, page, max_pages = 4, 16, 4
    kn, kr = _paged(rng, b * max_pages + 1, page, lat, rope, int8=dtype == "int8")
    bt = (rng.permutation(b * max_pages) + 1).reshape(b, max_pages).astype(np.int32)
    bt[3] = 0
    sl = np.asarray([43, 17, 64, 1], np.int32)
    q = (rng.standard_normal((b, 4, lat + rope)) * 0.5).astype(np.float32)
    scores = rng.standard_normal((b, max_pages * page)).astype(np.float32)
    scores[np.arange(max_pages * page)[None, :] >= sl[:, None]] = -np.inf
    ks = KS if dtype == "int8" else None
    if dtype == "int8":
        args_j = (jx(q, jnp.bfloat16), jx(kn), jx(kr, jnp.bfloat16))
        args_t = (tt(q, torch.bfloat16), tt(kn), tt(kr, torch.bfloat16))
    else:
        args_j, args_t = (jx(q), jx(kn), jx(kr)), (tt(q), tt(kn), tt(kr))
    want = np32(jda.decode_mla_block_sparse(*args_j, jx(sl), 0.1, jx(bt), jx(scores), 2,
                                            k_scale=ks))
    got = tda.decode_mla_block_sparse(*args_t, tt(sl), 0.1, tt(bt), tt(scores), 2, k_scale=ks)
    tol = 2e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(np32(got), want, atol=tol, rtol=0 if dtype == "float32" else tol)
    sel = tda.select_decode_pages(tt(scores), tt(sl), page, 2)
    bt_sel, seq_sel = tda.pruned_block_table(tt(bt), tt(sl), sel, page)
    assert (np.diff(sel.numpy(), axis=1) > 0).all()               # sorted
    assert seq_sel.tolist() == [27, 17, 32, 1]                    # 16 + 11, 16 + 1, 2 x 16, 1
    assert bool((sel[:, -1] == torch.tensor([2, 1, 3, 1])).all())  # the last page, or a dead one


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_decode_mla_sparse_matches_jax(dtype):
    """Token mode's decode over selected positions with -1 pads and a
    position past the context (masked)."""
    rng = np.random.default_rng(3)
    lat, rope = (512, 64) if dtype == "int8" else (64, 32)
    b, page, max_pages, k = 3, 16, 4, 10
    kn, kr = _paged(rng, b * max_pages + 1, page, lat, rope, int8=dtype == "int8")
    bt = (rng.permutation(b * max_pages) + 1).reshape(b, max_pages).astype(np.int32)
    sl = np.asarray([40, 9, 64], np.int32)
    sel = np.stack([rng.choice(int(s), min(k, int(s)), replace=False).tolist()
                    + [-1] * (k - min(k, int(s))) for s in sl]).astype(np.int32)
    sel[2, 0] = 63
    sel[0, -1] = 50                                              # past the context
    q = (rng.standard_normal((b, 4, lat + rope)) * 0.5).astype(np.float32)
    ks = KS if dtype == "int8" else None
    want = np32(jda.decode_mla_sparse(jx(q), jx(kn), jx(kr), jx(sl), 0.1, jx(bt), jx(sel),
                                      k_scale=ks))
    got = tda.decode_mla_sparse(tt(q), tt(kn), tt(kr), tt(sl), 0.1, tt(bt), tt(sel),
                                k_scale=ks)
    np.testing.assert_allclose(np32(got), want, atol=2e-4)


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------

PAGE = 16


_DSA = jm.DeepSeekV3Config(num_layers=1, page_size=PAGE, vocab_size=64, sparse_count=32)


@functools.lru_cache(maxsize=None)
def _weights():
    """One layer at hidden 256: the JAX weights (the indexer's included) with
    W8A8 experts, and the port's copies of them."""
    params = jm.init_weights(jax.random.key(0), _DSA, jnp.float32)
    moe_j = jm.quantize_moe_weights(_DSA, params)
    tparams, moe_t, _, _ = tm.from_jax_params(jax.tree.map(np.asarray, params),
                                              jax.tree.map(np.asarray, moe_j), device="cpu")
    return params, moe_j, tparams, moe_t


@functools.lru_cache(maxsize=None)
def _prologue(kv_cache_dtype):
    """The fused prologue's weights for a latent cache type (calibrated on one
    sample), the JAX package's and the port's copies."""
    jcfg = dataclasses.replace(_DSA, kv_cache_dtype=kv_cache_dtype)
    sample = jx(np.random.default_rng(14).standard_normal((16, jcfg.hidden)) * 0.3,
                jnp.float32)
    mla_j = jm.make_mla_preprocess_weights(jcfg, _weights()[0], sample)
    _, _, mla_t, _ = tm.from_jax_params(jax.tree.map(np.asarray, _weights()[0]), device="cpu",
                                        mla_wq_np=jax.tree.map(np.asarray, mla_j))
    return mla_j, mla_t


def _model(kv_cache_dtype, gran):
    """DSA with 32 keys (2 pages of 16) a decode row or prefill chunk."""
    jcfg = dataclasses.replace(_DSA, kv_cache_dtype=kv_cache_dtype, sparse_granularity=gran)
    tcfg = port_config(jcfg, tm.DeepSeekV3Config)
    params, moe_j, tparams, moe_t = _weights()
    return jcfg, tcfg, params, moe_j, tparams, moe_t


def test_from_jax_params_carries_the_indexer_weights():
    jcfg, tcfg, params, _, tparams, _ = _model("bf16", "page")
    assert tcfg.sparse_count == 32 and tcfg.idx_heads == 4 and tcfg.idx_dim == 64
    for lj, lt in zip(params["layers"], tparams["layers"]):
        for name, shape in (("w_qidx", (jcfg.hidden, 4 * 64)), ("w_kidx", (jcfg.hidden, 64)),
                            ("w_widx", (jcfg.hidden, 4))):
            assert tuple(lt[name].shape) == shape
            np.testing.assert_array_equal(lt[name].numpy(), np.asarray(lj[name]))
    caches = tm.init_kv_cache(tcfg, 3, device="cpu")
    assert caches[0]["kidx"].shape == (3, 1, PAGE, 64) and caches[0]["kidx"].dtype == torch.bfloat16


def test_init_weights_indexer_keeps_the_other_weights():
    """DSA adds the three projections from a stream of their own: every other
    weight keeps its dense-config value."""
    dense = tm.DeepSeekV3Config(num_layers=2)
    sparse = dataclasses.replace(dense, sparse_count=64)
    wd, ws = tm.init_weights(dense, 3, device="cpu"), tm.init_weights(sparse, 3, device="cpu")
    assert torch.equal(wd["embed"], ws["embed"])
    for ld, ls in zip(wd["layers"], ws["layers"]):
        assert set(ls) - set(ld) == {"w_qidx", "w_kidx", "w_widx"}
        assert all(torch.equal(ld[k], ls[k]) for k in ld)
    assert ws["layers"][0]["w_widx"].std() > 0.1               # scale 0.2, as JAX


def _caches(rng, jcfg, tcfg, num_pages):
    """Random latent, rope and index-key caches, the same on both sides."""
    kv_j = jm.init_kv_cache(jcfg, num_pages, jnp.float32)
    for c in kv_j:
        for key in ("nope", "rope", "kidx"):
            if c[key].dtype == jnp.int8:
                c[key] = jx(rng.integers(-100, 100, c[key].shape).astype(np.int8))
            else:
                c[key] = jx((rng.standard_normal(c[key].shape) * 0.5).astype(np.float32))
    return kv_j, [{k: tt(np.asarray(v)) for k, v in c.items()} for c in kv_j]


def _replay_jax_routing(monkeypatch):
    record, router = [], jm._router

    def recording(cfg, lw, x):
        ids, w = router(cfg, lw, x)
        record.append((tt(np.asarray(ids)), tt(np32(w))))
        return ids, w

    monkeypatch.setattr(jm, "_router", recording)
    monkeypatch.setattr(tm, "_router", lambda cfg, lw, x: record.pop(0))


def _rows_close(got, want, tol):
    want = np32(want)
    err_row = np.abs(np32(got) - want).max(axis=-1) / np.abs(want).max()
    assert (err_row <= tol).all(), np.sort(err_row)[-8:]


# (granularity, fused W8A8 prologue, latent cache)
STEP_CASES = [("page", False, "bf16"), ("page", True, "bf16"), ("page", False, "int8"),
              ("page", True, "int8"), ("token", False, "bf16"), ("token", True, "int8")]


@pytest.mark.parametrize("gran,fused,kv_cache_dtype", STEP_CASES)
def test_prefill_then_decode_match_jax(gran, fused, kv_cache_dtype, monkeypatch):
    """A packed varlen prefill of three requests (3, 25 and 10 new tokens at
    contexts 40, 25 and 64, two pad rows; pages selected from 4 causal pages
    of the longest) then a decode step (contexts 1-64, a slot -1 row) on the
    cache the prefill wrote, against JAX; the index keys written equal."""
    jcfg, tcfg, params, moe_j, tparams, moe_t = _model(kv_cache_dtype, gran)
    mla_j, mla_t = _prologue(kv_cache_dtype) if fused else (None, None)
    if fused:
        _replay_jax_routing(monkeypatch)
    jkw = dict(moe_weights_q=moe_j, mla_wq=mla_j)
    tkw = dict(moe_weights_q=moe_t, mla_wq=mla_t)
    rng = np.random.default_rng(6)
    kv_j, kv_t = _caches(rng, jcfg, tcfg, 13)
    sl = np.asarray([3, 25, 10], np.int32)
    ctx = np.asarray([40, 25, 64], np.int32)
    bt = np.arange(1, 13).reshape(3, 4).astype(np.int32)
    slots = np.asarray([bt[b, p // PAGE] * PAGE + p % PAGE
                        for b in range(3) for p in range(ctx[b] - sl[b], ctx[b])] + [-1, -1],
                       np.int32)
    hid = (rng.standard_normal((len(slots), jcfg.hidden)) * 0.3).astype(np.float32)
    yj, kv_j = jm.prefill_step(jcfg, params, jx(hid), jx(sl), kv_j, jx(bt), jx(ctx), jx(slots),
                               max_q=len(slots), **jkw)
    yt, kv_t = tm.prefill_step(tcfg, tparams, tt(hid), tt(sl), kv_t, tt(bt), tt(ctx), tt(slots),
                               max_q=len(slots), **tkw)
    tol = 0.02 if fused else 0.01
    _rows_close(yt[: int(sl.sum())], yj[: int(sl.sum())], tol)
    np.testing.assert_allclose(np32(kv_t[0]["kidx"]), np32(kv_j[0]["kidx"]), atol=1e-5)

    n = 4
    seq = np.asarray([1, 20, 33, 64], np.int32)
    pos = seq - 1
    bt4 = np.concatenate([bt, np.zeros((1, 4), np.int32)])[[0, 1, 2, 3]]
    slot = (bt4[np.arange(n), pos // PAGE] * PAGE + pos % PAGE).astype(np.int32)
    slot[0] = -1
    x = (rng.standard_normal((n, jcfg.hidden)) * 0.3).astype(np.float32)
    yj, _ = jm.decode_step(jcfg, params, jx(x), jx(pos), kv_j, jx(bt4), jx(seq), jx(slot), **jkw)
    yt, _ = tm.decode_step(tcfg, tparams, tt(x), tt(pos), kv_t, tt(bt4), tt(seq), tt(slot), **tkw)
    _rows_close(yt, yj, tol)


def test_dsa_prunes_and_differs_from_dense():
    """Two pages of four: the page-mode prefill and decode attend fewer pages
    than their causal range (the selection hook sees it), and the output
    moves off the dense model's."""
    jcfg, tcfg, _, _, tparams, moe_t = _model("bf16", "page")
    rng = np.random.default_rng(7)
    seen = []
    kw = dict(moe_weights_q=moe_t)
    hid = tt((rng.standard_normal((64, tcfg.hidden)) * 0.3).astype(np.float32))
    bt = torch.arange(1, 5, dtype=torch.int32)[None]
    slots = (bt[0, torch.arange(64) // PAGE] * PAGE + torch.arange(64) % PAGE).to(torch.int32)
    n64 = torch.tensor([64], dtype=torch.int32)
    outs = {}
    for cfg in (tcfg, dataclasses.replace(tcfg, sparse_count=0)):
        caches = tm.init_kv_cache(cfg, 5, torch.float32, device="cpu")
        orig = tm._selected
        tm._selected = lambda s: seen.append(s) or s
        try:
            outs[cfg.sparse_count], _ = tm.prefill_step(cfg, tparams, hid, n64, caches, bt, n64,
                                                       slots, max_q=64, **kw)
        finally:
            tm._selected = orig
    pos_sel = seen[0]
    assert pos_sel.shape == (1, 1, 2) and (pos_sel >= 0).all() and int(pos_sel[0, 0, 0]) == 3
    assert float((outs[32] - outs[0]).abs().max()) > 1e-4


def _engine_tokens(gran):
    """The port's Engine and the JAX package's on the same DSA model: two
    prompts (the second admitted while the first decodes), 5 new tokens."""
    from sgl_kernel_npu_tpu.runtime.engine import Engine as JEngine
    from sgl_kernel_npu_tpu.runtime.engine import deepseek_adapter as jadapter

    jcfg = jm.DeepSeekV3Config(num_layers=1, page_size=4, vocab_size=61, sparse_count=8,
                               sparse_granularity=gran)
    tcfg = port_config(jcfg, tm.DeepSeekV3Config)
    params = jm.init_weights(jax.random.key(3), jcfg, jnp.float32)
    moe_j = jm.quantize_moe_weights(jcfg, params)
    tparams, moe_t, _, _ = tm.from_jax_params(jax.tree.map(np.asarray, params),
                                              jax.tree.map(np.asarray, moe_j), device="cpu")
    prompts = [[5, 9, 2, 33, 17, 4, 8, 21, 60, 3, 7, 11, 40, 2], [40, 41, 42, 43, 44, 45]]
    kw = dict(max_batch=2, max_pages_per_req=8, prefill_chunk=8)
    out = []
    for eng in (JEngine(jadapter(jcfg, params, moe_weights_q=moe_j), 32, **kw),
                Engine(deepseek_adapter(tcfg, tparams, moe_weights_q=moe_t, device="cpu"), 32,
                       device="cpu", **kw)):
        out.append(eng.run(prompts, 5))
        assert eng.cm.free_pages + eng.cm.cached_pages == 32
    return out


@pytest.mark.parametrize("gran", ["page", "token"])
def test_engine_matches_jax_engine(gran):
    want, got = _engine_tokens(gran)
    assert got == want
