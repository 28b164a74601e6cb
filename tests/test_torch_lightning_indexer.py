"""Port parity: the lightning indexer (DeepSeek-V3.2 DSA) and the prefill page
selection.

The JAX prefill-score kernel (K10) runs in Pallas interpret mode; the port
takes its plain path on CPU tensors.  Tolerances: scores ``-inf`` at exactly
the same positions and finite values within 1e-5 of the row's largest
|score| (f32 sums over heads and the key width in another order); selected
indices and pages equal (the port's ``top_k`` keeps ``jax.lax.top_k``'s order
of ties, and the data has no ties among finite scores)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, tt
from sgl_kernel_npu_tpu.ops.attention import lightning_indexer as jli
from sgl_kernel_npu_tpu.ops.attention import mla_prefill as jpf
from sgl_kernel_npu_tpu_torch.ops.attention import lightning_indexer as tli
from sgl_kernel_npu_tpu_torch.ops.attention import mla_prefill as tpf

PAGE, HEADS, DIM = 16, 4, 64


def _keys(rng, n_pages):
    return rng.standard_normal((n_pages, 1, PAGE, DIM)).astype(np.float32)


def _scores_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    dead = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), dead)
    assert (got[dead] < 0).all() and (want[dead] < 0).all()
    scale = np.abs(np.where(dead, 0.0, want)).max(axis=-1, keepdims=True) + 1e-30
    err = np.abs(np.where(dead, 0.0, got) - np.where(dead, 0.0, want)) / scale
    assert err.max() <= 1e-5, err.max()


# (lens_q, lens_k, max_q, q_chunk, causal): ragged requests after earlier
# context with pad rows, max_q not a multiple of the chunk (45 in chunks of
# 16), a request with no new tokens, a single chunk, and no causality
K10_CASES = [([1, 5, 40], [17, 60, 40], 45, 16, True),
             ([0, 12, 7], [9, 30, 70], 12, 64, True),
             ([3, 12], [30, 12], 12, 8, False)]


@pytest.mark.parametrize("lens_q,lens_k,max_q,q_chunk,causal", K10_CASES)
def test_prefill_scores_match_jax_kernel(lens_q, lens_k, max_q, q_chunk, causal):
    rng = np.random.default_rng(0)
    b, max_pages = len(lens_q), 5
    key = _keys(rng, b * max_pages + 1)
    bt = (rng.permutation(b * max_pages) + 1).reshape(b, max_pages).astype(np.int32)
    q = rng.standard_normal((b, max_q, HEADS, DIM)).astype(np.float32)
    w = rng.standard_normal((b, max_q, HEADS)).astype(np.float32)
    lq, lk = np.asarray(lens_q, np.int32), np.asarray(lens_k, np.int32)
    want = jli.lightning_indexer_scores_prefill_pallas(
        jx(q), jx(w), jx(key), jx(lq), jx(lk), jx(bt), causal=causal, q_chunk=q_chunk)
    got = tli.lightning_indexer_scores_prefill_pallas(
        tt(q), tt(w), tt(key), tt(lq), tt(lk), tt(bt), causal=causal, q_chunk=q_chunk)
    assert got.dtype == torch.float32
    _scores_close(got.numpy(), want)
    assert np.isfinite(np.asarray(want)).any()


def test_prefill_scores_bf16_match_jax_kernel():
    """bf16 queries and keys (the model's index-key cache dtype), f32 weights:
    both sides multiply the same bf16 values exactly in f32."""
    rng = np.random.default_rng(1)
    b, max_q, max_pages = 2, 24, 4
    key = _keys(rng, b * max_pages)
    bt = np.arange(b * max_pages, dtype=np.int32).reshape(b, max_pages)
    q = rng.standard_normal((b, max_q, HEADS, DIM)).astype(np.float32)
    w = rng.standard_normal((b, max_q, HEADS)).astype(np.float32)
    lq, lk = np.asarray([24, 9], np.int32), np.asarray([50, 64], np.int32)
    want = jli.lightning_indexer_scores_prefill_pallas(
        jx(q, jnp.bfloat16), jx(w), jx(key, jnp.bfloat16), jx(lq), jx(lk), jx(bt))
    got = tli.lightning_indexer_scores_prefill_pallas(
        tt(q, torch.bfloat16), tt(w), tt(key, torch.bfloat16), tt(lq), tt(lk), tt(bt))
    _scores_close(got.numpy(), want)


def test_decode_scores_match_jax():
    rng = np.random.default_rng(2)
    b, max_pages = 3, 4
    key = _keys(rng, b * max_pages + 1)
    bt = (np.arange(b * max_pages) + 1).reshape(b, max_pages).astype(np.int32)
    q = rng.standard_normal((b, HEADS, DIM)).astype(np.float32)
    w = rng.standard_normal((b, HEADS)).astype(np.float32)
    lk = np.asarray([1, 33, 64], np.int32)
    want = jli.lightning_indexer_scores_decode(jx(q), jx(key), jx(w), jx(lk), jx(bt))
    got = tli.lightning_indexer_scores_decode(tt(q), tt(key), tt(w), tt(lk), tt(bt))
    _scores_close(got.numpy(), want)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("layout", ["BSND", "TND"])
def test_lightning_indexer_matches_jax(layout, backend):
    """Top-``sparse_count`` indices, ``-1`` past ``min(sparse_count, lens_k)``
    and on pad tokens: equal to JAX's, the causally dead slots included."""
    rng = np.random.default_rng(3)
    b, s1, max_pages, count = 3, 10, 4, 24
    key = _keys(rng, b * max_pages + 1)
    bt = (rng.permutation(b * max_pages) + 1).reshape(b, max_pages).astype(np.int32)
    lens_q = np.asarray([10, 4, 7], np.int32)
    lens_k = np.asarray([40, 12, 64], np.int32)
    if layout == "BSND":
        q = rng.standard_normal((b, s1, HEADS, DIM)).astype(np.float32)
        w = rng.standard_normal((b, s1, HEADS)).astype(np.float32)
        lq = lens_q
    else:
        t = int(lens_q.sum()) + 2                           # two pad tokens
        q = rng.standard_normal((t, HEADS, DIM)).astype(np.float32)
        w = rng.standard_normal((t, HEADS)).astype(np.float32)
        lq = np.cumsum(lens_q).astype(np.int32)
    want = jli.lightning_indexer(jx(q), jx(key), jx(w), jx(lq), jx(lens_k), jx(bt),
                                 layout_query=layout, sparse_count=count, backend=backend,
                                 max_q=s1 if backend == "pallas" else None)
    got = tli.lightning_indexer(tt(q), tt(key), tt(w), tt(lq), tt(lens_k), tt(bt),
                                layout_query=layout, sparse_count=count, backend=backend,
                                max_q=s1 if backend == "pallas" else None)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) == -1).any() and (np.asarray(want) >= 0).any()


def test_lightning_indexer_decode_shape_matches_jax():
    """The model's token-mode decode call: one token a row (BSND, S1 = 1, no
    query lengths), K10 at max_q 1 padded to a chunk of 8; a pad row of
    context 1."""
    rng = np.random.default_rng(4)
    b, max_pages, count = 3, 4, 20
    key = _keys(rng, b * max_pages + 1)
    bt = (np.arange(b * max_pages) + 1).reshape(b, max_pages).astype(np.int32)
    bt[2] = 0
    q = rng.standard_normal((b, 1, HEADS, DIM)).astype(np.float32)
    w = rng.standard_normal((b, 1, HEADS)).astype(np.float32)
    lk = np.asarray([50, 9, 1], np.int32)
    want = jli.lightning_indexer(jx(q), jx(key), jx(w), None, jx(lk), jx(bt), sparse_count=count)
    got = tli.lightning_indexer(tt(q), tt(key), tt(w), None, tt(lk), tt(bt), sparse_count=count)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_prefill_pages_matches_jax():
    """Per-token page scores with dead (-inf) positions: chunks past a
    request's tokens come back all -1, each live chunk's last causal page is
    forced in first, pages no token of the chunk sees are -1."""
    rng = np.random.default_rng(5)
    b, max_q, max_pages, cq, num_sel = 3, 24, 6, 8, 4
    seq = np.asarray([24, 5, 13], np.int32)
    ctx = np.asarray([90, 5, 40], np.int32)
    scores = rng.standard_normal((b, max_q, max_pages)).astype(np.float32)
    for i in range(b):                                  # -inf past each token's causal page
        for t in range(max_q):
            last = (ctx[i] - seq[i] + t) // PAGE
            scores[i, t, last + 1:] = -np.inf
            if t >= seq[i]:
                scores[i, t] = -np.inf
    want = jpf.select_prefill_pages(jx(scores), jx(seq), jx(ctx), cq=cq, page_size=PAGE,
                                    num_sel=num_sel)
    got = tpf.select_prefill_pages(tt(scores), tt(seq), tt(ctx), cq=cq, page_size=PAGE,
                                   num_sel=num_sel)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = np.asarray(want)
    assert (want[1, 1:] == -1).all() and (want == -1).any()
    last_rows = ctx[0] - seq[0] + np.asarray([7, 15, 23])      # each chunk's last row
    np.testing.assert_array_equal(want[0, :, 0], last_rows // PAGE)


@pytest.mark.parametrize("blocks,width", [(256, 4224), (8, 4224), (64, 4224), (3, 80), (1, 8),
                                          (132, 32768), (1, 32768)])
def test_indexer_splits_cover_the_table(blocks, width):
    """K10's key splits, from shapes alone: their chunks cover the table's
    keys, none of the splits is empty, one split where the token tiles
    alone fill ``LI_BLOCKS`` blocks, else splits of at least
    ``LI_MIN_CHUNKS`` chunks (or the whole table) up to that many blocks."""
    cps, splits = tli.indexer_splits(blocks, width)
    chunks = -(-width // tli.LI_CHUNK)
    assert cps * splits >= chunks and cps * (splits - 1) < chunks
    if blocks >= tli.LI_BLOCKS:
        assert splits == 1
    else:
        assert cps >= min(tli.LI_MIN_CHUNKS, chunks)
        assert blocks * splits >= min(tli.LI_BLOCKS, blocks * -(-chunks // tli.LI_MIN_CHUNKS))
