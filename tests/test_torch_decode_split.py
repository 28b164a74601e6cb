"""Port parity: the split design of the paged decode kernel
(``csrc/sinks_attention.cu``: K11a / K11b, K12a / K12b / K12c), in plain
PyTorch.

The kernel cuts each row's keys into splits of ``split`` keys from its window
start, computes each split's (m, l, o) in a block of its own and merges them
in split order.  Two pieces of the port stand for it on the CPU:
``decode_attention.split_plan`` (the splits of each row and their key ranges,
from the context lengths, the window, the block table's keys and the split
size, by torch ops without a host sync; the grid's split count from shapes
alone) and ``paged_decode_split_plain`` (the kernel's algorithm: per-split
(m, l, o) with P rounded to q's dtype for P V and the f32 P in l, the merge in
split order, the sink logit at the merge, the int8 fold).  Both are held to
the JAX kernels (``decode_gqa``, ``attention_sinks``,
``attention_sinks_packed``, in interpret mode on the CPU as
``tests/test_torch_decode_gqa.py`` and ``test_torch_sinks_attention.py``
run them) and to ``paged_decode_plain``, at split sizes 16 and 32 so that
the cases cross several splits.

Cases: contexts 0, 1, the page (16) and the splits (16, 32, 64) and one more;
windows whose first key lies inside a page (37 - 8) or on a page boundary
(40 - 8), shorter than a split, one and a half and exactly two splits long
(splits start at the window's first key, so a window's end is what falls
inside a split or on its boundary); pad rows (ctx 1, a table of zeros);
``sinks=None``; groups 1, 4, 8 and 16; int8 levels with a scalar and a
per-kv-head scale; the packed layout.  A row of context 0 sees no key: the
mirror and the plain version give exactly 0, JAX's ``decode_gqa`` 0 / 0
(NaN), so that row is left out of that one comparison.  Tolerances as the
two files above: f32 within 1e-5 of the output's largest value, 1e-4 where
int8 levels take part (the folded q rounds like JAX's, the sums do not),
bf16 within 2e-2 (P rounded to bf16 on one side only)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops.attention import decode_attention as jd
from sgl_kernel_npu_tpu.ops.attention import sinks_attention as js
from sgl_kernel_npu_tpu_torch.ops.attention import decode_attention as td

PAGE, D, MAX_PAGES = 16, 32, 5        # a block table of 80 keys
SPLITS = (16, 32)
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
INT8_REL = {"f32": 1e-4, "bf16": 2e-2}
CTX = [0, 1, 16, 17, 32, 33, 37, 40, 64, 80]   # then a pad row


def _close(got, want, rel):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=rel * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _case(hq, hkv, int8=False, seed=0, n_pages_max=MAX_PAGES):
    """numpy queries, caches (int8 levels when ``int8``) of permuted pages, a
    block table a row, f32 sinks, contexts ``CTX`` and a pad row last."""
    rng = np.random.default_rng(seed + hq + 3 * hkv + int8)
    ctx = [c for c in CTX if c <= n_pages_max * PAGE]
    b = len(ctx)
    n_pages = b * n_pages_max + 1
    if int8:
        k = rng.integers(-127, 128, (n_pages, hkv, PAGE, D)).astype(np.int8)
        v = rng.integers(-127, 128, (n_pages, hkv, PAGE, D)).astype(np.int8)
    else:
        k = (rng.standard_normal((n_pages, hkv, PAGE, D)) * 0.5).astype(np.float32)
        v = (rng.standard_normal((n_pages, hkv, PAGE, D)) * 0.5).astype(np.float32)
    bt = np.zeros((b + 1, n_pages_max), np.int32)
    bt[:b] = (rng.permutation(n_pages - 1)[: b * n_pages_max] + 1).reshape(b, n_pages_max)
    q = (rng.standard_normal((b + 1, hq * D)) * 0.5).astype(np.float32)
    sinks = rng.standard_normal(hq).astype(np.float32) * 2
    return q, k, v, bt, np.asarray(ctx + [1], np.int32), sinks


def _scales(kind, hkv):
    """(k_scale, v_scale) as numpy: a scalar or one per kv head."""
    if kind == "scalar":
        return np.float32(0.013), np.float32(0.021)
    return (np.linspace(0.011, 0.017, hkv).astype(np.float32),
            np.linspace(0.023, 0.009, hkv).astype(np.float32))


def _port(x, tdt=None):
    return x if np.ndim(x) == 0 else tt(x, tdt)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("window", [0, 8, 24, 32, 40])
def test_split_plan_covers_each_visible_key_once(window, split):
    """Every context 0-200 on a 160-key table: the splits of a row are
    non-empty, cover exactly the keys it sees (its window's, within its
    context and the table) and never outnumber the grid's split count."""
    table_keys = 160
    ctx = torch.arange(0, 201, dtype=torch.int32)
    n_splits, lo, hi, n_live = td.split_plan(ctx, window, table_keys, split)
    assert n_splits == td.split_count(table_keys, window, split)
    assert int(n_live.max()) <= n_splits
    for c, a, b, n in zip(ctx.tolist(), lo.tolist(), hi.tolist(), n_live.tolist()):
        seen = set(range(max(c - window, 0) if window else 0, min(c, table_keys)))
        covered = []
        for j in range(n):
            keys = range(a + j * split, min(a + (j + 1) * split, b))
            assert len(keys) > 0
            covered += keys
        assert sorted(covered) == sorted(seen), (c, a, b, n)


def test_split_plan_needs_no_host_sync():
    """The plan runs on tensors whose values no host can read (the meta
    device): no ``.item()``, ``.cpu()`` or ``nonzero``.  The kernel's split
    size comes from shapes alone: 256 keys, more where a row would need more
    than 16 splits (then a multiple of the 64-key chunk), the same for any
    cache type."""
    ctx = torch.empty(9, dtype=torch.int32, device="meta")
    n_splits, lo, hi, n_live = td.split_plan(ctx, 24, 2048, 256)
    assert n_splits == 1 and n_live.device.type == "meta" and n_live.shape == (9,)
    assert td.decode_split_size(2048, 0) == 256 and td.split_count(2048, 0, 256) == 8
    assert td.decode_split_size(32768, 0) == 2048
    assert td.decode_split_size(2048, 128) == 256 and td.split_count(2048, 128, 256) == 1
    for table_keys in (16, 2048, 8192, 8208, 32768, 131072):
        for window in (0, 128, 4096):
            split = td.decode_split_size(table_keys, window)
            assert split >= td.DECODE_SPLIT and split % td.DECODE_CHUNK == 0
            assert td.split_count(table_keys, window, split) <= td.DECODE_MAX_SPLITS


# ---------------------------------------------------------------------------
# the mirror against JAX and the plain version
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_decode_gqa(dt, hq, hkv, int8=False, scales=None):
    q, k, v, bt, ctx, _ = _case(hq, hkv, int8)
    jdt = DTYPES[dt][0]
    kw = {}
    if scales:
        kw = dict(zip(("k_scale", "v_scale"), (jx(s) for s in _scales(scales, hkv))))
    cdt = None if int8 else jdt
    out = jd.decode_gqa(jx(q.reshape(len(ctx), hq, D), jdt), jx(k, cdt), jx(v, cdt), jx(ctx),
                        0.17, jx(bt), **kw)
    return np32(out).reshape(len(ctx), -1)


@functools.lru_cache(maxsize=None)
def _jax_sinks(dt, window, hq=8, hkv=2, int8=False, scales=None):
    q, k, v, bt, ctx, sinks = _case(hq, hkv, int8)
    jdt = DTYPES[dt][0]
    kw = {}
    if scales:
        kw = dict(zip(("k_scale", "v_scale"), (jx(s) for s in _scales(scales, hkv))))
    cdt = None if int8 else jdt
    return np32(js.attention_sinks(jx(q, jdt), jx(k, cdt), jx(v, cdt), jx(sinks), jx(bt), jx(ctx),
                                   0.17, window, hq, hkv, **kw))


def _mirror(dt, hq, hkv, window, split, *, sinks=True, int8=False, scales=None, hpr=1,
            caches=None):
    q, k, v, bt, ctx, sk = _case(hq, hkv, int8)
    tdt = DTYPES[dt][1]
    cdt = None if int8 else tdt
    kc, vc = caches if caches is not None else (tt(k, cdt), tt(v, cdt))
    sc = {}
    if scales:
        sc = dict(zip(("k_scale", "v_scale"), (_port(s) for s in _scales(scales, hkv))))
    args = (tt(q, tdt), kc, vc, tt(sk) if sinks else None, tt(bt), tt(ctx), 0.17, window, hq, hkv)
    got = td.paged_decode_split_plain(*args, heads_per_row=hpr, split=split, **sc)
    plain = td.paged_decode_plain(*args, heads_per_row=hpr, **sc)
    assert got.dtype == tdt and got.shape == (len(ctx), hq * D)
    assert not got[0].any() and not plain[0].any()       # context 0: exactly 0
    return got, plain


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("hq,hkv", [(2, 2), (8, 2), (16, 2), (32, 2)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_split_mirror_matches_jax_decode_gqa(dt, hq, hkv, split):
    """Groups 1, 4, 8 and 16 without sinks or window: the mirror against
    JAX's ``decode_gqa`` (every row but context 0) and the plain version."""
    rel = DTYPES[dt][2]
    got, plain = _mirror(dt, hq, hkv, 0, split, sinks=False)
    _close(got[1:], _jax_decode_gqa(dt, hq, hkv)[1:], rel)
    _close(got, plain, rel)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("window", [8, 24, 32])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_split_mirror_matches_jax_attention_sinks(dt, window, split):
    """Sinks and a sliding window (shorter than a split, one and a half,
    exactly two at split 16): the mirror against JAX's ``attention_sinks``
    on every row, context 0 included, and the plain version."""
    rel = DTYPES[dt][2]
    got, plain = _mirror(dt, 8, 2, window, split)
    _close(got, _jax_sinks(dt, window), rel)
    _close(got, plain, rel)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("hq", [2, 8, 16, 32])
@pytest.mark.parametrize("window", [0, 8, 24])
def test_split_mirror_without_sinks_matches_plain(window, hq, split):
    """``sinks=None`` with and without a window, groups 1-16, bf16: the
    mirror against the plain version (JAX's sinks kernels take sinks)."""
    got, plain = _mirror("bf16", hq, 2, window, split, sinks=False)
    _close(got, plain, 2e-2)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("scales", ["scalar", "per_head"])
@pytest.mark.parametrize("fn", ["decode_gqa", "attention_sinks"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_split_mirror_int8_matches_jax(dt, fn, scales, split):
    """int8 levels, the scales folded into q (rounded to q's dtype) and the
    output: the mirror against JAX's kernels (their host fold), without a
    sink or window (``decode_gqa``) and with sinks and a window of 24."""
    rel = INT8_REL[dt]
    if fn == "decode_gqa":
        got, plain = _mirror(dt, 8, 2, 0, split, sinks=False, int8=True, scales=scales)
        _close(got[1:], _jax_decode_gqa(dt, 8, 2, True, scales)[1:], rel)
    else:
        got, plain = _mirror(dt, 8, 2, 24, split, int8=True, scales=scales)
        _close(got, _jax_sinks(dt, 24, 8, 2, True, scales), rel)
    _close(got, plain, rel)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_split_mirror_packed_matches_jax(kind, split):
    """The packed layout (``heads_per_row`` 2, 8 q / 4 kv heads on a
    3-page table, full attention; int8 with per-kv-head scales), bf16: the
    mirror against JAX's ``attention_sinks_packed`` (``impl="flat"``, in
    interpret mode) and equal to itself over the cache unpacked."""
    int8 = kind == "int8"
    q, k, v, bt, ctx, sinks = _case(8, 4, int8, seed=1, n_pages_max=3)
    cdt_j, cdt_t = (None, None) if int8 else (jnp.bfloat16, torch.bfloat16)
    sc_j = sc_t = {}
    if int8:
        ks, vs = _scales("per_head", 4)
        sc_j, sc_t = dict(k_scale=jx(ks), v_scale=jx(vs)), dict(k_scale=tt(ks), v_scale=tt(vs))
    pack = lambda c: np.asarray(js.pack_kv_sinks(jx(c)))  # noqa: E731
    want = js.attention_sinks_packed(jx(q, jnp.bfloat16), jx(pack(k), cdt_j), jx(pack(v), cdt_j),
                                     jx(sinks), jx(bt), jx(ctx), 0.17, 0, 8, 4, impl="flat",
                                     **sc_j)
    args = (tt(q, torch.bfloat16), tt(pack(k), cdt_t), tt(pack(v), cdt_t), tt(sinks), tt(bt),
            tt(ctx), 0.17, 0, 8, 4)
    got = td.paged_decode_split_plain(*args, heads_per_row=2, split=split, **sc_t)
    _close(got, want, 2e-2)
    flat = (args[0], tt(k, cdt_t), tt(v, cdt_t)) + args[3:]
    assert torch.equal(got, td.paged_decode_split_plain(*flat, split=split, **sc_t))
