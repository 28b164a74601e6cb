"""Port parity: paged GQA decode (K11a ``decode_gqa``, K11b
``decode_gqa_high_performance``).

The same numpy queries and paged caches go through the JAX package (its
Pallas kernels in interpret mode on the CPU, and its golden) and through the
port's wrappers on CPU tensors, which take the plain version (the wrapper's
fold of the int8 scales into q and the output, as JAX's wrappers fold
them).  Shapes are those of ``tests/test_decode_attention.py`` (Dk ≠ Dv runs
on the plain path here; the card's kernel takes Dk = Dv only), plus a pad
row (ctx 1, a table of zeros).  Tolerances: f32 within 1e-5 of the output's
largest value (f32 sums in another order), 1e-4 where int8 levels take part
(the folded q rounds like JAX's, the sums do not), bf16 within 2e-2 (the JAX
kernels round P to bf16 for P V, the plain version does not)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops.attention import decode_attention as jd
from sgl_kernel_npu_tpu_torch.ops.attention import decode_attention as td

PAGE = 16
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
JAX_REF = jax.jit(jd.decode_gqa_ref, static_argnums=(4,))


def _close(got, want, rel):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=rel * np.abs(want).max())


def _case(rng, hq, hkv, dk, dv, ctx, max_pages=5, int8=False):
    """Queries, caches (int8 levels when ``int8``) of permuted pages, a block
    table per row and a pad row last (ctx 1, table of zeros)."""
    b = len(ctx)
    n_pages = b * max_pages + 1
    if int8:
        k = rng.integers(-127, 128, (n_pages, hkv, PAGE, dk)).astype(np.int8)
        v = rng.integers(-127, 128, (n_pages, hkv, PAGE, dv)).astype(np.int8)
    else:
        k = (rng.standard_normal((n_pages, hkv, PAGE, dk)) * 0.5).astype(np.float32)
        v = (rng.standard_normal((n_pages, hkv, PAGE, dv)) * 0.5).astype(np.float32)
    bt = np.zeros((b + 1, max_pages), np.int32)
    bt[:b] = (rng.permutation(n_pages - 1)[: b * max_pages] + 1).reshape(b, max_pages)
    q = (rng.standard_normal((b + 1, hq, dk)) * 0.5).astype(np.float32)
    return q, k, v, bt, np.asarray(list(ctx) + [1], np.int32)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,dk,dv", [(8, 2, 128, 128), (16, 16, 64, 64), (4, 1, 576, 512),
                                          (32, 2, 32, 32)])
def test_decode_gqa_matches_jax(hq, hkv, dk, dv, dt):
    """Contexts 7 and 77 (the JAX test's), 1 and 16, and a pad row; a group
    of 16 at head_dim 32 (the JAX config's width)."""
    jdt, tdt, rel = DTYPES[dt]
    rng = np.random.default_rng(hq + dk + len(dt))
    q, k, v, bt, ctx = _case(rng, hq, hkv, dk, dv, [7, 77, 1, 16])
    scale = 1.0 / np.sqrt(dk)
    args_j = (jx(q, jdt), jx(k, jdt), jx(v, jdt), jx(ctx), scale, jx(bt))
    args_t = (tt(q, tdt), tt(k, tdt), tt(v, tdt), tt(ctx), scale, tt(bt))
    want = jd.decode_gqa(*args_j)
    got = td.decode_gqa(*args_t)
    assert got.dtype == tdt and got.shape == (q.shape[0], hq, dv)
    _close(got, want, rel)
    _close(td.decode_gqa_ref(*args_t), JAX_REF(*args_j), rel)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv", [(8, 2), (16, 16)])
def test_decode_gqa_high_performance_matches_jax(hq, hkv, dt):
    """K11b (JAX's flat page walk, in interpret mode) against the port's,
    which is K11a's function: contexts 9 and 61 (the JAX test's)."""
    jdt, tdt, rel = DTYPES[dt]
    rng = np.random.default_rng(hq + hkv)
    q, k, v, bt, ctx = _case(rng, hq, hkv, 128, 128, [9, 61])
    args_j = (jx(q, jdt), jx(k, jdt), jx(v, jdt), jx(ctx), 0.09, jx(bt))
    args_t = (tt(q, tdt), tt(k, tdt), tt(v, tdt), tt(ctx), 0.09, tt(bt))
    want = jd.decode_gqa_high_performance(*args_j)
    got = td.decode_gqa_high_performance(*args_t)
    _close(got, want, rel)
    _close(got, td.decode_gqa(*args_t), 0)


@pytest.mark.parametrize("dt,rel", [("f32", 1e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("fn,scales", [("decode_gqa", "scalar"), ("decode_gqa", "per_head"),
                                       ("decode_gqa_high_performance", "per_head")])
def test_decode_gqa_int8_matches_jax(fn, scales, dt, rel):
    """int8 K / V levels with a scalar or per-kv-head scale: the wrappers
    (fold) against JAX's, and the goldens (dequantize) against JAX's."""
    jdt, tdt, _ = DTYPES[dt]
    rng = np.random.default_rng(len(fn) + len(scales) + len(dt))
    hq, hkv = 8, 2
    q, k, v, bt, ctx = _case(rng, hq, hkv, 128, 128, [5, 40, 70], int8=True)
    if scales == "scalar":
        ks, vs = 0.013, 0.021
    else:
        ks = np.asarray([0.011, 0.017], np.float32)
        vs = np.asarray([0.023, 0.009], np.float32)
    sc = {"k_scale": ks, "v_scale": vs}
    args_j = (jx(q, jdt), jx(k), jx(v), jx(ctx), 0.09, jx(bt))
    args_t = (tt(q, tdt), tt(k), tt(v), tt(ctx), 0.09, tt(bt))
    sc_j = {n: s if np.isscalar(s) else jx(s) for n, s in sc.items()}
    sc_t = {n: s if np.isscalar(s) else tt(s) for n, s in sc.items()}
    want = getattr(jd, fn)(*args_j, **sc_j)
    got = getattr(td, fn)(*args_t, **sc_t)
    assert got.dtype == tdt
    _close(got, want, rel)
    _close(td.decode_gqa_ref(*args_t, **sc_t), JAX_REF(*args_j, **sc_j), rel)


def test_plain_folds_where_golden_dequantizes():
    """On an int8 cache the plain version (q · k_scale rounded to q's dtype,
    levels, out · v_scale) and the golden (levels · scale) agree within bf16
    rounding, and exactly on a float cache."""
    rng = np.random.default_rng(3)
    q, k, v, bt, ctx = _case(rng, 8, 2, 64, 64, [3, 50], int8=True)
    args = (tt(q, torch.bfloat16), tt(k), tt(v), tt(ctx), 0.125, tt(bt))
    sc = dict(k_scale=tt(np.asarray([0.02, 0.03], np.float32)), v_scale=0.01)
    _close(td.decode_gqa_plain(*args, **sc), td.decode_gqa_ref(*args, **sc), 2e-2)
    fl = (args[0], args[1].float() * 0.02, args[2].float() * 0.01) + args[3:]
    assert torch.equal(td.decode_gqa_plain(*fl), td.decode_gqa_ref(*fl))
