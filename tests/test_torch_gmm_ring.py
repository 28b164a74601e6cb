"""Port parity: the W8A8 ring GEMMs (K3 ``gmm1_ring``, on int8 and on float
tokens, and K4 ``gmm2_combine_ring``).

Mirrors tests/test_gmm_ring.py: the JAX kernels run in Pallas interpret mode,
the port takes its plain path on CPU tensors.  Tolerances: int8 outputs
within 1 LSB (round-half-even at a boundary can flip with the order of the
float ops); scales rtol 1e-5; the combine rtol 2e-2 with atol 2e-2 x max|ref|
— the JAX kernel rounds each expert output to bf16 before the f32 weighting,
the port keeps f32."""

import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops import gmm_ring as jring
from sgl_kernel_npu_tpu.ops.grouped_matmul import pack_gmm1_scales as jpack_s
from sgl_kernel_npu_tpu.ops.grouped_matmul import pack_gmm1_weights as jpack_w
from sgl_kernel_npu_tpu_torch.ops import gmm_ring as tring
from sgl_kernel_npu_tpu_torch.ops.grouped_matmul import pack_gmm1_scales, pack_gmm1_weights
from sgl_kernel_npu_tpu_torch.ops.quant import quant_per_token_ref


def _gmm1_inputs(rng, n_tok, k, n, g, s):
    xq = rng.integers(-30, 30, (n_tok, k)).astype(np.int8)
    tok = rng.integers(0, n_tok, s).astype(np.int32)
    wg = rng.integers(-20, 20, (g, k, n // 2)).astype(np.int8)
    wu = rng.integers(-20, 20, (g, k, n // 2)).astype(np.int8)
    sg = (rng.random((g, n // 2)) / 50).astype(np.float32)
    su = (rng.random((g, n // 2)) / 50).astype(np.float32)
    w1 = np.asarray(jpack_w(jx(wg), jx(wu), n))
    sw = np.asarray(jpack_s(jx(sg), jx(su), n))
    # the port packs to the same layout
    np.testing.assert_array_equal(pack_gmm1_weights(tt(wg), tt(wu), n).numpy(), w1)
    np.testing.assert_array_equal(pack_gmm1_scales(tt(sg), tt(su), n).numpy(), sw)
    sx_tok = (rng.random(n_tok) / 10).astype(np.float32)
    return xq, tok, w1, sx_tok, sw


def _check_gmm1(xq, tok, w1, gs, sx_tok, sw, **jax_kw):
    total = int(np.sum(gs))
    h1_j, hs_j = jring.gmm1_ring(jx(xq), jx(tok), jx(w1), jx(gs), jx(sx_tok), jx(sw),
                                 **jax_kw)
    h1_t, hs_t = tring.gmm1_ring(tt(xq), tt(tok), tt(w1), tt(gs), tt(sx_tok), tt(sw))
    h1_j, h1_t = np.asarray(h1_j, np.int32), h1_t.numpy().astype(np.int32)
    assert h1_t.shape == h1_j.shape and hs_t.shape == hs_j.shape
    np.testing.assert_allclose(h1_t[:total], h1_j[:total], atol=1)
    np.testing.assert_allclose(np32(hs_t)[:total], np32(hs_j)[:total], rtol=1e-5)
    assert np.all(h1_t[total:] == 0) and np.all(np32(hs_t)[total:] == 0)


def _check_gmm2(x, w2, gs, sx, sw, dest, topw, init, **jax_kw):
    want = np32(jring.gmm2_combine_ring(
        jx(x), jx(w2), jx(gs), jx(sx), jx(sw), jx(dest), jx(topw),
        init=None if init is None else jx(init), **jax_kw))
    got = np32(tring.gmm2_combine_ring(
        tt(x), tt(w2), tt(gs), tt(sx), tt(sw), tt(dest), tt(topw),
        init=None if init is None else tt(init)))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * float(np.abs(want).max()))


@pytest.mark.parametrize("sizes", [(128, 128, 128, 128), (96, 0, 200, 40)])
def test_gmm1_ring_matches_jax(sizes):
    """Mirror of test_gmm_ring.py::test_gmm1_ring_vs_golden: full and ragged
    groups with a zero group, capacity past the groups' total."""
    rng = np.random.default_rng(7)
    xq, tok, w1, sx_tok, sw = _gmm1_inputs(rng, 32, 256, 512, 4, 512)
    _check_gmm1(xq, tok, w1, np.asarray(sizes, np.int32), sx_tok, sw, tm=128, tk=128,
                ring=3)


@pytest.mark.parametrize("sizes,use_init", [((128, 128, 128, 128), False),
                                            ((64, 0, 250, 30), True)])
def test_gmm2_combine_ring_matches_jax(sizes, use_init):
    """Mirror of test_gmm_ring.py::test_gmm2_combine_ring_vs_golden, with the
    residual init; dest rows outside every group contribute nothing."""
    rng = np.random.default_rng(7)
    n_tok, k, n, g, ktop, s = 32, 256, 512, 4, 8, 512
    x = rng.integers(-30, 30, (s, k)).astype(np.int8)
    w2 = rng.integers(-20, 20, (g, k, n)).astype(np.int8)
    sx = (rng.random(s) / 10).astype(np.float32)
    sw = (rng.random((g, n)) / 50).astype(np.float32)
    dest = rng.permutation(s)[: n_tok * ktop].reshape(n_tok, ktop).astype(np.int32)
    init = rng.standard_normal((n_tok, n)).astype(np.float32) if use_init else None
    topw = rng.random((n_tok, ktop)).astype(np.float32)
    _check_gmm2(x, w2, np.asarray(sizes, np.int32), sx, sw, dest, topw, init, tm=128,
                tn=256, ring=3)


def test_ring_kernels_rows_below_one_tile():
    """Mirror of test_gmm_ring.py::test_ring_kernels_row_count_below_tile:
    16 rows (far below the TPU's 128-row tile), a zero group, and the
    decode-shaped chain GMM1 → GMM2 through the port's own outputs."""
    rng = np.random.default_rng(7)
    n_tok, k, n, g, ktop = 8, 256, 512, 4, 2
    s = n_tok * ktop
    gs = np.asarray([5, 0, 7, 4], np.int32)
    xq, tok, w1, sx_tok, sw = _gmm1_inputs(rng, n_tok, k, n, g, s)
    _check_gmm1(xq, tok, w1, gs, sx_tok, sw, tm=128, ring=3)

    w2 = rng.integers(-20, 20, (g, k, n)).astype(np.int8)
    sw2 = (rng.random((g, n)) / 50).astype(np.float32)
    x2 = rng.integers(-30, 30, (s, k)).astype(np.int8)
    sx2 = (rng.random(s) / 10).astype(np.float32)
    dest = rng.permutation(s).reshape(n_tok, ktop).astype(np.int32)
    topw = rng.random((n_tok, ktop)).astype(np.float32)
    _check_gmm2(x2, w2, gs, sx2, sw2, dest, topw, None, tm=128, ring=3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gmm1_ring_float_input_matches_jax(dtype):
    """The in-kernel quant mode (float tokens, ``scale_x_tok`` None) against
    JAX's kernel in interpret mode: each token quantized once (amax / 127,
    true division, half to even), then the int8 GMM1; a zero group and
    capacity past the total."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    _, tok, w1, _, sw = _gmm1_inputs(rng, 16, 256, 512, 4, 96)
    x = rng.standard_normal((16, 256)).astype(np.float32)
    gs = np.asarray([30, 0, 41, 10], np.int32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    h1_j, hs_j = jring.gmm1_ring(jx(x, jdt), jx(tok), jx(w1), jx(gs), None, jx(sw), tm=128,
                                 ring=3)
    h1_t, hs_t = tring.gmm1_ring(tt(x, tdt), tt(tok), tt(w1), tt(gs), None, tt(sw))
    total = int(gs.sum())
    diff = np.abs(h1_t.numpy().astype(np.int32) - np.asarray(h1_j, np.int32))
    assert diff[:total].max() <= 1 and (diff == 0).mean() > 0.99
    np.testing.assert_allclose(np32(hs_t)[:total], np32(hs_j)[:total], rtol=1e-5)
    assert not h1_t[total:].any() and not hs_t[total:].any()
    assert tring.gmm1_ring.launches == 0


def test_gmm1_ring_float_input_is_quant_then_int8():
    """Float tokens give, bit for bit, ``quant_per_token`` (K5's plain
    version) followed by the int8 mode; the scale argument is ignored."""
    rng = np.random.default_rng(10)
    _, tok, w1, _, sw = _gmm1_inputs(rng, 8, 128, 256, 3, 40)
    x = tt(rng.standard_normal((8, 128)).astype(np.float32), torch.bfloat16)
    gs = tt(np.asarray([12, 20, 0], np.int32))
    xq, sx = quant_per_token_ref(x)
    want = tring.gmm1_ring(xq, tt(tok), tt(w1), gs, sx, tt(sw))
    for scale in (None, torch.full((8,), 7.0)):
        got = tring.gmm1_ring(x, tt(tok), tt(w1), gs, scale, tt(sw))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_pad_token_rows_read_as_zero():
    """A sorted row whose token id is n_tok (the TPU wrapper's pad id) reads
    as a zero row: zero activation, zero int8 row."""
    rng = np.random.default_rng(3)
    xq, tok, w1, sx_tok, sw = _gmm1_inputs(rng, 4, 128, 256, 2, 6)
    tok[2] = 4
    h1, hs = tring.gmm1_ring(tt(xq), tt(tok), tt(w1), tt(np.asarray([3, 3], np.int32)),
                             tt(sx_tok), tt(sw))
    assert np.all(h1.numpy()[2] == 0)
    assert float(hs[2]) == pytest.approx(1e-12)
