"""Port parity: RMSNorm (K6a), its fused variants (K6b add_rms_norm_bias,
K6c add_gemma_rms_norm, K6d l1_norm) and GPT-OSS's clamped SwiGLU (K7b).

The same numpy inputs go through the JAX package's Pallas kernels (interpret
mode on the CPU) and through the port's wrappers on CPU tensors (their plain
versions).  Tolerances: f32 within 1e-5 of the output's largest value (f32
sums in another order); bf16 within 2e-2 of it (both round the f32 result
once to bf16: one ulp, 2^-8 relative, apart at a rounding boundary); the
residual sums bit-equal (one addition, rounded once); int8 outputs within
one level (the f32 rsqrt of the two libraries may differ by an ulp, which
moves a value at a rounding tie).

``add_rms_norm_rows_plain`` (K6b / K6c's order of operations on the CUDA
kernel's plan, which the kernel matches bit for bit on the card) is held to
the plain versions within one ulp of the output's largest value in bf16
(1e-5 of it in f32: its sum of squares runs in another order) or one int8
level on 99 % equal, to JAX's functions at the tolerances above, and to
K6a's order (``rms_norm_rows_plain``) bit for bit.  ``l1_norm_rows_plain``
(K6d's order on its plan) is held to ``l1_norm_ref`` and to JAX's
``l1_norm`` within 1e-5 of the output's largest value (the signed sum in
another order), and to a numpy f32 butterfly bit for bit."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops import activation as ja
from sgl_kernel_npu_tpu.ops import norm as jn
from sgl_kernel_npu_tpu_torch.ops import activation as ta
from sgl_kernel_npu_tpu_torch.ops import norm as tn
from sgl_kernel_npu_tpu_torch.ops import row_reduce as rr

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _close(got, want, rel):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("hidden", [2880, 256])
@pytest.mark.parametrize("rows", [1, 7, 64])
def test_rms_norm_matches_jax(rows, hidden, dt):
    jdt, tdt, rel = DTYPES[dt]
    rng = np.random.default_rng(rows * 7 + hidden)
    x = (rng.standard_normal((rows, hidden)) * 3).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)
    want = jn.rms_norm(jx(x, jdt), jx(w, jdt), 1e-5)
    got = tn.rms_norm(tt(x, tdt), tt(w, tdt), 1e-5)
    assert got.dtype == tdt and got.shape == (rows, hidden)
    _close(got, want, rel)
    _close(tn.rms_norm_ref(tt(x, tdt), tt(w, tdt), 1e-5), jn.rms_norm_ref(jx(x, jdt), jx(w, jdt),
                                                                          1e-5), rel)


def _vectors(rng, hidden):
    w = (1 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)
    b = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    return w, b


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("rows,hidden", [(1, 256), (9, 4096), (40, 100)])
def test_add_rms_norm_bias_matches_jax(rows, hidden, quant, dt):
    """K6b: the normed output (int8 with a static per-channel scale and
    offset) and the residual sum.  In bf16, XLA on the CPU keeps ``x +
    residual`` in f32 inside its fused computation (excess precision) where
    the kernel's ``astype`` rounds it to bf16, as the port does: int8 levels
    then differ by one at a few percent of the elements (in f32 at under 1 %)."""
    jdt, tdt, rel = DTYPES[dt]
    rng = np.random.default_rng(rows + hidden)
    x = (rng.standard_normal((rows, hidden)) * 2).astype(np.float32)
    res = rng.standard_normal((rows, hidden)).astype(np.float32)
    w, b = _vectors(rng, hidden)
    qj, qt = {}, {}
    if quant:
        qs = rng.uniform(60, 100, hidden).astype(np.float32)
        qo = rng.uniform(-3, 3, hidden).astype(np.float32)
        qj = {"quant_scale": jx(qs), "quant_offset": jx(qo)}
        qt = {"quant_scale": tt(qs), "quant_offset": tt(qo)}
    oj, aj = jn.add_rms_norm_bias(jx(x, jdt), jx(res, jdt), jx(w, jdt), jx(b, jdt), 1e-5, **qj)
    ot, at = tn.add_rms_norm_bias(tt(x, tdt), tt(res, tdt), tt(w, tdt), tt(b, tdt), 1e-5, **qt)
    np.testing.assert_array_equal(np32(at), np32(aj))
    assert at.dtype == tdt and ot.dtype == (torch.int8 if quant else tdt)
    if quant:
        diff = np.abs(ot.numpy().astype(np.int32) - np.asarray(oj).astype(np.int32))
        assert diff.max() <= 1 and (dt == "bf16" or (diff == 0).mean() > 0.99)
        assert ot.numpy().min() == -128 and ot.numpy().max() == 127    # both ends saturate
    else:
        _close(ot, oj, rel)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rows,hidden", [(1, 256), (9, 4096), (40, 100)])
def test_add_gemma_rms_norm_matches_jax(rows, hidden, dt):
    """K6c: RMSNorm of the residual sum scaled by ``w + 1``, and the sum."""
    jdt, tdt, rel = DTYPES[dt]
    rng = np.random.default_rng(rows * 3 + hidden)
    x = (rng.standard_normal((rows, hidden)) * 2).astype(np.float32)
    res = rng.standard_normal((rows, hidden)).astype(np.float32)
    w = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    nj, aj = jn.add_gemma_rms_norm(jx(x, jdt), jx(w, jdt), jx(res, jdt), 1e-5)
    nt, at = tn.add_gemma_rms_norm(tt(x, tdt), tt(w, tdt), tt(res, tdt), 1e-5)
    assert nt.dtype == at.dtype == tdt
    np.testing.assert_array_equal(np32(at), np32(aj))
    _close(nt, nj, rel)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rows,hidden", [(1, 256), (9, 4096), (40, 100)])
def test_l1_norm_matches_jax(rows, hidden, dt):
    """K6d: each row over its signed sum (negative values in every row, one
    row whose sum is negative), f32 out from either input type."""
    jdt, tdt, _ = DTYPES[dt]
    rng = np.random.default_rng(rows + 5 * hidden)
    x = (rng.standard_normal((rows, hidden)) + 0.5).astype(np.float32)
    x[0] -= 1.0                                     # a row of negative sum
    want = jn.l1_norm(jx(x, jdt))
    got = tn.l1_norm(tt(x, tdt))
    assert got.dtype == torch.float32 and float(tt(x).sum(-1)[0]) < 0
    _close(got, want, 1e-5)
    _close(tn.l1_norm_ref(tt(x, tdt)), jn.l1_norm_ref(jx(x, jdt)), 1e-5)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rows,inter", [(1, 64), (9, 2880), (40, 96)])
def test_swiglu_oai_matches_jax(rows, inter, dt):
    """Interleaved gate / up with values past ±limit (N(0, 5²) inputs against
    limit 7), at GPT-OSS's alpha 1.702 and limit 7 and at other ones."""
    jdt, tdt, rel = DTYPES[dt]
    rng = np.random.default_rng(rows + inter)
    x = (rng.standard_normal((rows, 2 * inter)) * 5).astype(np.float32)
    assert (np.abs(x) > 7).any()
    for alpha, limit in ((1.702, 7.0), (1.0, 3.0)):
        want = ja.swiglu_oai(jx(x, jdt), alpha, limit)
        got = ta.swiglu_oai(tt(x, tdt), alpha, limit)
        assert got.dtype == tdt and got.shape == (rows, inter)
        _close(got, want, rel)
        _close(ta.swiglu_oai_ref(tt(x, tdt), alpha, limit),
               ja.swiglu_oai_ref(jx(x, jdt), alpha, limit), rel)


def test_cpu_wrappers_count_no_launch():
    """On CPU tensors the wrappers take their plain versions and count
    nothing: a launch is counted only where a CUDA kernel runs."""
    wrappers = (tn.rms_norm, ta.swiglu_oai, tn.add_rms_norm_bias, tn.add_gemma_rms_norm,
                tn.l1_norm)
    before = [f.launches for f in wrappers]
    x = torch.randn(3, 16)
    w = torch.ones(16)
    torch.testing.assert_close(tn.rms_norm(x, w), tn.rms_norm_ref(x, w))
    torch.testing.assert_close(ta.swiglu_oai(x), ta.swiglu_oai_ref(x))
    torch.testing.assert_close(tn.add_rms_norm_bias(x, x, w, w), tn.add_rms_norm_bias_ref(
        x, x, w, w, 1e-6))
    torch.testing.assert_close(tn.add_gemma_rms_norm(x, w, x), tn.add_gemma_rms_norm_ref(
        x, w, x, 1e-6))
    torch.testing.assert_close(tn.l1_norm(x), tn.l1_norm_ref(x))
    assert [f.launches for f in wrappers] == before


SMS = 132   # the H100's SMs
MODES = ("bias", "quant", "gemma")


def _add_inputs(rows, hidden, x_dt, w_dt, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, hidden)) * 2).astype(np.float32)
    res = rng.standard_normal((rows, hidden)).astype(np.float32)
    w, b = _vectors(rng, hidden)
    qs = rng.uniform(60, 100, hidden).astype(np.float32)
    qo = rng.uniform(-3, 3, hidden).astype(np.float32)
    return tt(x, x_dt), tt(res, x_dt), tt(w, w_dt), tt(b, w_dt), tt(qs), tt(qo)


def _mirror(x, res, w, b, qs, qo, mode, plan=None):
    plan = plan or rr._row_plan(x.shape[0], x.shape[1], x.element_size(), SMS, inputs=2)
    q = (qs, qo) if mode == "quant" else (None, None)
    return tn.add_rms_norm_rows_plain(x, res, w, None if mode == "gemma" else b, *q, mode, 1e-5,
                                      plan)


# one plan for each cluster size (8 at decode, 1 with four rows a block at
# 512), one block of one vector a thread ([8, 4096]), and the element path
ADD_SHAPES = [(8, 32768), (8, 16384), (512, 4096), (8, 4096), (7, 100), (3, 4097)]
ADD_TYPES = {"bf16": (torch.bfloat16, torch.bfloat16), "f32": (torch.float32, torch.float32),
             "bf16-x f32-w": (torch.bfloat16, torch.float32)}


@pytest.mark.parametrize("types", sorted(ADD_TYPES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows,hidden", ADD_SHAPES)
def test_add_rms_norm_rows_plain_matches_ref(rows, hidden, mode, types):
    """The mirror against ``add_rms_norm_bias_ref`` / ``add_gemma_rms_norm_ref``:
    ``added`` bit-equal; the output within one ulp of x's type of its largest
    value (1e-5 of it in f32), int8 within one level and equal on 99 %."""
    x_dt, w_dt = ADD_TYPES[types]
    x, res, w, b, qs, qo = _add_inputs(rows, hidden, x_dt, w_dt, rows * 3 + hidden)
    got, added = _mirror(x, res, w, b, qs, qo, mode)
    if mode == "gemma":
        want, want_added = tn.add_gemma_rms_norm_ref(x, w, res, 1e-5)
    else:
        q = {"quant_scale": qs, "quant_offset": qo} if mode == "quant" else {}
        want, want_added = tn.add_rms_norm_bias_ref(x, res, w, b, 1e-5, **q)
    assert torch.equal(added, want_added) and got.dtype == want.dtype
    if mode == "quant":
        diff = (got.int() - want.int()).abs()
        assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) > 0.99
    else:
        scale = float(want.float().abs().max())
        tol = 2.0 ** (math.floor(math.log2(scale)) - 7) if x_dt == torch.bfloat16 else 1e-5 * scale
        assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows,hidden", [(9, 4096), (40, 100)])
def test_add_rms_norm_rows_plain_matches_jax(rows, hidden, mode, dt):
    """The mirror against JAX's ``add_rms_norm_bias`` (its Pallas kernel in
    interpret mode; with and without the quant) and ``add_gemma_rms_norm`` on
    the same numpy inputs, at ``test_add_rms_norm_bias_matches_jax``'s
    tolerances."""
    jdt, tdt, rel = DTYPES[dt]
    rng = np.random.default_rng(rows + 7 * hidden)
    x = (rng.standard_normal((rows, hidden)) * 2).astype(np.float32)
    res = rng.standard_normal((rows, hidden)).astype(np.float32)
    w, b = _vectors(rng, hidden)
    qs = rng.uniform(60, 100, hidden).astype(np.float32)
    qo = rng.uniform(-3, 3, hidden).astype(np.float32)
    if mode == "gemma":
        oj, aj = jn.add_gemma_rms_norm(jx(x, jdt), jx(w, jdt), jx(res, jdt), 1e-5)
    else:
        qj = {"quant_scale": jx(qs), "quant_offset": jx(qo)} if mode == "quant" else {}
        oj, aj = jn.add_rms_norm_bias(jx(x, jdt), jx(res, jdt), jx(w, jdt), jx(b, jdt), 1e-5,
                                      **qj)
    ot, at = _mirror(tt(x, tdt), tt(res, tdt), tt(w, tdt), tt(b, tdt), tt(qs), tt(qo), mode)
    np.testing.assert_array_equal(np32(at), np32(aj))
    if mode == "quant":
        diff = np.abs(ot.numpy().astype(np.int32) - np.asarray(oj).astype(np.int32))
        assert diff.max() <= 1 and (dt == "bf16" or (diff == 0).mean() > 0.99)
    else:
        _close(ot, oj, rel)


def test_add_rms_norm_rows_plain_order():
    """The mirror's sum runs in K6a's order: in the Gemma mode with w = 0 (a
    scale of w + 1 = 1) its output is ``rms_norm_rows_plain`` of ``added``
    bit for bit on the same plan, for a one-warp butterfly (checked against
    numpy f32) and clusters of 1 and 8; a permuted order (another plan)
    changes the bits."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 32)) * 3).astype(np.float32)
    r = rng.standard_normal((4, 32)).astype(np.float32)
    a = x + r
    v = a * a
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, np.arange(32) ^ o]
    s = np.float32(1) / np.sqrt(v[:, 0] / np.float32(32) + np.float32(1e-5))
    got, _ = tn.add_rms_norm_rows_plain(tt(x), tt(r), torch.zeros(32), None, None, None, "gemma",
                                        1e-5, rr.RowPlan(1, 32, 1, 1))
    assert np.array_equal(got.numpy(), a * s[:, None])
    x, res, w, b, qs, qo = _add_inputs(4, 4096, torch.bfloat16, torch.bfloat16, 11)
    zero = torch.zeros(4096, dtype=torch.bfloat16)
    outs = []
    for c in (1, 8):
        plan = rr.RowPlan(c, 32, 4096 // (8 * 32 * c), 8)
        got, added = _mirror(x, res, zero, b, qs, qo, "gemma", plan)
        assert torch.equal(got, tn.rms_norm_rows_plain(added, torch.ones(4096), 1e-5, plan))
        outs.append(_mirror(x.float(), res.float(), zero.float(), b, qs, qo, "gemma", plan)[0])
    assert not torch.equal(outs[0], outs[1])


# K6d's plans: clusters of 8, 4 and 2 blocks a row at decode, two rows a
# block at chunk sizes, one block a row at [8, 4096], the element path
L1_SHAPES = [(8, 32768), (8, 16384), (100, 16384), (512, 4096), (8, 4096), (7, 100), (3, 4097)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rows,hidden", L1_SHAPES)
def test_l1_norm_rows_plain_matches_ref(rows, hidden, dt):
    """K6d's mirror on the launch's plan against ``l1_norm_ref``: f32 out,
    within 1e-5 of the largest value (a row of negative sum included)."""
    tdt = DTYPES[dt][1]
    rng = np.random.default_rng(rows * 7 + hidden)
    x = (rng.standard_normal((rows, hidden)) + 0.5).astype(np.float32)
    x[0] -= 1.0
    xt = tt(x, tdt)
    got = tn.l1_norm_rows_plain(xt, rr.l1_plan(rows, hidden, SMS))
    want = tn.l1_norm_ref(xt)
    assert got.dtype == torch.float32 and float(xt.float().sum(-1)[0]) < 0
    _close(got, want, 1e-5)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rows,hidden", [(1, 256), (9, 4096), (40, 100)])
def test_l1_norm_rows_plain_matches_jax(rows, hidden, dt):
    """K6d's mirror against JAX's ``l1_norm`` (its Pallas kernel in interpret
    mode) on the same numpy inputs, within 1e-5 of the largest value."""
    jdt, tdt, _ = DTYPES[dt]
    rng = np.random.default_rng(rows + 5 * hidden)
    x = (rng.standard_normal((rows, hidden)) + 0.5).astype(np.float32)
    x[0] -= 1.0
    xt = tt(x, tdt)
    got = tn.l1_norm_rows_plain(xt, rr.l1_plan(rows, hidden, SMS))
    _close(got, jn.l1_norm(jx(x, jdt)), 1e-5)


def test_l1_norm_rows_plain_order():
    """The mirror's signed sum runs in K6a's order: one warp of one element a
    lane adds by butterfly (checked against numpy f32, then x / sum), and
    another plan (a cluster of 8) changes the bits; a row summing to 0
    gives ±inf or NaN, as the reference."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 32)).astype(np.float32) + np.float32(0.5)
    v = x.copy()
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, np.arange(32) ^ o]
    got = tn.l1_norm_rows_plain(torch.from_numpy(x), rr.RowPlan(1, 32, 1, 1))
    assert np.array_equal(got.numpy(), x / v[:, :1])
    xl = torch.from_numpy(rng.standard_normal((4, 4096)).astype(np.float32) + np.float32(0.5))
    outs = [tn.l1_norm_rows_plain(xl, rr.RowPlan(c, 32, 4096 // (32 * c), 1)) for c in (1, 8)]
    assert not torch.equal(outs[0], outs[1])
    z = torch.tensor([[1.0, -1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    out = tn.l1_norm_rows_plain(z, rr.RowPlan(1, 32, 1, 1))
    assert torch.isinf(out[0, :2]).all() and torch.isnan(out[1]).all()
    ref = tn.l1_norm_ref(z)
    assert torch.isinf(ref[0, :2]).all() and torch.isnan(ref[1]).all()
