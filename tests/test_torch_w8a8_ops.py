"""Port parity: the W8A8 building blocks — ``quant_per_tensor``,
``quant_matmul`` (K1), ``quant_per_token`` (K5), ``swiglu_quant`` (K7a) and
``models/w8a8.py`` — against the JAX package (its Pallas kernels in interpret
mode) on the same numpy inputs, through the port's plain path on the CPU.

Tolerances, with their reasons:
- ``quant_per_tensor`` and ``quant_matmul``: exact.  The int8 products are
  summed exactly on both sides (int32 / float64) and the epilogue is the same
  sequence of correctly rounded f32 operations, so f32 outputs are equal and
  bf16 outputs equal after the same rounding.
- per-row quant (``quant_per_token``, ``swiglu_quant``, ``quantize_matrix``):
  int8 values within one level (XLA on the CPU may multiply by a reciprocal
  where torch divides, which moves a value at a rounding tie), scales rtol
  1e-6 (``swiglu_quant``'s 2e-6: the SiLU goes through two libraries' exp).
- ``project`` / ``mlp_swiglu``: 1e-2 of the largest output (a one-level flip
  of an activation moves its products by one quantum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np32, tt
from sgl_kernel_npu_tpu.models import w8a8 as jw
from sgl_kernel_npu_tpu.ops import activation as jact
from sgl_kernel_npu_tpu.ops import matmul as jmm
from sgl_kernel_npu_tpu.ops import quant as jq
from sgl_kernel_npu_tpu_torch.models import w8a8 as tw
from sgl_kernel_npu_tpu_torch.ops import activation as tact
from sgl_kernel_npu_tpu_torch.ops import matmul as tmm
from sgl_kernel_npu_tpu_torch.ops import quant as tq
from sgl_kernel_npu_tpu_torch.utils import counters


def _int8(a):
    return np.asarray(a).astype(np.int32)


def _within_one_level(got, want):
    diff = np.abs(_int8(got) - _int8(want))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, (diff.max(), (diff > 0).mean())


def test_quant_per_tensor_exact():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((16, 96)) * 4).astype(np.float32)
    x[0, :4] = [0.025, -0.075, 1e3, -1e3]           # ties at scale 0.05, saturation
    for scale, zp in ((0.05, 0.0), (0.02, 3.0)):
        want = jmm.quant_per_tensor(jnp.asarray(x), scale, zp)
        got = tmm.quant_per_tensor(tt(x), torch.tensor(scale), torch.tensor(zp))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,bias", [(1, False), (1, True), (40, False), (40, True)])
def test_quant_matmul_matches_jax(m, bias):
    """N = 264 (not a multiple of 128: the JAX wrapper pads it), K = 192."""
    rng = np.random.default_rng(m + bias)
    n, k = 264, 192
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (n, k)).astype(np.int8)
    ds = (rng.random(n) / 1000).astype(np.float32)
    b = rng.integers(-1000, 1000, n).astype(np.int32) if bias else None
    counters.reset()
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jmm.quant_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ds),
                                None if b is None else jnp.asarray(b), out_dtype=jdt)
        got = tmm.quant_matmul(tt(x), tt(w), tt(ds), None if b is None else tt(b),
                               out_dtype=tdt)
        assert got.dtype == tdt and got.shape == (m, n)
        np.testing.assert_array_equal(np32(got), np32(want))
    assert counters.read()["quant_matmul"] == 0      # CPU tensors: the plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_per_token_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((12, 320)) * 3).astype(np.float32)
    x[5] = 0.0                                        # zero row: scale clamps to 1e-12
    jx_ = jnp.asarray(x, getattr(jnp, dtype))
    q_j, s_j = jq.quant_per_token(jx_)
    q_t, s_t = tq.quant_per_token(tt(x, getattr(torch, dtype)))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    _within_one_level(q_t.numpy(), q_j)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    assert float(s_t[5]) == pytest.approx(1e-12) and not q_t[5].any()
    deq = tq.dequant_per_token(q_t, s_t, torch.float32)
    np.testing.assert_allclose(deq.numpy(), np32(jq.dequant_per_token(q_j, s_j, jnp.float32)),
                               atol=float(s_t.max()) * 1.01)


@pytest.mark.parametrize("group_list_type,need_quant", [(None, True), (0, True), (1, True),
                                                        (1, False)])
def test_swiglu_quant_matches_jax(group_list_type, need_quant):
    """Rows past the group total are zeros with scale 0; so is an all-zero
    live row (the scale is returned unclamped)."""
    rng = np.random.default_rng(2)
    rows, h = 24, 256
    x = (rng.standard_normal((rows, h)) * 2).astype(np.float32)
    x[3] = 0.0
    counts = np.array([5, 0, 9, 2], np.int32)         # 16 live rows of 24
    gl = None if group_list_type is None else (
        np.cumsum(counts).astype(np.int32) if group_list_type == 0 else counts)
    kw = dict(group_list_type=1 if group_list_type is None else group_list_type,
              need_quant=need_quant)
    out_j, s_j = jact.swiglu_quant(jnp.asarray(x, jnp.bfloat16),
                                   None if gl is None else jnp.asarray(gl), **kw)
    out_t, s_t = tact.swiglu_quant(tt(x, torch.bfloat16), None if gl is None else tt(gl), **kw)
    live = rows if gl is None else int(counts.sum())
    assert s_t.shape == (rows,) and not s_t[live:].any() and float(s_t[3]) == 0.0
    if need_quant:
        assert out_t.dtype == torch.int8
        _within_one_level(out_t.numpy(), out_j)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=2e-6)
        assert not out_t[live:].any() and not out_t[3].any()
    else:
        assert out_t.dtype == torch.bfloat16 and not s_t.any()
        np.testing.assert_allclose(np32(out_t), np32(out_j), rtol=1e-2, atol=1e-2)
        want = np32(jact.swiglu_ref(jnp.asarray(x, jnp.bfloat16)))
        np.testing.assert_allclose(np32(tact.swiglu_ref(tt(x, torch.bfloat16)))[:live],
                                   want[:live], rtol=1e-2, atol=1e-2)


def test_project_and_mlp_swiglu_match_jax():
    """``quantize_matrix``, ``project`` (K5 + K1) and ``mlp_swiglu`` (K5 + K1
    → K7a → K1) on the same weights and inputs as the JAX package."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((9, 128)) * 0.5).astype(np.float32)
    w_gu = (rng.standard_normal((128, 2 * 96)) * 0.1).astype(np.float32)
    w_down = (rng.standard_normal((96, 160)) * 0.1).astype(np.float32)
    for w in (w_gu, w_down):
        (q_j, s_j), (q_t, s_t) = jw.quantize_matrix(jnp.asarray(w)), tw.quantize_matrix(tt(w))
        assert q_t.shape == (w.shape[1], w.shape[0]) and q_t.is_contiguous()
        _within_one_level(q_t.numpy(), q_j)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    # the same quantized weights on both sides
    gu_j, down_j = jw.quantize_matrix(jnp.asarray(w_gu)), jw.quantize_matrix(jnp.asarray(w_down))
    gu_t = tuple(tt(np.asarray(a)) for a in gu_j)
    down_t = tuple(tt(np.asarray(a)) for a in down_j)

    want = np32(jw.project(jnp.asarray(x), gu_j))
    got = tw.project(tt(x), gu_t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=1e-2 * np.abs(want).max())

    want = np32(jw.mlp_swiglu(jnp.asarray(x, jnp.bfloat16), gu_j, down_j, jnp.float32))
    got = tw.mlp_swiglu(tt(x, torch.bfloat16), gu_t, down_t, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (9, 160)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=1e-2 * np.abs(want).max())
