"""Port parity: RMSNorm (K6a) and GPT-OSS's clamped SwiGLU (K7b).

The same numpy inputs go through the JAX package's Pallas kernels (interpret
mode on the CPU) and through the port's wrappers on CPU tensors (their plain
versions).  Tolerances: f32 within 1e-5 of the output's largest value (f32
sums in another order); bf16 within 2e-2 of it (both round the f32 result
once to bf16: one ulp, 2^-8 relative, apart at a rounding boundary)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops import activation as ja
from sgl_kernel_npu_tpu.ops import norm as jn
from sgl_kernel_npu_tpu_torch.ops import activation as ta
from sgl_kernel_npu_tpu_torch.ops import norm as tn

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
    before = (tn.rms_norm.launches, ta.swiglu_oai.launches)
    x = torch.randn(3, 16)
    torch.testing.assert_close(tn.rms_norm(x, torch.ones(16)), tn.rms_norm_ref(x, torch.ones(16)))
    torch.testing.assert_close(ta.swiglu_oai(x), ta.swiglu_oai_ref(x))
    assert (tn.rms_norm.launches, ta.swiglu_oai.launches) == before
