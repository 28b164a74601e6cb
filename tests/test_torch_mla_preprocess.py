"""Port parity: the fused W8A8 MLA prologue ``mla_preprocess`` against the
JAX package's (its ``quant_matmul`` in Pallas interpret mode), on the inputs
of ``tests/test_mla_preprocess.py`` cut to hidden 256 and 4 heads.

Both ``wdqkv`` widths run: 2112 channels as made, and 2176 after
``pad_weights_lane_aligned``.  Tolerance, of each output's largest value:
1e-5 for f32 hidden states (the same f32 operations on both sides; the
norms' rsqrt and the einsum's summation order differ by ulps), 2e-2 for bf16
(the norms, the rope and the outputs round to bf16 on both sides, and a bf16
ulp moved across a rounding tie of the static quant moves a GEMM input by one
level)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np32, tt
from sgl_kernel_npu_tpu.ops.attention import mla_preprocess as jmp
from sgl_kernel_npu_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from sgl_kernel_npu_tpu_torch.ops.attention import mla_preprocess as tmp
from sgl_kernel_npu_tpu_torch.ops.rope import rope_cos_sin

HID, HEADS, N, Q_RMS = 256, 4, 16, 1536
PAGES, PAGE = 8, 16


def _weights(rng):
    f32, i8, i32 = np.float32, np.int8, np.int32
    return dict(
        gamma1=rng.uniform(0.5, 1.5, HID).astype(f32),
        beta1=rng.uniform(-0.1, 0.1, HID).astype(f32),
        qscale1=np.asarray(0.05, f32), qoffset1=np.asarray(0.0, f32),
        wdqkv=rng.integers(-16, 16, (2112, HID)).astype(i8),
        descale1=(rng.random(2112) / 1000).astype(f32),
        bias1=rng.integers(-10, 10, 2112).astype(i32),
        gamma2=rng.uniform(0.5, 1.5, Q_RMS).astype(f32),
        beta2=rng.uniform(-0.1, 0.1, Q_RMS).astype(f32),
        qscale2=np.asarray(0.02, f32), qoffset2=np.asarray(0.0, f32),
        wuq=rng.integers(-16, 16, (HEADS * 192, Q_RMS)).astype(i8),
        descale2=(rng.random(HEADS * 192) / 1000).astype(f32),
        bias2=rng.integers(-10, 10, HEADS * 192).astype(i32),
        gamma3=rng.uniform(0.5, 1.5, 512).astype(f32),
        wuk=(rng.standard_normal((HEADS, 128, 512)) * 0.05).astype(f32),
    )


@pytest.mark.parametrize("padded,dtype", [(False, "float32"), (True, "bfloat16")])
def test_mla_preprocess_matches_jax(padded, dtype):
    rng = np.random.default_rng(42)
    hidden = rng.standard_normal((N, HID)).astype(np.float32)
    wn = _weights(rng)
    slots = rng.choice(PAGES * PAGE, N, replace=False).astype(np.int32)
    slots[3] = -1                                     # a row that writes nothing
    w_j = jmp.MlaPreprocessWeights(**{k: jnp.asarray(v) for k, v in wn.items()})
    w_t = tmp.MlaPreprocessWeights(**{k: tt(v) for k, v in wn.items()})
    if padded:
        w_j, w_t = jmp.pad_weights_lane_aligned(w_j), tmp.pad_weights_lane_aligned(w_t)
        assert w_t.wdqkv.shape == (2176, HID) and not w_t.bias1[2112:].any()
        np.testing.assert_array_equal(w_t.wdqkv.numpy(), np.asarray(w_j.wdqkv))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cos_j, sin_j = j_rope_cos_sin(jnp.arange(N), 64)    # one table for both sides
    cos_t, sin_t = tt(np.asarray(cos_j)), tt(np.asarray(sin_j))

    cn_j, cr_j = jnp.zeros((PAGES, 1, PAGE, 512), jdt), jnp.zeros((PAGES, 1, 64, PAGE), jdt)
    cn_t = torch.zeros((PAGES, 1, PAGE, 512), dtype=tdt)
    cr_t = torch.zeros((PAGES, 1, 64, PAGE), dtype=tdt)
    want = jmp.mla_preprocess(jnp.asarray(hidden, jdt), w_j, (cos_j, sin_j), cn_j, cr_j,
                              jnp.asarray(slots))
    got = tmp.mla_preprocess(tt(hidden, tdt), w_t, (cos_t, sin_t), cn_t, cr_t, tt(slots))
    assert got[2] is cn_t and got[3] is cr_t          # written in place
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, g, wv in zip(("q_nope_out", "q_pe", "cache_nope", "cache_rope"), got, want):
        assert g.dtype == tdt and tuple(g.shape) == wv.shape, name
        wv = np32(wv)
        np.testing.assert_allclose(np32(g), wv, rtol=0, atol=tol * np.abs(wv).max(),
                                   err_msg=name)
    written = np.zeros(PAGES * PAGE, bool)
    written[slots[slots >= 0]] = True
    nope = np32(cn_t).reshape(PAGES * PAGE, 512)
    assert np.abs(nope[written]).min(axis=1).max() > 0 and not nope[~written].any()


def test_int8_nzcache_raises():
    """``int8_nzcache`` without its per-head q scales and latent scale, or
    with a float latent cache, raises (the mode itself is ported:
    ``tests/test_torch_int8_cache.py``)."""
    rng = np.random.default_rng(0)
    w = tmp.MlaPreprocessWeights(**{k: tt(v) for k, v in _weights(rng).items()})
    cos, sin = rope_cos_sin(torch.arange(2), 64)
    args = (torch.zeros((2, HID)), w, (cos, sin), torch.zeros((1, 1, PAGE, 512), dtype=torch.int8),
            torch.zeros((1, 1, 64, PAGE)), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="qnope_scale"):
        tmp.mla_preprocess(*args, cache_mode="int8_nzcache")
    scaled = w._replace(qnope_scale=torch.ones(HEADS), ctkv_scale=torch.tensor(1 / 32))
    with pytest.raises(ValueError, match="int8 latent cache"):
        tmp.mla_preprocess(args[0], scaled, *args[2:3], torch.zeros((1, 1, PAGE, 512)),
                           *args[4:], cache_mode="int8_nzcache")
    q, _, cache, _ = tmp.mla_preprocess(args[0], scaled, *args[2:], cache_mode="int8_nzcache")
    assert q.dtype == cache.dtype == torch.int8
