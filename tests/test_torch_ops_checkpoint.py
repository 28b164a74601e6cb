"""Port parity: the jnp ops without a Pallas kernel (``ops/matmul.
batch_matmul_transpose``, ``ops/norm.split_qkv_rmsnorm_rope``,
``ops/rope.apply_rope_interleaved``), ``utils/checkpoint``,
``ops/sampling.sample_tokens_ref`` and ``utils/common.next_power_of_2``
against the JAX package.

``batch_matmul_transpose``: the float path in f32 (within 1e-6 of the
largest value: sums in another order) and bf16 (2e-2; JAX's on the same
bf16 values in f32, as XLA on the CPU has no bf16 dot into f32), every int8
``quant_mode`` with ``de_scale`` as ``[m, n]`` and ``[n]``,
``per_token_scale`` as ``[b, m]`` and ``[b]``, out bf16 and f32:
bit-equal to JAX (the int32 sums are exact and the epilogue is the same
f32 products).  ``split_qkv_rmsnorm_rope`` with and without the norm and
the biases, f32 within 1e-6 and bf16 within one bf16 ulp of the largest
value; ``apply_rope_interleaved`` f32 within 1e-6.  Checkpoints round-trip
bit-equal with their structure and dtypes, cast to ``like``'s dtypes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops import matmul as jmm
from sgl_kernel_npu_tpu.ops import norm as jnorm
from sgl_kernel_npu_tpu.ops import rope as jrope
from sgl_kernel_npu_tpu.ops import sampling as jsamp
from sgl_kernel_npu_tpu.utils import common as jcommon
from sgl_kernel_npu_tpu_torch.ops import matmul as tmm
from sgl_kernel_npu_tpu_torch.ops import norm as tnorm
from sgl_kernel_npu_tpu_torch.ops import rope as trope
from sgl_kernel_npu_tpu_torch.ops import sampling as tsamp
from sgl_kernel_npu_tpu_torch.utils import checkpoint, common

B, M, K, N = 5, 3, 64, 24


def _close(got, want, rel):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_batch_matmul_transpose_float_matches_jax(dt):
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((B, M, K)), rng.standard_normal((M, K, N))
    jdt, tdt, tol = {"f32": (jnp.float32, torch.float32, 1e-6),
                     "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[dt]
    # XLA on the CPU has no bf16 x bf16 -> f32 dot: JAX takes the bf16 values in f32
    want = jmm.batch_matmul_transpose(jx(a, jdt).astype(jnp.float32),
                                      jx(b, jdt).astype(jnp.float32), jdt)
    got = tmm.batch_matmul_transpose(tt(a, tdt), tt(b, tdt))
    assert got.dtype == tdt
    _close(got, want, tol)


QUANT = [("per_channel_symm", "mn", None), ("per_channel_symm", "n", None),
         ("per_channel_asymm", "mn", None), ("per_token_symm", "mn", "bm"),
         ("per_token_symm", "n", "b")]


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("mode,ds_shape,pts_shape", QUANT)
def test_batch_matmul_transpose_int8_modes_bit_equal_to_jax(mode, ds_shape, pts_shape, out):
    rng = np.random.default_rng(2)
    a = rng.integers(-128, 128, (B, M, K), dtype=np.int8)
    b = rng.integers(-128, 128, (M, K, N), dtype=np.int8)
    ds = (rng.random((M, N) if ds_shape == "mn" else (N,)) * 1e-3).astype(np.float32)
    bias = rng.integers(-5000, 5000, (M, N)).astype(np.int32)
    pts = None if pts_shape is None else rng.random((B, M) if pts_shape == "bm" else (B,))
    pts = None if pts is None else pts.astype(np.float32)
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}[out]
    kw_j = dict(quant_mode=mode, de_scale=jx(ds), bias=jx(bias),
                per_token_scale=None if pts is None else jx(pts))
    kw_t = dict(quant_mode=mode, de_scale=tt(ds), bias=tt(bias),
                per_token_scale=None if pts is None else tt(pts))
    want = jmm.batch_matmul_transpose(jx(a), jx(b), jdt, **kw_j)
    got = tmm.batch_matmul_transpose(tt(a), tt(b), tdt, **kw_t)
    assert got.dtype == tdt
    np.testing.assert_array_equal(np32(got), np32(want))


def test_batch_matmul_transpose_refusals():
    a = torch.zeros((1, 1, 16), dtype=torch.int8)
    b = torch.zeros((1, 16, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="quant_mode"):
        tmm.batch_matmul_transpose(a, b, quant_mode="per_block", de_scale=torch.ones(8))
    with pytest.raises(ValueError, match="de_scale"):
        tmm.batch_matmul_transpose(a, b, quant_mode="per_channel_symm")
    with pytest.raises(ValueError, match="bias"):
        tmm.batch_matmul_transpose(a, b, quant_mode="per_channel_asymm", de_scale=torch.ones(8))
    with pytest.raises(ValueError, match="per_token_scale"):
        tmm.batch_matmul_transpose(a, b, quant_mode="per_token_symm", de_scale=torch.ones(8))
    with pytest.raises(ValueError, match="int8"):
        tmm.batch_matmul_transpose(a.float(), b, quant_mode="per_channel_symm",
                                   de_scale=torch.ones(8))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["norm", "norm_bias", "rope_only"])
def test_split_qkv_rmsnorm_rope_matches_jax(variant, dt):
    rng = np.random.default_rng(3)
    hq, hkv, d, b = 4, 2, 16, 6
    x = rng.standard_normal((b, (hq + 2 * hkv) * d)).astype(np.float32)
    ang = rng.random((b, d // 2)) * 3
    cos = np.cos(np.concatenate([ang, ang], -1)).astype(np.float32)
    sin = np.sin(np.concatenate([ang, ang], -1)).astype(np.float32)
    w = {n: rng.standard_normal((d,)).astype(np.float32) for n in ("qw", "kw", "qb", "kb")}
    jdt, tdt, tol = {"f32": (jnp.float32, torch.float32, 1e-6),
                     "bf16": (jnp.bfloat16, torch.bfloat16, 2 ** -7)}[dt]

    def kwargs(f):
        if variant == "rope_only":
            return {}
        kw = dict(eps=1e-6, q_weight=f(w["qw"]), k_weight=f(w["kw"]))
        if variant == "norm_bias":
            kw.update(q_bias=f(w["qb"]), k_bias=f(w["kb"]))
        return kw

    want = jnorm.split_qkv_rmsnorm_rope(jx(x, jdt), jx(sin), jx(cos), hq * d, hkv * d, d,
                                        **kwargs(jx))
    got = tnorm.split_qkv_rmsnorm_rope(tt(x, tdt), tt(sin), tt(cos), hq * d, hkv * d, d,
                                       **kwargs(tt))
    for g, wv in zip(got, want):
        assert g.dtype == tdt
        _close(g, wv, tol)


def test_apply_rope_interleaved_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((7, 3, 32)).astype(np.float32)
    ang = rng.random((7, 16)) * 3
    cos = np.cos(np.concatenate([ang, ang], -1)).astype(np.float32)
    sin = np.sin(np.concatenate([ang, ang], -1)).astype(np.float32)
    want = jrope.apply_rope_interleaved(jx(x), jx(cos), jx(sin))
    got = trope.apply_rope_interleaved(tt(x), tt(cos), tt(sin))
    _close(got, want, 1e-6)


def test_checkpoint_round_trip(tmp_path):
    state = {"params": {"w": torch.randn(3, 4).to(torch.bfloat16),
                        "layers": [torch.arange(6, dtype=torch.int32), torch.randn(2)]},
             "opt": (torch.zeros(2), 0.5), "step": 7}
    checkpoint.save_checkpoint(tmp_path / "ck", state)
    like = {"params": {"w": torch.empty(3, 4, dtype=torch.bfloat16),
                       "layers": [torch.empty(6, dtype=torch.int32), torch.empty(2)]},
            "opt": (torch.empty(2), 0.0), "step": 0}
    got = checkpoint.restore_checkpoint(tmp_path / "ck", like=like)
    assert got["step"] == 7 and got["opt"][1] == 0.5 and isinstance(got["opt"], tuple)
    for a, b in ((got["params"]["w"], state["params"]["w"]),
                 (got["params"]["layers"][0], state["params"]["layers"][0]),
                 (got["params"]["layers"][1], state["params"]["layers"][1])):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    cast = checkpoint.restore_checkpoint(
        tmp_path / "ck", like={**like, "params": {**like["params"], "w": torch.empty(3, 4)}})
    assert cast["params"]["w"].dtype == torch.float32
    assert torch.equal(cast["params"]["w"], state["params"]["w"].float())
    with pytest.raises(ValueError, match="structure"):
        checkpoint.restore_checkpoint(tmp_path / "ck", like={"step": 0})
    with pytest.raises(FileExistsError):
        checkpoint.save_checkpoint(tmp_path / "ck", state, force=False)
    checkpoint.save_checkpoint(tmp_path / "ck", {**state, "step": 8})
    assert checkpoint.restore_checkpoint(tmp_path / "ck", like=like)["step"] == 8


def test_sample_tokens_ref_and_next_power_of_2_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((4, 32)).astype(np.float32)
    seeds, steps = np.arange(4, dtype=np.uint32), np.arange(4, dtype=np.int32)
    temp = np.asarray([0.0, 0.0, 0.7, 1.0], np.float32)
    top_k, top_p, min_p = np.zeros(4, np.int32), np.ones(4, np.float32), np.zeros(4, np.float32)
    args = (logits, seeds, steps, temp, top_k, top_p, min_p)
    got = tsamp.sample_tokens_ref(*map(tt, args))
    assert torch.equal(got, tsamp.sample_tokens(*map(tt, args)))
    want = np.asarray(jsamp.sample_tokens_ref(*map(jx, args)))
    np.testing.assert_array_equal(got.numpy(), want)
    for x in list(range(-2, 70)) + [1023, 1024, 1025, 2 ** 20 + 1]:
        assert common.next_power_of_2(x) == jcommon.next_power_of_2(x), x
