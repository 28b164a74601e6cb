"""Port parity: the ragged grouped W8A8 GEMM (K8a ``grouped_matmul``) and the
MoE above 512 tokens that runs on it.

The JAX kernel runs in Pallas interpret mode; the port takes its plain path on
CPU tensors.  Tolerances: ``dequant`` (bf16 out) within 1e-2 relative (both
sides sum the int8 products exactly and apply the same two f32 scales; the
bf16 cast may land one ulp apart); int8 outputs within one level (the SiLU's
exp differs by ulps between libraries, which can move a value across a
rounding tie) and scales rtol 1e-5; the MoE output within 1e-2 of each row's
largest value (the requant flips above, and the combine weights: exact f32 in
the port, a bf16 hi + lo split in JAX)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.models import deepseek_v3 as jm
from sgl_kernel_npu_tpu.ops import grouped_matmul as jgm
from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tm
from sgl_kernel_npu_tpu_torch.ops import grouped_matmul as tgm

# ragged groups with empty ones (and a last one), 30 rows past the total
SIZES = np.asarray([40, 0, 70, 0, 50, 10, 0], np.int32)
ROWS, K, N = 200, 256, 256


def _inputs(rng, n=N):
    x = rng.integers(-127, 128, (ROWS, K)).astype(np.int8)
    w = rng.integers(-127, 128, (len(SIZES), K, n)).astype(np.int8)
    sx = (rng.random(ROWS) / 50 + 1e-3).astype(np.float32)
    sw = (rng.random((len(SIZES), n)) / 500 + 1e-4).astype(np.float32)
    return x, w, sx, sw


def test_grouped_matmul_dequant_matches_jax():
    rng = np.random.default_rng(0)
    x, w, sx, sw = _inputs(rng)
    want = np32(jgm.grouped_matmul(jx(x), jx(w), jx(SIZES), jx(sx), jx(sw), epilogue="dequant",
                                   out_dtype=jnp.bfloat16, tm=64, tk=128, tn=128))
    got = tgm.grouped_matmul(tt(x), tt(w), tt(SIZES), tt(sx), tt(sw), epilogue="dequant",
                             out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    total = int(SIZES.sum())
    np.testing.assert_allclose(np32(got), want, rtol=1e-2, atol=1e-6)
    assert not np32(got)[total:].any() and not want[total:].any()


def test_grouped_matmul_swiglu_quant_matches_jax():
    rng = np.random.default_rng(1)
    x, w, sx, sw = _inputs(rng)
    q_j, s_j = jgm.grouped_matmul(jx(x), jx(w), jx(SIZES), jx(sx), jx(sw),
                                  epilogue="dequant_swiglu_quant", tm=64, tk=128)
    q_t, s_t = tgm.grouped_matmul(tt(x), tt(w), tt(SIZES), tt(sx), tt(sw),
                                  epilogue="dequant_swiglu_quant")
    assert q_t.dtype == torch.int8 and tuple(q_t.shape) == (ROWS, N // 2)
    total = int(SIZES.sum())
    diff = np.abs(q_t.numpy().astype(np.int32) - np.asarray(q_j, np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99
    np.testing.assert_allclose(s_t.numpy()[:total], np.asarray(s_j)[:total], rtol=1e-5)
    assert not q_t[total:].any() and not s_t[total:].any()   # rows past the total: 0, scale 0
    assert (s_t[:total] > 0).all()


def test_grouped_matmul_golden_and_row_groups_match_jax():
    """``grouped_matmul_ref`` (float and int8 rows) and ``_row_groups``."""
    rng = np.random.default_rng(2)
    xf = rng.standard_normal((ROWS, K)).astype(np.float32)
    wf = (rng.standard_normal((len(SIZES), K, 64)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(np32(tgm.grouped_matmul_ref(tt(xf), tt(wf), tt(SIZES))),
                               np32(jgm.grouped_matmul_ref(jx(xf), jx(wf), jx(SIZES))),
                               rtol=1e-4, atol=1e-4)
    x, w, _, _ = _inputs(rng, 64)
    np.testing.assert_array_equal(np32(tgm.grouped_matmul_ref(tt(x), tt(w), tt(SIZES))),
                                  np32(jgm.grouped_matmul_ref(jx(x), jx(w), jx(SIZES))))
    np.testing.assert_array_equal(tgm._row_groups(tt(SIZES), ROWS).numpy(),
                                  np.asarray(jgm._row_groups(jx(SIZES), ROWS)))


def test_gmm_moe_above_512_tokens_matches_jax():
    """``_gmm_moe`` at 520 tokens (the K8a branch: gather, GMM1, GMM2, the
    gather combine) on the same routing; outputs within 1e-2 of each row's
    largest value."""
    cfg = jm.DeepSeekV3Config(num_layers=1)
    rng = np.random.default_rng(3)
    n, e, h, i = 520, cfg.num_experts, cfg.hidden, cfg.moe_intermediate
    wg = (rng.standard_normal((e, h, i)) * h ** -0.5).astype(np.float32)
    wu = (rng.standard_normal((e, h, i)) * h ** -0.5).astype(np.float32)
    wd = (rng.standard_normal((e, i, h)) * i ** -0.5).astype(np.float32)
    moe_j = jm.quantize_moe_weights(cfg, {"layers": [{"w_gate": jx(wg), "w_up": jx(wu),
                                                      "w_down": jx(wd)}]})[0]
    moe_t = tuple(tt(np.asarray(a)) for a in moe_j)
    x = rng.standard_normal((n, h)).astype(np.float32)
    idx = np.stack([rng.choice(e, cfg.topk, replace=False) for _ in range(n)]).astype(np.int32)
    topw = rng.random((n, cfg.topk)).astype(np.float32)
    topw /= topw.sum(-1, keepdims=True)
    want = np32(jm._gmm_moe(cfg, moe_j, jx(x), jx(idx), jx(topw)))
    got = tm._gmm_moe(tm.DeepSeekV3Config(num_layers=1), moe_t, tt(x), tt(idx), tt(topw))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(np32(got) - want).max(-1) / np.abs(want).max(-1)
    assert err.max() <= 1e-2, err.max()


def test_gmm_moe_plain_switch_matches_default_on_cpu():
    """``plain=True`` reaches the same plain K8a on CPU tensors."""
    cfg = tm.DeepSeekV3Config(num_layers=1)
    params = tm.init_weights(cfg, 0, device="cpu")
    moe = tm.quantize_moe_weights(cfg, params)[0]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((530, cfg.hidden), generator=gen)
    idx = torch.stack([torch.randperm(cfg.num_experts, generator=gen)[: cfg.topk]
                       for _ in range(530)]).to(torch.int32)
    w = torch.full((530, cfg.topk), 1.0 / cfg.topk)
    torch.testing.assert_close(tm._gmm_moe(cfg, moe, x, idx, w),
                               tm._gmm_moe(cfg, moe, x, idx, w, plain=True), rtol=0, atol=0)
    assert tgm.grouped_matmul.launches == 0            # CPU tensors never count a launch


@pytest.mark.parametrize("epilogue", ["dequant", "dequant_swiglu_quant"])
def test_grouped_matmul_plain_matches_golden(epilogue):
    """The plain K8a is the golden ``grouped_matmul_ref`` with the two scales
    applied in f32, then the bf16 cast or the SwiGLU requant."""
    rng = np.random.default_rng(4)
    x, w, sx, sw = _inputs(rng)
    gs = tt(SIZES)
    got = tgm.grouped_matmul(tt(x), tt(w), gs, tt(sx), tt(sw), epilogue=epilogue)
    sw_row = tt(sw)[tgm._row_groups(gs, ROWS)]
    y = tgm.grouped_matmul_ref(tt(x), tt(w), gs) * tt(sx)[:, None] * sw_row
    if epilogue == "dequant":
        want = (y.to(torch.bfloat16),)
    else:
        want = tgm.swiglu_requant_ref(y, torch.arange(ROWS) < int(SIZES.sum()))
    for u, v in zip(got if isinstance(got, tuple) else (got,), want):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
