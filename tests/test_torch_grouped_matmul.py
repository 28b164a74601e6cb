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


# --- K8a's float modes and gmm_train -------------------------------------------------
#
# JAX's kernel in interpret mode against the port's plain version on the same
# rows and weights (f32, or both rounded to bf16): per group the f32 product of
# the inputs, rows past the groups' total zero.  The products of two bf16 or two
# f32 values are summed in f32 in another order on each side: within 1e-5 of the
# output's largest |value|.

FLOAT_K, FLOAT_N = 96, 64


def _float_inputs(rng, dtype, contract_last):
    x = rng.standard_normal((ROWS, FLOAT_K)).astype(np.float32)
    shape = (len(SIZES),) + ((FLOAT_N, FLOAT_K) if contract_last else (FLOAT_K, FLOAT_N))
    w = (rng.standard_normal(shape) * FLOAT_K ** -0.5).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    return jx(x, jdt), jx(w, jdt), tt(x, tdt), tt(w, tdt)


@pytest.mark.parametrize("contract_last", [False, True], ids=["none", "rhs_contract_last"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grouped_matmul_float_modes_match_jax(dtype, contract_last):
    rng = np.random.default_rng(5)
    xj, wj, xt, wt = _float_inputs(rng, dtype, contract_last)
    want = np32(jgm.grouped_matmul(xj, wj, jx(SIZES), rhs_contract_last=contract_last))
    got = tgm.grouped_matmul(xt, wt, tt(SIZES), rhs_contract_last=contract_last)
    direct = (tgm.grouped_matmul_dx if contract_last else tgm.grouped_matmul_float)(
        xt, wt, tt(SIZES))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (ROWS, FLOAT_N)
    torch.testing.assert_close(got, direct, rtol=0, atol=0)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=1e-5 * np.abs(want).max())
    total = int(SIZES.sum())
    assert not got[total:].any() and not want[total:].any()
    assert tgm.grouped_matmul_float.launches == tgm.grouped_matmul_dx.launches == 0


def test_grouped_matmul_float_empty_and_single_groups():
    """Every group empty but one of a single row, and no row at all in the
    groups: the output is that row's product, zeros elsewhere."""
    rng = np.random.default_rng(6)
    xj, wj, xt, wt = _float_inputs(rng, "f32", False)
    for sizes in ([0, 0, 1, 0, 0, 0, 0], [0] * len(SIZES)):
        sz = np.asarray(sizes, np.int32)
        want = np32(jgm.grouped_matmul(xj, wj, jx(sz)))
        got = np32(tgm.grouped_matmul_float(xt, wt, tt(sz)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1))
        assert not got[int(sz.sum()):].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gmm_train_grads_match_jax(dtype):
    """``gmm_train``'s forward and gradients against ``jax.grad`` of JAX's
    (its custom_vjp: dx on the kernel's ``rhs_contract_last`` mode with dy
    rounded to x's type, dw by ``ragged_dot_general``) on a random cotangent.
    f32: the output and dw within 1e-5, dx 1e-5 of the largest |value|; bf16:
    dx and dw are rounded to bf16 on both sides from f32 sums in another
    order, within 1e-2 of the largest |value| (an ulp of bf16 is 2^-8)."""
    import jax

    rng = np.random.default_rng(7)
    xj, wj, xt, wt = _float_inputs(rng, dtype, False)
    ct = rng.standard_normal((ROWS, FLOAT_N)).astype(np.float32)

    def loss_j(x, w):
        return jnp.sum(jgm.gmm_train(x, w, jx(SIZES)) * jx(ct))

    (dxj, dwj) = jax.grad(loss_j, argnums=(0, 1))(xj, wj)
    xt.requires_grad_()
    wt.requires_grad_()
    out = tgm.gmm_train(xt, wt, tt(SIZES))
    (out * tt(ct)).sum().backward()
    assert xt.grad.dtype == xt.dtype and wt.grad.dtype == wt.dtype
    tol = 1e-5 if dtype == "f32" else 1e-2
    for got, want in ((out, jgm.gmm_train(xj, wj, jx(SIZES))), (xt.grad, dxj), (wt.grad, dwj)):
        want = np32(want)
        np.testing.assert_allclose(np32(got), want, rtol=0, atol=tol * np.abs(want).max())
    assert not xt.grad[int(SIZES.sum()):].any()          # rows past the total get no gradient
    for g, size in enumerate(SIZES):                     # empty groups: zero weight gradient
        assert bool(wt.grad[g].any()) == bool(size)


def test_gmm_train_plain_switch_matches_default_on_cpu():
    """``plain=True`` takes the same plain versions on CPU tensors."""
    rng = np.random.default_rng(8)
    _, _, xt, wt = _float_inputs(rng, "f32", False)
    grads = []
    for plain in (False, True):
        x, w = xt.clone().requires_grad_(), wt.clone().requires_grad_()
        out = tgm.gmm_train(x, w, tt(SIZES), plain=plain)
        out.square().sum().backward()
        grads.append((out.detach(), x.grad, w.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --- K8a's remaining modes, K8b and dispatch_onehot ----------------------------------
#
# JAX's kernel in interpret mode (tm 64, tk 128) against the port's plain version
# on the same int8 rows.  Tolerances: the integer sums are exact on both sides, so
# ``none`` is bit-equal and ``dequant`` (the same two f32 scale products) within
# an f32 ulp; the SwiGLU modes 1e-5 of the output's largest |value| in f32 (the
# SiLU's exp differs by ulps between libraries), one bf16 ulp (2^-7 relative) in
# bf16; the dispatched rows bit-equal to the gathered ones.

MODE_CASES = [
    ("none-f32", dict(epilogue="none"), {}),
    ("none-bf16", dict(epilogue="none", out_dtype="bf16"), {}),
    ("dequant-f32", dict(epilogue="dequant", out_dtype="f32"), {}),
    ("dequant_swiglu-tn128-f32", dict(epilogue="dequant_swiglu", out_dtype="f32"), {"tn": 128}),
    ("dequant_swiglu-tn64-bf16", dict(epilogue="dequant_swiglu"), {"tn": 64}),
    ("dequant_swiglu-tn256-f32", dict(epilogue="dequant_swiglu", out_dtype="f32"), {"tn": 256}),
]
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _mode_kw(kw):
    out = kw.get("out_dtype")
    jkw = {**kw, "out_dtype": _DT[out][0]} if out else dict(kw)
    tkw = {**kw, "out_dtype": _DT[out][1]} if out else dict(kw)
    return jkw, tkw


def _close(got, want, kw):
    got, want = np32(got), np32(want)
    if kw["epilogue"] == "none":
        np.testing.assert_array_equal(got, want)
    elif kw["epilogue"] == "dequant":
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    elif kw.get("out_dtype") == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("name,kw,opt", MODE_CASES, ids=[c[0] for c in MODE_CASES])
def test_grouped_matmul_remaining_modes_match_jax(name, kw, opt):
    rng = np.random.default_rng(20)
    x, w, sx, sw = _inputs(rng)
    jkw, tkw = _mode_kw(kw)
    tn = opt.get("tn", 128)
    want = jgm.grouped_matmul(jx(x), jx(w), jx(SIZES), jx(sx), jx(sw), tm=64, tk=128, tn=tn,
                              **jkw)
    got = tgm.grouped_matmul(tt(x), tt(w), tt(SIZES), tt(sx), tt(sw), tn=tn, **tkw)
    assert tuple(got.shape) == want.shape and got.dtype == _DT[kw.get("out_dtype") or (
        "f32" if kw["epilogue"] == "none" else "bf16")][1]
    _close(got, want, kw)
    assert not got[int(SIZES.sum()):].any()
    assert tgm.grouped_matmul.launches == 0


@pytest.mark.parametrize("epilogue", ["dequant", "dequant_swiglu_quant", "none"])
def test_grouped_matmul_dispatch_p_onehot_matches_jax(epilogue):
    """``dispatch_p`` from :func:`dispatch_onehot` (a token id out of range
    gives a zero row): the port's rows equal its own gather bit for bit, and
    JAX's kernel, which forms them as P @ x."""
    rng = np.random.default_rng(21)
    n_tok = 24
    x = rng.integers(-127, 128, (n_tok, K)).astype(np.int8)
    _, w, sx, sw = _inputs(rng)
    tok = rng.integers(0, n_tok, ROWS).astype(np.int32)
    tok[5] = n_tok                                             # the TPU wrapper's pad id
    p = tgm.dispatch_onehot(tt(tok), n_tok)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jgm.dispatch_onehot(jx(tok), n_tok)))
    args = (tt(SIZES), tt(sx), tt(sw))
    got = tgm.grouped_matmul(tt(x), tt(w), *args, epilogue=epilogue, dispatch_p=p)
    gathered = torch.where(tt(tok)[:, None] < n_tok, tt(x)[tt(tok).clamp(max=n_tok - 1).long()], 0)
    same = tgm.grouped_matmul(gathered, tt(w), *args, epilogue=epilogue)
    want = jgm.grouped_matmul(jx(x), jx(w), jx(SIZES), jx(sx), jx(sw), epilogue=epilogue,
                              dispatch_p=jx(p.numpy()), tm=64, tk=128, tn=128)
    for a, b, c in zip(*(v if isinstance(v, tuple) else (v,) for v in (got, same, want))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        if a.dtype == torch.int8:
            assert np.abs(a.numpy().astype(np.int32) - np.asarray(c, np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(np32(a), np32(c), rtol=1e-2 if epilogue == "dequant"
                                       else 1e-5, atol=1e-6)


def test_grouped_matmul_dispatch_p_general_matches_jax():
    """A P that is not one-hot (several nonzeros a row, values 0-2): the
    plain version forms P @ x with the int32 → int8 wrap, as JAX's kernel."""
    rng = np.random.default_rng(22)
    n_tok = 16
    x = rng.integers(-127, 128, (n_tok, K)).astype(np.int8)
    _, w, _, _ = _inputs(rng)
    p = rng.integers(0, 3, (ROWS, n_tok)).astype(np.int8) * (rng.random((ROWS, n_tok)) < 0.2)
    p = p.astype(np.int8)
    want = jgm.grouped_matmul(jx(x), jx(w), jx(SIZES), dispatch_p=jx(p), tm=64, tk=128, tn=128)
    got = tgm.grouped_matmul(tt(x), tt(w), tt(SIZES), dispatch_p=tt(p))
    np.testing.assert_array_equal(np32(got), np32(want))


def test_grouped_matmul_dispatch_p_float_rows_match_jax():
    """bf16 tokens through ``dispatch_p`` into the float ``none`` mode."""
    rng = np.random.default_rng(23)
    n_tok = 12
    xj, wj, xt, wt = _float_inputs(rng, "bf16", False)
    xj, xt = xj[:n_tok], xt[:n_tok]
    tok = rng.integers(0, n_tok, ROWS).astype(np.int32)
    p = tgm.dispatch_onehot(tt(tok), n_tok, torch.bfloat16)
    want = np32(jgm.grouped_matmul(xj, wj, jx(SIZES), dispatch_p=jx(p.float().numpy(),
                                                                     jnp.bfloat16)))
    got = np32(tgm.grouped_matmul(xt, wt, tt(SIZES), dispatch_p=p))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_grouped_matmul_float_rows_dequant_match_jax():
    """Float rows into the ``dequant`` epilogue (the plain path): the f32
    product times the two scales."""
    rng = np.random.default_rng(24)
    xj, wj, xt, wt = _float_inputs(rng, "f32", False)
    sx = (rng.random(ROWS) + 0.5).astype(np.float32)
    sw = (rng.random((len(SIZES), FLOAT_N)) + 0.5).astype(np.float32)
    want = np32(jgm.grouped_matmul(xj, wj, jx(SIZES), jx(sx), jx(sw), epilogue="dequant",
                                   out_dtype=jnp.float32, tm=64, tk=32, tn=64))
    got = np32(tgm.grouped_matmul(xt, wt, tt(SIZES), tt(sx), tt(sw), epilogue="dequant",
                                  out_dtype=torch.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_select_gmm_tiles_and_default_pack_width_match_jax():
    """``select_gmm_tiles`` (the default pack width of ``dequant_swiglu``)
    is JAX's, and ``tn`` None packs as JAX's default does."""
    for args in ((200, 256, 512, jnp.int8, torch.int8), (4096, 7168, 4096, jnp.int8, torch.int8),
                 (64, 512, 1024, jnp.bfloat16, torch.bfloat16)):
        s, k, n, jd, td = args
        assert tgm.select_gmm_tiles(s, k, n, td, num_groups=7, out_esize=4) == \
            jgm.select_gmm_tiles(s, k, n, jd, num_groups=7, out_esize=4)
    rng = np.random.default_rng(25)
    x, w, sx, sw = _inputs(rng, 512)
    want = jgm.grouped_matmul(jx(x), jx(w), jx(SIZES), jx(sx), jx(sw), epilogue="dequant_swiglu",
                              out_dtype=jnp.float32)
    got = tgm.grouped_matmul(tt(x), tt(w), tt(SIZES), tt(sx), tt(sw), epilogue="dequant_swiglu",
                             out_dtype=torch.float32)
    np.testing.assert_allclose(np32(got), np32(want), rtol=0, atol=1e-5 * np.abs(np32(want)).max())


@pytest.mark.parametrize("sizes,rows", [((30, 26, 0, 40), 100), ((0, 0, 7, 0), 9)],
                         ids=["ragged-tail", "one-group"])
def test_grouped_matmul_combine_matches_jax(sizes, rows):
    """K8b's plain version against JAX's kernel (tm 64, so S % tm != 0):
    each expert row rounded to bf16 before the hi + lo products, the mask's
    columns past the total (and an empty group's) weigh nothing.  The f32
    products of bf16 values are exact; the sums' order differs: within 1e-5
    of the largest |value|."""
    rng = np.random.default_rng(26)
    g, n_tok, kd, n = len(sizes), 24, 256, 384
    gs = np.asarray(sizes, np.int32)
    x = rng.integers(-128, 128, (rows, kd)).astype(np.int8)
    w = rng.integers(-128, 128, (g, kd, n)).astype(np.int8)
    sx = (np.abs(rng.standard_normal(rows)) * 0.01 + 0.001).astype(np.float32)
    sw = (np.abs(rng.standard_normal((g, n))) * 0.01).astype(np.float32)
    mask = np.zeros((n_tok, rows), np.float32)
    for t in range(n_tok):
        mask[t, rng.choice(rows, 3, replace=False)] = rng.random(3)   # some past the total
    hi = jx(mask, jnp.bfloat16)
    lo = jx(mask - np.asarray(hi, np.float32), jnp.bfloat16)
    want = np32(jgm.grouped_matmul_combine(jx(x), jx(w), jx(gs), jx(sx), jx(sw), hi, lo, tm=64,
                                           tk=128, tn=128))
    hi_t, lo_t = tt(np32(hi), torch.bfloat16), tt(np32(lo), torch.bfloat16)
    got = tgm.grouped_matmul_combine(tt(x), tt(w), tt(gs), tt(sx), tt(sw), hi_t, lo_t)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n_tok, n)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1))
    assert tgm.grouped_matmul_combine.launches == 0


def test_combine_masks_match_jax():
    """The masks of ``_gmm_moe``'s branch: JAX's scatter of each token's
    top-k weights to its sorted rows, split into bf16 hi and lo."""
    rng = np.random.default_rng(27)
    n_tok, rows = 24, 100
    dest = rng.permutation(rows)[: n_tok * 2].reshape(n_tok, 2).astype(np.int32)
    topw = rng.random((n_tok, 2)).astype(np.float32)
    m = np.zeros((n_tok, rows), np.float32)
    np.put_along_axis(m, dest, topw, axis=1)
    m_hi, m_lo = tgm.combine_masks(tt(dest), tt(topw), rows)
    np.testing.assert_array_equal(np32(m_hi), np32(jx(m, jnp.bfloat16)))
    np.testing.assert_array_equal(np32(m_lo), np32(jx(m - np32(jx(m, jnp.bfloat16)),
                                                      jnp.bfloat16)))


def test_grouped_matmul_int8_rhs_contract_last_matches_jax():
    """Int8 rows with ``rhs_contract_last`` (``w [G, N, K]``): the exact
    integer sums to f32, bit-equal to JAX's kernel."""
    rng = np.random.default_rng(28)
    x, w, _, _ = _inputs(rng)
    wt = np.ascontiguousarray(w.transpose(0, 2, 1))
    want = jgm.grouped_matmul(jx(x), jx(wt), jx(SIZES), rhs_contract_last=True, tm=64, tk=128,
                              tn=128)
    got = tgm.grouped_matmul(tt(x), tt(wt), tt(SIZES), rhs_contract_last=True)
    np.testing.assert_array_equal(np32(got), np32(want))


def _work_items(group_sizes, tile_m):
    """The CUDA kernel's work items from the wrapper's offsets, as the kernel
    finds them (``find_group``: the last group whose first item is at or
    before the item, a binary search): ``(group, first row, end row)``."""
    offsets = tgm._offsets(group_sizes).tolist()
    tile_off = tgm._tile_offsets(group_sizes, tile_m).tolist()
    g_count = len(offsets) - 1
    items = []
    for item in range(tile_off[-1]):
        lo, hi = 0, g_count
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if tile_off[mid] <= item else (lo, mid)
        r0 = offsets[lo] + (item - tile_off[lo]) * tile_m
        items.append((lo, r0, min(r0 + tile_m, offsets[lo + 1])))
    return items


# ids: items of 64 rows (any tile size the offsets take) and the kernels' 128
@pytest.mark.parametrize("tile_m", [64, tgm.TILE_M_WG], ids=["int8", "bf16"])
def test_work_items_cover_each_row_once(tile_m):
    """Every row below the groups' total lies in exactly one work item, of
    its own group; the rows past the total in none."""
    sizes = torch.tensor([0, 1, 64, 65, 0, 128, 129, 300, 0, 7], dtype=torch.int32)
    total = int(sizes.sum())
    group_of_row = torch.repeat_interleave(torch.arange(len(sizes)), sizes.long())
    count = torch.zeros(total + 5, dtype=torch.int64)
    for g, r0, r1 in _work_items(sizes, tile_m):
        assert 0 < r1 - r0 <= tile_m
        assert bool((group_of_row[r0:r1] == g).all())
        count[r0:r1] += 1
    assert bool((count[:total] == 1).all()) and not count[total:].any()


def test_bf16_work_items_per_group():
    """Groups of 0, 1, 64, 65, 128 and 129 rows take 0, 1, 1, 1, 1 and 2
    items of the kernels' 128 rows (the offsets' default: K8a's modes, K8b,
    K16a, K16b); items of 64 rows would be 0, 1, 1, 2, 2, 3."""
    sizes = torch.tensor([0, 1, 64, 65, 128, 129], dtype=torch.int32)
    assert tgm.TILE_M_WG == 128
    assert torch.diff(tgm._tile_offsets(sizes)).tolist() == [0, 1, 1, 1, 1, 2]
    assert torch.diff(tgm._tile_offsets(sizes, 64)).tolist() == [0, 1, 1, 2, 2, 3]


def test_work_item_offsets_need_no_host_sync():
    """The offsets are device computations: on meta tensors (whose values
    cannot be read) they come out with their shapes and dtypes."""
    sizes = torch.empty(32, dtype=torch.int32, device="meta")
    for tile_m in (64, tgm.TILE_M_WG):
        off = tgm._tile_offsets(sizes, tile_m)
        assert off.device.type == "meta" and off.shape == (33,) and off.dtype == torch.int32
    assert tgm._offsets(sizes).shape == (33,)
