"""Port parity: the int8 latent cache (``kv_cache_dtype="int8"``, the
``int8_nzcache`` mode) through ``decode_mla`` (K2), ``mla_prefill_pallas``
(K9a), the fused prologue and the model's steps.

The JAX kernels run in Pallas interpret mode; the port takes its plain path on
CPU tensors.  Tolerances: attention 3e-2 (as ``test_torch_decode_mla.py``:
bf16 q and output, the JAX kernel's P·V in bf16); int8 q and cache levels
within one level (a rounding tie moved by an ulp of the f32 arithmetic before
them); scales rtol 1e-5; model hidden states within 2% of max|hidden| on
every row, with the JAX run's routing replayed in the port (as the fully
W8A8 case of ``test_torch_deepseek_v3.py``, the int8 steps move router
near-ties)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, port_config, tt
from sgl_kernel_npu_tpu.models import deepseek_v3 as jm
from sgl_kernel_npu_tpu.ops.attention import decode_attention as jda
from sgl_kernel_npu_tpu.ops.attention import mla_preprocess as jmp
from sgl_kernel_npu_tpu.ops.attention import mla_prefill as jpf
from sgl_kernel_npu_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tm
from sgl_kernel_npu_tpu_torch.ops.attention import decode_attention as tda
from sgl_kernel_npu_tpu_torch.ops.attention import mla_preprocess as tmp
from sgl_kernel_npu_tpu_torch.ops.attention import mla_prefill as tpf

KS = 1.0 / 32                    # ctkv_scale, the JAX config's default


def _int8_cache(rng, n_pages, page, dn=512, dr=64):
    kn = rng.integers(-127, 128, (n_pages, 1, page, dn)).astype(np.int8)
    kr = (rng.standard_normal((n_pages, 1, dr, page)) * 0.5).astype(np.float32)
    return kn, kr


def test_decode_mla_int8_latent_matches_jax():
    """Two sequences and an engine pad row (ctx 1, block table of zeros)."""
    rng = np.random.default_rng(0)
    b, hq, page, max_pages = 3, 8, 16, 4
    kn, kr = _int8_cache(rng, b * max_pages + 1, page)
    q = (rng.standard_normal((b, hq, 576)) * 0.5).astype(np.float32)
    bt = np.concatenate([np.arange(1, 1 + 2 * max_pages).reshape(2, max_pages),
                         np.zeros((1, max_pages), int)]).astype(np.int32)
    ctx = np.asarray([5, 50, 1], np.int32)
    want = np32(jda.decode_mla(jx(q, jnp.bfloat16), jx(kn), jx(kr, jnp.bfloat16), jx(ctx),
                               576 ** -0.5, jx(bt), k_scale=KS))
    got = tda.decode_mla(tt(q, torch.bfloat16), tt(kn), tt(kr, torch.bfloat16), tt(ctx),
                         576 ** -0.5, tt(bt), k_scale=KS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), want, atol=3e-2, rtol=3e-2)
    # the plain version dequantizes the levels: the same as a float cache of k
    flt = tda.decode_mla_ref(tt(q, torch.bfloat16), tt(kn.astype(np.float32) * KS),
                             tt(kr, torch.bfloat16), tt(ctx), 576 ** -0.5, tt(bt))
    np.testing.assert_allclose(np32(got), np32(flt), atol=1e-2, rtol=1e-2)


def test_mla_prefill_int8_latent_matches_jax():
    """Three packed requests and two pad rows (zeros out)."""
    rng = np.random.default_rng(1)
    h, page, max_pages, bsz = 8, 16, 4, 3
    kn, kr = _int8_cache(rng, bsz * max_pages, page)
    bt = rng.permutation(bsz * max_pages).reshape(bsz, max_pages).astype(np.int32)
    ctx = np.asarray([40, 25, 64], np.int32)
    seq = np.asarray([3, 25, 10], np.int32)
    q = (rng.standard_normal((int(seq.sum()) + 2, h, 576)) * 0.5).astype(np.float32)
    args_j = (jx(q, jnp.bfloat16), jx(kn), jx(kr, jnp.bfloat16), jx(seq), jx(bt), jx(ctx),
              576 ** -0.5)
    want = np32(jpf.mla_prefill_pallas(*args_j, max_q=32, q_chunk=16, k_scale=KS))
    want_ref = np32(jpf.mla_prefill_ref(*args_j, k_scale=KS))
    got = tpf.mla_prefill_pallas(tt(q, torch.bfloat16), tt(kn), tt(kr, torch.bfloat16),
                                 tt(seq), tt(bt), tt(ctx), 576 ** -0.5, max_q=32, k_scale=KS)
    np.testing.assert_allclose(np32(got), want, rtol=3e-2, atol=3e-2)
    live = int(seq.sum())
    np.testing.assert_allclose(np32(got)[:live], want_ref[:live], rtol=3e-2, atol=3e-2)
    assert not np32(got)[live:].any()


HID, HEADS, N, Q_RMS, PAGES, PAGE = 256, 4, 16, 1536, 8, 16


def _prologue_weights(rng):
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
        qnope_scale=rng.uniform(2.0, 4.0, HEADS).astype(f32),
        ctkv_scale=np.asarray(KS, f32),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_preprocess_int8_nzcache_matches_jax(dtype):
    """``cache_mode="int8_nzcache"``: int8 q_nope (per-head scale) and int8
    latent cache within one level in f32; in bf16 within one level + 2e-2 of
    the largest level (the bf16 case of ``test_torch_mla_preprocess.py``: a
    bf16 ulp moved across a rounding tie of the static quant moves a GEMM
    input by a level); q_pe and the rope cache as the float modes (1e-5 of the
    largest value in f32, 2e-2 in bf16)."""
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((N, HID)).astype(np.float32)
    wn = _prologue_weights(rng)
    slots = rng.choice(PAGES * PAGE, N, replace=False).astype(np.int32)
    slots[3] = -1
    w_j = jmp.MlaPreprocessWeights(**{k: jnp.asarray(v) for k, v in wn.items()})
    w_t = tmp.MlaPreprocessWeights(**{k: tt(v) for k, v in wn.items()})
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cos_j, sin_j = j_rope_cos_sin(jnp.arange(N), 64)
    cos_t, sin_t = tt(np.asarray(cos_j)), tt(np.asarray(sin_j))
    cn_j, cr_j = jnp.zeros((PAGES, 1, PAGE, 512), jnp.int8), jnp.zeros((PAGES, 1, 64, PAGE), jdt)
    cn_t = torch.zeros((PAGES, 1, PAGE, 512), dtype=torch.int8)
    cr_t = torch.zeros((PAGES, 1, 64, PAGE), dtype=tdt)
    want = jmp.mla_preprocess(jnp.asarray(hidden, jdt), w_j, (cos_j, sin_j), cn_j, cr_j,
                              jnp.asarray(slots), cache_mode="int8_nzcache")
    got = tmp.mla_preprocess(tt(hidden, tdt), w_t, (cos_t, sin_t), cn_t, cr_t, tt(slots),
                             cache_mode="int8_nzcache")
    assert got[2] is cn_t and got[3] is cr_t
    for name, g, wv in zip(("q_nope_out", "q_pe", "cache_nope", "cache_rope"), got, want):
        assert tuple(g.shape) == wv.shape, name
        if wv.dtype == jnp.int8:
            assert g.dtype == torch.int8, name
            wv = np.asarray(wv, np.int32)
            diff = np.abs(g.numpy().astype(np.int32) - wv)
            extra = 0 if dtype == "float32" else 2e-2 * np.abs(wv).max()
            assert diff.max() <= 1 + extra, (name, diff.max())
        else:
            wv = np32(wv)
            tol = 1e-5 if dtype == "float32" else 2e-2
            np.testing.assert_allclose(np32(g), wv, rtol=0, atol=tol * np.abs(wv).max(),
                                       err_msg=name)
    assert np.abs(np.asarray(want[0], np.int32)).max() > 64     # the levels are used


@functools.lru_cache(maxsize=None)
def _model(kv_cache_dtype):
    """Two layers at hidden 256: the JAX weights (W8A8 experts, fused-prologue
    weights calibrated on one sample) and the port's copies of them."""
    jcfg = jm.DeepSeekV3Config(num_layers=2, page_size=16, vocab_size=64,
                               kv_cache_dtype=kv_cache_dtype)
    tcfg = port_config(jcfg, tm.DeepSeekV3Config)
    params = jm.init_weights(jax.random.key(0), jcfg, jnp.float32)
    moe_j = jm.quantize_moe_weights(jcfg, params)
    sample = jx(np.random.default_rng(14).standard_normal((16, jcfg.hidden)) * 0.3,
                jnp.float32)
    mla_j = jm.make_mla_preprocess_weights(jcfg, params, sample)
    tparams, moe_t, mla_t, _ = tm.from_jax_params(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, moe_j), device="cpu",
        mla_wq_np=jax.tree.map(np.asarray, mla_j))
    return jcfg, tcfg, params, moe_j, mla_j, tparams, moe_t, mla_t, sample


def test_make_mla_preprocess_weights_int8_matches_jax():
    """The int8 config's per-head ``qnope_scale`` (rtol 1e-5) and
    ``ctkv_scale``; a bf16 config carries neither."""
    jcfg, tcfg, params, _, mla_j, tparams, _, _, sample = _model("int8")
    mla_t = tm.make_mla_preprocess_weights(tcfg, tparams, tt(np.asarray(sample)))
    for wj, wt in zip(mla_j, mla_t):
        assert wt.qnope_scale.shape == (jcfg.num_heads,)
        np.testing.assert_allclose(wt.qnope_scale.numpy(), np.asarray(wj.qnope_scale),
                                   rtol=1e-5)
        assert float(wt.ctkv_scale) == float(wj.ctkv_scale) == jcfg.ctkv_scale
    bf16_cfg = dataclasses.replace(tcfg, kv_cache_dtype="bf16")
    w = tm.make_mla_preprocess_weights(bf16_cfg, tparams, tt(np.asarray(sample)))[0]
    assert w.qnope_scale is None and w.ctkv_scale is None
    caches = tm.init_kv_cache(tcfg, 3, device="cpu")
    assert caches[0]["nope"].dtype == torch.int8 and caches[0]["rope"].dtype == torch.bfloat16


def _rows_close(got, want, tol=0.02):
    """Every row within ``tol`` of max|want|."""
    want = np32(want)
    err_row = np.abs(np32(got) - want).max(axis=-1) / np.abs(want).max()
    assert (err_row <= tol).all(), np.sort(err_row)[-8:]


def _replay_jax_routing(monkeypatch):
    """The port's router hands out the routing the JAX run just chose, layer
    by layer: routing is discrete, and a near-tie that one ulp moves sends a
    row to other experts (the JAX kernels' bf16 P·V and the int8 steps of the
    fused prologue move many such ties at 520 rows)."""
    record, router = [], jm._router

    def recording(cfg, lw, x):
        ids, w = router(cfg, lw, x)
        record.append((tt(np.asarray(ids)), tt(np32(w))))
        return ids, w

    monkeypatch.setattr(jm, "_router", recording)
    monkeypatch.setattr(tm, "_router", lambda cfg, lw, x: record.pop(0))


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
def test_prefill_520_then_decode_match_jax(kv_cache_dtype, monkeypatch):
    """One 520-token prefill chunk (the MoE on K8a) then a decode step (the
    ring GEMMs), through the fused W8A8 prologue, on a bf16 cache and on the
    int8 latent cache, the routing replayed: hidden states within 2% of
    max|hidden| on every row; latent caches within one int8 level (int8) or
    2e-2 (bf16) in the first layer, 0.1 in the second (whose input the first
    layer's rounding has moved)."""
    jcfg, tcfg, params, moe_j, mla_j, tparams, moe_t, mla_t, _ = _model(kv_cache_dtype)
    _replay_jax_routing(monkeypatch)
    rng = np.random.default_rng(5)
    n, max_pages, page = 520, 36, jcfg.page_size
    kv_j = jm.init_kv_cache(jcfg, max_pages + 1, jnp.bfloat16)
    kv_t = tm.init_kv_cache(tcfg, max_pages + 1, torch.bfloat16, device="cpu")
    bt = np.arange(1, 1 + max_pages, dtype=np.int32)[None, :]
    slots = (bt[0, np.arange(n) // page] * page + np.arange(n) % page).astype(np.int32)
    hid = (rng.standard_normal((n, jcfg.hidden)) * 0.3).astype(np.float32)
    jkw, tkw = dict(moe_weights_q=moe_j, mla_wq=mla_j), dict(moe_weights_q=moe_t, mla_wq=mla_t)
    yj, kv_j = jm.prefill_step(jcfg, params, jx(hid), jx([n]), kv_j, jx(bt), jx([n]),
                               jx(slots), max_q=n, **jkw)
    yt, kv_t = tm.prefill_step(tcfg, tparams, tt(hid), tt(np.asarray([n], np.int32)), kv_t,
                               tt(bt), tt(np.asarray([n], np.int32)), tt(slots), max_q=n, **tkw)
    _rows_close(yt, yj)
    int8 = kv_cache_dtype == "int8"
    for li, (cj, ct) in enumerate(zip(kv_j, kv_t)):
        assert ct["nope"].dtype == (torch.int8 if int8 else torch.bfloat16)
        step = jcfg.ctkv_scale if int8 else 1.0          # latent units of one cache step
        diff = np.abs(np32(ct["nope"]) - np32(cj["nope"])) * step
        # layer 0 reads the same hidden states: one level (int8) or a bf16
        # ulp; layer 1's input already differs by up to 2% of its max (the
        # fully W8A8 test's cache tolerance, 8e-2, plus that)
        assert diff.max() <= (0.1 if li else (step if int8 else 2e-2)), (li, diff.max())
        np.testing.assert_allclose(np32(ct["rope"]), np32(cj["rope"]), atol=0.1 if li else 2e-2)

    pos = np.asarray([n, 0], np.int32)                  # a live row and an engine pad row
    bt2 = np.concatenate([bt, np.zeros_like(bt)]).astype(np.int32)
    ctx = np.asarray([n + 1, 1], np.int32)
    slot = np.asarray([bt[0, n // page] * page + n % page, -1], np.int32)
    x = (rng.standard_normal((2, jcfg.hidden)) * 0.3).astype(np.float32)
    yj, _ = jm.decode_step(jcfg, params, jx(x), jx(pos), kv_j, jx(bt2), jx(ctx), jx(slot),
                           **jkw)
    yt, _ = tm.decode_step(tcfg, tparams, tt(x), tt(pos), kv_t, tt(bt2), tt(ctx), tt(slot),
                           **tkw)
    _rows_close(yt[:1], yj[:1])
