"""Port parity: DeepSeek-V3 decode_step / prefill_step with W8A8 experts.

Two layers at hidden 256 under both router scorings; the JAX weights cross
over through ``from_jax_params``.  Tolerance: 1% of max|hidden| — both paths
requantize the expert activations to int8 (a boundary value can flip by one
level) and the JAX GMM2 kernel rounds each expert output to bf16 before the
combine, where the port keeps f32 (relative 2^-9 per expert)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, port_config, tt
from sgl_kernel_npu_tpu.models import deepseek_v3 as jm
from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tm
from sgl_kernel_npu_tpu_torch.parallel.fused_moe import quantize_expert_weights

PAGE = 16


def _setup(scoring):
    kw = (dict(router_scoring="sigmoid_v3", n_group=4, topk_group=2,
               routed_scaling_factor=2.5) if scoring == "sigmoid_v3" else {})
    jcfg = jm.DeepSeekV3Config(num_layers=2, page_size=PAGE, vocab_size=64, **kw)
    tcfg = port_config(jcfg, tm.DeepSeekV3Config)
    params = jm.init_weights(jax.random.key(0), jcfg, jnp.float32)
    rng = np.random.default_rng(0)
    if scoring == "sigmoid_v3":   # a checkpoint's choice bias (utils/hf_loader.py)
        for lw in params["layers"]:
            lw["router_bias"] = jnp.asarray(
                rng.standard_normal(jcfg.num_experts) * 0.01, jnp.float32)
    moe_j = jm.quantize_moe_weights(jcfg, params)
    tparams, moe_t = tm.from_jax_params(jax.tree.map(np.asarray, params),
                                        jax.tree.map(np.asarray, moe_j), device="cpu")
    return jcfg, tcfg, params, moe_j, tparams, moe_t, rng


def _random_caches(rng, jcfg, num_pages):
    caches = jm.init_kv_cache(jcfg, num_pages, jnp.float32)
    for c in caches:
        c["nope"] = jx(rng.standard_normal(c["nope"].shape).astype(np.float32))
        c["rope"] = jx(rng.standard_normal(c["rope"].shape).astype(np.float32))
    return caches, [{k: tt(np.asarray(v)) for k, v in c.items()} for c in caches]


def _close(got, want):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=0.01 * np.abs(want).max())


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid_v3"])
def test_decode_then_prefill_match_jax(scoring):
    """One decode step (a length-1 sequence and a slot -1 row included), then
    a packed varlen prefill of three requests with two pad rows, on the cache
    state the decode left; hidden outputs and caches compared."""
    jcfg, tcfg, params, moe_j, tparams, moe_t, rng = _setup(scoring)
    assert ("router_bias" in tparams["layers"][0]) == (scoring == "sigmoid_v3")
    n = 5
    kv_j, kv_t = _random_caches(rng, jcfg, 4 * n + 1)
    hidden = rng.standard_normal((n, jcfg.hidden)).astype(np.float32)
    bt = np.arange(1, 1 + 4 * n).reshape(n, 4).astype(np.int32)
    seq = np.asarray([1, 7, 20, 33, 64], np.int32)
    pos = seq - 1
    slots = (bt[np.arange(n), pos // PAGE] * PAGE + pos % PAGE).astype(np.int32)
    slots[0] = -1
    yj, kv_j = jm.decode_step(jcfg, params, jx(hidden), jx(pos), kv_j, jx(bt), jx(seq),
                              jx(slots), moe_weights_q=moe_j)
    yt, kv_t = tm.decode_step(tcfg, tparams, tt(hidden), tt(pos), kv_t, tt(bt), tt(seq),
                              tt(slots), moe_weights_q=moe_t)
    _close(yt, yj)
    for cj, ct in zip(kv_j, kv_t):
        for key in ("nope", "rope"):
            np.testing.assert_allclose(np32(ct[key]), np32(cj[key]), atol=1e-2)

    sl = np.asarray([3, 25, 10], np.int32)
    ctx = np.asarray([40, 25, 64], np.int32)
    bt3 = np.arange(1, 13).reshape(3, 4).astype(np.int32)
    slots3 = [bt3[b, p // PAGE] * PAGE + p % PAGE
              for b in range(3) for p in range(ctx[b] - sl[b], ctx[b])] + [-1, -1]
    slots3 = np.asarray(slots3, np.int32)
    hid = rng.standard_normal((len(slots3), jcfg.hidden)).astype(np.float32)
    yj, _ = jm.prefill_step(jcfg, params, jx(hid), jx(sl), kv_j, jx(bt3), jx(ctx),
                            jx(slots3), max_q=len(slots3), moe_weights_q=moe_j)
    yt, _ = tm.prefill_step(tcfg, tparams, tt(hid), tt(sl), kv_t, tt(bt3), tt(ctx),
                            tt(slots3), max_q=len(slots3), moe_weights_q=moe_t)
    _close(yt, yj)


def test_quantize_moe_weights_within_one_lsb():
    jcfg, tcfg, params, moe_j, tparams, _, _ = _setup("softmax")
    ours = tm.quantize_moe_weights(tcfg, tparams)
    for lj, lt in zip(moe_j, ours):
        for aj, at in zip(lj, lt):
            aj = np.asarray(aj)
            assert at.dtype == {np.dtype(np.int8): torch.int8,
                                np.dtype(np.float32): torch.float32}[aj.dtype]
            if aj.dtype == np.int8:
                assert np.abs(at.numpy().astype(np.int32) - aj.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(at.numpy(), aj, rtol=1e-6)


def test_router_matches_jax():
    """Top-k ids and weights of both scorings over many tokens."""
    for scoring in ("softmax", "sigmoid_v3"):
        jcfg, tcfg, params, _, tparams, _, rng = _setup(scoring)
        x = rng.standard_normal((64, jcfg.hidden)).astype(np.float32)
        ij, wj = jm._router(jcfg, params["layers"][0], jx(x))
        it, wt = tm._router(tcfg, tparams["layers"][0], tt(x))
        np.testing.assert_array_equal(np.sort(it.numpy(), 1), np.sort(np.asarray(ij), 1))
        np.testing.assert_allclose(np.sort(wt.numpy(), 1), np.sort(np32(wj), 1), rtol=1e-5)


def test_unported_switches_raise():
    cfg = tm.DeepSeekV3Config(num_layers=1)
    params = tm.init_weights(cfg, 0, device="cpu")
    x = torch.zeros((600, cfg.hidden))
    idx = torch.zeros((600, cfg.topk), dtype=torch.int32)
    w = torch.ones((600, cfg.topk))
    moe = tm.quantize_moe_weights(cfg, params)[0]
    with pytest.raises(NotImplementedError, match="K8"):
        tm._gmm_moe(cfg, moe, x, idx, w)
    with pytest.raises(NotImplementedError):
        tm.decode_step(cfg, params, x[:1], torch.zeros(1, dtype=torch.int32),
                       tm.init_kv_cache(cfg, 2, device="cpu"),
                       torch.zeros((1, 1), dtype=torch.int32),
                       torch.ones(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="K8"):   # packing narrower than 2I
        quantize_expert_weights(torch.zeros((1, 128, 8192)), torch.zeros((1, 128, 8192)),
                                   torch.zeros((1, 8192, 128)))
