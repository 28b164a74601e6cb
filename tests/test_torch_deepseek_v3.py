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

from _torch_parity import TwoRankMesh, jx, np32, port_config, tt
from sgl_kernel_npu_tpu.models import deepseek_v3 as jm
from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tm

PAGE = 16


def _setup(scoring, **fields):
    kw = (dict(router_scoring="sigmoid_v3", n_group=4, topk_group=2,
               routed_scaling_factor=2.5) if scoring == "sigmoid_v3" else {})
    jcfg = jm.DeepSeekV3Config(num_layers=2, page_size=PAGE, vocab_size=64, **kw, **fields)
    tcfg = port_config(jcfg, tm.DeepSeekV3Config)
    params = jm.init_weights(jax.random.key(0), jcfg, jnp.float32)
    rng = np.random.default_rng(0)
    if scoring == "sigmoid_v3":   # a checkpoint's choice bias (utils/hf_loader.py)
        for lw in params["layers"]:
            lw["router_bias"] = jnp.asarray(
                rng.standard_normal(jcfg.num_experts) * 0.01, jnp.float32)
    moe_j = jm.quantize_moe_weights(jcfg, params)
    tparams, moe_t, _, _ = tm.from_jax_params(jax.tree.map(np.asarray, params),
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


def _decode_inputs(rng, jcfg, n=5):
    """A decode batch with a length-1 sequence and a slot -1 row, over random
    caches: ``(kv_j, kv_t, hidden, bt, seq, pos, slots)``."""
    kv_j, kv_t = _random_caches(rng, jcfg, 4 * n + 1)
    hidden = rng.standard_normal((n, jcfg.hidden)).astype(np.float32)
    bt = np.arange(1, 1 + 4 * n).reshape(n, 4).astype(np.int32)
    seq = np.asarray([1, 7, 20, 33, 64], np.int32)
    pos = seq - 1
    slots = (bt[np.arange(n), pos // PAGE] * PAGE + pos % PAGE).astype(np.int32)
    slots[0] = -1
    return kv_j, kv_t, hidden, bt, seq, pos, slots


def _decode_then_prefill(jcfg, tcfg, params, tparams, rng, jkw, tkw, close,
                         dtype=np.float32, cache_atol=1e-2):
    """One decode step (:func:`_decode_inputs`), then a packed varlen prefill of three requests with two pad rows, on the cache
    state the decode left; hidden outputs (via ``close``) and caches (within
    ``cache_atol``) compared.  ``dtype`` is the hidden states' (``"bfloat16"``
    rounds them on both sides); the steps' keyword switches are ``jkw`` /
    ``tkw``."""
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
                else (jnp.float32, torch.float32))
    kv_j, kv_t, hidden, bt, seq, pos, slots = _decode_inputs(rng, jcfg)
    yj, kv_j = jm.decode_step(jcfg, params, jx(hidden, jdt), jx(pos), kv_j, jx(bt), jx(seq),
                              jx(slots), **jkw)
    yt, kv_t = tm.decode_step(tcfg, tparams, tt(hidden, tdt), tt(pos), kv_t, tt(bt), tt(seq),
                              tt(slots), **tkw)
    close(yt, yj)
    for cj, ct in zip(kv_j, kv_t):
        for key in ("nope", "rope"):
            np.testing.assert_allclose(np32(ct[key]), np32(cj[key]), atol=cache_atol)

    sl = np.asarray([3, 25, 10], np.int32)
    ctx = np.asarray([40, 25, 64], np.int32)
    bt3 = np.arange(1, 13).reshape(3, 4).astype(np.int32)
    slots3 = [bt3[b, p // PAGE] * PAGE + p % PAGE
              for b in range(3) for p in range(ctx[b] - sl[b], ctx[b])] + [-1, -1]
    slots3 = np.asarray(slots3, np.int32)
    hid = rng.standard_normal((len(slots3), jcfg.hidden)).astype(np.float32)
    yj, _ = jm.prefill_step(jcfg, params, jx(hid, jdt), jx(sl), kv_j, jx(bt3), jx(ctx),
                            jx(slots3), max_q=len(slots3), **jkw)
    yt, _ = tm.prefill_step(tcfg, tparams, tt(hid, tdt), tt(sl), kv_t, tt(bt3), tt(ctx),
                            tt(slots3), max_q=len(slots3), **tkw)
    close(yt, yj)


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid_v3"])
def test_decode_then_prefill_match_jax(scoring):
    jcfg, tcfg, params, moe_j, tparams, moe_t, rng = _setup(scoring)
    assert ("router_bias" in tparams["layers"][0]) == (scoring == "sigmoid_v3")
    _decode_then_prefill(jcfg, tcfg, params, tparams, rng, dict(moe_weights_q=moe_j),
                         dict(moe_weights_q=moe_t), _close)


def test_decode_then_prefill_dispatch_branch_match_jax():
    """At ``moe_intermediate=96`` the W8A8 MoE of every step (at most 512
    tokens, 2I % 256 != 0) runs ``_gmm_moe``'s dispatch_p + K8b branch on
    both sides.  Tolerances as above."""
    jcfg, tcfg, params, moe_j, tparams, moe_t, rng = _setup("sigmoid_v3", moe_intermediate=96)
    _decode_then_prefill(jcfg, tcfg, params, tparams, rng, dict(moe_weights_q=moe_j),
                         dict(moe_weights_q=moe_t), _close)


@pytest.mark.parametrize("n_tok", [8, 64])
def test_gmm_moe_dispatch_branch_matches_jax(n_tok):
    """``_gmm_moe`` at widths the ring GEMMs refuse (I 96): K8a with the
    one-hot ``dispatch_p`` then K8b on the hi / lo combine masks, on the
    same routing as JAX's; within 1e-2 of each row's largest value (int8
    requant flips at a rounding tie)."""
    cfg = jm.DeepSeekV3Config(num_layers=1, moe_intermediate=96)
    rng = np.random.default_rng(5)
    e, h, i = cfg.num_experts, cfg.hidden, cfg.moe_intermediate
    ws = [(rng.standard_normal(s) * s[1] ** -0.5).astype(np.float32)
          for s in ((e, h, i), (e, h, i), (e, i, h))]
    moe_j = jm.quantize_moe_weights(cfg, {"layers": [dict(zip(("w_gate", "w_up", "w_down"),
                                                              map(jx, ws)))]})[0]
    moe_t = tuple(tt(np.asarray(a)) for a in moe_j)
    x = rng.standard_normal((n_tok, h)).astype(np.float32)
    idx = np.stack([rng.choice(e, cfg.topk, replace=False) for _ in range(n_tok)]).astype(np.int32)
    topw = rng.random((n_tok, cfg.topk)).astype(np.float32)
    want = np32(jm._gmm_moe(cfg, moe_j, jx(x), jx(idx), jx(topw)))
    tcfg = port_config(cfg, tm.DeepSeekV3Config)
    got = tm._gmm_moe(tcfg, moe_t, tt(x), tt(idx), tt(topw))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(np32(got) - want).max(-1) / np.abs(want).max(-1)
    assert err.max() <= 1e-2, err.max()
    rows = tm._moe_rows(tt(x), tt(idx), e)
    torch.testing.assert_close(tm._gmm_moe_dispatch(moe_t, rows, tt(topw)), got, rtol=0, atol=0)


@pytest.mark.parametrize("tn", [64, 128, None])
def test_quantize_moe_weights_pack_width_matches_jax(tn):
    """``quantize_moe_weights(tn=...)`` packs gate / up in slabs of ``tn``
    bit-equal to JAX's (None: ``moe_pack_tn``'s full width)."""
    cfg = jm.DeepSeekV3Config(num_layers=1)
    params = jm.init_weights(jax.random.key(2), cfg, jnp.float32)
    want = jm.quantize_moe_weights(cfg, params, tn=tn)[0]
    tparams, _, _, _ = tm.from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    got = tm.quantize_moe_weights(port_config(cfg, tm.DeepSeekV3Config), tparams, tn=tn)[0]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", ["pallas_ragged", "xla", "eplb"])
def test_ep_decode_then_prefill_match_jax(mode):
    """The W8A8 MoE expert parallel (``ep_buffer``: ``Buffer.fused_deep_moe``
    on a one-rank group, the port on the window transport or the
    collective) against JAX's ``Buffer`` on a one-device mesh; ``eplb``
    serves a placement of 20 physical slots for the 16 experts (replicas of
    the hottest), its tables remapping the routing.  Tolerances as the W8A8
    cases above (1% of max|hidden|)."""
    from sgl_kernel_npu_tpu.config import EPConfig as JEPConfig
    from sgl_kernel_npu_tpu.parallel import eplb as jeplb
    from sgl_kernel_npu_tpu.parallel.buffer import Buffer as JBuffer

    from _torch_parity import one_rank_group
    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.parallel import eplb
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer

    jcfg, tcfg, params, moe_j, tparams, moe_t, rng = _setup("softmax")
    n_exp = jcfg.num_experts
    jkw, tkw = dict(moe_weights_q=moe_j), dict(moe_weights_q=moe_t)
    if mode == "eplb":
        place = eplb.make_placement(np.arange(n_exp) + 1.0, 1, n_exp + 4)
        n_exp += 4
        jkw = dict(moe_weights_q=[tuple(jeplb.physical_expert_weights(a, place) for a in lw)
                                  for lw in moe_j], eplb_tables=jeplb.make_remap_tables(place, 16))
        tkw = dict(moe_weights_q=[tuple(eplb.physical_expert_weights(a, place) for a in lw)
                                  for lw in moe_t],
                   eplb_tables=eplb.make_remap_tables(place, 16, device="cpu"))
    mesh1 = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("ep",))
    jkw["ep_buffer"] = JBuffer(mesh1, "ep", n_exp, JEPConfig())
    tkw["ep_buffer"] = Buffer(one_rank_group(), n_exp, EPConfig(
        comm_backend="xla" if mode == "xla" else "pallas_ragged"))
    _decode_then_prefill(jcfg, tcfg, params, tparams, rng, jkw, tkw, _close)


def _w8a8_weights(jcfg, params):
    """The JAX package's fused-prologue and dense W8A8 weights, and the port's
    copies of them (calibrated on one sample of post-embedding scale)."""
    sample = jx(np.random.default_rng(14).standard_normal((16, jcfg.hidden)) * 0.3,
                jnp.float32)
    mla_j = jm.make_mla_preprocess_weights(jcfg, params, sample)
    dense_j = jm.quantize_dense_weights(jcfg, params)
    _, _, mla_t, dense_t = tm.from_jax_params(
        jax.tree.map(np.asarray, params), device="cpu",
        mla_wq_np=jax.tree.map(np.asarray, mla_j), dense_wq_np=jax.tree.map(np.asarray, dense_j))
    return sample, mla_j, dense_j, mla_t, dense_t


def _rows_close(got, want, tol=0.02, outliers=0):
    """Every row within ``tol`` of max|want|, but for up to ``outliers`` rows."""
    want = np32(want)
    err_row = np.abs(np32(got) - want).max(axis=-1) / np.abs(want).max()
    assert (err_row > tol).sum() <= outliers, err_row


def test_fully_w8a8_decode_then_prefill_match_jax():
    """The fully W8A8 layer (``mla_wq`` + ``dense_wq`` + ``moe_weights_q``).
    Rows within 2% of max|hidden| (int8 activations are requantized five
    times a layer, and a value at a rounding tie may land one level apart on
    the two sides), but one row a step: such a flip can move a router
    near-tie, and a row routed to other experts on one side is not comparable
    (this input's prefill has one, in layer 2).  Caches within 8e-2, 2% of
    their largest values (a flip of the static quant before ``wdqkv`` moves a
    latent by up to ~4e-2)."""
    jcfg, tcfg, params, moe_j, tparams, moe_t, rng = _setup("softmax")
    _, mla_j, dense_j, mla_t, dense_t = _w8a8_weights(jcfg, params)
    _decode_then_prefill(
        jcfg, tcfg, params, tparams, rng,
        dict(moe_weights_q=moe_j, mla_wq=mla_j, dense_wq=dense_j),
        dict(moe_weights_q=moe_t, mla_wq=mla_t, dense_wq=dense_t),
        lambda got, want: _rows_close(got, want, outliers=1), cache_atol=8e-2)


def test_fully_w8a8_residual_turns_f32_like_jax():
    """bf16 hidden states through the fully W8A8 decode step: the W8A8
    projections return f32, so the residual stream turns f32 on both sides.
    Rows within 2% of max|hidden|, but one (a routing flip, as above)."""
    jcfg, tcfg, params, moe_j, tparams, moe_t, rng = _setup("softmax")
    _, mla_j, dense_j, mla_t, dense_t = _w8a8_weights(jcfg, params)
    kv_j, kv_t, hidden, bt, seq, pos, slots = _decode_inputs(rng, jcfg)
    yj, _ = jm.decode_step(jcfg, params, jx(hidden, jnp.bfloat16), jx(pos), kv_j, jx(bt),
                           jx(seq), jx(slots), moe_weights_q=moe_j, mla_wq=mla_j,
                           dense_wq=dense_j)
    yt, _ = tm.decode_step(tcfg, tparams, tt(hidden, torch.bfloat16), tt(pos), kv_t, tt(bt),
                           tt(seq), tt(slots), moe_weights_q=moe_t, mla_wq=mla_t,
                           dense_wq=dense_t)
    assert yj.dtype == jnp.float32 and yt.dtype == torch.float32
    _rows_close(yt, yj, outliers=1)


def test_w8a8_weights_match_jax():
    """``make_mla_preprocess_weights`` and ``quantize_dense_weights`` made by
    the port from the same float weights: int8 within one level (XLA on the
    CPU may multiply by a reciprocal where torch divides), scales rtol 1e-6,
    everything else equal.  The JAX ``wdqkv`` carries a lane pad of zero rows
    that the port's leaves out."""
    jcfg, tcfg, params, _, tparams, _, _ = _setup("softmax")
    sample, mla_j, dense_j, _, _ = _w8a8_weights(jcfg, params)
    mla_t = tm.make_mla_preprocess_weights(tcfg, tparams, tt(np.asarray(sample)))
    dense_t = tm.quantize_dense_weights(tcfg, tparams)

    def same(at, aj, what):
        aj = np.asarray(aj)
        if what in ("wdqkv", "descale1", "bias1"):
            assert aj.shape[0] % 128 == 0 and not aj[at.shape[0]:].any(), what
            aj = aj[: at.shape[0]]
        assert at.dtype == _TORCH_OF[aj.dtype] and tuple(at.shape) == aj.shape, what
        if aj.dtype == np.int8:
            assert np.abs(at.numpy().astype(np.int32) - aj.astype(np.int32)).max() <= 1, what
        else:
            np.testing.assert_allclose(at.numpy(), aj, rtol=1e-6, err_msg=what)

    for wj, wt in zip(mla_j, mla_t):
        assert wt.qnope_scale is None
        for name in wj._fields:
            if name not in ("qnope_scale", "ctkv_scale"):
                same(getattr(wt, name), getattr(wj, name), name)
    for dj, dt in zip(dense_j, dense_t):
        for name in ("wo", "ws_gate_up", "ws_down"):
            same(dt[name][0], dj[name][0], name)
            same(dt[name][1], dj[name][1], name)


_TORCH_OF = {np.dtype(np.int8): torch.int8, np.dtype(np.int32): torch.int32,
             np.dtype(np.float32): torch.float32}


def test_quantize_moe_weights_within_one_lsb():
    jcfg, tcfg, params, moe_j, tparams, _, _ = _setup("softmax")
    ours = tm.quantize_moe_weights(tcfg, tparams)
    for lj, lt in zip(moe_j, ours):
        for aj, at in zip(lj, lt):
            aj = np.asarray(aj)
            assert at.dtype == _TORCH_OF[aj.dtype]
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
    """What the port still leaves to the JAX package raises, naming ROADMAP:
    the gradients of a mesh of more than one rank (item 16); K8a refuses
    ``rhs_contract_last`` with an epilogue, as JAX asserts."""
    from sgl_kernel_npu_tpu_torch.ops.grouped_matmul import grouped_matmul

    cfg = tm.DeepSeekV3Config(num_layers=1)
    xq, gs = torch.zeros((8, 128), dtype=torch.int8), torch.tensor([8], dtype=torch.int32)
    wq = torch.zeros((1, 128, 256), dtype=torch.int8)
    sx, sw = torch.ones(8), torch.ones((1, 256))
    with pytest.raises(ValueError, match="rhs_contract_last"):
        grouped_matmul(xq, wq, gs, sx, sw, epilogue="dequant", rhs_contract_last=True)
    with pytest.raises(NotImplementedError, match="item 16"):
        tm.make_train_step(cfg, mesh=TwoRankMesh())
