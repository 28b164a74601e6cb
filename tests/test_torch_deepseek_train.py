"""Port parity: DeepSeek-V3 single-GPU training and the dense float MoE.

At the tiny configuration of ``tests/test_aux.py``'s training test (one
layer, hidden 64, 4 heads, 4 experts top-2), here under DeepSeek-V3's
``sigmoid_v3`` routing with a choice bias, in f32, with the JAX weights
crossing over through ``from_jax_params``:

- ``train_forward``'s loss and every gradient leaf of the port's
  ``loss_and_grads``, dense and flash attention (plain K14a-c), against
  ``jax.value_and_grad`` of JAX's dense ``train_forward`` (JAX's own test
  shows its flash path equal to its dense one; it is marked slow, so the JAX
  flash path does not run on the whole model here).  Tolerances: the loss
  1e-5 relative, each leaf 1e-4 of its largest |g| (f32 sums in another
  order; the flash path's softmax sums whole rows where JAX's einsum path
  does too);
- one and two ``make_train_step`` steps against JAX's: the loss 1e-5
  relative, every new leaf within 1e-6 + 1e-5 |p| (one SGD step of lr 1e-3 on
  the gradients above);
- the leaves the loss does not reach (``router_bias``, the DSA indexer
  projections) come back unchanged, and a mesh of two ranks raises;
- the expert-parallel MoE on a one-rank ``DeviceMesh``: ``loss_and_grads``
  (every leaf, dense and flash attention) against ``jax.value_and_grad`` of
  ``train_forward(mesh=Mesh(1x1, ("dp", "ep")))``, and one
  ``make_train_step`` step, with the same tolerances;
- ``decode_step`` / ``prefill_step`` without ``moe_weights_q`` (the dense
  float MoE) against JAX's, 1e-5 of max|hidden| (no int8 anywhere);
- ``Engine`` + ``deepseek_adapter`` without ``moe_weights_q``: its greedy
  tokens against JAX's adapter teacher-forced on them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TwoRankMesh, jx, np32, port_config
from sgl_kernel_npu_tpu.models import deepseek_v3 as jm
from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tm
from sgl_kernel_npu_tpu_torch.runtime.engine import Engine, deepseek_adapter
from test_torch_deepseek_v3 import _decode_then_prefill

TINY = dict(vocab_size=64, hidden=64, num_layers=1, num_heads=4, kv_lora_rank=32,
            qk_rope_dim=16, qk_nope_dim=16, q_lora_rank=32, v_head_dim=16, num_experts=4,
            topk=2, moe_intermediate=32, page_size=8, router_scoring="sigmoid_v3", n_group=2,
            topk_group=1, routed_scaling_factor=2.5)


@pytest.fixture(scope="module")
def model():
    jcfg = jm.DeepSeekV3Config(**TINY)
    params = jm.init_weights(jax.random.key(0), jcfg)
    rng = np.random.default_rng(7)
    for lw in params["layers"]:                 # a checkpoint's choice bias
        lw["router_bias"] = jnp.asarray(rng.standard_normal(jcfg.num_experts) * 0.01,
                                        jnp.float32)
    tparams, _, _, _ = tm.from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    tokens = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    return jcfg, port_config(jcfg, tm.DeepSeekV3Config), params, tparams, tokens


@pytest.fixture(scope="module")
def jax_loss_grads(model):
    jcfg, _, params, _, tokens = model
    return jax.jit(jax.value_and_grad(
        lambda p: jm.train_forward(jcfg, p, jx(tokens), mesh=None)))(params)


def _leaf_rel(got, want):
    want = np32(want)
    return float(np.abs(np32(got) - want).max()) / max(float(np.abs(want).max()), 1e-12)


def _assert_tree_close(got, want, check):
    """Leaf by leaf, the port's dict against JAX's pytree (same keys)."""
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = jax.tree_util.tree_leaves(got)         # torch tensors are leaves to JAX
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        check(jax.tree_util.keystr(path), g, w)


@pytest.mark.parametrize("flash", [False, True])
def test_loss_and_grads_match_jax(model, jax_loss_grads, flash):
    _, tcfg, _, tparams, tokens = model
    lj, gj = jax_loss_grads
    lt, gt = tm.loss_and_grads(tcfg, tparams, torch.from_numpy(tokens), flash=flash)
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))

    def check(name, g, w):
        assert g.shape == tuple(w.shape), name
        if not np.abs(np32(w)).max():           # unreached: exact zeros on both sides
            assert not bool(g.any()), name
            return
        assert _leaf_rel(g, w) < 1e-4, (name, _leaf_rel(g, w))

    _assert_tree_close(gt, gj, check)


@pytest.mark.parametrize("steps", [1, 2])
def test_train_steps_match_jax(model, steps):
    jcfg, tcfg, params, tparams, tokens = model
    jstep = jm.make_train_step(jcfg, None)
    tstep = tm.make_train_step(tcfg, None, flash=True)
    pj, pt = params, tparams
    for _ in range(steps):
        pj, lj = jstep(pj, jx(tokens))
        pt, lt = tstep(pt, torch.from_numpy(tokens))
        assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))

    def check(name, g, w):
        np.testing.assert_allclose(np32(g), np32(w), rtol=1e-5, atol=1e-6, err_msg=name)

    _assert_tree_close(pt, pj, check)


def test_unreached_leaves_come_back_unchanged(model):
    _, tcfg, _, tparams, tokens = model
    new, _ = tm.make_train_step(tcfg)(tparams, torch.from_numpy(tokens))
    old_l, new_l = tparams["layers"][0], new["layers"][0]
    for k in ("router_bias", "w_qidx", "w_kidx", "w_widx"):
        assert new_l[k] is old_l[k], k
    assert not torch.equal(new_l["wdqkv"], old_l["wdqkv"])
    assert not torch.equal(new_l["w_gate"], old_l["w_gate"])


def test_mesh_raises(model):
    """A mesh of more than one rank: ``make_train_step`` and
    ``loss_and_grads`` raise (the replicated gradients need an all-reduce,
    ROADMAP item 16); a mesh without the ("dp", "ep") axes is refused."""
    _, tcfg, _, tparams, tokens = model
    with pytest.raises(NotImplementedError, match="item 16"):
        tm.loss_and_grads(tcfg, tparams, torch.from_numpy(tokens), mesh=TwoRankMesh())
    with pytest.raises(NotImplementedError, match="item 16"):
        tm.make_train_step(tcfg, mesh=TwoRankMesh())
    with pytest.raises(ValueError, match="DeviceMesh"):
        tm.train_forward(tcfg, tparams, torch.from_numpy(tokens), mesh=object())


@pytest.fixture(scope="module")
def jax_ep_mesh():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "ep"))


@pytest.mark.parametrize("flash", [False, True])
def test_ep_loss_and_grads_match_jax(model, jax_ep_mesh, flash):
    """The expert-parallel MoE (``_ep_moe_train`` on ``gmm_train``) on a
    one-rank ``DeviceMesh``: the loss and every gradient leaf against
    ``jax.value_and_grad(train_forward(mesh=Mesh(1x1, ("dp", "ep"))))``, JAX's
    dense attention (its flash path equals it, see above); tolerances as
    :func:`test_loss_and_grads_match_jax`."""
    from _torch_parity import one_rank_mesh

    jcfg, tcfg, params, tparams, tokens = model
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p: jm.train_forward(jcfg, p, jx(tokens), mesh=jax_ep_mesh)))(params)
    lt, gt = tm.loss_and_grads(tcfg, tparams, torch.from_numpy(tokens), mesh=one_rank_mesh(),
                               flash=flash)
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))

    def check(name, g, w):
        assert g.shape == tuple(w.shape), name
        if not np.abs(np32(w)).max():
            assert not bool(g.any()), name
            return
        assert _leaf_rel(g, w) < 1e-4, (name, _leaf_rel(g, w))

    _assert_tree_close(gt, gj, check)


def test_ep_train_step_matches_jax(model, jax_ep_mesh):
    """One ``make_train_step(cfg, mesh)`` step on the one-rank mesh against
    JAX's (its jitted step; the shardings it returns beside it are moot on
    one device); tolerances as :func:`test_train_steps_match_jax`."""
    from _torch_parity import one_rank_mesh

    jcfg, tcfg, params, tparams, tokens = model
    jstep, _ = jm.make_train_step(jcfg, jax_ep_mesh)
    pj, lj = jstep(params, jx(tokens))
    pt, lt = tm.make_train_step(tcfg, one_rank_mesh(), flash=True)(tparams,
                                                                    torch.from_numpy(tokens))
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))

    def check(name, g, w):
        np.testing.assert_allclose(np32(g), np32(w), rtol=1e-5, atol=1e-6, err_msg=name)

    _assert_tree_close(pt, pj, check)


def test_dense_moe_decode_then_prefill_match_jax():
    """The serving steps without ``moe_weights_q`` take the dense float MoE,
    as JAX's do (hidden 256, ``sigmoid_v3``)."""
    jcfg = jm.DeepSeekV3Config(num_layers=1, page_size=16, vocab_size=64,
                               router_scoring="sigmoid_v3", n_group=4, topk_group=2,
                               routed_scaling_factor=2.5)
    params = jm.init_weights(jax.random.key(0), jcfg, jnp.float32)
    rng = np.random.default_rng(0)
    for lw in params["layers"]:
        lw["router_bias"] = jnp.asarray(rng.standard_normal(jcfg.num_experts) * 0.01,
                                        jnp.float32)
    tparams, _, _, _ = tm.from_jax_params(jax.tree.map(np.asarray, params), device="cpu")

    def close(got, want):
        want = np32(want)
        np.testing.assert_allclose(np32(got), want, rtol=0, atol=1e-5 * np.abs(want).max())

    _decode_then_prefill(jcfg, port_config(jcfg, tm.DeepSeekV3Config), params, tparams, rng,
                         {}, {}, close, cache_atol=1e-5)


def test_engine_serves_dense_moe_like_jax(model):
    """``deepseek_adapter(cfg, params)`` without ``moe_weights_q`` serves two
    prompts (the second admitted mid-decode); JAX's adapter, teacher-forced
    on the first one's tokens, picks the same greedy tokens."""
    from sgl_kernel_npu_tpu.runtime.engine import deepseek_adapter as jadapter

    jcfg, tcfg, params, tparams, _ = model
    prompt, n_new = [5, 9, 2, 33, 17, 4, 8, 21, 60, 3], 4
    eng = Engine(deepseek_adapter(tcfg, tparams, device="cpu"), num_pages=32, max_batch=2,
                 max_pages_per_req=8, prefill_chunk=8, device="cpu")
    rid = eng.add_request(prompt, n_new)
    eng.step()
    eng.add_request([40, 41, 42], 2)
    while eng.waiting or eng.running:
        eng.step()
    toks = eng.finished[rid]
    assert len(toks) == n_new and eng.cm.free_pages + eng.cm.cached_pages == 32

    a = jadapter(jcfg, params)
    caches = a.init_cache(16, 1)
    page, n = jcfg.page_size, len(prompt)
    bt = np.arange(1, 9, dtype=np.int32).reshape(1, 8)
    slot = lambda i: int(bt[0, i // page]) * page + i % page
    i32 = lambda v: jx(np.asarray(v, np.int32))
    h, caches = a.prefill_step(a.embed(i32(prompt)), i32([n]), caches, jx(bt), i32([n]),
                               i32([slot(i) for i in range(n)]), None, None)
    want = [int(jnp.argmax(a.lm_head(h[n - 1 : n])[0]))]
    for t, tok in enumerate(toks[:-1]):
        i = n + t
        y, caches = a.decode_step(a.embed(i32([tok])), i32([i]), caches, jx(bt), i32([i + 1]),
                                  i32([slot(i)]), None, None)
        want.append(int(jnp.argmax(a.lm_head(y)[0])))
    assert toks == want
