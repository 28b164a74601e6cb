"""Port parity: DeepSeek-V3's head-parallel decode (``models.deepseek_v3.
tp_shard_layer`` / ``tp_attention_block`` / ``decode_step_tp``) on two gloo
ranks against JAX's ``decode_step_tp`` on a 2-device ``tp`` mesh.

A small config (2 layers, hidden 256, 8 heads: 4 a rank, 16 experts, page
16) from ``jax.random.key(4)``; four decode rows at contexts 6, 21, 13 and
31 over a random cache history, on the float cache and on the int8 latent
cache.  One spawn of two rank processes (``tests/_torch_mr_ranks.py``, task
``"tp"``); JAX's goldens are made while the ranks run.  Held: the hidden
states of both ranks bit-equal and within 1e-5 of the largest value of
JAX's (f32 sums in another order), every rank's caches (replicated: each
rank writes the same latent pages) against JAX's (float within 1e-5, int8
levels equal) and the port's one-rank ``decode_step`` on the same inputs
within 1e-5.  A DSA config raises ``NotImplementedError``, as JAX's does;
an unsharded layer raises ``ValueError``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_mr_ranks import start_ranks
from _torch_parity import np32, port_config
from sgl_kernel_npu_tpu.models import deepseek_v3 as jm
from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tm

TP, PAGES, PAGE = 2, 9, 16
POS = np.asarray([5, 20, 12, 30], np.int32)
KINDS = ("bf16", "int8")


def _cfg(kind="bf16", **kw):
    return jm.DeepSeekV3Config(num_layers=2, page_size=PAGE, vocab_size=61, num_heads=8,
                               kv_cache_dtype=kind, **kw)


def _inputs(rng):
    cfg = _cfg()
    bt = np.arange(1, PAGES, dtype=np.int32).reshape(4, 2)
    slots = (bt[np.arange(4), POS // PAGE] * PAGE + POS % PAGE).astype(np.int32)
    cases = {}
    for kind in KINDS:
        caches = []
        for _ in range(cfg.num_layers):
            nope = rng.standard_normal((PAGES, 1, PAGE, cfg.kv_lora_rank)) * 0.5
            if kind == "int8":
                nope = np.clip(np.round(nope * 64), -127, 127).astype(np.int8)
            caches.append({"nope": nope.astype(np.int8 if kind == "int8" else np.float32),
                           "rope": (rng.standard_normal((PAGES, 1, cfg.qk_rope_dim, PAGE))
                                    * 0.5).astype(np.float32)})
        cases[kind] = {"cfg": dataclasses.asdict(port_config(_cfg(kind), tm.DeepSeekV3Config)),
                       "caches": caches}
    return dict(hidden=(rng.standard_normal((4, cfg.hidden)) * 0.3).astype(np.float32),
                pos=POS, seq=POS + 1, bt=bt, slots=slots, cases=cases)


def _args(inp, caches, conv):
    return (conv(inp["hidden"]), conv(inp["pos"]), caches, conv(inp["bt"]), conv(inp["seq"]),
            conv(inp["slots"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = jax.tree.map(np.asarray, jm.init_weights(jax.random.key(4), _cfg(), jnp.float32))
    inp = _inputs(np.random.default_rng(28))
    wait = start_ranks(tmp_path_factory.mktemp("tp"),
                       {"task": "tp", "world": TP, "tp": TP, "params": params, **inp})
    mesh = Mesh(np.array(jax.devices()[:TP]), ("tp",))
    want, one_rank = {}, {}
    tparams, _, _, _ = tm.from_jax_params(params, device="cpu")
    for kind in KINDS:
        caches = jax.tree.map(jnp.asarray, inp["cases"][kind]["caches"])
        step = jax.jit(functools.partial(jm.decode_step_tp, _cfg(kind), mesh=mesh))
        h, caches = step(params, *_args(inp, caches, jnp.asarray))
        want[kind] = {"h": np32(h), "caches": jax.tree.map(np.asarray, caches)}
        tcaches = [{n: torch.from_numpy(a.copy()) for n, a in layer.items()}
                   for layer in inp["cases"][kind]["caches"]]
        h1, _ = tm.decode_step(tm.DeepSeekV3Config(**inp["cases"][kind]["cfg"]), tparams,
                               *_args(inp, tcaches, lambda a: torch.from_numpy(a.copy())),
                               plain=True)
        one_rank[kind] = np32(h1)
    return want, one_rank, wait()


def _close(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("kind", KINDS)
def test_decode_step_tp_matches_jax(runs, kind):
    want, one_rank, outs = runs
    np.testing.assert_array_equal(outs[1][kind]["h"], outs[0][kind]["h"])
    _close(outs[0][kind]["h"], want[kind]["h"])
    _close(outs[0][kind]["h"], one_rank[kind])
    for out in outs:
        for layer, wlayer in zip(out[kind]["caches"], want[kind]["caches"]):
            for name in ("nope", "rope"):
                if layer[name].dtype == np.int8:
                    np.testing.assert_array_equal(layer[name], wlayer[name])
                else:
                    _close(layer[name], wlayer[name])


def test_tp_shard_layer_takes_this_ranks_heads():
    params = jax.tree.map(np.asarray, jm.init_weights(jax.random.key(4), _cfg(), jnp.float32))
    tparams, _, _, _ = tm.from_jax_params(params, device="cpu")
    lw = tparams["layers"][0]
    h, qk, v = 8, _cfg().qk_dim, _cfg().v_head_dim
    parts = [tm.tp_shard_layer(lw, r, TP) for r in range(TP)]
    np.testing.assert_array_equal(torch.cat([p["wuq"] for p in parts], 1).numpy(),
                                  lw["wuq"].numpy())
    for name, dim in (("wuk", 0), ("wvu", 0), ("wo", 0)):
        np.testing.assert_array_equal(torch.cat([p[name] for p in parts], dim).numpy(),
                                      lw[name].numpy())
    assert parts[1]["wuq"].shape == (lw["wuq"].shape[0], h // TP * qk)
    assert parts[1]["wo"].shape == (h // TP * v, lw["wo"].shape[1])
    assert parts[1]["w_gate"] is lw["w_gate"]          # replicated: the same tensor
    with pytest.raises(ValueError, match="divide"):
        tm.tp_shard_layer(lw, 0, 3)


def test_decode_step_tp_refusals():
    cfg = port_config(_cfg(sparse_count=32), tm.DeepSeekV3Config)
    with pytest.raises(NotImplementedError, match="DSA"):
        tm.decode_step_tp(cfg, {"layers": []}, None, None, None, None, None, None, group=None)
    jcfg = _cfg(sparse_count=32)
    with pytest.raises(NotImplementedError, match="DSA"):
        jm.decode_step_tp(jcfg, {"layers": []}, None, None, None, None, None, None,
                          mesh=Mesh(np.array(jax.devices()[:TP]), ("tp",)))
    params = tm.init_weights(port_config(_cfg(), tm.DeepSeekV3Config), 0, device="cpu")
    x = torch.zeros((1, 256))
    one = torch.ones((1,), dtype=torch.int64)
    caches = tm.init_kv_cache(port_config(_cfg(), tm.DeepSeekV3Config), 2, torch.float32,
                              device="cpu")
    half = {**params, "layers": [tm.tp_shard_layer(lw, 0, 2) for lw in params["layers"]]}
    with pytest.raises(ValueError, match="tp_shard_layer"):     # a one-rank group, half the heads
        tm.decode_step_tp(port_config(_cfg(), tm.DeepSeekV3Config), half, x, one, caches,
                          torch.ones((1, 1), dtype=torch.int32), one + 1,
                          torch.tensor([17], dtype=torch.int32), group=None)
