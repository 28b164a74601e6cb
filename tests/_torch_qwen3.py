"""Shared by the Qwen3-Next parity tests: small widths, JAX's hybrid
weights and the port's copies, caches of random history."""

import dataclasses

import jax
import numpy as np
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.models import qwen3_next as jm
from sgl_kernel_npu_tpu_torch.models import qwen3_next as tm

PAGE = 4
SMALL = dict(vocab_size=61, hidden=64, num_k_heads=2, num_v_heads=4, head_k_dim=16,
             head_v_dim=16, num_heads=4, num_kv_heads=2, head_dim=32, page_size=PAGE,
             chunk_size=8, mlp_intermediate=128)
FULL = dict(attn_gate=True, qk_norm=True, rotary_dim=16, moe_experts=8, moe_topk=3,
            moe_intermediate=32, shared_expert_intermediate=32)


def _close(got, want, rel):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=rel * np.abs(want).max())


def _cfgs(**fields):
    jcfg = jm.Qwen3NextHybridConfig(**{**SMALL, **fields})
    return jcfg, tm.Qwen3NextHybridConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed, tdt=torch.float32, jdt=None, w_lm=False):
    """JAX's hybrid weights (an untied head drawn from numpy when asked)
    and the port's copies."""
    with jax.default_matmul_precision("float32"):
        params = jm.init_hybrid_weights(jax.random.key(seed), jcfg)
    params = jax.tree.map(np.asarray, params)
    if w_lm:
        rng = np.random.default_rng(seed)
        params["w_lm"] = (rng.standard_normal((jcfg.hidden, jcfg.vocab_size)) * 0.02).astype(
            np.float32)
    jp = jax.tree.map(lambda a: a if a.dtype.kind == "U" else jx(a, jdt), params)
    jp["layers"] = [{k: (str(v) if k == "kind" else v) for k, v in lw.items()}
                    for lw in jp["layers"]]
    return jp, tm.from_jax_params(params, device="cpu", dtype=tdt)


def _caches(rng, jcfg, num_pages, slots, jdt, tdt):
    """Per-layer caches of random history: K / V pages and GDN states."""
    out_j, out_t = [], []
    for c in jm.init_hybrid_cache(jcfg, num_pages, slots):
        lj, lt = {}, {}
        for k, v in c.items():
            a = (rng.standard_normal(v.shape) * (0.2 if k == "ssm" else 0.5)).astype(np.float32)
            d_j, d_t = (None, None) if k == "ssm" else (jdt, tdt)
            lj[k], lt[k] = jx(a, d_j), tt(a, d_t)
        out_j.append(lj)
        out_t.append(lt)
    return out_j, out_t


def _slots(bt_row, positions):
    return np.asarray([bt_row[p // PAGE] * PAGE + p % PAGE for p in positions], np.int32)


def step_inputs(jcfg, seed, jdt, tdt):
    """:func:`run_steps`' inputs from ``seed``: caches of random history
    (JAX's and the port's), the decode batch and the prefill chunk."""
    rng = np.random.default_rng(seed)
    c_j, c_t = _caches(rng, jcfg, 33, 5, jdt, tdt)
    bt = np.arange(1, 33, dtype=np.int32).reshape(4, 8)
    ctx = np.asarray([5, 13, 22, 1], np.int32)
    pos = ctx - 1
    slots = np.asarray([_slots(bt[i], [pos[i]])[0] for i in range(4)], np.int32)
    slots[3] = -1
    state = np.asarray([2, 0, 3, -1], np.int32)
    x = (rng.standard_normal((4, jcfg.hidden)) * 0.5).astype(np.float32)
    n, s, c0 = 9, 12, 30
    pslots = np.concatenate([_slots(bt[1], range(c0 - n, c0)), np.full(s - n, -1, np.int32)])
    xp = (rng.standard_normal((s, jcfg.hidden)) * 0.5).astype(np.float32)
    return dict(c_j=c_j, c_t=c_t, bt=bt, ctx=ctx, pos=pos, slots=slots, state=state, x=x, n=n,
                s=s, c0=c0, pslots=pslots, xp=xp)


def jax_steps(jcfg, jp, inp, jdt, kw_j=None):
    """JAX's decode step, then its prefill chunk on the caches the step
    left → (decode hidden, prefill hidden, caches)."""
    kw_j = kw_j or {}
    i = inp
    with jax.default_matmul_precision("float32"):
        dec = jax.jit(lambda *a: jm.hybrid_decode_step(jcfg, jp, *a, **kw_j))
        yj, c_j = dec(jx(i["x"], jdt), jx(i["pos"]), i["c_j"], jx(i["bt"]), jx(i["ctx"]),
                      jx(i["slots"]), jx(i["state"]))
        args = (jx(np.asarray([i["n"]], np.int32)), jx(i["bt"][1:2]),
                jx(np.asarray([i["c0"]], np.int32)), jx(i["pslots"]),
                jx(np.asarray([1], np.int32)))
        pre = jax.jit(lambda x_, c_, sl, b_, cx, ps, si: jm.hybrid_prefill_step(
            jcfg, jp, x_, sl, c_, b_, cx, ps, si, max_q=i["s"], **kw_j))
        hj, c_j = pre(jx(i["xp"], jdt), c_j, *args)
    return yj, hj, c_j


def port_steps(tcfg, tp, inp, want, tdt, rel, kw_t=None):
    """The port's decode step and prefill chunk on the same inputs, each
    held to ``want`` (:func:`jax_steps`) within ``rel`` of the largest
    value, then every cache; returns the port's caches."""
    kw_t = kw_t or {}
    i = inp
    yj, hj, c_j = want
    c_t = [{k: v.clone() for k, v in c.items()} for c in i["c_t"]]
    yt, c_t = tm.hybrid_decode_step(tcfg, tp, tt(i["x"], tdt), tt(i["pos"]), c_t, tt(i["bt"]),
                                    tt(i["ctx"]), tt(i["slots"]), tt(i["state"]), **kw_t)
    assert yt.dtype == tdt
    _close(yt[:3], yj[:3], rel)
    n = i["n"]
    ht, c_t = tm.hybrid_prefill_step(
        tcfg, tp, tt(i["xp"], tdt), tt(np.asarray([n], np.int32)), c_t, tt(i["bt"][1:2]),
        tt(np.asarray([i["c0"]], np.int32)), tt(i["pslots"]), tt(np.asarray([1], np.int32)),
        max_q=i["s"], **kw_t)
    _close(ht[:n], hj[:n], rel)
    for lj, lt in zip(c_j, c_t):
        for k in lj:
            _close(lt[k], lj[k], rel)
    return c_t


def run_steps(jcfg, tcfg, jp, tp, seed, jdt, tdt, rel, kw_j=None, kw_t=None):
    """A decode step (3 live rows at contexts 5, 13, 22 on state slots 2, 0,
    3, and a pad row: slot -1, state -1), then one request's 12-row prefill
    chunk (9 tokens at context 30, 3 pad rows) on state slot 1, both over
    caches of random history: hidden states, then every cache, compared."""
    inp = step_inputs(jcfg, seed, jdt, tdt)
    return port_steps(tcfg, tp, inp, jax_steps(jcfg, jp, inp, jdt, kw_j), tdt, rel, kw_t)
