"""Port parity on two ranks: the ``Buffer`` methods and the expert-parallel
``train_forward`` against the JAX package on ``mesh2``.

The JAX side runs on two of the conftest's CPU devices (``shard_map`` over
the global arrays); the port's two ranks are two processes of
``tests/_torch_ep_ranks.py``, each on its half of the tokens, in a gloo group
that meets through a ``FileStore`` in ``tmp_path`` (no port to pick; safe
under several pytest workers).  Tolerances as ``test_torch_ep_core.py``: the
dispatched rows, counts and drops exact, int8 scales an f32 ulp, the combine
1e-6 of its largest |value|, ``fused_oai_moe`` (bf16 wire) 1e-2 of a row's
largest; the loss 1e-5 relative (f32 sums in another order).  The window
transports (K15a / K15b's plain versions on gloo) as the collective;
``fused_deep_moe`` on each transport, unfused and ``single_kernel`` (K16b's
plain version), against JAX's unfused form (its suite holds its single
kernel to that form within 4e-4): receive counts and drops exact, a
relative mean difference below 4e-4.  A mesh of two
ranks refuses ``make_train_step`` (its replicated gradients need an
all-reduce, ROADMAP item 16)."""

import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from _torch_parity import jx, np32, port_config
from sgl_kernel_npu_tpu.config import EPConfig as JEPConfig
from sgl_kernel_npu_tpu.models import deepseek_v3 as jm
from sgl_kernel_npu_tpu.parallel.buffer import Buffer as JBuffer
from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tm
from test_torch_deepseek_train import TINY
from test_torch_ep_core import E, H, K, _routing

T2 = 32              # tokens over both ranks
CASES = [("exact-float", dict(num_max_dispatch_tokens_per_rank=4), False),
         ("dropping-int8", dict(num_max_dispatch_tokens_per_rank=4, capacity_factor=0.3), True),
         ("window-float", dict(num_max_dispatch_tokens_per_rank=4, comm_backend="pallas"), False),
         ("ragged-dropping-int8", dict(num_max_dispatch_tokens_per_rank=4, capacity_factor=0.3,
                                       comm_backend="pallas_ragged"), True)]
DEEP_E, DEEP_H, DEEP_I, DEEP_K = 8, 128, 64, 2
HERE = pathlib.Path(__file__).resolve().parent


def run_ranks(work: pathlib.Path, world: int = 2) -> list[dict]:
    """Start the ``world`` rank processes on ``work/inputs.pkl`` (which
    names the same ``world`` where it is not 2); their outputs."""
    env = dict(os.environ, PYTHONPATH=str(HERE.parent), OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen([sys.executable, str(HERE / "_torch_ep_ranks.py"), str(work),
                               str(r)], cwd=HERE.parent, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def test_two_ranks_match_jax(tmp_path, mesh2):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((T2, H)).astype(np.float32)
    idx, w = _routing(rng, t=T2)
    idx_live, _ = _routing(rng, t=T2, dead=0.0)
    inp = {"E": E, "x": x, "idx": idx, "w": w, "idx_live": idx_live, "cases": []}
    want = {}
    for name, kw, int8 in CASES:
        cfg = JEPConfig(**kw)
        cap = 2 * cfg.pair_capacity(T2 // 2, K, 2, E // 2)
        y = rng.standard_normal((2, cap, H)).astype(np.float32)
        jbuf = JBuffer(mesh2, "ep", num_experts=E, config=cfg)
        xs, sc, gs, handle, st = jbuf.dispatch(jx(x), jx(idx), use_int8=int8)
        comb = jbuf.combine(jx(y), jx(w), handle, out_dtype=jnp.float32)
        want[name] = dict(xs=np32(xs), sc=None if sc is None else np32(sc), gs=np.asarray(gs),
                          counts=np.asarray(st["recv_count_matrix"]),
                          dropped=np.asarray(st["num_dropped"]), combined=np32(comb))
        inp["cases"].append(dict(name=name, config=kw, int8=int8, y=y))

    inter = 16
    oai = {"w_gate_up": (rng.standard_normal((E, H, 2 * inter)) * H ** -0.5),
           "b_gate_up": rng.standard_normal((E, 2 * inter)) * 0.1,
           "w_down": rng.standard_normal((E, inter, H)) * inter ** -0.5,
           "b_down": rng.standard_normal((E, H)) * 0.1}
    oai = {k: v.astype(np.float32) for k, v in oai.items()}
    inp["oai"] = oai
    jo, jgs, jdrop = JBuffer(mesh2, "ep", num_experts=E, config=JEPConfig()).fused_oai_moe(
        jx(x, jnp.bfloat16), jx(idx_live), jx(w), *(jx(oai[k]) for k in
                                                    ("w_gate_up", "b_gate_up", "w_down", "b_down")))

    from sgl_kernel_npu_tpu.parallel.fused_moe import quantize_expert_weights

    wq = [np.asarray(a) for a in quantize_expert_weights(
        *(jx(rng.standard_normal(s) * 0.05, jnp.float32) for s in
          ((DEEP_E, DEEP_H, DEEP_I), (DEEP_E, DEEP_H, DEEP_I), (DEEP_E, DEEP_I, DEEP_H))),
        tn=2 * DEEP_I)]
    deep = dict(E=DEEP_E, wq=wq, x=rng.standard_normal((T2, DEEP_H)).astype(np.float32),
                idx=np.stack([rng.choice(DEEP_E, DEEP_K, replace=False)
                              for _ in range(T2)]).astype(np.int32),
                w=rng.random((T2, DEEP_K)).astype(np.float32))
    inp["deep"] = deep
    jdeep = JBuffer(mesh2, "ep", num_experts=DEEP_E, config=JEPConfig()).fused_deep_moe(
        jx(deep["x"]), jx(deep["idx"]), jx(deep["w"]), *map(jx, wq))

    jcfg = jm.DeepSeekV3Config(**TINY)
    params = jm.init_weights(jax.random.key(0), jcfg)
    for lw in params["layers"]:
        lw["router_bias"] = jnp.asarray(rng.standard_normal(jcfg.num_experts) * 0.01, jnp.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("dp", "ep"))
    loss = float(jax.jit(lambda p: jm.train_forward(jcfg, p, jx(tokens), mesh=mesh))(params))
    inp.update(train_cfg=dataclasses.asdict(port_config(jcfg, tm.DeepSeekV3Config)),
               train_params=jax.tree.map(np.asarray, params), tokens=tokens)
    (tmp_path / "inputs.pkl").write_bytes(pickle.dumps(inp))

    ranks = run_ranks(tmp_path)
    t = T2 // 2
    for r, got in enumerate(ranks):
        mine = slice(r * t, (r + 1) * t)
        for name, _, int8 in CASES:
            g, ref = got[name], want[name]
            np.testing.assert_array_equal(g["xs"], ref["xs"][r], err_msg=name)
            np.testing.assert_array_equal(g["gs"], ref["gs"][r], err_msg=name)
            np.testing.assert_array_equal(g["counts"], ref["counts"][r], err_msg=name)
            assert g["dropped"] == int(ref["dropped"][r]), name
            if int8:
                np.testing.assert_allclose(g["sc"], ref["sc"][r], rtol=2e-7, atol=0)
            c = ref["combined"][mine]
            np.testing.assert_allclose(g["combined"], c, rtol=0, atol=1e-6 * np.abs(c).max())
        jo_deep = np32(jdeep[0])[mine]
        for key in (k for k in got if k.startswith("deep-")):
            g = got[key]
            np.testing.assert_array_equal(g["gs"], np.asarray(jdeep[1][r]), err_msg=key)
            assert g["dropped"] == int(jdeep[2][r]) == 0, key
            rel = np.abs(g["out"] - jo_deep).mean() / np.abs(jo_deep).mean()
            assert rel < 4e-4, (key, rel)
        np.testing.assert_array_equal(got["oai"]["gs"], np.asarray(jgs[r]))
        assert got["oai"]["dropped"] == int(jdrop[r]) == 0
        ref = np32(jo)[mine]
        err = np.abs(got["oai"]["out"] - ref).max(-1) / np.abs(ref).max(-1)
        assert err.max() <= 1e-2, (r, err.max())
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss), (r, got["loss"], loss)
        assert "item 16" in got["step_refused"]
    assert int(want["dropping-int8"]["dropped"].sum()) > 0


def test_unequal_token_counts_raise_on_both_ranks(tmp_path):
    """Rank 0 passes 4 tokens and rank 1 passes 6 to ``Buffer.dispatch``
    and to ``Buffer.fused_deep_moe``: the exchanges are sized from the
    token count, so both ranks raise ``ValueError`` together (one
    all-reduce of the counts), naming both extremes, instead of hanging."""
    (tmp_path / "inputs.pkl").write_bytes(pickle.dumps({"task": "unequal"}))
    for r, got in enumerate(run_ranks(tmp_path)):
        assert len(got["errors"]) == 2, (r, got)
        for msg in got["errors"]:
            assert "4 to 6" in msg and f"this rank {4 + 2 * r}" in msg, msg
