"""Port parity: ``parallel/layered`` (the two-tier expert-parallel dispatch /
combine) against the JAX package.

Four processes of ``tests/_torch_ep_ranks.py`` (task ``"layered"``, one
spawn a module) form a 2 x 2 (node, ici) grid of gloo ranks, global rank =
node · 2 + ici; JAX runs on a (2, 2) ``("node", "ici")`` mesh of four CPU
devices, its goldens made once a module.  Each case is JAX's
``tests/test_layered.py`` path: dispatch, the expert step y = dequant(recv_x)
· (global expert id + 1), combine with weights 1/K.  Cases: the round trip,
the int8 hops, the normal (prefill) form with its statistics, -1 slots, the
deduplicated node hop (every token's experts on one node), the monitored node
hop (K15c's plain version over the node group; JAX's suite holds its
monitored hop equal to its collective one, so the golden is the collective
hop's) and a dead node (every node-hop send muted by ``_dcn_inject_fault``,
polls bounded at 64: every wait times out, nothing arrives).  Then the same
dead-node drill on a 4 x 1 grid (no intra-node hop, ``ici_group=None``)
against JAX's on a four-node mesh (``ici_axis=None``), as JAX's own drill
runs.

Tolerances: rows, int8 levels, counts, drops, node-hop rows and flags exact;
int8 scales within 2e-7 relative (an f32 ulp); the combine within 1e-6 of the
largest |value| (f32 sums of the same products in another order).
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from _torch_parity import np32
from sgl_kernel_npu_tpu.parallel import layered as jl
from test_torch_ep_two_ranks import run_ranks

N_NODES, RPN = 2, 2
R = N_NODES * RPN
E, T, K, H = 16, 8, 4, 32
E_LOCAL = E // R
CASES = {      # name: (routing, dispatch options, normal form)
    "float": ("random", {}, False),
    "int8": ("random", {"use_int8": True}, False),
    "normal": ("random", {"use_int8": True, "monitor": True}, True),
    "neg1": ("neg1", {}, False),
    "dedup": ("one_node", {"monitor": True}, False),
    "monitored": ("random", {"use_int8": True, "monitor": True, "dcn_transport": "monitored"},
                  False),
    "dead": ("random", {"use_int8": True, "monitor": True, "dcn_transport": "monitored",
                        "dcn_max_poll_rounds": 64, "_dcn_inject_fault": True}, False),
}
GOLDEN = {"monitored": "int8"}      # JAX's collective hop stands for its monitored one


def _routings(rng):
    random = np.stack([rng.choice(E, K, replace=False) for _ in range(R * T)]).astype(np.int32)
    neg1 = random.copy()
    neg1[:, -1] = -1
    nodes = rng.integers(0, N_NODES, R * T)
    one_node = np.stack([rng.choice(E // N_NODES, K, replace=False) + n * (E // N_NODES)
                         for n in nodes]).astype(np.int32)
    return {"random": random, "neg1": neg1, "one_node": one_node}


def _jax_case(mesh, x, idx, opts, normal, grid=(N_NODES, RPN)):
    n_nodes, rpn = grid
    ici = "ici" if rpn > 1 else None
    axes = ("node", "ici") if ici else "node"
    jopts = {k: v for k, v in opts.items() if k != "_dcn_inject_fault"}
    if opts.get("_dcn_inject_fault"):
        jopts.update(_dcn_inject_fault=True, _dcn_force_sem_read=True)
    kw = dict(node_axis="node", ici_axis=ici, num_nodes=n_nodes, ranks_per_node=rpn)
    t = x.shape[0] // (n_nodes * rpn)
    el = E // (n_nodes * rpn)

    def body(xs, tk):
        rank = jax.lax.axis_index("node") * rpn + (jax.lax.axis_index(ici) if ici else 0)
        eid = (rank * el + jnp.arange(el) + 1).astype(jnp.float32)
        w = jnp.ones((t, K), jnp.float32) / K
        common = dict(num_experts=E, phase1_capacity=t, phase2_capacity=n_nodes * t * K,
                      seg_capacity=t, **jopts, **kw)
        ckw = dict(seg_capacity=t, num_tokens=t, out_dtype=jnp.float32, **kw)
        if normal:
            d = jl.dispatch_layered_normal(xs, tk, **common)
            gs = d["group_sizes"]
            row = jnp.arange(d["recv_x_sorted"].shape[0], dtype=jnp.int32)
            e_of_row = jnp.clip(jnp.searchsorted(jnp.cumsum(gs), row, side="right"), 0, el - 1)
            deq = d["recv_x_sorted"].astype(jnp.float32) * d["recv_scales_sorted"][:, None]
            y = jnp.where((row < gs.sum())[:, None], deq * eid[e_of_row][:, None], 0.0)
            out = jl.combine_layered_normal(y, w, d["handle"], **ckw)
            rx, sc = d["recv_x_sorted"], d["recv_scales_sorted"]
        else:
            d = jl.dispatch_layered(xs, tk, **common)
            rx, sc = d["recv_x"], d.get("recv_scales", jnp.zeros((1,), jnp.float32))
            deq = rx.astype(jnp.float32) * (sc[..., None] if "recv_scales" in d else 1.0)
            out = jl.combine_layered(deq * eid[:, None, None], w, d["handle"], **ckw)
        st = d.get("stats", {})
        return (rx[None], sc[None], d["recv_count_matrix"][None], d["dcn_rows"][None],
                d["num_dropped"][None], out, {k: jnp.asarray(v)[None] for k, v in st.items()})

    spec = P(axes)
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
                              check_vma=False))
    rx, sc, cnt, dcn, dropped, out, st = jax.tree.map(np.asarray, f(jnp.asarray(x),
                                                                     jnp.asarray(idx)))
    return dict(rx=rx, sc=sc, cnt=cnt, dcn=dcn, dropped=dropped, combined=np32(out), stats=st)


@pytest.fixture(scope="module")
def layered_runs(tmp_path_factory):
    """One spawn of four ranks over every case, and JAX's goldens."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((R * T, H)).astype(np.float32)
    routes = _routings(rng)
    mesh = Mesh(np.array(jax.devices()[:R]).reshape(N_NODES, RPN), ("node", "ici"))
    want = {name: _jax_case(mesh, x, routes[route], opts, normal)
            for name, (route, opts, normal) in CASES.items() if name not in GOLDEN}
    flat = Mesh(np.array(jax.devices()[:R]), ("node",))
    want["dead_flat"] = _jax_case(flat, x, routes["random"], CASES["dead"][1], False, (R, 1))
    inp = {"task": "layered", "world": R, "grid": (N_NODES, RPN), "E": E, "T": T, "x": x,
           "cases": [dict(name=name, idx=routes[route], opts=opts, normal=normal)
                     for name, (route, opts, normal) in CASES.items()]}
    inp["cases"].append(dict(name="dead_flat", idx=routes["random"], opts=CASES["dead"][1],
                             normal=False, grid=(R, 1)))
    work = tmp_path_factory.mktemp("layered")
    (work / "inputs.pkl").write_bytes(pickle.dumps(inp))
    return want, run_ranks(work, R)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", [c for c in CASES if c != "dead"])
def test_layered_matches_jax(layered_runs, case):
    """Each rank's received rows (int8 levels and scales), count matrix,
    node-hop rows, drops, statistics and combine."""
    want, ranks = layered_runs
    ref = want[GOLDEN.get(case, case)]
    for r, got in enumerate(ranks):
        g = got[case]
        np.testing.assert_array_equal(g["rx"], ref["rx"][r], err_msg=case)
        if g["sc"] is not None:
            np.testing.assert_allclose(g["sc"], ref["sc"][r], rtol=2e-7, atol=0)
        np.testing.assert_array_equal(g["cnt"], ref["cnt"][r])
        np.testing.assert_array_equal(g["dcn"], ref["dcn"][r])
        assert g["dropped"] == int(ref["dropped"][r]) == 0
        for key, v in ref["stats"].items():
            np.testing.assert_array_equal(np.asarray(g["stats"][key]), v[r], err_msg=key)
        if case == "monitored":
            assert not g["stats"]["dcn_timeout_flags"].any()
            assert set(g["stats"]) >= {"dcn_wait_cost", "dcn_abort_observed"}
        _close(g["combined"], ref["combined"][r * T:(r + 1) * T])
    total = sum(int(got[case]["cnt"].sum()) for got in ranks)
    k_live = K - 1 if case == "neg1" else K
    assert total == R * T * k_live              # every live pair lands once
    if case == "dedup":
        assert sum(int(got[case]["dcn"].sum()) for got in ranks) == R * T


@pytest.mark.parametrize("case", ["dead", "dead_flat"])
def test_layered_dead_node(layered_runs, case):
    """Every node-hop send muted with polls bounded at 64: every wait from a
    node times out (64 polls), nothing arrives, the combine is zero; on the
    4 x 1 grid the flags and counts equal JAX's drill (whose later waits end
    early on the abort broadcast, so its wait costs are not compared)."""
    want, ranks = layered_runs
    for r, got in enumerate(ranks):
        g = got[case]
        assert g["stats"]["dcn_timeout_flags"].all() and (g["stats"]["dcn_wait_cost"] >= 64).all()
        assert int(g["cnt"].sum()) == 0 and not g["combined"].any()
        if case == "dead_flat":
            ref = want[case]
            np.testing.assert_array_equal(g["cnt"], ref["cnt"][r])
            np.testing.assert_array_equal(g["stats"]["dcn_timeout_flags"],
                                          ref["stats"]["dcn_timeout_flags"][r])
