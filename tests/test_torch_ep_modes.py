"""Port parity: the rest of DeepEP's ``Buffer`` surface against the JAX package.

One rank (the port's ``Buffer`` on a one-rank gloo group of this process,
JAX's on a one-device mesh): the low-latency (decode) dispatch / combine on
the three transports, with drops and -1 slots, int8 and float; the monitored
and validated exchanges; ``payload_checksum``; ``zero_experts_compute_identity``;
``diagnose_matrix`` / ``expert_balance_report``; ``log_parameters``.

Two ranks (two processes of ``tests/_torch_ep_ranks.py``, task ``"modes"``,
in one spawn, against JAX on ``mesh2``; JAX's goldens made once a module):
the low-latency mode on each transport, multi-round dispatch against JAX's
``dispatch(rounds=)`` and against one round, ``rank_remap`` with a dead and
a rehomed rank, ``shared_expert_layout`` with one shared rank, the TP
all-gather / reduce at TP 2, both modes on one buffer, and the validated
exchange with a planted fault (one flipped bit: exactly that source's flag)
and with garbage past the ragged counts (no flag).

Tolerances: routing, counts, drops, flags and dispatched rows exact (int8
levels too); int8 scales within 2e-7 relative (an f32 ulp: XLA may compile
JAX's ``amax / 127`` as a multiply by the reciprocal); checksums bit-equal;
combines within 1e-6 of the largest |value| (f32 sums of the same products in
another order), the TP path's too (the TP sum in f32, as JAX's ``psum`` of
f32); the zero-expert result exact in f32 and within one bf16 ulp in bf16.
"""

import logging
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from _torch_parity import jx, np32, one_rank_group, tt
from sgl_kernel_npu_tpu.config import EPConfig as JEPConfig
from sgl_kernel_npu_tpu.parallel import ep_core as jep
from sgl_kernel_npu_tpu.parallel.buffer import Buffer as JBuffer
from sgl_kernel_npu_tpu_torch.config import EPConfig
from sgl_kernel_npu_tpu_torch.parallel import ep_core as tep
from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer, EventOverlap
from test_torch_ep_core import E, H, K, T, _routing
from test_torch_ep_two_ranks import run_ranks

BACKENDS = ["xla", "pallas", "pallas_ragged"]


@pytest.fixture(scope="module")
def group():
    return one_rank_group()


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("ep",))


def _close(got, want):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,use_int8", [("xla", False), *((b, True) for b in BACKENDS)],
                         ids=["xla-float", *(f"{b}-int8" for b in BACKENDS)])
def test_low_latency_matches_jax(group, mesh1, backend, use_int8):
    """``low_latency_dispatch`` / ``low_latency_combine`` with dropping
    capacities and -1 slots: the packed rows (and scales), counts, drops,
    the validation flags (zero), on ``"pallas_ragged"`` the monitored
    statistics of both, and the combine."""
    rng = np.random.default_rng(20)
    x = rng.standard_normal((T, H)).astype(np.float32)
    idx, w = _routing(rng)
    kw = dict(num_max_dispatch_tokens_per_rank=4, capacity_factor=0.3, comm_backend=backend,
              validate_comm=True, monitor_comm=backend == "pallas_ragged")
    jbuf = JBuffer(mesh1, "ep", num_experts=E, config=JEPConfig(**kw))
    jrx, jsc, jcnt, jh, jst = jbuf.low_latency_dispatch(jx(x), jx(idx), use_int8=use_int8)
    buf = Buffer(group, num_experts=E, config=EPConfig(**kw))
    rx, sc, cnt, h, st = buf.low_latency_dispatch(tt(x), tt(idx), use_int8=use_int8)
    assert rx.dtype == (torch.int8 if use_int8 else torch.float32)
    np.testing.assert_array_equal(np32(rx), np32(jrx))
    if use_int8:
        np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=2e-7, atol=0)
    else:
        assert sc is None and jsc is None
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert set(st) == set(jst), (set(st), set(jst))
    for key in st:
        np.testing.assert_array_equal(st[key].numpy().reshape(-1),
                                      np.asarray(jst[key]).reshape(-1), err_msg=key)
    assert int(st["num_dropped"]) > 0 and not st["validation_flags"].any()
    y = rng.standard_normal(rx.shape).astype(np.float32)
    want = jbuf.low_latency_combine(jx(y), jx(w), jh, out_dtype=jnp.float32)
    got = buf.low_latency_combine(tt(y), tt(w), h, out_dtype=torch.float32)
    if backend == "pallas_ragged":
        (want, jcst), (got, cst) = want, got
        assert set(cst) == set(jcst)
        for key in cst:
            np.testing.assert_array_equal(cst[key].numpy(), np.asarray(jcst[key])[0],
                                          err_msg=key)
    _close(got, want)
    # a handle without send counts combines with zero counts (JAX's)
    bare = h._replace(sent_counts=None, recv_counts=None)
    jbare = jh._replace(sent_counts=None, recv_counts=None)
    if backend == "xla":
        _close(buf.low_latency_combine(tt(y), tt(w), bare, out_dtype=torch.float32),
               jbuf.low_latency_combine(jx(y), jx(w), jbare, out_dtype=jnp.float32))


def test_full_last_segment_keeps_its_row(group, mesh1):
    """The departure recorded in ROADMAP §C: the last (expert, source)
    segment exactly full while send rows stay empty (slot -1).  The port's
    packed layout holds every live row in its slot, the last slot included,
    and its combine is the plain NumPy sum, in ``dispatch_core`` and in the
    layered dispatch (one-rank groups); JAX's scatter wraps the -1 slots to
    the last slot, where the empty rows overwrite its live row."""
    from sgl_kernel_npu_tpu_torch.parallel import layered

    e, seg = 4, 3
    idx = np.array([[0, 3], [1, 3], [2, 3], [0, -1], [1, -1], [-1, -1]], np.int32)
    t, k = idx.shape
    rng = np.random.default_rng(26)
    x = rng.standard_normal((t, H)).astype(np.float32)
    w = rng.random((t, k)).astype(np.float32)
    packed = np.zeros((e, seg, H), np.float32)
    fill = [0] * e
    for tok, ex in zip(*np.nonzero(idx >= 0)):
        packed[idx[tok, ex], fill[idx[tok, ex]]] = x[tok]
        fill[idx[tok, ex]] += 1
    assert fill[-1] == seg and sum(fill) < t * k         # last segment full, empty rows
    eid = np.arange(1, e + 1, dtype=np.float32)
    want = (np.where(idx >= 0, w * eid[idx], 0.0)[..., None] * x[:, None]).sum(1)
    kw = dict(num_experts=e, num_ranks=1, pair_capacity=t * k, seg_capacity=seg, use_int8=False)
    d = tep.dispatch_core(tt(x), tt(idx), group=group, **kw)
    np.testing.assert_array_equal(d["recv_x"].numpy(), packed)
    got = tep.combine_core(d["recv_x"] * tt(eid)[:, None, None], tt(w), d["handle"],
                           group=group, num_ranks=1, seg_capacity=seg, out_dtype=torch.float32)
    _close(got, want)
    grid = dict(node_group=group, ici_group=None, num_nodes=1, ranks_per_node=1,
                seg_capacity=seg)
    dl = layered.dispatch_layered(tt(x), tt(idx), num_experts=e, phase1_capacity=t,
                                  phase2_capacity=t * k, **grid)
    np.testing.assert_array_equal(dl["recv_x"].numpy(), packed)
    got_l = layered.combine_layered(dl["recv_x"] * tt(eid)[:, None, None], tt(w), dl["handle"],
                                    num_tokens=t, out_dtype=torch.float32, **grid)
    _close(got_l, want)

    def body(xs, ids, ws):
        jd = jep.dispatch_core(xs, ids, axis_name="ep", **kw)
        out = jep.combine_core(jd["recv_x"] * jnp.asarray(eid)[:, None, None], ws, jd["handle"],
                               axis_name="ep", num_ranks=1, seg_capacity=seg,
                               out_dtype=jnp.float32)
        return jd["recv_x"], out

    jrx, jout = (np.asarray(a) for a in _smap(mesh1, body, 3, 2)(jx(x), jx(idx), jx(w)))
    np.testing.assert_array_equal(jrx[:, :-1], packed[:, :-1])
    assert packed[-1, -1].any() and not jrx[-1, -1].any()       # JAX's collision
    np.testing.assert_allclose(np.delete(jout, 2, 0), np.delete(want, 2, 0), atol=1e-5)
    assert np.abs(jout[2] - want[2]).max() > 0.1                # token 2 lost that pair


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_payload_checksum_matches_jax(dtype):
    """The wrapping int32 bit-sum, bit-equal to JAX's over every axis choice
    (the f32 and bf16 sums wrap), and sensitive to one changed value."""
    rng = np.random.default_rng(21)
    if dtype == "int8":
        a = rng.integers(-128, 128, (3, 40, 64)).astype(np.int8)
        t_a, j_a = tt(a), jx(a)
    else:
        a = (rng.standard_normal((3, 40, 64)) * 100).astype(np.float32)
        t_a, j_a = tt(a, getattr(torch, dtype)), jx(a, getattr(jnp, dtype))
    for axes in ((1, 2), (0, 1, 2), (2,)):
        got = tep.payload_checksum(t_a, axes)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jep.payload_checksum(j_a, axes)))
    b = t_a.clone()
    b[1, 2, 3] += 1
    assert int(tep.payload_checksum(b, (0, 1, 2))) != int(tep.payload_checksum(t_a, (0, 1, 2)))


def test_zero_experts_match_jax():
    """``ops/moe.zero_experts_compute_identity`` (ids at or past E are
    identity experts), f32 and bf16 states, a row routed to zero experts
    only."""
    from sgl_kernel_npu_tpu.ops.moe import zero_experts_compute_identity as jzero
    from sgl_kernel_npu_tpu_torch.ops.moe import zero_experts_compute_identity

    rng = np.random.default_rng(22)
    s, k, e = 12, 4, 8
    idx = rng.integers(0, e + 3, (s, k)).astype(np.int32)
    idx[3] = [e, e + 1, e + 2, e]
    scales = rng.random((s, k)).astype(np.float32)
    hs = rng.standard_normal((s, 16)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jzero(jx(idx), jx(scales), e, "identity", jx(hs, jdt), identity_mask_value=-1)
        got = zero_experts_compute_identity(tt(idx), tt(scales), e, "identity", tt(hs, tdt),
                                            identity_mask_value=-1)
        assert got[0].dtype == tdt and got[1].dtype == torch.int32
        np.testing.assert_array_equal(np32(got[0]), np32(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[1][3].tolist() == [0, -1, -1, -1]
    with pytest.raises(ValueError, match="identity"):
        zero_experts_compute_identity(tt(idx), tt(scales), e, "zero", tt(hs))


def test_diagnostics_match_jax():
    """``diagnose_matrix`` / ``expert_balance_report`` on the port's stats
    tensors (int32, as a dispatch returns them) against JAX's on the same
    values."""
    from sgl_kernel_npu_tpu.utils import diagnostics as jd
    from sgl_kernel_npu_tpu_torch.utils import diagnostics as td

    rng = np.random.default_rng(23)
    m = rng.integers(1, 10, (8, 8)).astype(np.int32)
    m[2] *= 40
    m[:, 5] *= 20
    m[6, 1] = 5000
    for kw in ({}, {"thres_col": 2.0, "thres_row": 1.5, "thres_point": 3.0}):
        assert td.diagnose_matrix(tt(m), **kw) == jd.diagnose_matrix(m, **kw)
    cnt = rng.integers(0, 5, (4, 6)).astype(np.int32)
    cnt[:, 2] = 0
    assert td.expert_balance_report(tt(cnt)) == jd.expert_balance_report(cnt)
    assert td.diagnose_matrix(m) == jd.diagnose_matrix(m)          # numpy in as well


def test_log_parameters_never_fetches(group, caplog, monkeypatch):
    """The four exchange entry points JAX decorates log their parameters at
    DEBUG level on the port's logger, tensors by shape, dtype and device:
    with every way of reading a tensor's values refused during the calls,
    the logged calls run and name each tensor."""
    from sgl_kernel_npu_tpu.parallel.buffer import Buffer as JB

    def decorated(cls):
        return sorted(n for n in vars(cls)
                      if not n.startswith("_") and hasattr(getattr(cls, n), "__wrapped__"))

    logged = decorated(Buffer)
    assert logged == decorated(JB)
    assert logged == ["combine", "dispatch", "low_latency_combine", "low_latency_dispatch"]
    buf = Buffer(group, num_experts=E, config=EPConfig(num_max_dispatch_tokens_per_rank=4))
    x, idx = torch.randn((T, H)), tt(_routing(np.random.default_rng(24))[0])
    w = torch.ones(idx.shape)

    def refuse(*args, **kwargs):
        raise AssertionError("a logged parameter's values were read")

    caplog.set_level(logging.DEBUG, logger="sgl_kernel_npu_tpu_torch")
    with monkeypatch.context() as mp:
        for name in ("__repr__", "__str__", "__format__", "tolist", "item", "numpy"):
            mp.setattr(torch.Tensor, name, refuse)
        xs, _, _, h, _ = buf.dispatch(x, idx)
        buf.combine(xs.float(), w, h)
        rx, _, _, hl, _ = buf.low_latency_dispatch(x, idx, validate=True)
        buf.low_latency_combine(rx.float(), w, hl)
    msgs = [r.getMessage() for r in caplog.records if r.name == "sgl_kernel_npu_tpu_torch"]
    assert [m.split("(")[0] for m in msgs] == ["Buffer.dispatch", "Buffer.combine",
                                               "Buffer.low_latency_dispatch",
                                               "Buffer.low_latency_combine"]
    assert f"x=Tensor({T}, {H}):float32@cpu" in msgs[0] and "validate=True" in msgs[2]
    assert "handle=DispatchHandle(len=6)" in msgs[1]
    EventOverlap().current_stream_wait()


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

T2 = 32                     # tokens over both ranks
LL_CASES = [("xla-int8", dict(capacity_factor=0.3), True),
            ("pallas-float", dict(num_max_dispatch_tokens_per_rank=4, comm_backend="pallas"),
             False),
            ("ragged-int8", dict(capacity_factor=0.3, comm_backend="pallas_ragged"), True)]


def _smap(mesh, body, n_in, n_out, spec=P("ep")):
    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,) * n_in,
                                 out_specs=(spec,) * n_out, check_vma=False))


def _jax_modes(mesh2, inp):
    """JAX's goldens for every part of the ``"modes"`` task."""
    x, idx, w = (jx(inp[k]) for k in ("x", "idx", "w"))
    want = {}
    for case in inp["ll"]:
        cfg = JEPConfig(validate_comm=True, **case["config"])
        jbuf = JBuffer(mesh2, "ep", num_experts=E, config=cfg)
        rx, sc, cnt, h, st = jbuf.low_latency_dispatch(x, idx, use_int8=case["int8"])
        comb = jbuf.low_latency_combine(jx(case["y"]), w, h, out_dtype=jnp.float32)
        want["ll-" + case["name"]] = dict(
            rx=np32(rx), sc=None if sc is None else np32(sc), cnt=np.asarray(cnt),
            counts=np.asarray(st["recv_count_matrix"]), dropped=np.asarray(st["num_dropped"]),
            combined=np32(comb), vflags=np.asarray(st["validation_flags"]))
    jbuf = JBuffer(mesh2, "ep", num_experts=E, config=JEPConfig(**inp["mr"]["config"]))
    xs, sc, gs, h, st = jbuf.dispatch(x, idx)
    assert isinstance(h, dict) and h["rounds"] == 2
    comb = jbuf.combine((xs.astype(jnp.float32) * sc[..., None]) * 3.0, w, h,
                        out_dtype=jnp.float32)
    want["mr"] = dict(xs=np32(xs), sc=np32(sc), gs=np.asarray(gs),
                      counts=np.asarray(st["recv_count_matrix"]),
                      dropped=np.asarray(st["num_dropped"]), combined=np32(comb))
    t = T2 // 2

    def remap_body(xs_, ids):
        d = jep.dispatch_core(xs_, ids, axis_name="ep", num_experts=E, num_ranks=2,
                              pair_capacity=t * K, seg_capacity=t, use_int8=False,
                              rank_remap=jnp.asarray(inp["remap"]))
        return d["recv_x"], d["recv_count_matrix"][None], d["num_dropped"][None]

    want["remap"] = [np.asarray(a) for a in _smap(mesh2, remap_body, 2, 3)(x, idx)]
    sh = inp["shared"]
    owner, slot, slots = jep.shared_expert_layout(sh["E"], 2, 1)

    def shared_body(xs_, ids, ws):
        my = jax.lax.axis_index("ep")
        ids_ext = jnp.concatenate([ids, jnp.full((t, 1), sh["E"], jnp.int32)], axis=1)
        ws_ext = jnp.concatenate([ws, jnp.ones((t, 1), jnp.float32)], axis=1)
        d = jep.dispatch_core(xs_, ids_ext, axis_name="ep", num_experts=sh["E"], num_ranks=2,
                              pair_capacity=t * (K + 1), seg_capacity=t, use_int8=False,
                              expert_owner=owner, expert_slot=slot, num_local_slots=slots)
        eid = (my - 1) * slots + jnp.arange(slots) + 1
        scale = jnp.where(my < 1, 100.0, eid.astype(jnp.float32))
        out = jep.combine_core(d["recv_x"] * scale[:, None, None], ws_ext, d["handle"],
                               axis_name="ep", num_ranks=2, seg_capacity=t,
                               out_dtype=jnp.float32)
        return out, d["num_dropped"][None]

    comb, dropped = _smap(mesh2, shared_body, 3, 2)(x, jx(sh["idx"]), w)
    want["shared"] = dict(combined=np32(comb), dropped=np.asarray(dropped),
                          layout=tuple(np.asarray(a) for a in (owner, slot)) + (slots,))
    tp = inp["tp"]
    mesh_tp = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("tp", "ep"))

    def tp_body(xs_, ids, ws):
        d = jep.dispatch_core(xs_, ids, axis_name="ep", num_experts=tp["E"], num_ranks=1,
                              pair_capacity=t * ids.shape[1], seg_capacity=t, use_int8=True)
        gx, gsc, gcnt = jep.dispatch_tp_allgather(d["recv_x"], d["recv_scales"],
                                                  d["recv_count_matrix"], tp_axis="tp")
        eid = (jnp.arange(tp["E"]) + 1).astype(jnp.float32)
        y_part = gx.astype(jnp.float32) * gsc[..., None] * (eid[:, None, None] / 2)
        y_mine = jep.combine_tp_reduce(y_part, tp_axis="tp", seg_total=t)
        out = jep.combine_core(y_mine, ws, d["handle"], axis_name="ep", num_ranks=1,
                               seg_capacity=t, out_dtype=jnp.float32)
        return out, gcnt[None], gx[None]

    comb, gcnt, gx = _smap(mesh_tp, tp_body, 3, 3, P(("tp", "ep")))(
        *(jx(tp[k]) for k in ("x", "idx", "w")))
    want["tp"] = dict(combined=np32(comb), counts=np.asarray(gcnt), gathered=np32(gx))
    both = inp["both"]
    # JAX's own suite holds its modes on one window buffer to its collective
    # (bit-identical transports): its golden runs on "xla", the port's on the window
    jbuf = JBuffer(mesh2, "ep", num_experts=E,
                   config=JEPConfig(**{**both["config"], "comm_backend": "xla"}))

    @jax.jit
    def both_modes(x_, idx_, w_):
        xs_, _, _, h_n, _ = jbuf.dispatch(x_, idx_)
        norm = jbuf.combine(xs_.astype(jnp.float32), w_, h_n, out_dtype=jnp.float32)
        rx_, _, _, h_l, _ = jbuf.low_latency_dispatch(x_, idx_)
        ll = jbuf.low_latency_combine(rx_.astype(jnp.float32) * 2.0, w_, h_l,
                                      out_dtype=jnp.float32)
        return norm, ll

    norm, ll = both_modes(x, jx(both["idx"]), jx(both["w"]))
    want["both"] = dict(norm=np32(norm), ll=np32(ll))
    return want


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, mesh2):
    """One spawn of the ``"modes"`` task and JAX's goldens: ``(inputs,
    JAX's results, each rank's results)``."""
    rng = np.random.default_rng(25)
    x = rng.standard_normal((T2, H)).astype(np.float32)
    idx, w = _routing(rng, t=T2)
    inp = {"task": "modes", "E": E, "x": x, "idx": idx, "w": w, "ll": []}
    for name, kw, int8 in LL_CASES:
        seg = max(kw.get("num_max_dispatch_tokens_per_rank", 128), T2 // 2)
        y = rng.standard_normal((E, 2 * seg, H)).astype(np.float32)
        inp["ll"].append(dict(name=name, config=kw, int8=int8, y=y))
    inp["mr"] = dict(config=dict(num_max_dispatch_tokens_per_rank=8, normal_round_tokens=8))
    inp["remap"] = np.array([1, -1], np.int32)      # rank 0's experts on rank 1; rank 1 dead
    inp["shared"] = dict(E=4, idx=np.stack([rng.choice(4, K, replace=False)
                                            for _ in range(T2)]).astype(np.int32))
    tidx, tw = _routing(rng, t=T2, e=4, k=2, dead=0.0)
    inp["tp"] = dict(E=4, x=x, idx=tidx, w=tw)
    bidx, bw = _routing(rng, t=T2, k=2, dead=0.0)
    inp["both"] = dict(config=dict(num_max_dispatch_tokens_per_rank=4, use_int8_dispatch=False,
                                   comm_backend="pallas_ragged"), idx=bidx, w=bw)
    want = _jax_modes(mesh2, inp)
    work = tmp_path_factory.mktemp("modes")
    (work / "inputs.pkl").write_bytes(pickle.dumps(inp))
    return inp, want, run_ranks(work)


def _mine(r, n=T2 // 2):
    return slice(r * n, (r + 1) * n)


@pytest.mark.parametrize("case", [c[0] for c in LL_CASES])
def test_two_rank_low_latency_matches_jax(two_ranks, case):
    """Each rank's packed rows, scales, counts, drops, validation flags
    (zero) and combine, per transport; the port's ``"pallas_ragged"`` run is
    monitored (K15c's plain version: no timeout flag), JAX's is not (the
    one-rank test holds the statistics to JAX's)."""
    _, want, ranks = two_ranks
    ref = want["ll-" + case]
    el = E // 2
    for r, got in enumerate(ranks):
        g = got["ll-" + case]
        mine = slice(r * el, (r + 1) * el)
        np.testing.assert_array_equal(g["rx"], ref["rx"][mine])
        if ref["sc"] is not None:
            np.testing.assert_allclose(g["sc"], ref["sc"][mine], rtol=2e-7, atol=0)
        np.testing.assert_array_equal(g["cnt"], ref["cnt"][mine])
        np.testing.assert_array_equal(g["counts"], ref["counts"][r])
        assert g["dropped"] == int(ref["dropped"][r])
        np.testing.assert_array_equal(g["vflags"], ref["vflags"][r])
        assert not g["vflags"].any()
        if g["tflags"] is not None:      # monitored on "pallas_ragged": no timeout
            assert not g["tflags"].any() and not g["ctflags"].any()
        _close(g["combined"], ref["combined"][_mine(r)])
    if "int8" in case:
        assert int(ref["dropped"].sum()) > 0


def test_two_rank_multi_round_matches_jax_and_one_round(two_ranks):
    """``normal_round_tokens`` = T / 2: JAX's merged rows, scales, group
    sizes, counts, drops and combine, on the collective and on the ragged
    window; the combine equal to one round's, and the group sizes."""
    _, want, ranks = two_ranks
    ref = want["mr"]
    for r, got in enumerate(ranks):
        for backend in ("xla", "pallas_ragged"):
            g = got["mr-" + backend]
            np.testing.assert_array_equal(g["xs"], ref["xs"][r], err_msg=backend)
            np.testing.assert_allclose(g["sc"], ref["sc"][r], rtol=2e-7, atol=0)
            np.testing.assert_array_equal(g["gs"], ref["gs"][r])
            np.testing.assert_array_equal(g["counts"], ref["counts"][r])
            assert g["dropped"] == int(ref["dropped"][r]) == 0
            _close(g["combined"], ref["combined"][_mine(r)])
            np.testing.assert_array_equal(g["gs1"], g["gs"])
            _close(g["combined1"], g["combined"])


def test_two_rank_placements_match_jax(two_ranks):
    """``rank_remap`` [1, -1] (rank 0's experts rehomed to rank 1, rank 1
    dead): the packed rows, counts and drops; ``shared_expert_layout`` with
    rank 0 shared: the layout and the combine of the shared and routed
    experts."""
    _, want, ranks = two_ranks
    rx, counts, dropped = want["remap"]
    el = E // 2
    for r, got in enumerate(ranks):
        g = got["remap"]
        np.testing.assert_array_equal(g["rx"], rx[r * el:(r + 1) * el])
        np.testing.assert_array_equal(g["counts"], counts[r])
        assert g["dropped"] == int(dropped[r]) > 0
        s, ref = got["shared"], want["shared"]
        for a, b in zip(s["layout"], ref["layout"]):
            np.testing.assert_array_equal(a, b)
        assert s["dropped"] == int(ref["dropped"][r]) == 0
        _close(s["combined"], ref["combined"][_mine(r)])
    assert ranks[0]["remap"]["counts"].sum() == 0


def test_two_rank_tp_allgather_matches_jax(two_ranks):
    """TP 2 x EP 1: the gathered rows and counts, and the combine after the
    TP reduce."""
    _, want, ranks = two_ranks
    ref = want["tp"]
    for r, got in enumerate(ranks):
        g = got["tp"]
        np.testing.assert_array_equal(g["gathered"], ref["gathered"][r])
        np.testing.assert_array_equal(g["counts"], ref["counts"][r])
        _close(g["combined"], ref["combined"][_mine(r)])


@pytest.mark.parametrize("backend", BACKENDS)
def test_two_rank_validation_flags_a_planted_fault(two_ranks, backend):
    """The validated int8 low-latency dispatch with one bit of source 1's
    first row flipped in what rank 0's transport delivers: rank 0's flag for
    source 1 rises and no other flag does; the same call without the fault
    flags nothing."""
    _, _, ranks = two_ranks
    for r, got in enumerate(ranks):
        g = got["fault-" + backend]
        assert not g["clean_vflags"].any()
        np.testing.assert_array_equal(g["vflags"], [0, 1] if r == 0 else [0, 0])
    assert ranks[0]["fault-" + backend]["counts"][1].sum() > 0      # the flipped row is live


def test_two_rank_validation_ignores_stale_ragged_rows(two_ranks):
    """On ``"pallas_ragged"`` the rows past a source's received count (stale
    window memory) filled with garbage in the payload and the slot / scale
    blob: no flag rises, and the packed rows and scales are the clean
    call's."""
    _, _, ranks = two_ranks
    for got in ranks:
        g = got["stale"]
        assert not g["vflags"].any() and not g["clean_vflags"].any() and g["same_rows"]
        assert len(g["garbled"]) == 2 and min(g["garbled"]) > 0      # payload and blob


def test_two_rank_normal_and_low_latency_on_one_buffer(two_ranks):
    """Both modes on one ``"pallas_ragged"`` buffer, one after the other:
    each equals JAX's (both in one jitted program, on its collective)."""
    _, want, ranks = two_ranks
    for r, got in enumerate(ranks):
        _close(got["both"]["norm"], want["both"]["norm"][_mine(r)])
        _close(got["both"]["ll"], want["both"]["ll"][_mine(r)])
