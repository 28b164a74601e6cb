"""Port parity: the expert-parallel core on one rank (``config``,
``parallel/layout``, ``parallel/ep_core``, ``parallel/buffer``).

The JAX side runs its ``Buffer`` on a one-device mesh of the conftest's CPU
devices (``shard_map``), the port its ``Buffer`` on a one-rank gloo group of
this process.  The pure routing functions also run at 2 and 4 ranks here (a
rank's plan needs no exchange).  Same numpy inputs; capacities exact
(``capacity_factor`` None) and small enough to drop rows.  Tolerances: the
routing, the counts and the dispatched rows exact (the port's sort keeps
JAX's order of ties); the int8 wire's scales within 2e-7 relative (an f32
ulp: XLA may compile JAX's interpret-mode ``amax / 127`` as a multiply by the
reciprocal, the port divides) and its levels exact; the combine
within 1e-6 of the largest |value| (f32 sums of the same k products in
another order); ``fused_oai_moe`` (bf16 wire, f32 weights) within 1e-2 of a
row's largest |value| (bf16 rounding of the activation and the output in
another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_parity import jx, np32, one_rank_group, tt
from sgl_kernel_npu_tpu.config import EPConfig as JEPConfig
from sgl_kernel_npu_tpu.parallel import ep_core as jep
from sgl_kernel_npu_tpu.parallel.buffer import Buffer as JBuffer
from sgl_kernel_npu_tpu.parallel.layout import get_dispatch_layout as jlayout
from sgl_kernel_npu_tpu_torch.config import EPConfig
from sgl_kernel_npu_tpu_torch.ops.quant import quant_per_token_ref
from sgl_kernel_npu_tpu_torch.parallel import ep_core as tep
from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer
from sgl_kernel_npu_tpu_torch.parallel.layout import get_dispatch_layout

E, K, T, H = 8, 3, 24, 32


def _routing(rng, t=T, e=E, k=K, dead=0.1):
    """Distinct experts per token, some slots inactive (-1)."""
    idx = np.stack([rng.choice(e, k, replace=False) for _ in range(t)]).astype(np.int32)
    idx[rng.random(idx.shape) < dead] = -1
    w = rng.random((t, k)).astype(np.float32)
    return idx, w / w.sum(-1, keepdims=True)


@pytest.fixture(scope="module")
def group():
    return one_rank_group()


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("ep",))


def test_ep_config_matches_jax():
    for kw in ({}, {"capacity_factor": 1.0}, {"capacity_factor": 0.25}):
        for args in ((T, K, 1, E), (T, K, 4, 2), (512, 8, 8, 32)):
            assert EPConfig(**kw).pair_capacity(*args) == JEPConfig(**kw).pair_capacity(*args)
    assert dataclasses.asdict(EPConfig()) == dataclasses.asdict(JEPConfig())


@pytest.mark.parametrize("ranks", [1, 4])
def test_dispatch_layout_matches_jax(ranks):
    idx, _ = _routing(np.random.default_rng(0))
    got = get_dispatch_layout(tt(idx), E, ranks)
    want = jlayout(jx(idx), E, ranks)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("ranks,rank,pair,seg", [(1, 0, T * K, T), (2, 1, 20, 9), (4, 2, 7, 3)])
def test_routing_plan_matches_jax(ranks, rank, pair, seg):
    """Every field of the plan, exact capacities and dropping ones."""
    idx, _ = _routing(np.random.default_rng(1))
    got = tep.make_routing_plan(tt(idx), num_experts=E, num_ranks=ranks, my_rank=rank,
                                pair_capacity=pair, seg_capacity=seg)
    want = jep.make_routing_plan(jx(idx), num_experts=E, num_ranks=ranks,
                                 my_rank=jnp.int32(rank), pair_capacity=pair, seg_capacity=seg)
    for name, a, b in zip(tep.RoutingPlan._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(got.num_dropped) > 0 or pair == T * K


def _jax_dispatch(mesh1, cfg, x, idx, use_int8):
    buf = JBuffer(mesh1, "ep", num_experts=E, config=cfg)
    return buf, buf.dispatch(jx(x), jx(idx), use_int8=use_int8)


@pytest.mark.parametrize("use_int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("capacity_factor", [None, 0.3], ids=["exact", "dropping"])
def test_buffer_dispatch_combine_match_jax(group, mesh1, capacity_factor, use_int8):
    """``Buffer.dispatch``: the expert-sorted rows (and int8 scales), group
    sizes, counts and drops; ``Buffer.combine`` of expert outputs given in
    that order."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((T, H)).astype(np.float32)
    idx, w = _routing(rng)
    kw = dict(capacity_factor=capacity_factor, num_max_dispatch_tokens_per_rank=4)
    jbuf, (jxs, jsc, jgs, jh, jst) = _jax_dispatch(mesh1, JEPConfig(**kw), x, idx, use_int8)
    buf = Buffer(group, num_experts=E, config=EPConfig(**kw))
    xs, sc, gs, handle, st = buf.dispatch(tt(x), tt(idx), use_int8=use_int8)
    np.testing.assert_array_equal(np32(xs), np32(jxs[0]))
    if use_int8:
        assert xs.dtype == torch.int8
        np.testing.assert_allclose(sc.numpy(), np.asarray(jsc[0]), rtol=2e-7, atol=0)
    else:
        assert sc is None and jsc is None
    np.testing.assert_array_equal(gs.numpy(), np.asarray(jgs[0]))
    np.testing.assert_array_equal(st["recv_count_matrix"].numpy(),
                                  np.asarray(jst["recv_count_matrix"][0]))
    assert int(st["num_dropped"]) == int(jst["num_dropped"][0])
    assert (int(st["num_dropped"]) > 0) == (capacity_factor is not None)

    y = rng.standard_normal(xs.shape).astype(np.float32)
    want = np32(jbuf.combine(jx(y)[None], jx(w), jh, out_dtype=jnp.float32))
    got = buf.combine(tt(y), tt(w), handle, out_dtype=torch.float32)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_dispatch_core_padded_layout_matches_jax(group, mesh1):
    """``dispatch_core`` / ``combine_core``: JAX's padded receiver layout
    ``[E_local, R·seg, H]`` (int8 wire), and the combine from it (with the
    int8 return wire too)."""
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(3)
    x = rng.standard_normal((T, H)).astype(np.float32)
    idx, w = _routing(rng)
    pair, seg = 30, 6
    y = rng.standard_normal((E, seg, H)).astype(np.float32)
    common = dict(num_ranks=1, seg_capacity=seg)

    def body(xs, ids, ws, ys):
        d = jep.dispatch_core(xs, ids, axis_name="ep", num_experts=E, pair_capacity=pair,
                              use_int8=True, **common)
        outs = [jep.combine_core(ys, ws, d["handle"], axis_name="ep", out_dtype=jnp.float32,
                                 use_int8_comm=q, **common) for q in (False, True)]
        return d["recv_x"], d["recv_scales"], d["recv_count"], outs[0], outs[1]

    want = jax.shard_map(body, mesh=mesh1, in_specs=(P("ep"),) * 4, out_specs=(P("ep"),) * 5,
                         check_vma=False)(jx(x), jx(idx), jx(w), jx(y))
    d = tep.dispatch_core(tt(x), tt(idx), group=group, num_experts=E, pair_capacity=pair,
                          use_int8=True, **common)
    for key, ref in zip(("recv_x", "recv_count"), (want[0], want[2])):
        np.testing.assert_array_equal(np32(d[key]), np32(ref), err_msg=key)
    np.testing.assert_allclose(np32(d["recv_scales"]), np32(want[1]), rtol=2e-7, atol=0)
    for q, ref in zip((False, True), want[3:]):
        got = tep.combine_core(tt(y), tt(w), d["handle"], group=group, out_dtype=torch.float32,
                               use_int8_comm=q, **common)
        np.testing.assert_allclose(np32(got), np32(ref), rtol=0,
                                   atol=1e-6 * np.abs(np32(ref)).max())


def test_fused_oai_moe_matches_jax(group, mesh1):
    """``Buffer.fused_oai_moe`` (bf16 wire, f32 expert weights and biases)
    against JAX's: the combined output, group sizes and drops."""
    rng = np.random.default_rng(4)
    inter = 16
    x = rng.standard_normal((T, H)).astype(np.float32)
    idx, w = _routing(rng, dead=0.0)
    wgu = (rng.standard_normal((E, H, 2 * inter)) * H ** -0.5).astype(np.float32)
    bgu = (rng.standard_normal((E, 2 * inter)) * 0.1).astype(np.float32)
    wd = (rng.standard_normal((E, inter, H)) * inter ** -0.5).astype(np.float32)
    bd = (rng.standard_normal((E, H)) * 0.1).astype(np.float32)
    jbuf = JBuffer(mesh1, "ep", num_experts=E, config=JEPConfig())
    want, jgs, jdrop = jbuf.fused_oai_moe(jx(x, jnp.bfloat16), jx(idx), jx(w), jx(wgu), jx(bgu),
                                          jx(wd), jx(bd))
    buf = Buffer(group, num_experts=E, config=EPConfig())
    got, gs, drop = buf.fused_oai_moe(tt(x, torch.bfloat16), tt(idx), tt(w), tt(wgu), tt(bgu),
                                      tt(wd), tt(bd))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (T, H)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(jgs[0]))
    assert int(drop) == int(jdrop[0]) == 0
    want = np32(want)
    err = np.abs(np32(got) - want).max(-1) / np.abs(want).max(-1)
    assert err.max() <= 1e-2, err.max()


def test_all_to_all_counts_and_differentiates(group):
    """The exchange counts its calls and passes gradients back (one rank:
    the identity both ways)."""
    before = tep.all_to_all.calls
    x = torch.randn((1, 5, 3), requires_grad=True)
    y = tep.all_to_all(x, group)
    (y * 2).sum().backward()
    torch.testing.assert_close(y, x)
    torch.testing.assert_close(x.grad, torch.full_like(x, 2.0))
    assert tep.all_to_all.calls == before + 2           # forward and backward


def test_unported_ep_switches_raise(group):
    """The EP switches that raised before this slice now run on one rank:
    both configs build a ``Buffer``, the low-latency round trip, two rounds,
    the validated exchange, the placements, the TP all-gather on a one-rank
    TP group and the multi-round core (each held to JAX in
    ``test_torch_ep_modes.py``).  What stays refused raises ``ValueError``:
    a token count the rounds do not divide, a pack width that does not
    divide 2I, an unknown transport, a monitor off ``"pallas_ragged"``."""
    for cfg in (EPConfig(validate_comm=True), EPConfig(normal_round_tokens=2)):
        buf = Buffer(group, num_experts=E, config=cfg)
    for backend in ("pallas", "pallas_ragged"):
        Buffer(group, num_experts=E, config=EPConfig(comm_backend=backend, monitor_comm=True))
    x = torch.randn((4, H), generator=torch.Generator().manual_seed(0))
    idx, w = torch.tensor([[0, 3, -1]] * 4, dtype=torch.int32), torch.ones((4, K))
    _, _, _, handle, st = buf.dispatch(x, idx)          # normal_round_tokens 2: two rounds
    assert handle.rounds == 2 and int(st["recv_count_matrix"].sum()) == 8
    buf = Buffer(group, num_experts=E)
    rx, sc, cnt, h, st = buf.low_latency_dispatch(x, idx, validate=True)
    assert rx.shape == (E, 128, H) and int(cnt.sum()) == 8 and not st["validation_flags"].any()
    out = buf.low_latency_combine(rx.float() * sc[..., None], w, h, out_dtype=torch.float32)
    q, scale = quant_per_token_ref(x)
    torch.testing.assert_close(out, 2 * q.float() * scale[:, None])
    xs, _, gs, h2, _ = buf.dispatch(x, idx, rounds=2, use_int8=False)
    torch.testing.assert_close(buf.combine(xs, w, h2, out_dtype=torch.float32), 2 * x)
    kw = dict(group=group, num_experts=E, num_ranks=1, pair_capacity=12, seg_capacity=4,
              use_int8=False)
    d = tep.dispatch_core(x, idx, validate=True, rank_remap=torch.zeros(1, dtype=torch.int32),
                          **kw)
    assert d["validation_flags"].tolist() == [0] and int(d["recv_count"].sum()) == 8
    gx, _, gcnt = tep.dispatch_tp_allgather(d["recv_x"], None, d["recv_count_matrix"],
                                            tp_group=group)
    assert torch.equal(gx, d["recv_x"]) and torch.equal(gcnt, d["recv_count_matrix"])
    assert torch.equal(tep.combine_tp_reduce(gx, tp_group=group, seg_total=4), gx)
    mr = tep.dispatch_ragged_multi_round(x, idx, rounds=2, **kw)
    assert mr["group_sizes"].tolist() == d["recv_count"].tolist()
    with pytest.raises(ValueError, match="3 equal rounds"):
        tep.dispatch_ragged_multi_round(x, idx, rounds=3, **kw)
    w1 = torch.zeros((E, H, 2 * 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="pack width 48"):
        buf.fused_deep_moe(x, idx, torch.ones((4, K)), w1, torch.ones((E, 128)),
                           torch.zeros((E, 64, H), dtype=torch.int8), torch.ones((E, H)),
                           pack_tn=48, single_kernel=True)
    with pytest.raises(ValueError, match="unknown comm backend"):
        buf.dispatch(x, idx, backend="nccl")
    with pytest.raises(ValueError, match="pallas_ragged"):
        tep.dispatch_core(x, idx, group=group, num_experts=E, num_ranks=1, pair_capacity=4,
                          seg_capacity=4, use_int8=False, backend="pallas", monitor=True)
    with pytest.raises(ValueError, match="divisible"):
        get_dispatch_layout(idx, 7, 2)


WINDOWS = ["pallas", "pallas_ragged"]


@pytest.mark.parametrize("use_int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("capacity_factor", [None, 0.3], ids=["exact", "dropping"])
@pytest.mark.parametrize("backend", WINDOWS)
def test_buffer_window_transports_match_jax(group, mesh1, backend, capacity_factor, use_int8):
    """``Buffer.dispatch`` / ``combine`` on the one-sided transports against
    JAX's on the same transport: the rows (int8 scales to 2e-7), group
    sizes, counts and drops exact, the combine to 1e-6 of its largest."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((T, H)).astype(np.float32)
    idx, w = _routing(rng)
    kw = dict(capacity_factor=capacity_factor, num_max_dispatch_tokens_per_rank=4,
              comm_backend=backend)
    jbuf, (jxs, jsc, jgs, jh, jst) = _jax_dispatch(mesh1, JEPConfig(**kw), x, idx, use_int8)
    buf = Buffer(group, num_experts=E, config=EPConfig(**kw))
    xs, sc, gs, handle, st = buf.dispatch(tt(x), tt(idx), use_int8=use_int8)
    np.testing.assert_array_equal(np32(xs), np32(jxs[0]))
    if use_int8:
        np.testing.assert_allclose(sc.numpy(), np.asarray(jsc[0]), rtol=2e-7, atol=0)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(jgs[0]))
    np.testing.assert_array_equal(st["recv_count_matrix"].numpy(),
                                  np.asarray(jst["recv_count_matrix"][0]))
    assert int(st["num_dropped"]) == int(jst["num_dropped"][0])
    y = rng.standard_normal(xs.shape).astype(np.float32)
    want = np32(jbuf.combine(jx(y)[None], jx(w), jh, out_dtype=jnp.float32))
    got = buf.combine(tt(y), tt(w), handle, out_dtype=torch.float32)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_buffer_monitored_dispatch_matches_jax(group, mesh1):
    """``EPConfig(monitor_comm=True)`` on ``"pallas_ragged"``: the payload
    exchange's statistics keys (JAX's interpret mode: zero, no timeout) and
    the same rows as the unmonitored dispatch."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((T, H)).astype(np.float32)
    idx, _ = _routing(rng)
    kw = dict(num_max_dispatch_tokens_per_rank=4, comm_backend="pallas_ragged",
              monitor_comm=True)
    _, (jxs, _, _, _, jst) = _jax_dispatch(mesh1, JEPConfig(**kw), x, idx, True)
    buf = Buffer(group, num_experts=E, config=EPConfig(**kw))
    xs, _, _, _, st = buf.dispatch(tt(x), tt(idx))
    for key in ("wait_recv_cost_stats", "timeout_flags", "payload_wait_cost_stats"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key][0]), err_msg=key)
    assert not st["timeout_flags"].any()
    np.testing.assert_array_equal(np32(xs), np32(jxs[0]))
    _, _, _, _, st_plain = buf.dispatch(tt(x), tt(idx), monitor=False)
    assert "wait_recv_cost_stats" not in st_plain


@pytest.mark.parametrize("backend", WINDOWS)
def test_dispatch_core_window_transports_match_jax(group, mesh1, backend):
    """``dispatch_core`` / ``combine_core`` (JAX's padded layout) on the
    one-sided transports: the int8 wire, the combine with the float and the
    int8 return wire (the ragged one moving live rows only), and the
    monitored ragged combine's statistics."""
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(14)
    x = rng.standard_normal((T, H)).astype(np.float32)
    idx, w = _routing(rng)
    pair, seg = 30, 6
    y = rng.standard_normal((E, seg, H)).astype(np.float32)
    common = dict(num_ranks=1, seg_capacity=seg)
    mon = backend == "pallas_ragged"

    def body(xs, ids, ws, ys):
        d = jep.dispatch_core(xs, ids, axis_name="ep", num_experts=E, pair_capacity=pair,
                              use_int8=True, backend=backend, **common)
        outs = [jep.combine_core(ys, ws, d["handle"], axis_name="ep", out_dtype=jnp.float32,
                                 use_int8_comm=q, backend=backend, **common) for q in (False, True)]
        return d["recv_x"], d["recv_scales"], d["recv_count"], outs[0], outs[1]

    want = jax.jit(jax.shard_map(body, mesh=mesh1, in_specs=(P("ep"),) * 4,
                                 out_specs=(P("ep"),) * 5, check_vma=False))(
        jx(x), jx(idx), jx(w), jx(y))
    d = tep.dispatch_core(tt(x), tt(idx), group=group, num_experts=E, pair_capacity=pair,
                          use_int8=True, backend=backend, monitor=mon, **common)
    for key, ref in zip(("recv_x", "recv_count"), (want[0], want[2])):
        np.testing.assert_array_equal(np32(d[key]), np32(ref), err_msg=key)
    np.testing.assert_allclose(np32(d["recv_scales"]), np32(want[1]), rtol=2e-7, atol=0)
    if mon:
        assert not d["timeout_flags"].any() and d["wait_recv_cost_stats"].shape == (1,)
    for q, ref in zip((False, True), want[3:]):
        got = tep.combine_core(tt(y), tt(w), d["handle"], group=group, out_dtype=torch.float32,
                               use_int8_comm=q, backend=backend, monitor=mon, **common)
        if mon:
            got, stats = got
            assert stats.shape == (1, 6) and not stats[:, 1].any()
        np.testing.assert_allclose(np32(got), np32(ref), rtol=0,
                                   atol=1e-6 * np.abs(np32(ref)).max())


def test_eplb_matches_jax():
    """``parallel/eplb``: the placement, the remap tables, ``remap_topk``,
    the physical weights and the folded load, exact against JAX."""
    from sgl_kernel_npu_tpu.parallel import eplb as jeplb
    from sgl_kernel_npu_tpu_torch.parallel import eplb

    rng = np.random.default_rng(15)
    load = rng.integers(0, 100, E).astype(np.float64)
    load[2] = 0
    for ranks, slots in ((2, 5), (4, 3), (1, 8)):
        place = eplb.make_placement(load, ranks, slots)
        np.testing.assert_array_equal(place, jeplb.make_placement(load, ranks, slots))
        tables = eplb.make_remap_tables(place, E, device="cpu")
        for a, b in zip(tables, jeplb.make_remap_tables(place, E)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        idx, _ = _routing(rng)
        np.testing.assert_array_equal(eplb.remap_topk(tt(idx), *tables).numpy(),
                                      np.asarray(jeplb.remap_topk(jx(idx), *jeplb.make_remap_tables(
                                          place, E))))
        wts = rng.standard_normal((E, 3, 2)).astype(np.float32)
        np.testing.assert_array_equal(eplb.physical_expert_weights(tt(wts), place).numpy(),
                                      np.asarray(jeplb.physical_expert_weights(jx(wts), place)))
        m = rng.integers(0, 9, (ranks, ranks * slots))
        np.testing.assert_array_equal(eplb.logical_load(tt(m), place, E),
                                      jeplb.logical_load(m, place, E))
    with pytest.raises(ValueError, match="slots"):
        eplb.make_placement(load, 1, 4)


def test_one_rank_buffer_runs_no_token_count_check(group, monkeypatch):
    """The equal-token-count check is a collective only a group of more
    than one rank needs: on one rank no ``Buffer`` entry point all-reduces
    (the two-rank mismatch is in ``test_torch_ep_two_ranks.py``)."""
    import torch.distributed as dist

    def refuse(*args, **kwargs):
        raise AssertionError("a one-rank Buffer ran an all-reduce")

    monkeypatch.setattr(dist, "all_reduce", refuse)
    buf = Buffer(group, num_experts=E)
    x, idx = torch.randn((4, H)), torch.zeros((4, K), dtype=torch.int32)
    xs, _, gs, handle, _ = buf.dispatch(x, idx)
    buf.get_routing_plan(idx)
    buf.combine(torch.zeros(xs.shape), torch.ones((4, K)), handle)
    assert int(gs.sum()) == 4 * K
