"""Port parity: the fused one-sided dispatch + W8A8 GEMM1 (K16a
``fused_dispatch_gmm1_rank``) and its routed wrapper ``fused_dispatch_gmm1``.

JAX's kernel runs under the eager-DMA interpreter inside ``shard_map`` (a
one-device mesh; ``mesh2`` for two ranks), at the shapes of JAX's own
``tests/test_fused_kernel.py`` (E 2, SEG 8, H 512, N 256); the port takes its
plain version on CPU tensors, on a one-rank gloo group of this process or, for
two ranks, in two processes of ``tests/_torch_ep_ranks.py``.  Tolerances:
the integer sums are exact on both sides and the two scale products the
same, so each bf16 value within one bf16 ulp (2^-7 relative) of JAX's; the
routed wrapper's counts exact and its output through ``ep_core.combine_core``
within 1e-2 of a row's largest value (the combine weighs bf16 rows in f32 on
both sides)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from _torch_parity import jx, np32, one_rank_group, tt
from sgl_kernel_npu_tpu.parallel import ep_core as jep
from sgl_kernel_npu_tpu.parallel import fused_kernel as jfk
from sgl_kernel_npu_tpu_torch.parallel import ep_core as tep
from sgl_kernel_npu_tpu_torch.parallel import fused_kernel as tfk

E, SEG, H, N = 2, 8, 512, 256


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("ep",))


def jax_rank_outputs(mesh, xsend, w1, sw, sx):
    """JAX's kernel on every rank of ``mesh``: ``xsend [R src, R dst, E·SEG,
    H]``, ``sx [R dst, E, R·SEG]`` → ``[R, E, R·SEG, N]``."""
    body = functools.partial(jfk.fused_dispatch_gmm1_rank, axis_name="ep",
                             num_ranks=xsend.shape[0], seg=SEG)
    return np32(jax.shard_map(
        lambda xs, w, s_, sx_: body(xs[0], w, s_, sx_[0])[None], mesh=mesh,
        in_specs=(P("ep"), P(), P(), P("ep")), out_specs=P("ep"), check_vma=False,
    )(jx(xsend), jx(w1), jx(sw), jx(sx)))


def rank_inputs(rng, r):
    xsend = rng.integers(-40, 40, (r, r, E * SEG, H)).astype(np.int8)
    w1 = rng.integers(-40, 40, (E, H, N)).astype(np.int8)
    sw = (rng.random((E, N)) / 100).astype(np.float32)
    sx = (rng.random((r, E, r * SEG)) / 10 + 0.01).astype(np.float32)
    return xsend, w1, sw, sx


def ulp_close(got, want):
    np.testing.assert_allclose(np32(got), np32(want), rtol=2 ** -7, atol=1e-30)


def test_fused_dispatch_gmm1_rank_matches_jax_one_rank(mesh1):
    """One rank: the plain version against JAX's kernel; with the senders'
    ``counts`` (rows past them zero in ``xsend``, as the wrapper places
    them) the same result."""
    rng = np.random.default_rng(0)
    xsend, w1, sw, sx = rank_inputs(rng, 1)
    counts = np.asarray([[5, 0]], np.int32)
    rows = np.arange(SEG)
    for e in range(E):
        xsend[0, 0, e * SEG:(e + 1) * SEG][rows >= counts[0, e]] = 0
    want = jax_rank_outputs(mesh1, xsend, w1, sw, sx)[0]
    group = one_rank_group()
    kw = dict(group=group, num_ranks=1, seg=SEG)
    got = tfk.fused_dispatch_gmm1_rank(tt(xsend[0]), tt(w1), tt(sw), tt(sx[0]), **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (E, SEG, N)
    ulp_close(got, want)
    with_counts = tfk.fused_dispatch_gmm1_rank(tt(xsend[0]), tt(w1), tt(sw), tt(sx[0]),
                                               counts=tt(counts), **kw)
    torch.testing.assert_close(with_counts, got, rtol=0, atol=0)
    assert not with_counts[1].any() and tfk.fused_dispatch_gmm1_rank.launches == 0


def test_fused_dispatch_gmm1_then_combine_matches_jax(mesh1):
    """The routed wrapper on one rank (16 experts, top-4, seg 6 so that
    some pairs drop): per-token quant, placement, kernel; its padded output
    (N = H) through ``combine_core`` against JAX's wrapper and combine."""
    rng = np.random.default_rng(1)
    t, k, e, seg, h = 10, 4, 16, 6, 128
    x = rng.standard_normal((t, h)).astype(np.float32)
    idx = np.stack([rng.choice(e, k, replace=False) for _ in range(t)]).astype(np.int32)
    idx[:, 0] = 3                                         # 10 pairs on expert 3: 4 drop
    tw = rng.random((t, k)).astype(np.float32)
    w1 = rng.integers(-40, 40, (e, h, h)).astype(np.int8)
    sw = (rng.random((e, h)) / 100).astype(np.float32)

    def body(x_, i_, tw_, w_, s_):
        out, counts, handle = jfk.fused_dispatch_gmm1(
            x_, i_, w_, s_, axis_name="ep", num_experts=e, num_ranks=1, seg_capacity=seg)
        comb = jep.combine_core(out, tw_, handle, axis_name="ep", num_ranks=1,
                                seg_capacity=seg, out_dtype=jnp.float32)
        return out[None], counts[None], comb

    out_j, cnt_j, comb_j = jax.shard_map(
        body, mesh=mesh1, in_specs=(P("ep"), P("ep"), P("ep"), P("ep"), P("ep")),
        out_specs=(P("ep"), P("ep"), P("ep")), check_vma=False,
    )(jx(x), jx(idx), jx(tw), jx(w1), jx(sw))
    group = one_rank_group()
    out_t, cnt_t, handle = tfk.fused_dispatch_gmm1(tt(x), tt(idx), tt(w1), tt(sw), group=group,
                                                   num_experts=e, num_ranks=1, seg_capacity=seg)
    assert tuple(out_t.shape) == (e, seg, h) and out_t.dtype == torch.bfloat16
    ulp_close(out_t, np32(out_j)[0])
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j)[0])
    assert int(cnt_t[3]) == seg                           # the surviving pairs sent
    comb_t = tep.combine_core(out_t, tt(tw), handle, group=group, num_ranks=1,
                              seg_capacity=seg, out_dtype=torch.float32)
    want = np32(comb_j)
    err = np.abs(np32(comb_t) - want).max(-1) / np.abs(want).max(-1)
    assert err.max() <= 1e-2, err.max()


def test_fused_dispatch_gmm1_two_ranks_match_jax(tmp_path, mesh2):
    """Two gloo ranks against JAX's kernel on ``mesh2`` (R 2, E 2, SEG 8, H
    512, N 256); then the routed wrapper on both ranks: its output against
    JAX's, and the send-count pin: each rank returns its own SEND counts
    (``plan.counts_per_expert``), as JAX's does, not the rows its experts
    received."""
    import pickle

    from test_torch_ep_two_ranks import run_ranks

    rng = np.random.default_rng(2)
    xsend, w1, sw, sx = rank_inputs(rng, 2)
    want = jax_rank_outputs(mesh2, xsend, w1, sw, sx)
    t, k, e, seg = 8, 2, 4, 6                              # 2 local experts a rank
    x = rng.standard_normal((2 * t, H)).astype(np.float32)
    idx = np.stack([rng.choice(e, k, replace=False) for _ in range(2 * t)]).astype(np.int32)
    idx[:t, 0] = 0                                        # rank 0 sends 8 pairs to expert 0
    w1r = rng.integers(-40, 40, (e, H, N)).astype(np.int8)
    swr = (rng.random((e, N)) / 100).astype(np.float32)

    def body(x_, i_, w_, s_):
        out, counts, _ = jfk.fused_dispatch_gmm1(x_, i_, w_, s_, axis_name="ep", num_experts=e,
                                                 num_ranks=2, seg_capacity=seg)
        return out[None], counts[None]

    out_j, cnt_j = jax.shard_map(body, mesh=mesh2, in_specs=(P("ep"),) * 4,
                                 out_specs=(P("ep"), P("ep")), check_vma=False)(
        jx(x), jx(idx), jx(w1r), jx(swr))
    (tmp_path / "inputs.pkl").write_bytes(pickle.dumps(dict(
        task="fused_kernel", xsend=xsend, w1=w1, sw=sw, sx=sx, seg=SEG,
        routed=dict(x=x, idx=idx, w1=w1r, sw=swr, e=e, seg=seg))))
    for r, got in enumerate(run_ranks(tmp_path)):
        ulp_close(got["out"], want[r])
        ulp_close(got["routed_out"], np32(out_j)[r])
        np.testing.assert_array_equal(got["routed_counts"], np.asarray(cnt_j)[r])
        np.testing.assert_array_equal(got["routed_counts"], got["plan_counts"])
        assert not np.array_equal(got["routed_counts"][2 * r:2 * r + 2], got["received"])
