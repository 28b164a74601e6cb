"""Port parity: the window all-to-alls' plain versions (K15a, K15b / K15c)
against JAX's Pallas kernels in interpret mode on a one-device mesh.

The port's plain versions run ``all_to_all_single`` on a one-rank gloo group
of this process (``_torch_parity.one_rank_group``); two ranks are in
``test_torch_ep_two_ranks.py``.  Cases follow JAX's ``test_pallas_a2a.py``:
float and int8 blocks, thin trailing shapes (which JAX pads to its 128-lane
tile), ragged counts of 0, some and all rows in small chunks, the monitored
exchange without a fault (JAX's interpret mode waits without polling: zero
statistics) and with this rank muted (JAX's ``force_sem_read`` bounded
polls: the source times out, its count is 0).  Tolerances: exact (the rows
are moved, not computed); rows past a ragged count are undefined on both
sides and are not compared."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from _torch_parity import jx, one_rank_group, tt
from sgl_kernel_npu_tpu.parallel import pallas_a2a as ja
from sgl_kernel_npu_tpu_torch.parallel import pallas_a2a as ta


@pytest.fixture(scope="module")
def group():
    return one_rank_group()


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("ep",))


def _smap(mesh, fn, n_in, n_out):
    out = P("ep") if n_out == 1 else (P("ep"),) * n_out
    return jax.shard_map(fn, mesh=mesh, in_specs=(P("ep"),) * n_in, out_specs=out,
                         check_vma=False)


@pytest.mark.parametrize("shape,dtype", [((1, 16, 128), np.float32), ((1, 16, 128), np.int8),
                                         ((1, 5, 3), np.float32), ((1, 8), np.int32)],
                         ids=["f32", "int8", "thin", "counts"])
def test_pallas_all_to_all_matches_jax(group, mesh1, shape, dtype):
    rng = np.random.default_rng(0)
    x = (rng.integers(-128, 128, shape) if dtype != np.float32
         else rng.standard_normal(shape)).astype(dtype)
    want = _smap(mesh1, functools.partial(ja.pallas_all_to_all, axis_name="ep", num_ranks=1),
                 1, 1)(jx(x))
    before = ta.pallas_all_to_all.launches
    got = ta.pallas_all_to_all(tt(x), group=group)
    assert ta.pallas_all_to_all.launches == before       # the plain path counts no launch
    assert got.dtype == tt(x).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("count,chunk", [(0, 4), (7, 4), (16, 4), (16, 32), (9, 1)])
def test_pallas_ragged_all_to_all_matches_jax(group, mesh1, count, chunk):
    """Live rows and counts exact, a count of 0, some and all rows."""
    rng = np.random.default_rng(count)
    x = rng.standard_normal((1, 16, 128)).astype(np.float32)
    counts = np.asarray([count], np.int32)

    def body(xs, cs):
        out, oc = ja.pallas_ragged_all_to_all(xs, cs, axis_name="ep", num_ranks=1,
                                              chunk_rows=chunk)
        return out, oc
    want, woc = _smap(mesh1, body, 2, 2)(jx(x), jx(counts))
    got, oc = ta.pallas_ragged_all_to_all(tt(x), tt(counts), group=group, chunk_rows=chunk)
    np.testing.assert_array_equal(oc.numpy(), np.asarray(woc))
    np.testing.assert_array_equal(got[0, :count].numpy(), np.asarray(want)[0, :count])


def test_pallas_ragged_all_to_all_thin_blob(group, mesh1):
    """An int32 blob of two columns a row (the dispatch's slot and scale
    bits), which JAX pads to a lane tile."""
    rng = np.random.default_rng(3)
    x = rng.integers(-2**31, 2**31 - 1, (1, 12, 2)).astype(np.int32)
    counts = np.asarray([5], np.int32)
    want, woc = _smap(mesh1, lambda xs, cs: ja.pallas_ragged_all_to_all(
        xs, cs, axis_name="ep", num_ranks=1), 2, 2)(jx(x), jx(counts))
    got, oc = ta.pallas_ragged_all_to_all(tt(x), tt(counts), group=group)
    assert int(oc[0]) == int(np.asarray(woc)[0]) == 5
    np.testing.assert_array_equal(got[0, :5].numpy(), np.asarray(want)[0, :5])


def test_monitored_no_fault_matches_jax(group, mesh1):
    """K15c without a fault: the rows, counts and statistics of JAX's
    interpret mode (blocking waits, zero statistics)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8, 128)).astype(np.float32)
    counts = np.asarray([6], np.int32)
    want, woc, wst = _smap(mesh1, lambda xs, cs: ja.pallas_ragged_all_to_all(
        xs, cs, axis_name="ep", num_ranks=1, chunk_rows=4, monitor=True), 2, 3)(
        jx(x), jx(counts))
    got, oc, st = ta.pallas_ragged_all_to_all(tt(x), tt(counts), group=group, chunk_rows=4,
                                              monitor=True)
    assert st.shape == (1, 6) and st.dtype == torch.int32
    np.testing.assert_array_equal(st.numpy(), np.asarray(wst))
    np.testing.assert_array_equal(oc.numpy(), np.asarray(woc))
    np.testing.assert_array_equal(got[0, :6].numpy(), np.asarray(want)[0, :6])


def test_monitored_mute_rank_times_out_like_jax(group, mesh1):
    """This rank muted (``inject_send_fault``): the source times out after
    the bounded polls, its count is 0, the payload is missing; JAX's bounded
    polls (``force_sem_read``) give the same statistics."""
    x = np.random.default_rng(5).standard_normal((1, 8, 128)).astype(np.float32)
    counts = np.asarray([8], np.int32)
    _, woc, wst = _smap(mesh1, lambda xs, cs: ja.pallas_ragged_all_to_all(
        xs, cs, axis_name="ep", num_ranks=1, chunk_rows=4, monitor=True, max_poll_rounds=16,
        inject_send_fault=True, force_sem_read=True), 2, 3)(jx(x), jx(counts))
    _, oc, st = ta.pallas_ragged_all_to_all(tt(x), tt(counts), group=group, chunk_rows=4,
                                            monitor=True, max_poll_rounds=16,
                                            inject_send_fault=True)
    np.testing.assert_array_equal(oc.numpy(), 0)
    np.testing.assert_array_equal(oc.numpy(), np.asarray(woc))
    np.testing.assert_array_equal(st.numpy(), np.asarray(wst))
    assert st[0, 1] == 1 and st[0, 4] == 1 and st[0, 0] == 16


# (ranks, block bytes, chunk bytes, blocks): K15a's per-expert counts [R, 256]
# int32 of 1 and of 64 ranks, a payload just at and just past K15a's 64 KB
# chunk, a 2048-token chunk's dispatch in K15b's 32-row chunks (the kernel
# caps it at the co-resident grid), an empty capacity
@pytest.mark.parametrize("ranks,block,chunk,blocks", [
    (1, 1024, ta.FIXED_CHUNK, 1), (64, 1024, ta.FIXED_CHUNK, 1),
    (1, ta.FIXED_CHUNK, ta.FIXED_CHUNK, 1), (1, ta.FIXED_CHUNK + 1, ta.FIXED_CHUNK, 2),
    (1, 16384 * 7168, 32 * 7168, 512), (2, 0, 1, 1)])
def test_window_grid_is_sized_to_the_payload(ranks, block, chunk, blocks):
    """The window kernels' grid rule (``a2a_blocks``): one block up to one
    chunk in all, which takes the one-block launch without grid syncs."""
    assert ta.a2a_blocks(ranks, block, chunk) == blocks


def test_window_all_to_alls_refuse_what_they_do_not_take(group):
    with pytest.raises(ValueError, match="monitor=True"):
        ta.pallas_ragged_all_to_all(torch.zeros((1, 4, 8)), torch.ones(1, dtype=torch.int32),
                                    group=group, inject_send_fault=True)
    with pytest.raises(ValueError, match="one block per rank"):
        ta.pallas_all_to_all(torch.zeros((2, 4)), group=group)
    with pytest.raises(ValueError, match="counts"):
        ta.pallas_ragged_all_to_all(torch.zeros((1, 4, 8)), torch.ones(2, dtype=torch.int32),
                                    group=group)
    with pytest.raises(ValueError, match="chunk_rows"):
        ta.pallas_ragged_all_to_all(torch.zeros((1, 4, 8)), torch.ones(1, dtype=torch.int32),
                                    group=group, chunk_rows=0)
