"""K16a's walk on the CPU: ``fused_kernel.fused_dispatch_gmm1_rank_tiled_plain``
(the CUDA kernel's units from ``gemm1_units``: 128-row items aligned to each
(expert, source) segment's first row in the expert-major window, 128-column
tiles, zeros for a unit's rows past its segment's count and for a dead
segment's every row) against the plain version (bit-equal: the same exact
integer sums and the same two f32 scale products, rows past a count exactly 0)
and against JAX's ``fused_dispatch_gmm1_rank`` in interpret mode on a
one-device mesh (within one bf16 ulp, 2^-7 relative, as
``tests/test_torch_fused_kernel.py`` holds the plain version), at segments of
8, 70, 128 and 200 rows with dead, partial and full segments; and the unit
list itself."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from _torch_parity import jx, np32, one_rank_group, tt
from sgl_kernel_npu_tpu.parallel import fused_kernel as jfk
from sgl_kernel_npu_tpu_torch.parallel import fused_kernel as tfk

E, H, N = 3, 256, 384          # N: three column tiles, the last of them full


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("ep",))


def _case(seed, seg, counts):
    """One rank's inputs, the rows past each count zero (the wrapper's
    placement; JAX's kernel multiplies them)."""
    rng = np.random.default_rng(seed)
    xsend = rng.integers(-128, 128, (1, E * seg, H)).astype(np.int8)
    for e, c in enumerate(counts):
        xsend[0, e * seg + c:(e + 1) * seg] = 0
    w1 = rng.integers(-128, 128, (E, H, N)).astype(np.int8)
    sw = (rng.random((E, N)) / 100 + 1e-4).astype(np.float32)
    sx = (rng.random((E, seg)) / 10 + 0.01).astype(np.float32)
    return xsend, w1, sw, sx, np.asarray([counts], np.int32)


@pytest.mark.parametrize("seg,counts", [(8, (0, 5, 8)), (70, (70, 0, 33)),
                                        (128, (1, 128, 0)), (200, (129, 0, 200))],
                         ids=["seg8", "seg70", "seg128", "seg200"])
def test_tiled_walk_matches_plain_and_jax(mesh1, seg, counts):
    xsend, w1, sw, sx, cnt = _case(seg, seg, counts)
    kw = dict(group=one_rank_group(), num_ranks=1, seg=seg)
    got = tfk.fused_dispatch_gmm1_rank_tiled_plain(tt(xsend), tt(w1), tt(sw), tt(sx),
                                                   counts=tt(cnt), **kw)
    plain = tfk.fused_dispatch_gmm1_rank_plain(tt(xsend), tt(w1), tt(sw), tt(sx),
                                               counts=tt(cnt), **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (E, seg, N)
    assert torch.equal(got, plain)
    for e, c in enumerate(counts):
        assert not got[e, c:].any()
    body = functools.partial(jfk.fused_dispatch_gmm1_rank, axis_name="ep", num_ranks=1, seg=seg)
    want = np32(jax.shard_map(
        lambda xs, w, s_, sx_: body(xs[0], w, s_, sx_[0])[None], mesh=mesh1,
        in_specs=(P("ep"), P(), P(), P("ep")), out_specs=P("ep"), check_vma=False,
    )(jx(xsend[None]), jx(w1), jx(sw), jx(sx[None])))[0]
    np.testing.assert_allclose(np32(got), want, rtol=2 ** -7, atol=1e-30)


def test_tiled_walk_reads_no_row_past_a_count():
    """Whatever ``xsend`` holds past a segment's count (the kernel never
    sends it), the walk's output is that of the zeroed rows."""
    xsend, w1, sw, sx, cnt = _case(5, 70, (3, 70, 0))
    noisy = xsend.copy()
    noisy[0, 3:70] = 7
    noisy[0, 140:] = -9
    kw = dict(group=one_rank_group(), num_ranks=1, seg=70, counts=tt(cnt))
    a = tfk.fused_dispatch_gmm1_rank_tiled_plain(tt(noisy), tt(w1), tt(sw), tt(sx), **kw)
    b = tfk.fused_dispatch_gmm1_rank_tiled_plain(tt(xsend), tt(w1), tt(sw), tt(sx), **kw)
    assert torch.equal(a, b)


@pytest.mark.parametrize("e_local,r,seg,n", [(3, 1, 70, 384), (2, 3, 200, 256), (4, 2, 128, 4096),
                                             (1, 1, 8, 16)])
def test_gemm1_units_cover_each_output_once(e_local, r, seg, n):
    """Every output element lies in exactly one unit; a unit's item starts
    on a 128-row boundary of its segment and never reaches into the next
    segment; units come item-major (a segment's column tiles together)."""
    units = tfk.gemm1_units(e_local, r, seg, n)
    cover = torch.zeros((e_local * r * seg, -(-n // 128)), dtype=torch.int64)
    items = []
    for e, s, r0, tile_rows, bx in units:
        assert r0 % tfk.ITEM_ROWS == 0 and 0 < tile_rows <= tfk.ITEM_ROWS
        assert r0 + tile_rows <= seg
        row0 = (e * r + s) * seg + r0
        cover[row0:row0 + tile_rows, bx] += 1
        if not items or items[-1] != (e, s, r0):
            items.append((e, s, r0))
    assert bool((cover == 1).all())
    assert len(items) == len(set(items)) == e_local * r * -(-seg // tfk.ITEM_ROWS)
    assert len(units) == len(items) * -(-n // tfk.UNIT_COLS)
