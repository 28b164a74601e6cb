"""K8b's order of work on the CPU: ``grouped_matmul.grouped_matmul_combine_tiled_plain``
(the first pass's units by block, ``combine_row_units``: 128-row items of
one group x 128-column tiles, block b taking units b, b + blocks, ...; then
the mask products over the rows of d below the total in 16-row steps, the hi
then the lo product of each into one f32 accumulator) against the plain
version and JAX's ``grouped_matmul_combine`` in interpret mode (within 1e-5
of the largest |value|: exact bf16 products, f32 sums in another order),
with empty groups, rows past the total (their mask columns weigh nothing),
S % 8 != 0 and a step straddling the total; and the unit partition."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops import grouped_matmul as jgm
from sgl_kernel_npu_tpu_torch.ops import grouped_matmul as tgm


def _case(seed, sizes, rows, n_tok, kd=256, n=384):
    rng = np.random.default_rng(seed)
    g = len(sizes)
    x = rng.integers(-128, 128, (rows, kd)).astype(np.int8)
    w = rng.integers(-128, 128, (g, kd, n)).astype(np.int8)
    sx = (np.abs(rng.standard_normal(rows)) * 0.01 + 0.001).astype(np.float32)
    sw = (np.abs(rng.standard_normal((g, n))) * 0.01).astype(np.float32)
    mask = np.zeros((n_tok, rows), np.float32)
    for t in range(n_tok):
        mask[t, rng.choice(rows, min(3, rows), replace=False)] = rng.random(min(3, rows))
    hi = np32(jx(mask, jnp.bfloat16))
    lo = np32(jx(mask - hi, jnp.bfloat16))
    return np.asarray(sizes, np.int32), x, w, sx, sw, hi, lo


@pytest.mark.parametrize("sizes,rows,n_tok", [((30, 26, 0, 40), 100, 24), ((0, 0, 7, 0), 9, 3),
                                              ((0, 3, 0, 130), 141, 5), ((0, 0, 0, 0), 5, 2)],
                         ids=["ragged-tail", "one-group", "two-items", "empty"])
def test_tiled_combine_matches_plain_and_jax(sizes, rows, n_tok):
    gs, x, w, sx, sw, hi, lo = _case(rows, sizes, rows, n_tok)
    args = (tt(x), tt(w), tt(gs), tt(sx), tt(sw), tt(hi, torch.bfloat16), tt(lo, torch.bfloat16))
    got = tgm.grouped_matmul_combine_tiled_plain(*args)
    plain = tgm.grouped_matmul_combine_plain(*args)
    want = np32(jgm.grouped_matmul_combine(jx(x), jx(w), jx(gs), jx(sx), jx(sw),
                                           jx(hi, jnp.bfloat16), jx(lo, jnp.bfloat16), tm=64,
                                           tk=128, tn=128))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n_tok, w.shape[2])
    tol = 1e-5 * max(np.abs(want).max(), 1)
    np.testing.assert_allclose(np32(got), np32(plain), rtol=0, atol=tol)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=tol)


def test_tiled_combine_reads_no_mask_column_past_the_total():
    """Mask columns past the groups' total (rows no group holds) weigh
    nothing, whatever they hold, infinities included."""
    gs, x, w, sx, sw, hi, lo = _case(3, (30, 26, 0, 40), 100, 6)
    args = [tt(x), tt(w), tt(gs), tt(sx), tt(sw), tt(hi, torch.bfloat16), tt(lo, torch.bfloat16)]
    clean = tgm.grouped_matmul_combine_tiled_plain(*args)
    args[5] = args[5].clone()
    args[5][:, 96:] = float("inf")
    assert torch.equal(tgm.grouped_matmul_combine_tiled_plain(*args), clean)


@pytest.mark.parametrize("sizes,s,n,blocks", [((0, 1, 64, 65, 0, 128, 129, 300, 0, 7), 694, 384, 7),
                                              ((16,) * 256, 4096, 7168, 264),
                                              ((5, 0, 3), 6, 256, 264)])
def test_combine_row_units_partition(sizes, s, n, blocks):
    """Every (row below the total cut at S, column tile) lies in exactly one
    unit, of its own group; a block's units ascend; the blocks' unit counts
    differ by at most one (the walk's balance)."""
    gs = torch.tensor(sizes, dtype=torch.int32)
    by_block = tgm.combine_row_units(gs, s, n, blocks)
    assert len(by_block) == blocks
    total = min(int(gs.sum()), s)
    ct = -(-n // 128)
    group_of_row = torch.repeat_interleave(torch.arange(len(sizes)), gs.long())
    cover = torch.zeros((max(total, 1), ct), dtype=torch.int64)
    for units in by_block:
        for g, r0, rows, bx in units:
            assert 0 < rows <= 128 or r0 >= s
            assert bool((group_of_row[r0:r0 + rows] == g).all())
            cover[r0:r0 + rows, bx] += 1
    assert bool((cover[:total] == 1).all())
    lens = [len(u) for u in by_block]
    assert max(lens) - min(lens) <= 1
