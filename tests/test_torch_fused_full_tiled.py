"""K16b's walk on the CPU: ``fused_deep_moe_full_tiled_plain`` (the CUDA
kernel's 128-row items x column tiles of its two GEMM phases, GMM1's gate /
up pairing by the pack width, then the requant, the returns and the top-k
reduce) against the port's plain version and JAX's single kernel.

One rank, 8 local experts of 0, 1, 3, 64, 65, 128, 129 and 257 rows (one,
two and three items; a one-row and an empty expert), dead (token, k) pairs,
H 256 (two 128-k stages), I 192 (GMM2's k off the 128-byte stage, GMM1's
output over three 64-column tiles), the packing at full width and at 128 and
96 columns (a 64-column tile over several slabs; slabs of 48).  Tolerances:
against the plain version bit-equal (the same exact sums, the same f32
epilogue operations; a column no unit writes stays NaN); against JAX's
``fused_deep_moe_full_rank`` (``Buffer.fused_deep_moe(single_kernel=True)``
on a one-device mesh, Pallas in interpret mode) a relative mean difference
below 4e-4, ``test_torch_fused_deep_moe.py``'s bar: int8 requant levels may
flip at a rounding tie, JAX's reduce weighs in bf16 hi + lo.  With a
segment capacity below the largest experts (drops), against the plain
version bit-equal and the unfused form within 4e-4."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_parity import jx, np32, one_rank_group, tt
from sgl_kernel_npu_tpu.config import EPConfig as JEPConfig
from sgl_kernel_npu_tpu.parallel.buffer import Buffer as JBuffer
from sgl_kernel_npu_tpu.parallel.fused_moe import quantize_expert_weights as jquant
from sgl_kernel_npu_tpu_torch.ops.quant import quant_per_token_ref
from sgl_kernel_npu_tpu_torch.parallel import fused_full, fused_moe

H, I, K = 256, 192, 4
SIZES = [0, 1, 3, 64, 65, 128, 129, 257]
E, T = len(SIZES), 288      # JAX's single kernel takes a segment capacity of whole 32-row tiles


def _routing(rng):
    """``topk_idx [T, K]`` giving expert e exactly SIZES[e] rows (each token's
    experts distinct, the rest of its slots dead: -1) and random weights."""
    load = np.zeros(T, np.int64)
    idx = np.full((T, K), -1, np.int32)
    for e in np.argsort(SIZES)[::-1]:
        order = np.lexsort((rng.random(T), load))      # least-loaded tokens first
        for t in order[:SIZES[e]]:
            idx[t, load[t]] = e
            load[t] += 1
    for t in range(T):
        rng.shuffle(idx[t])
    return idx, rng.random((T, K)).astype(np.float32)


def _case(seed, tn):
    rng = np.random.default_rng(seed)
    wg, wu = ((rng.standard_normal((E, H, I)) * 0.05).astype(np.float32) for _ in range(2))
    wd = (rng.standard_normal((E, I, H)) * 0.05).astype(np.float32)
    w = [np.asarray(a) for a in jquant(jx(wg), jx(wu), jx(wd), tn=tn)]
    x = rng.standard_normal((T, H)).astype(np.float32)
    idx, tw = _routing(rng)
    return w, x, idx, tw


def _layout(idx, seg):
    group = one_rank_group()
    plan, lay = fused_full.full_layout(tt(idx), group=group, num_experts=E, num_ranks=1,
                                       seg_capacity=seg)
    return group, plan, lay


def _both(w, x, idx, tw, tn, seg):
    group, plan, lay = _layout(idx, seg)
    xq, s = quant_per_token_ref(tt(x))
    args = (xq, s, tt(tw), *(tt(a) for a in w), lay)
    kw = dict(tn=tn, group=group)
    return (fused_full.fused_deep_moe_full_tiled_plain(*args, **kw),
            fused_full.fused_deep_moe_full_plain(*args, **kw), plan, lay)


def _rel_mean(got, want):
    g, w = np32(got), np32(want)
    return np.abs(g - w).mean() / (np.abs(w).mean() + 1e-9)


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("ep",))


@pytest.mark.parametrize("tn", [2 * I, 128, 96], ids=["full", "tn128", "tn96"])
def test_tiled_walk_matches_plain_and_jax(mesh1, tn):
    w, x, idx, tw = _case(1, tn)
    got, want, plan, lay = _both(w, x, idx, tw, tn, T)
    assert lay.offsets.diff().tolist() == SIZES and int(plan.num_dropped) == 0
    assert lay.tile_off.diff().tolist() == [0, 1, 1, 1, 1, 1, 2, 3]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jbuf = JBuffer(mesh1, "ep", E, JEPConfig(num_max_dispatch_tokens_per_rank=T))
    ref, jcnt, jdrop = jbuf.fused_deep_moe(jx(x), jx(idx), jx(tw), *(jx(a) for a in w),
                                           pack_tn=tn, single_kernel=True)
    np.testing.assert_array_equal(np.asarray(jcnt[0]), SIZES)
    assert int(jdrop[0]) == 0
    assert _rel_mean(got, ref) < 4e-4, _rel_mean(got, ref)


@pytest.mark.parametrize("tn", [2 * I, 64], ids=["full", "tn64"])
def test_tiled_walk_with_drops(tn):
    """A segment capacity of 100: the three largest experts keep their first
    100 rows; the walk bit-equal to the plain version and within 4e-4 of the
    unfused form, which drops the same pairs."""
    w, x, idx, tw = _case(2, tn)
    got, want, plan, lay = _both(w, x, idx, tw, tn, 100)
    assert lay.offsets.diff().tolist() == [min(n, 100) for n in SIZES]
    assert int(plan.num_dropped) == sum(max(n - 100, 0) for n in SIZES)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    unf, cnt, drop = fused_moe.fused_deep_moe_rank(
        tt(x), tt(idx), tt(tw), *(tt(a) for a in w), group=one_rank_group(), num_experts=E,
        num_ranks=1, pair_capacity=E * 100, seg_capacity=100, pack_tn=tn)
    assert int(drop) == int(plan.num_dropped)
    assert _rel_mean(got, unf) < 4e-4, _rel_mean(got, unf)
