"""K13a / K13b's order of work on the CPU: ``lora_kernel_order_plain`` (the
CUDA kernels' shrink, a warp's 32 lanes striding over H and summed by a
butterfly, then the expand's sum over the rank in order) against JAX's
``bgmv_fused`` / ``sgmv_fused`` in Pallas interpret mode and against the
port's plain versions.

Out-of-range ids, both B layouts, ranks below R, zero-length sequences and
rows past the sequences, H a multiple of the lanes' 256-element stride, off
it, and off 8 (one element a lane a step).  Tolerance: 1e-4 of the output's
largest value (f32 sums of the same products in another order); JAX in f32
(its bf16 chain rounds the shrink, which the port keeps in f32); dead rows
exactly 0."""

import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops import lora_pallas as jlp
from sgl_kernel_npu_tpu_torch.ops import lora_pallas as tlp


def _close(got, want):
    want = np32(want)
    assert np32(got).shape == want.shape
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=1e-4 * np.abs(want).max())


def _weights(rng, t, h, l, r, d):
    x = rng.standard_normal((t, h)).astype(np.float32)
    a = (rng.standard_normal((l, r, h)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((l, d, r)) * 0.1).astype(np.float32)
    return x, a, b


def test_shrink_lane_order():
    """The shrink's lane walk and butterfly, one component at a time: lane
    l's elements l V + 256 k + i summed in order, then the lanes by xor 16,
    8, 4, 2, 1, against the same sums written out; a dead row is 0."""
    rng = np.random.default_rng(5)
    x, a, b = _weights(rng, 2, 512, 1, 2, 8)
    got = tlp.lora_kernel_order_plain(tt(x), tt(a), tt(b), torch.tensor([0, -1]),
                                      torch.tensor([2, 2]), torch.tensor([1.0, 1.0]))
    prod = (x[0, None, :] * a[0]).reshape(2, 2, 32, 8)             # [r, k, lane, i]
    lanes = np.zeros((2, 32), np.float32)
    for k in range(2):
        for i in range(8):
            lanes += prod[:, k, :, i]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ o]
    want = np.zeros(8, np.float32)
    for r in range(2):
        want = want + lanes[r, 0] * b[0, :, r]
    np.testing.assert_array_equal(np32(got[0]), want)
    assert not got[1].any()


# (t, h, adapters, rank, d): H under one stride; 4 strides; H off 8 (V = 1)
BGMV = [(5, 96, 3, 8, 80), (37, 1024, 5, 16, 300), (20, 1000, 64, 4, 64),
        (9, 99, 4, 8, 40)]


@pytest.mark.parametrize("layout", ["b", "bt"])
@pytest.mark.parametrize("t,h,l,r,d", BGMV)
def test_bgmv_tiled_matches_jax_and_plain(t, h, l, r, d, layout):
    rng = np.random.default_rng(t + h)
    x, a, b = _weights(rng, t, h, l, r, d)
    idx = rng.integers(0, min(l, 6), t).astype(np.int32)
    idx[1], idx[-1] = -1, l                         # out of range: a zero delta
    bt = np.ascontiguousarray(b.transpose(0, 2, 1))
    kw_j = {"bt": jx(bt)} if layout == "bt" else {}
    want = jlp.bgmv_fused(jx(x), jx(a), None if kw_j else jx(b), jx(idx), scaling=0.5, **kw_j)
    plain = tlp.bgmv_fused_plain(tt(x), tt(a), tt(b), tt(idx), scaling=0.5)
    rows = tlp.bgmv_rows(tt(idx), l, r, 0.5)
    got = tlp.lora_kernel_order_plain(tt(x), tt(a), tt(bt) if layout == "bt" else tt(b), *rows,
                                     transposed=layout == "bt")
    _close(got, want)
    _close(got, plain)
    assert not got[1].any() and not got[-1].any()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t,h", [(24, 512), (700, 2048)], ids=["decode", "prefill"])
def test_bgmv_tiled_matches_plain_bf16(t, h, dt):
    """bf16 inputs: the kernels' order and the plain version both keep the
    shrink in f32, so they differ only in the order of f32 sums; a decode
    step's rows and a prefill's."""
    rng = np.random.default_rng(3)
    x, a, b = _weights(rng, t, h, 4, 16, 256)
    idx = tt(rng.integers(-1, 5, t).astype(np.int32))
    args = [tt(v, dt) for v in (x, a, b)]
    got = tlp.lora_kernel_order_plain(*args, *tlp.bgmv_rows(idx, 4, 16, 2.0))
    _close(got, tlp.bgmv_fused_plain(*args, idx, scaling=2.0))


@pytest.mark.parametrize("seq,s", [([7, 0, 12, 7], 29), ([0, 0, 40], 45), ([1], 1)],
                         ids=["empty-mid", "empty-first", "one-row"])
def test_sgmv_tiled_matches_jax_and_plain(seq, s):
    """Sequences under several adapters, empty ones, a tail past them
    (exactly 0), ranks [8, 4, 2, 8] of 8 and mixed scalings; H 300 (two
    lane strides, the second short)."""
    rng = np.random.default_rng(11 + s)
    x, a, b = _weights(rng, s, 300, 4, 8, 48)
    widx = np.asarray([(2 + i) % 4 for i in range(len(seq))], np.int32)
    seq = np.asarray(seq, np.int32)
    ranks = np.asarray([8, 4, 2, 8], np.int32)
    scal = np.asarray([1.0, 0.5, 2.0, 0.25], np.float32)
    want = jlp.sgmv_fused(jx(x), jx(a), jx(b), jx(widx), jx(seq), jx(ranks), jx(scal), tm=8)
    targs = [tt(v) for v in (x, a, b, widx, seq, ranks, scal)]
    plain = tlp.sgmv_fused_plain(*targs)
    rows = tlp.sgmv_rows(s, *targs[3:], 4, 8)
    got = tlp.lora_kernel_order_plain(*targs[:3], *rows)
    _close(got, want)
    _close(got, plain)
    assert not got[int(seq.sum()):].any()
