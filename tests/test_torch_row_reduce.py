"""The row-reduction kernels' launch plan, K6a's order of operations and
K5's rule for its levels on the CPU: ``ops/row_reduce._row_plan`` (K5
``quant_per_token`` and K6a ``rms_norm`` on ``csrc/row_reduce.cuh``),
``ops/norm.rms_norm_rows_plain``, which the CUDA kernel matches bit for bit
on the card (``test_torch_cuda_kernels.py``), and
``ops/quant.quant_levels_plain``, which must equal IEEE division's levels
exactly (every finite bf16 value against 300 scales; f32 values one ulp from
a rounding tie).

The plan: each vector of a row (16 bytes, or one element on the element
path) goes to exactly one (cluster rank, thread, vector) slot; clusters of at
most 8 blocks; a thread's vectors within its registers at every timed shape.
The mirror: within one bf16 ulp of the output's largest value of
``rms_norm_ref`` (bf16: the sums in another order move a rounding), 1e-5 of
it in f32; and against JAX's ``rms_norm`` (its Pallas kernel in interpret
mode) at ``test_torch_norm_activation.py``'s tolerances."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops import norm as jn
from sgl_kernel_npu_tpu_torch.ops import norm as tn
from sgl_kernel_npu_tpu_torch.ops import quant as tq
from sgl_kernel_npu_tpu_torch.ops import row_reduce as rr

SMS = 132   # the H100's SMs

# (rows, hidden, element bytes): K5's and K6a's timed shapes, f32 rows, ragged widths
TIMED = [(8, 16384, 2), (8, 7168, 2), (64, 7168, 2), (2048, 7168, 2), (512, 2880, 2),
         (8, 2880, 2), (8, 4096, 2), (512, 4096, 2), (8, 16384, 4), (2048, 7168, 4)]
RAGGED = [(3, 100, 2), (7, 100, 2), (3, 4097, 2), (3, 4097, 4), (1, 1, 2)]


def _covers_once(plan, hidden):
    index, live = rr.row_vectors(plan, hidden)
    got = torch.sort(index[live]).values
    return torch.equal(got, torch.arange(hidden // plan.elems))


@pytest.mark.parametrize("rows,hidden,nbytes", TIMED + RAGGED)
def test_row_plan_covers_each_vector_once(rows, hidden, nbytes):
    plan = rr._row_plan(rows, hidden, nbytes, SMS)
    assert plan.cluster in (1, 2, 4, 8)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= rr.MAX_THREADS
    assert plan.elems == (16 // nbytes if hidden % (16 // nbytes) == 0 else 1)
    assert plan.cluster * plan.threads * plan.vecs * plan.elems >= hidden
    assert _covers_once(plan, hidden)
    if (rows, hidden, nbytes) in TIMED:
        assert plan.vecs <= rr.VMAX             # the row stays in registers


def test_row_plan_shapes():
    """Decode rows wider than SPLIT_BYTES split across a cluster into blocks
    of at most BLOCK_BYTES (while the blocks do not yet fill the SMs), one
    vector a thread up to ONE_VEC of them; chunk rows take two rows a block;
    a misaligned tensor or a ragged width takes the element path; a row past
    the registers streams (vecs > VMAX) and is still covered."""
    assert rr._row_plan(8, 16384, 2, SMS) == rr.RowPlan(4, 256, 2, 8, 1)
    assert rr._row_plan(8, 32768, 2, SMS).cluster == 8
    assert rr._row_plan(100, 16384, 2, SMS).cluster == 2
    assert rr._row_plan(8, 7168, 2, SMS) == rr.RowPlan(1, 448, 2, 8, 1)
    assert rr._row_plan(8, 2880, 2, SMS) == rr.RowPlan(1, 384, 1, 8, 1)
    assert rr._row_plan(2048, 7168, 2, SMS) == rr.RowPlan(1, 448, 2, 8, 2)
    assert rr._row_plan(512, 2880, 2, SMS) == rr.RowPlan(1, 192, 2, 8, 2)
    for rows in (1, 8, 16, 40, 100, 132, 300):
        for hidden in (2880, 4096, 7168, 16384, 65536):
            c = rr._row_plan(rows, hidden, 2, SMS).cluster
            assert c == 1 or 2 * hidden > rr.SPLIT_BYTES
            assert c in (1, rr.MAX_CLUSTER) or rows * c >= SMS or 2 * hidden <= rr.BLOCK_BYTES * c
    assert rr._row_plan(8, 16384, 2, SMS, aligned=False).elems == 1
    wide = rr._row_plan(4096, 65536, 4, SMS)
    assert wide.vecs > rr.VMAX and _covers_once(wide, 65536)


# one plan for each cluster size (8, 4, 2, 1 in bf16; two rows a block at
# 512), the element path (in a cluster of 8 at (3, 32771)), and a thread's
# partial vector
MIRROR = [(8, 32768), (8, 16384), (100, 16384), (512, 2880), (8, 2880), (300, 256), (3, 100),
          (7, 100), (3, 32771)]


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("rows,hidden", MIRROR)
def test_rms_norm_rows_plain_matches_ref(rows, hidden, dt):
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    rng = np.random.default_rng(rows * 5 + hidden)
    x = torch.from_numpy((rng.standard_normal((rows, hidden)) * 3).astype(np.float32)).to(tdt)
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)).to(tdt)
    plan = rr._row_plan(rows, hidden, x.element_size(), SMS)
    got = tn.rms_norm_rows_plain(x, w, 1e-5, plan)
    want = tn.rms_norm_ref(x, w, 1e-5)
    assert got.dtype == tdt and got.shape == x.shape
    scale = float(want.float().abs().max())
    tol = 2.0 ** (math.floor(math.log2(scale)) - 7) if dt == "bf16" else 1e-5 * scale
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_rms_norm_rows_plain_order():
    """The order is the kernel's, not a plain sum's: one warp of one element
    a lane adds by butterfly (lane l adds lane l ^ o's value for o = 16, 8,
    4, 2, 1), repeated here in numpy f32; and the sum, so the output, depends
    on the plan."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 32)) * 3).astype(np.float32)
    v = x * x
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, np.arange(32) ^ o]
    r = np.float32(1) / np.sqrt(v[:, 0] / np.float32(32) + np.float32(1e-5))
    want = x * r[:, None] * np.float32(1)
    got = tn.rms_norm_rows_plain(torch.from_numpy(x), torch.ones(32), 1e-5,
                                 rr.RowPlan(1, 32, 1, 1))
    assert np.array_equal(got.numpy(), want)
    xl = torch.from_numpy((rng.standard_normal((4, 4096)) * 3).astype(np.float32))
    outs = [tn.rms_norm_rows_plain(xl, torch.ones(4096), 1e-5,
                                   rr.RowPlan(c, 32, 4096 // (32 * c), 1)) for c in (1, 8)]
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("rows,hidden,dt", [(8, 2880, "bf16"), (3, 100, "f32"),
                                            (40, 2880, "bf16"), (100, 4096, "f32")])
def test_rms_norm_rows_plain_matches_jax(rows, hidden, dt):
    jdt, tdt, rel = {"f32": (jnp.float32, torch.float32, 1e-5),
                     "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[dt]
    rng = np.random.default_rng(rows * 11 + hidden)
    x = (rng.standard_normal((rows, hidden)) * 3).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)
    want = np32(jn.rms_norm(jx(x, jdt), jx(w, jdt), 1e-5))
    xt = tt(x, tdt)
    got = np32(tn.rms_norm_rows_plain(xt, tt(w, tdt), 1e-5,
                                      rr._row_plan(rows, hidden, xt.element_size(), SMS)))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _levels_equal(x):
    """K5's level rule against IEEE division on rows ``x``, each scaled by
    its own ``max(amax / 127, 1e-12)``."""
    s = torch.clamp_min(tq.row_scale(x), 1e-12)
    return torch.equal(tq.quant_levels_plain(x, s), tq.saturate_int8(x / s[:, None]))


def test_quant_levels_every_bf16_value():
    """Every finite bf16 value up to a row's amax, for amax 127 (s = 1: exact
    ties), 100, 3e38, 1e-30 (s clamped at 1e-12) and 300 more from e^-40 to
    e^40: the screened reciprocal product and IEEE division agree."""
    vals = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).float()
    vals = vals[torch.isfinite(vals)]
    gen = torch.Generator().manual_seed(0)
    amaxes = torch.cat([torch.tensor([127.0, 100.0, 3.0e38, 1e-30]),
                        torch.exp(torch.empty(300).uniform_(-40, 40, generator=gen))])
    for a in amaxes.to(torch.bfloat16).float():
        x = vals[vals.abs() <= a]
        assert _levels_equal(torch.cat([x, a.reshape(1)])[None]), float(a)


@pytest.mark.parametrize("amax", [100.0, 127.0, 55.5, 1e-3, 3.3e-12])
def test_quant_levels_near_ties(amax):
    """f32 values one ulp either side of (k + 1/2) s, where a reciprocal
    product alone would round to the other level now and then."""
    gen = torch.Generator().manual_seed(int(amax * 1000) % 1000)
    s = torch.clamp_min(torch.tensor([amax]) / torch.tensor([127.0]), 1e-12)
    x = (torch.randint(-127, 127, (100000,), generator=gen).float() + 0.5) * s
    x = torch.nextafter(x, x + torch.randn(x.shape, generator=gen).sign())
    x = torch.cat([x[x.abs() <= amax], torch.tensor([amax])])
    assert _levels_equal(x[None])


# K7a (swiglu_quant) over gate ‖ up: (rows, output width I, element bytes) at
# its timed shapes (DeepSeek-V3's shared expert at decode and a 2048-row
# chunk, Llama-3.1-8B's MLP at decode and a 512-row chunk), f32 rows and
# ragged widths
K7A_TIMED = [(8, 2048, 2), (8, 14336, 2), (512, 14336, 2), (2048, 2048, 2), (8, 14336, 4)]
K7A_RAGGED = [(5, 100, 2), (3, 4100, 2), (1, 1, 2), (7, 2050, 4)]


@pytest.mark.parametrize("rows,width,nbytes", K7A_TIMED + K7A_RAGGED)
def test_swiglu_plan_covers_each_vector_once(rows, width, nbytes):
    """K7a's plan is over the output row: each output vector in exactly one
    (cluster rank, thread, vector) slot, and through it each of the input's
    gate and up vectors (vector j reads column j N of each half) read once."""
    plan = rr._row_plan(rows, width, nbytes, SMS, inputs=2)
    assert plan.elems == (16 // nbytes if width % (16 // nbytes) == 0 else 1)
    assert _covers_once(plan, width)
    index, live = rr.row_vectors(plan, width)
    nvec = width // plan.elems
    both = torch.cat([index[live], index[live] + nvec])           # gate, then up vectors
    assert torch.equal(torch.sort(both).values, torch.arange(2 * nvec))
    if (rows, width, nbytes) in K7A_TIMED:
        assert plan.vecs <= rr.VMAX


def test_two_input_plan_shapes():
    """K7a's and K6b / K6c's plans (two inputs an output vector) split on the
    input's bytes: Llama's K7a decode rows (57 KB of gate ‖ up) take clusters
    of 8, DeepSeek's [8, 4096] (8 KB) and K6b's [8, 4096] (16 KB of x and r)
    one block a row; one vector a thread up to 512 of them at any row count;
    chunk sizes four rows a block."""
    assert rr._row_plan(8, 14336, 2, SMS, inputs=2) == rr.RowPlan(8, 224, 1, 8, 1)
    assert rr._row_plan(8, 14336, 2, SMS).cluster == 4            # one input span: half the bytes
    assert rr._row_plan(8, 2048, 2, SMS, inputs=2) == rr.RowPlan(1, 256, 1, 8, 1)
    assert rr._row_plan(8, 4096, 2, SMS, inputs=2) == rr.RowPlan(1, 512, 1, 8, 1)
    assert rr._row_plan(512, 14336, 2, SMS, inputs=2) == rr.RowPlan(1, 512, 4, 8, 4)
    assert rr._row_plan(2048, 2048, 2, SMS, inputs=2) == rr.RowPlan(1, 256, 1, 8, 4)
    assert rr._row_plan(512, 4096, 2, SMS, inputs=2) == rr.RowPlan(1, 512, 1, 8, 4)
    assert rr._row_plan(512, 7168, 2, SMS, inputs=2) == rr.RowPlan(1, 448, 2, 8, 4)


@pytest.mark.parametrize("rows,hidden,nbytes", TIMED + RAGGED)
def test_two_input_plan_covers_each_vector_once(rows, hidden, nbytes):
    """K6b / K6c's plan (``inputs=2``) at K5's and K6a's shapes and ragged
    widths: each vector in exactly one slot, within the registers at the
    timed shapes."""
    plan = rr._row_plan(rows, hidden, nbytes, SMS, inputs=2)
    assert plan.cluster in (1, 2, 4, 8) and plan.threads % 32 == 0
    assert _covers_once(plan, hidden)
    if (rows, hidden, nbytes) in TIMED:
        assert plan.vecs <= rr.VMAX


def test_launch_plan_checks_each_half(monkeypatch):
    """``launch_plan(..., halves=2)`` takes 16-byte vectors only where each
    half of x starts 16-byte aligned: a tensor 2 bytes past a boundary, or a
    width whose up half starts mid-vector, takes the element path."""
    monkeypatch.setattr(rr, "_sm_count", lambda device: SMS)
    flat = torch.zeros(8 * 4096 + 8, dtype=torch.bfloat16)
    x = flat[:8 * 4096].view(8, 4096)
    out = torch.zeros((8, 2048), dtype=torch.int8)
    assert rr.launch_plan(x, out, halves=2).elems == 8
    assert rr.launch_plan(flat[1:8 * 4096 + 1].view(8, 4096), out, halves=2).elems == 1
    ragged = torch.zeros((8, 4100), dtype=torch.bfloat16)         # the up half at 4100 bytes
    assert rr.launch_plan(ragged, out, halves=2).elems == 1
    assert rr.launch_plan(x, out, halves=2) == rr._row_plan(8, 2048, 2, SMS, inputs=2)


# K6d's shapes (f32 out from bf16 or f32): decode and chunk sizes, a cluster
# of 8, the element path
L1_PLANS = [(512, 4096), (8, 4096), (2048, 4096), (8, 32768), (100, 16384), (7, 100),
            (3, 4097)]


@pytest.mark.parametrize("rows,hidden", L1_PLANS)
def test_l1_plan_covers_each_vector_once(rows, hidden):
    """K6d's plan: vectors of 16 bytes of the f32 output (4 elements, or 1 on
    the element path), each in one slot, the row in registers at every timed
    shape."""
    plan = rr.l1_plan(rows, hidden, SMS)
    assert plan.elems == (4 if hidden % 4 == 0 else 1)
    assert _covers_once(plan, hidden)
    assert plan.vecs <= rr.VMAX and plan.cluster in (1, 2, 4, 8)
    assert rr.l1_plan(rows, hidden, SMS, aligned=False).elems == 1


def test_l1_plan_shapes():
    """The plans the sweep chose on the H100 (PERF.md §6): four vectors a
    thread and two rows a block at chunk sizes, two a thread at decode, a
    decode row over 16 KB of output split across a cluster."""
    assert rr.l1_plan(512, 4096, SMS) == rr.RowPlan(1, 256, 4, 4, 2)
    assert rr.l1_plan(2048, 4096, SMS) == rr.RowPlan(1, 256, 4, 4, 2)
    assert rr.l1_plan(8, 4096, SMS) == rr.RowPlan(1, 512, 2, 4, 1)
    assert rr.l1_plan(8, 32768, SMS).cluster == 8
