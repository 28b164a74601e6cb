"""Port parity: LoRA ops (``ops/lora.py``) and the fused LoRA kernels'
plain versions (``ops/lora_pallas.py``: K13a ``bgmv_fused``, K13b
``sgmv_fused``).

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode on the CPU, its jnp ops) and through the port's functions on
CPU tensors (the wrappers take their plain versions).  Tolerances: f32
within 1e-5 of the output's largest value (f32 sums in another order); bf16
within 2e-2 of it (bf16 inputs, f32 sums, one rounding of the output; JAX's
jnp chain also rounds the shrink to bf16, the port's kernel keeps it in
f32, which moves the delta by ~2^-8 of its size)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops import lora as jl
from sgl_kernel_npu_tpu.ops import lora_pallas as jlp
from sgl_kernel_npu_tpu_torch.ops import lora as tl
from sgl_kernel_npu_tpu_torch.ops import lora_pallas as tlp

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _close(got, want, rel):
    want = np32(want)
    assert np32(got).shape == want.shape
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=rel * np.abs(want).max())


def _weights(rng, t, h, l, r, d):
    x = rng.standard_normal((t, h)).astype(np.float32)
    a = (rng.standard_normal((l, r, h)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((l, d, r)) * 0.1).astype(np.float32)
    return x, a, b


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("layout", ["b", "bt"])
@pytest.mark.parametrize("pool", ["small", "chunked"])
def test_bgmv_fused_matches_jax(pool, layout, dt):
    """K13a's plain version against JAX's kernel, B in its stored ``[L, D,
    R]`` layout or pre-transposed (``bt``), scaling 0.5, ids outside ``[0,
    L)`` (delta 0 on both sides).  ``chunked``: a pool of 7 adapters of rank
    64 at width 2048 that outgrows the TPU kernel's VMEM budget, so JAX walks
    it in chunks (and pads the last)."""
    jdt, tdt, rel = DTYPES[dt]
    t, h, l, r, d = (9, 96, 3, 8, 80) if pool == "small" else (5, 2048, 7, 64, 2048)
    rng = np.random.default_rng(t + l)
    x, a, b = _weights(rng, t, h, l, r, d)
    idx = rng.integers(0, l, t).astype(np.int32)
    idx[1], idx[-1] = -1, l                         # out of range: a zero delta
    kw_j = {"bt": jx(b.transpose(0, 2, 1), jdt)} if layout == "bt" else {}
    kw_t = {"bt": tt(b.transpose(0, 2, 1).copy(), tdt)} if layout == "bt" else {}
    want = jlp.bgmv_fused(jx(x, jdt), jx(a, jdt), None if kw_j else jx(b, jdt), jx(idx),
                          scaling=0.5, **kw_j)
    got = tlp.bgmv_fused(tt(x, tdt), tt(a, tdt), None if kw_t else tt(b, tdt), tt(idx),
                         scaling=0.5, **kw_t)
    assert got.dtype == torch.float32
    _close(got, want, rel)
    assert not got[1].any() and not got[-1].any()


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_sgmv_fused_matches_jax(dt):
    """K13b's plain version against JAX's kernel: 4 sequences over 29 rows
    (one empty, a 3-row tail past them), ranks ``[8, 4, 2, 8]`` of 8, mixed
    scalings; tail rows exactly 0.  JAX's tiles are 8 rows, so tiles
    straddle sequences."""
    jdt, tdt, rel = DTYPES[dt]
    rng = np.random.default_rng(11)
    x, a, b = _weights(rng, 29, 64, 4, 8, 48)
    seq = np.asarray([7, 0, 12, 7], np.int32)
    widx = np.asarray([2, 1, 3, 0], np.int32)
    ranks = np.asarray([8, 4, 2, 8], np.int32)
    scal = np.asarray([1.0, 0.5, 2.0, 0.25], np.float32)
    want = jlp.sgmv_fused(jx(x, jdt), jx(a, jdt), jx(b, jdt), jx(widx), jx(seq), jx(ranks),
                          jx(scal), tm=8)
    got = tlp.sgmv_fused(tt(x, tdt), tt(a, tdt), tt(b, tdt), tt(widx), tt(seq), tt(ranks),
                         tt(scal))
    assert got.dtype == torch.float32
    _close(got, want, rel)
    assert not got[26:].any()
    got_delta = tl.fused_sgmv_delta(tt(x, tdt), tt(a, tdt), tt(b, tdt), tt(widx), tt(seq),
                                    tt(ranks), tt(scal))
    want_delta = jl.fused_sgmv_delta(jx(x, jdt), jx(a, jdt), jx(b, jdt), jx(widx), jx(seq),
                                     jx(ranks), jx(scal))
    assert got_delta.dtype == tdt
    _close(got_delta, want_delta, rel)


def test_token_lora_indices_match_jax():
    seq = np.asarray([3, 0, 2], np.int32)
    widx = np.asarray([4, 5, 6], np.int32)
    want_idx, want_valid = jl.token_lora_indices(jx(widx), jx(seq), 7)
    got_idx, got_valid = tl.token_lora_indices(tt(widx), tt(seq), 7)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_bgmv_shrink_expand_match_jax(dt):
    """bgmv shrink (scaled) then expand into a slice of a base output."""
    jdt, tdt, rel = DTYPES[dt]
    rng = np.random.default_rng(3)
    x, a, b = _weights(rng, 6, 32, 3, 4, 24)
    idx = np.asarray([0, 2, 1, 1, 2, 0], np.int32)
    base = rng.standard_normal((6, 40)).astype(np.float32)
    sj = jl.bgmv_shrink(jx(x, jdt), jx(a, jdt), jx(idx), 0.5)
    st = tl.bgmv_shrink(tt(x, tdt), tt(a, tdt), tt(idx), 0.5)
    assert st.dtype == tdt
    _close(st, sj, rel)
    ej = jl.bgmv_expand(sj, jx(b, jdt), jx(idx), jx(base, jdt), slice_offset=10)
    et = tl.bgmv_expand(st, tt(b, tdt), tt(idx), tt(base, tdt), slice_offset=10)
    _close(et, ej, rel)
    _close(tl.bgmv_expand(st, tt(b, tdt), tt(idx)), jl.bgmv_expand(sj, jx(b, jdt), jx(idx)), rel)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("num_slices", [1, 3])
def test_sgmv_sgemmv_shrink_expand_match_jax(num_slices, dt):
    """sgmv / sgemmv shrink and expand with per-adapter ranks and scalings,
    compact-by-rank slices (1, or 3 as q / k / v), an empty sequence and a
    tail past the sequences."""
    jdt, tdt, rel = DTYPES[dt]
    rng = np.random.default_rng(num_slices)
    max_r, h = 4, 32
    offsets = (0, 16, 24, 40) if num_slices == 3 else (0, 20)
    x = rng.standard_normal((11, h)).astype(np.float32)
    a = (rng.standard_normal((3, num_slices * max_r, h)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((3, offsets[-1], max_r)) * 0.1).astype(np.float32)
    seq = np.asarray([4, 0, 5], np.int32)
    widx = np.asarray([1, 0, 2], np.int32)
    ranks = np.asarray([4, 2, 3], np.int32)
    scal = np.asarray([0.5, 1.0, 2.0], np.float32)
    base = rng.standard_normal((11, offsets[-1])).astype(np.float32)
    for shrink, expand, t_shrink, t_expand in (
            (jl.sgmv_shrink, jl.sgmv_expand, tl.sgmv_shrink, tl.sgmv_expand),
            (jl.sgemmv_shrink, jl.sgemmv_expand, tl.sgemmv_shrink, tl.sgemmv_expand)):
        sj = shrink(jx(x, jdt), jx(a, jdt), jx(widx), jx(seq), jx(ranks), jx(scal), num_slices)
        ej = expand(sj, jx(b, jdt), jx(widx), jx(seq), jx(ranks), offsets, jx(base, jdt))
        st = t_shrink(tt(x, tdt), tt(a, tdt), tt(widx), tt(seq), tt(ranks), tt(scal), num_slices)
        _close(st, sj, rel)
        et = t_expand(st, tt(b, tdt), tt(widx), tt(seq), tt(ranks), offsets, tt(base, tdt))
        assert et.dtype == tdt
        _close(et, ej, rel)
        _close(t_expand(st, tt(b, tdt), tt(widx), tt(seq), tt(ranks), offsets),
               expand(sj, jx(b, jdt), jx(widx), jx(seq), jx(ranks), offsets), rel)


# JAX's fused_lora_delta picks its route by TPU heuristics: (tokens, pool,
# width) that send it down each one.
ROUTES = {"jnp_chain": (8, 4, 128), "bgmv_kernel": (8, 40, 128), "gather_chain": (64, 33, 8192)}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fused_lora_delta_matches_each_jax_route(route, dt):
    """The port's ``fused_lora_delta`` (K13a at every size) against JAX's
    on each of its routes, in x's type: the all-adapters jnp chain (a small
    pool), its ``bgmv_fused`` kernel (a pool above 32), the per-token gather
    chain (T·L·H past 64 MiB)."""
    jdt, tdt, rel = DTYPES[dt]
    t, l, h = ROUTES[route]
    rng = np.random.default_rng(t + l)
    x, a, b = _weights(rng, t, h, l, 4, 64)
    idx = rng.integers(0, l, t).astype(np.int32)
    want = jl.fused_lora_delta(jx(x, jdt), jx(a, jdt), jx(b, jdt), jx(idx), scaling=0.5)
    got = tl.fused_lora_delta(tt(x, tdt), tt(a, tdt), tt(b, tdt), tt(idx), scaling=0.5)
    assert got.dtype == tdt
    _close(got, want, rel)


def test_cpu_wrappers_count_no_launch():
    """On CPU tensors the LoRA wrappers take their plain versions and count
    nothing."""
    before = (tlp.bgmv_fused.launches, tlp.sgmv_fused.launches)
    x, a, b = (torch.randn(s) for s in ((3, 8), (2, 4, 8), (2, 6, 4)))
    idx = torch.tensor([0, 1, 1], dtype=torch.int32)
    torch.testing.assert_close(tlp.bgmv_fused(x, a, b, idx), tlp.bgmv_fused_plain(x, a, b, idx))
    args = (torch.tensor([1]), torch.tensor([2]), torch.tensor([4, 4]), torch.tensor([1.0, 1.0]))
    torch.testing.assert_close(tlp.sgmv_fused(x, a, b, *args), tlp.sgmv_fused_plain(x, a, b, *args))
    assert (tlp.bgmv_fused.launches, tlp.sgmv_fused.launches) == before
