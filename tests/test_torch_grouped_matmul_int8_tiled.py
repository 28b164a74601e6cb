"""K8a's int8 walk on the CPU: ``grouped_matmul_tiled_plain`` (the CUDA
kernel's 128-row work items x 128-column tiles, the gate / up pairing of the
SwiGLU modes by the pack width's slabs, stages of 128 k) against JAX's
``grouped_matmul`` in Pallas interpret mode and against the port's plain
version.

Groups of 1-64, 65-128, 129 and 257 rows (one, two and three work items),
empty groups and rows past the total; N not a multiple of the 128-column
tile.  Tolerances as ``test_torch_grouped_matmul.py``'s remaining modes:
``none`` bit-equal (exact integer sums on both sides), ``dequant`` within an
f32 ulp, the SwiGLU modes 1e-5 of the largest |value| in f32 and one bf16
ulp in bf16, ``dequant_swiglu_quant`` one int8 level (the SiLU's exp) and
scales rtol 1e-5; against the port's plain version, which runs the same f32
operations, bit-equal where the epilogue does not take the exp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops import grouped_matmul as jgm
from sgl_kernel_npu_tpu_torch.ops import grouped_matmul as tgm

# one item, two and three items, a one-row group, empty groups, 9 rows past the total
SIZES = np.asarray([70, 0, 129, 1, 257, 0, 40], np.int32)
ROWS, K, N = int(SIZES.sum()) + 9, 384, 320
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, k=K, n=N):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (ROWS, k)).astype(np.int8)
    w = rng.integers(-127, 128, (len(SIZES), k, n)).astype(np.int8)
    sx = (rng.random(ROWS) / 50 + 1e-3).astype(np.float32)
    sw = (rng.random((len(SIZES), n)) / 500 + 1e-4).astype(np.float32)
    return x, w, sx, sw


def _jax(x, w, sx, sw, **kw):
    out = kw.pop("out_dtype", None)
    if out:
        kw["out_dtype"] = _DT[out][0]
    return jgm.grouped_matmul(jx(x), jx(w), jx(SIZES), jx(sx), jx(sw), tm=64, tk=128, **kw)


def _port(fn, x, w, sx, sw, **kw):
    out = kw.pop("out_dtype", None)
    if out:
        kw["out_dtype"] = _DT[out][1]
    return fn(tt(x), tt(w), tt(SIZES), tt(sx), tt(sw), **kw)


CASES = [
    ("none-f32", dict(epilogue="none", tn=64)),
    ("none-bf16", dict(epilogue="none", tn=64, out_dtype="bf16")),
    ("dequant-f32", dict(epilogue="dequant", tn=64, out_dtype="f32")),
    ("dequant-bf16", dict(epilogue="dequant", tn=64)),
    ("swiglu-full-f32", dict(epilogue="dequant_swiglu", tn=N, out_dtype="f32")),
    ("swiglu-tn64-bf16", dict(epilogue="dequant_swiglu", tn=64)),
    ("swiglu-tn32-f32", dict(epilogue="dequant_swiglu", tn=32, out_dtype="f32")),
    ("swiglu-tn160-f32", dict(epilogue="dequant_swiglu", tn=160, out_dtype="f32")),
]


def _close(got, want, kw):
    got, want = np32(got), np32(want)
    if kw["epilogue"] == "none":
        np.testing.assert_array_equal(got, want)
    elif kw["epilogue"] == "dequant":
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    elif kw.get("out_dtype") == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_tiled_walk_matches_jax(name, kw):
    """Each mode of the tiled walk against JAX's kernel in interpret mode,
    the narrow pack widths (32, 64: a 64-column gate half spans several
    slabs; 160: a slab of 80 columns) included; rows past the total zero."""
    x, w, sx, sw = _inputs(1)
    want = _jax(x, w, sx, sw, **kw)
    got = _port(tgm.grouped_matmul_tiled_plain, x, w, sx, sw, **kw)
    assert tuple(got.shape) == want.shape
    _close(got, want, kw)
    assert not got[int(SIZES.sum()):].any()


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_tiled_walk_matches_plain(name, kw):
    """The tiled walk runs the plain version's f32 operations on the same
    exact sums: bit-equal, K off the 128-byte stage (336) included."""
    x, w, sx, sw = _inputs(2, k=336)
    got = _port(tgm.grouped_matmul_tiled_plain, x, w, sx, sw, **kw)
    want = _port(tgm.grouped_matmul_plain, x, w, sx, sw, **kw)
    assert got.dtype == want.dtype
    if kw["epilogue"] == "dequant_swiglu":     # torch's exp on a tile vs on the whole rows
        _close(got, want, kw)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_tiled_walk_swiglu_quant_matches_jax():
    """``dequant_swiglu_quant``: the activation's per-row requant over every
    column tile, one int8 level and scales rtol 1e-5 of JAX's; rows past the
    total zero with scale 0."""
    x, w, sx, sw = _inputs(3)
    h1_j, hs_j = _jax(x, w, sx, sw, epilogue="dequant_swiglu_quant", tn=N)
    h1, hs = _port(tgm.grouped_matmul_tiled_plain, x, w, sx, sw,
                   epilogue="dequant_swiglu_quant")
    assert h1.dtype == torch.int8 and h1.shape == h1_j.shape
    assert np.abs(h1.numpy().astype(np.int32) - np.asarray(h1_j, np.int32)).max() <= 1
    np.testing.assert_allclose(hs.numpy(), np32(hs_j), rtol=1e-5, atol=0)
    total = int(SIZES.sum())
    assert not h1[total:].any() and not hs[total:].any()


def test_tiled_walk_contract_last_and_dispatch_match_jax():
    """``rhs_contract_last`` (``w [G, N, K]``, read K-major as stored)
    bit-equal to JAX's kernel; a one-hot ``dispatch_p`` (a pad id gives a
    zero row) bit-equal to the walk on the gathered rows."""
    x, w, _, _ = _inputs(4)
    wt = np.ascontiguousarray(w.transpose(0, 2, 1))
    want = jgm.grouped_matmul(jx(x), jx(wt), jx(SIZES), rhs_contract_last=True, tm=64, tk=128,
                              tn=64)
    got = tgm.grouped_matmul_tiled_plain(tt(x), tt(wt), tt(SIZES), rhs_contract_last=True)
    np.testing.assert_array_equal(np32(got), np32(want))
    rng = np.random.default_rng(5)
    n_tok = 30
    tok = rng.integers(0, n_tok + 1, ROWS).astype(np.int32)      # n_tok: a pad id
    p = tgm.dispatch_onehot(tt(tok), n_tok)
    xt = tt(x[:n_tok])
    gathered = torch.where(tt(tok)[:, None] < n_tok, xt[tt(tok).clamp(max=n_tok - 1).long()], 0)
    a = tgm.grouped_matmul_tiled_plain(xt, tt(w), tt(SIZES), epilogue="none", dispatch_p=p)
    b = tgm.grouped_matmul_tiled_plain(gathered, tt(w), tt(SIZES), epilogue="none")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
