"""K9a's walk on the CPU: ``mla_prefill_tiled_plain`` (the CUDA kernel's
blocks of 64 rows, tokens x heads of one request as ``sparse_tiling`` gives
them, 64-key chunks of positions up to the causal end of a block's last live
token, each row masking keys past its own, the base-2 online softmax with P
rounded to bf16) against JAX's ``mla_prefill_pallas`` in Pallas interpret
mode and against the port's ``mla_prefill_ref``.

Requests of 1, 63, 64, 65 and 130 tokens whose causal ends fall on and
beside 64-key chunk edges, three pad rows past them (exactly 0), heads 128
(two head tiles of 64 rows: one token a block), 16 (4 tokens a block) and 8
(8 tokens), page 16 and page 12 (not a multiple of 8), f32, bf16 and an int8
latent with ``k_scale``.  Tolerances: f32 within 1e-5 of the output's largest
|value| (the same f32 products, summed in another order), bf16 and int8
within 2e-2 (P and the output rounded to bf16)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops.attention import mla_prefill as jmp
from sgl_kernel_npu_tpu_torch.ops.attention import mla_prefill as tmp

SEQ = np.asarray([1, 63, 64, 65, 130], np.int32)
# causal ends: 1; 2 .. 64 (on an edge); 64 .. 127; 65 .. 129 (beside 128); 63 .. 192
CTX = np.asarray([1, 64, 127, 129, 192], np.int32)
PAD = 3
KS = 1.0 / 32
SCALE = 576 ** -0.5
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(heads, page, kind, seed):
    rng = np.random.default_rng(seed)
    max_pages = -(-int(CTX.max()) // page)
    n_pages = len(SEQ) * max_pages
    if kind == "int8":
        kn = rng.integers(-127, 128, (n_pages, 1, page, 512)).astype(np.int8)
    else:
        kn = (rng.standard_normal((n_pages, 1, page, 512)) * 0.5).astype(np.float32)
    kr = (rng.standard_normal((n_pages, 1, 64, page)) * 0.5).astype(np.float32)
    bt = rng.permutation(n_pages).reshape(len(SEQ), max_pages).astype(np.int32)
    q = (rng.standard_normal((int(SEQ.sum()) + PAD, heads, 576)) * 0.5).astype(np.float32)
    return q, kn, kr, bt


CASES = [(128, 16, "f32"), (128, 12, "bf16"), (16, 16, "int8"), (16, 12, "f32"),
         (8, 16, "bf16"), (8, 12, "int8")]


@pytest.mark.parametrize("heads,page,kind", CASES, ids=[f"h{h}-p{p}-{k}" for h, p, k in CASES])
def test_tiled_walk_matches_jax_and_plain(heads, page, kind):
    q, kn, kr, bt = _inputs(heads, page, kind, seed=heads + page)
    fdt = "bf16" if kind == "int8" else kind
    ks = KS if kind == "int8" else None
    jdt, tdt = _DT[fdt]
    kn_j = jx(kn) if kind == "int8" else jx(kn, jdt)
    kn_t = tt(kn) if kind == "int8" else tt(kn, tdt)
    want = np32(jmp.mla_prefill_pallas(jx(q, jdt), kn_j, jx(kr, jdt), jx(SEQ), jx(bt), jx(CTX),
                                       SCALE, max_q=int(SEQ.max()), q_chunk=64, k_scale=ks))
    args = (tt(q, tdt), kn_t, tt(kr, tdt), tt(SEQ), tt(bt), tt(CTX), SCALE)
    got = tmp.mla_prefill_tiled_plain(*args, max_q=int(SEQ.max()), k_scale=ks)
    ref = np32(tmp.mla_prefill_ref(*args, k_scale=ks))
    assert got.dtype == tdt and got.shape == (q.shape[0], heads, 512)
    got = np32(got)
    for other in (want, ref):
        if kind == "f32":
            np.testing.assert_allclose(got, other, rtol=0, atol=1e-5 * np.abs(other).max())
        else:
            np.testing.assert_allclose(got, other, rtol=2e-2, atol=2e-2)
    assert not got[-PAD:].any()


@pytest.mark.parametrize("heads,tiling", [(128, (1, 64)), (16, (4, 16)), (8, (8, 8)),
                                          (20, (3, 20))])
def test_tiling_of_dense_blocks(heads, tiling):
    """K9a's blocks: one chunk of ``max_q`` tokens, ``tq`` tokens x ``hb``
    heads of at most 64 rows (all heads below 64)."""
    tq, hb, tiles = tmp.sparse_tiling(heads, 130)
    assert (tq, hb) == tiling and tq * hb <= tmp.SPARSE_ROWS and tiles * tq >= 130


def test_tiled_walk_independent_of_max_q():
    """``max_q`` only bounds the grid: a larger one gives the same rows bit
    for bit (a block's walk past a row's own causal end leaves it as it is)."""
    q, kn, kr, bt = _inputs(16, 16, "bf16", seed=7)
    args = (tt(q, torch.bfloat16), tt(kn, torch.bfloat16), tt(kr, torch.bfloat16), tt(SEQ),
            tt(bt), tt(CTX), SCALE)
    a = tmp.mla_prefill_tiled_plain(*args, max_q=int(SEQ.max()))
    b = tmp.mla_prefill_tiled_plain(*args, max_q=4 * int(SEQ.max()))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
