"""Port parity: the CPU mirror of the CUDA K14a's walk
(``mla_flash_fwd_tiled_plain``: blocks of 64 flat rows, 64-key chunks up to
a block's last token, a base-2 online softmax) against JAX's ``_flash_fwd``
(its Pallas kernel in interpret mode, as ``tests/test_torch_mla_train.py``
runs it) and against the port's ``mla_flash_fwd_plain``.

Cases cross the chunk edges (S = 1, 63, 64, 65, 130) with rows that span
tokens (H = 4), a block boundary inside a token (H = 20) and blocks of half
a token's heads (H = 128), at B = 2.  Tolerances: the f32 output 1e-5 of its
largest value (f32 sums in another order), bf16 2e-2 of it (P rounded to
bf16 at another scale, the output rounded once), the LSE 1e-4 absolute."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops.attention import mla_train as jmt
from sgl_kernel_npu_tpu_torch.ops.attention import mla_train as tmt

SC = 0.13
CASES = [(s, h) for s in (1, 63, 64, 65, 130) for h in (4, 20, 128)]


def _inputs(rng, b, s, h, dl=64, dr=32):
    return tuple((rng.standard_normal(sh) * 0.3).astype(np.float32)
                 for sh in ((b, s, h, dl), (b, s, h, dr), (b, s, dl), (b, s, dr)))


def _jax_fwd(x, sm_scale, q_chunk=32, k_chunk=64):
    """JAX's K14a (``_flash_fwd``, interpret mode) → (out, lse [B, S, H]);
    the chunk sizes follow ``mla_flash_train``'s rules."""
    b, s, h, _ = x[0].shape
    cq = min(q_chunk, max(8, s))
    ck = -(-max(k_chunk, cq) // cq) * cq
    out, res = jmt._flash_fwd(sm_scale, cq, ck, cq, True, *x)
    return out, np32(res[5])[:, :s * h, 0].reshape(b, s, h)


def _close(got, want, tol):
    got, want = np32(got), np32(want)
    assert float(np.abs(got - want).max()) <= tol * float(np.abs(want).max()), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("s,h", CASES)
def test_tiled_walk_matches_jax_f32(rng, s, h):
    x = _inputs(rng, 2, s, h)
    want, want_lse = _jax_fwd(tuple(map(jx, x)), SC)
    got, lse = tmt.mla_flash_fwd_tiled_plain(*map(tt, x), SC)
    _close(got, want, 1e-5)
    np.testing.assert_allclose(np32(lse), want_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("s,h", CASES)
def test_tiled_walk_matches_jax_bf16(rng, s, h):
    x = _inputs(rng, 2, s, h)
    want, want_lse = _jax_fwd(tuple(jx(a, jnp.bfloat16) for a in x), SC)
    got, lse = tmt.mla_flash_fwd_tiled_plain(*(tt(a, torch.bfloat16) for a in x), SC)
    assert got.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(got, want, 2e-2)
    np.testing.assert_allclose(np32(lse), want_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("s,h", [(65, 20), (130, 128)])
def test_tiled_walk_matches_plain(rng, s, h, dtype):
    """At the kernel's widths (latent 512, rope 64) against the port's plain
    version, which takes the whole score row at once."""
    x = [tt(a, dtype) for a in _inputs(rng, 2, s, h, 512, 64)]
    got, lse = tmt.mla_flash_fwd_tiled_plain(*x, SC)
    want, want_lse = tmt.mla_flash_fwd_plain(*x, SC)
    _close(got, want, 1e-5 if dtype == torch.float32 else 2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


def test_tiled_walk_stops_at_each_block_last_token(rng):
    """Chunks past a block's last token change nothing: the same rows give
    bit-identical results with the keys beyond them replaced by NaN (a walk
    that read them would carry the NaN into its sums)."""
    b, s, h = 2, 130, 4
    x = [tt(a) for a in _inputs(rng, b, s, h)]
    got, lse = tmt.mla_flash_fwd_tiled_plain(*x, SC)
    rows = 64 // h                                  # tokens of the first block
    cut = [t.clone() for t in x]
    for t in cut[2:]:
        t[:, 64:] = float("nan")                    # keys past the first block's chunk
    got_cut, lse_cut = tmt.mla_flash_fwd_tiled_plain(*cut, SC)
    assert torch.equal(got_cut[:, :rows], got[:, :rows])
    assert torch.equal(lse_cut[:, :rows], lse[:, :rows])
