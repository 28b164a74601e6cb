"""Port parity: the CPU mirrors of the CUDA K14b / K14c walks
(``mla_flash_bwd_dq_tiled_plain``: K14a's 64-row blocks over 32-key chunks;
``mla_flash_bwd_dk_tiled_plain``: 64-key chunks against bands of 32-row
tiles, an f32 partial a (band, chunk), a chunk's added in band order)
against JAX's ``_flash_bwd`` (its Pallas kernels in interpret mode, as
``tests/test_torch_mla_train.py`` runs them) and against the port's plain
versions.

Both sides take the same inputs, the port's plain forward's output and LSE
and delta = rowsum(dO o O) (JAX's ``_flash_bwd`` takes them as its saved
residuals), so only the backward differs.  Cases cross the 32- and 64-key
chunk edges (S = 1, 31, 32, 33, 63, 64, 65, 130) with rows that span tokens
(H = 4), a block boundary inside a token (H = 20) and blocks of half a
token's heads (H = 128), at B = 2: each S once in f32, four in bf16, each
at one H (a JAX backward in interpret mode takes 1-2 s to compile under one
``jax.jit``); K14c's bands are a quarter of a chunk's width (H / 2 tiles),
so each chunk adds several partials and the last band is cut short.
Tolerances: f32 within 1e-5 of the tensor's largest |value| (f32 sums in
another order) plus 1e-6 (at S = 1 the true dQ is 0: a softmax over one key,
both sides f32 cancellation noise); bf16 2e-2 of the largest |value| plus
1e-6 (dS and P round to bf16 on both sides, at base-2 and natural-exp P that
differ by an f32 ulp, so a tie flips one)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops.attention import mla_train as jmt
from sgl_kernel_npu_tpu_torch.ops.attention import mla_train as tmt

SC = 0.13
SEQS = (1, 31, 32, 33, 63, 64, 65, 130)
HEADS = (4, 20, 128)
CASES = ([(s, HEADS[i % 3], torch.float32) for i, s in enumerate(SEQS)]
         + [(s, h, torch.bfloat16) for s, h in ((1, 20), (33, 128), (65, 4), (130, 20))])
BANDS = 4           # divides 2 H for every H of the cases


def _inputs(rng, b, s, h, dl=64, dr=32):
    return tuple((rng.standard_normal(sh) * 0.3).astype(np.float32)
                 for sh in ((b, s, h, dl), (b, s, h, dr), (b, s, dl), (b, s, dr), (b, s, h, dl)))


def _jax_bwd(x, out, lse, g, sm_scale):
    """JAX's K14b / K14c (``_flash_bwd`` in interpret mode, chunks by
    ``mla_flash_train``'s rules at q_chunk 32, k_chunk 64) on the residuals
    ``(q_lat, q_pe, k_lat, k_pe, out, lse)``, the LSE ``[B, S, H]`` laid out as
    JAX's forward saves it (``[B, padded rows, 128]``) → (dq_lat, dq_pe,
    dk_lat, dk_pe)."""
    b, s, h, _ = x[0].shape
    cq = min(32, max(8, s))
    ck = -(-max(64, cq) // cq) * cq
    rows = -(-s // ck) * ck * h
    lse_j = np.zeros((b, rows, 128), np.float32)
    lse_j[:, :s * h] = lse.reshape(b, s * h, 1)
    bwd = jax.jit(functools.partial(jmt._flash_bwd, sm_scale, cq, ck, ck, True))
    return bwd((*x, out, jx(lse_j)), g)


def _close(got, want, tol):
    got, want = np32(got), np32(want)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()) + 1e-6, err


@pytest.mark.parametrize("s,h,dtype", CASES)
def test_tiled_walks_match_jax(rng, s, h, dtype):
    b = 2
    x = [tt(a, dtype) for a in _inputs(rng, b, s, h)]
    out, lse = tmt.mla_flash_fwd_plain(*x[:4], SC)
    delta = (x[4].float() * out.float()).sum(-1)
    args = (*x, lse, delta, SC)
    got = (*tmt.mla_flash_bwd_dq_tiled_plain(*args),
           *tmt.mla_flash_bwd_dk_tiled_plain(*args, BANDS))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _jax_bwd(tuple(jx(np32(a), jdt) for a in x[:4]), jx(np32(out), jdt), np32(lse),
                    jx(np32(x[4])), SC)
    for a, w in zip(got, want):
        assert a.dtype == dtype
        _close(a, w, 1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("s,h,sms,dtype", [
    (65, 20, 132, torch.float32), (65, 20, 132, torch.bfloat16), (64, 128, 132, torch.float32),
    (130, 20, 132, torch.bfloat16), (33, 4, 2, torch.float32), (33, 4, 2, torch.bfloat16)])
def test_tiled_walks_match_plain(rng, s, h, sms, dtype):
    """At the kernel's widths (latent 512, rope 64) against the port's plain
    versions, which take the whole score matrix at once; K14c at the bands
    the wrapper picks for an H100's 132 SMs (one tile a band at these sizes)
    or for 2 (wider bands)."""
    x = [tt(a, dtype) for a in _inputs(rng, 2, s, h, 512, 64)]
    q_lat, q_pe, k_lat, k_pe, do = x
    out, lse = tmt.mla_flash_fwd_plain(q_lat, q_pe, k_lat, k_pe, SC)
    delta = (do.float() * out.float()).sum(-1)
    args = (q_lat, q_pe, k_lat, k_pe, do, lse, delta, SC)
    got = (*tmt.mla_flash_bwd_dq_tiled_plain(*args),
           *tmt.mla_flash_bwd_dk_tiled_plain(*args, tmt.dk_bands(2, s, h, sms)))
    want = (*tmt.mla_flash_bwd_dq_plain(*args), *tmt.mla_flash_bwd_dk_plain(*args))
    for a, w in zip(got, want):
        _close(a, w, 1e-5 if dtype == torch.float32 else 2e-2)


def test_dk_partition():
    """K14c's items: a batch row's tiles of 32 flat rows cut into bands of 2 H
    / u tiles, band j seen by chunks 0 .. j // u (every chunk starts on a
    band's edge); the wrapper's u is the fewest bands giving 4 items an SM.
    Other bands only regroup the f32 partials: the same dK to f32 rounding."""
    for s, h in ((520, 128), (4096, 128), (65, 20), (1, 4), (33, 3)):
        ts = -(-s * h // 32)
        for u in (d for d in range(1, 2 * h + 1) if 2 * h % d == 0):
            band = 2 * h // u
            items = [(j, c) for j in range(-(-ts // band)) for c in range(-(-s // 64))
                     if 2 * h * c < (j + 1) * band]
            assert tmt.dk_items(s, h, u) == len(items)
            assert all(2 * h * c <= j * band for j, c in items)   # whole bands
    assert tmt.dk_bands(2, 520, 128, 132) == 8                # 594 items, 4.5 waves
    assert tmt.dk_bands(1, 4096, 128, 132) == 1               # 2080 items
    assert tmt.dk_bands(1, 1, 4, 132) == 8                    # one tile a band
    g = torch.Generator().manual_seed(0)
    x = [torch.randn(sh, generator=g) for sh in ((2, 65, 20, 64), (2, 65, 20, 32), (2, 65, 64),
                                                 (2, 65, 32), (2, 65, 20, 64))]
    out, lse = tmt.mla_flash_fwd_plain(*x[:4], SC)
    args = (*x, lse, (x[4] * out).sum(-1), SC)
    one = tmt.mla_flash_bwd_dk_tiled_plain(*args, 1)
    for u in (2, 5, 40):
        for a, w in zip(tmt.mla_flash_bwd_dk_tiled_plain(*args, u), one):
            _close(a, w, 1e-6)
    with pytest.raises(ValueError, match="divisor"):
        tmt.mla_flash_bwd_dk_tiled_plain(*args, 3)
