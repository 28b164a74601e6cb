"""Port parity: varlen causal MLA prefill (K9 ``mla_prefill_pallas``).

The JAX kernel runs in Pallas interpret mode; the port takes its plain path on
CPU tensors.  f32 throughout; tolerance 2e-2 as tests/test_decode_attention.py
(the JAX kernel's MXU dots at default precision)."""

import numpy as np

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops.attention import decode_attention as jda
from sgl_kernel_npu_tpu.ops.attention import mla_prefill as jmp
from sgl_kernel_npu_tpu_torch.ops.attention import decode_attention as tda
from sgl_kernel_npu_tpu_torch.ops.attention import mla_prefill as tmp


def _caches(rng, n_pages, page, dn=128, dr=64):
    kn = (rng.standard_normal((n_pages, 1, page, dn)) * 0.5).astype(np.float32)
    kr = (rng.standard_normal((n_pages, 1, dr, page)) * 0.5).astype(np.float32)
    return kn, kr


def test_mla_prefill_matches_jax():
    """Mirror of tests/test_decode_attention.py::test_mla_prefill_pallas_matches_golden,
    plus two packed pad rows past the requests (they must come out as zeros)."""
    rng = np.random.default_rng(42)
    h, dn, dr, page, max_pages, bsz = 8, 128, 64, 16, 4, 3
    kn, kr = _caches(rng, bsz * max_pages, page, dn, dr)
    bt = rng.permutation(bsz * max_pages).reshape(bsz, max_pages).astype(np.int32)
    ctx = np.asarray([40, 25, 64], np.int32)
    seq = np.asarray([3, 25, 10], np.int32)
    s = int(seq.sum()) + 2
    q = (rng.standard_normal((s, h, dn + dr)) * 0.5).astype(np.float32)
    scale = 1 / np.sqrt(dn + dr)
    want = np32(jmp.mla_prefill_pallas(jx(q), jx(kn), jx(kr), jx(seq), jx(bt), jx(ctx),
                                       scale, max_q=32, q_chunk=16))
    got = np32(tmp.mla_prefill_pallas(tt(q), tt(kn), tt(kr), tt(seq), tt(bt), tt(ctx),
                                      scale, max_q=32))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    assert np.all(got[-2:] == 0)


def test_mla_prefill_lastrow_matches_decode():
    """Mirror of tests/test_decode_attention.py::test_mla_prefill_lastrow_matches_decode:
    the last prefill row of each request equals decode at the same context,
    in the port and against JAX's decode kernel."""
    rng = np.random.default_rng(42)
    h, dn, dr, page, max_pages, bsz = 8, 128, 64, 16, 4, 2
    kn, kr = _caches(rng, bsz * max_pages, page, dn, dr)
    bt = rng.permutation(bsz * max_pages).reshape(bsz, max_pages).astype(np.int32)
    ctx = np.asarray([40, 25], np.int32)
    seq = np.asarray([4, 6], np.int32)
    q = (rng.standard_normal((int(seq.sum()), h, dn + dr)) * 0.5).astype(np.float32)
    scale = 1 / np.sqrt(dn + dr)
    out = np32(tmp.mla_prefill_pallas(tt(q), tt(kn), tt(kr), tt(seq), tt(bt), tt(ctx),
                                      scale, max_q=8))[[3, 9]]
    dec_t = np32(tda.decode_mla(tt(q[[3, 9]]), tt(kn), tt(kr), tt(ctx), scale, tt(bt)))
    dec_j = np32(jda.decode_mla(jx(q[[3, 9]]), jx(kn), jx(kr), jx(ctx), scale, jx(bt)))
    np.testing.assert_allclose(out, dec_t, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, dec_j, rtol=2e-2, atol=2e-2)


def test_prefill_page_bounds_matches_jax():
    from sgl_kernel_npu_tpu.ops.attention.sinks_attention import _prefill_page_bounds as jb
    from sgl_kernel_npu_tpu_torch.ops.attention.sinks_attention import (
        _prefill_page_bounds as tb,
    )

    for seq, ctx, qc, cq, window in [(3, 40, 0, 16, 0), (25, 25, 1, 16, 0),
                                     (10, 64, 0, 8, 0), (64, 200, 3, 16, 32),
                                     (1, 1, 0, 8, 0)]:
        kw = dict(cq=cq, window=window, page_size=16, max_pages=16)
        want = tuple(int(v) for v in jb(seq, ctx, qc, **kw))
        assert tb(seq, ctx, qc, **kw) == want
