"""Port parity: paged MLA decode attention (K2 ``decode_mla``).

The JAX kernel runs in Pallas interpret mode; the port takes its plain path on
CPU tensors.  Tolerance 3e-2 (as tests/test_decode_attention.py): bf16 inputs
and output, and the JAX kernel multiplies probabilities by V in bf16 while the
port keeps f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops.attention import decode_attention as jda
from sgl_kernel_npu_tpu_torch.ops.attention import decode_attention as tda


def _case(rng, b, hq, d_nope, d_rope, page, max_pages, seq_lens, pad_rows=0):
    n_pages = b * max_pages + 1
    q = (rng.standard_normal((b + pad_rows, hq, d_nope + d_rope)) * 0.5).astype(np.float32)
    kn = (rng.standard_normal((n_pages, 1, page, d_nope)) * 0.5).astype(np.float32)
    kr = (rng.standard_normal((n_pages, 1, d_rope, page)) * 0.5).astype(np.float32)
    bt = (rng.permutation(n_pages - 1)[: b * max_pages].reshape(b, max_pages) + 1)
    # pad rows as the engine sends them: context 1, block table of zeros
    bt = np.concatenate([bt, np.zeros((pad_rows, max_pages), int)]).astype(np.int32)
    ctx = np.asarray(list(seq_lens) + [1] * pad_rows, np.int32)
    return q, kn, kr, bt, ctx


def _both(q, kn, kr, bt, ctx, sm_scale):
    want = jda.decode_mla(jx(q, jnp.bfloat16), jx(kn, jnp.bfloat16), jx(kr, jnp.bfloat16),
                          jx(ctx), sm_scale, jx(bt))
    got = tda.decode_mla(tt(q, torch.bfloat16), tt(kn, torch.bfloat16),
                         tt(kr, torch.bfloat16), tt(ctx), sm_scale, tt(bt))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
    return np32(got), np32(want)


@pytest.mark.parametrize("hq,d_nope,d_rope", [(16, 128, 64), (8, 512, 64)])
def test_decode_mla_matches_jax(hq, d_nope, d_rope):
    """Mirror of tests/test_decode_attention.py::test_decode_mla."""
    rng = np.random.default_rng(42)
    case = _case(rng, 3, hq, d_nope, d_rope, 32, 4, [1, 40, 128])
    got, want = _both(*case, 1.0 / np.sqrt(d_nope + d_rope))
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("page", [4, 16])
def test_decode_mla_small_pages_len1_and_pad_rows(page):
    """Page 4 / 16, a length-1 sequence, and two engine pad rows."""
    rng = np.random.default_rng(page)
    case = _case(rng, 3, 8, 512, 64, page, 6, [1, 2 * page + 3, 6 * page], pad_rows=2)
    got, want = _both(*case, 1.0 / np.sqrt(576))
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)
    # a pad row attends to key 0 of page 0 alone: it returns that latent row
    np.testing.assert_allclose(got[-1], np.broadcast_to(
        np32(tt(case[1], torch.bfloat16))[0, 0, 0], got[-1].shape), atol=1e-2)


def test_decode_mla_int8_cache_not_ported():
    """The int8 latent cache, once left to the JAX package, now runs: levels
    ``round(k / k_scale)`` with ``k_scale`` give the JAX kernel's output (the
    name is kept from the slice that refused it)."""
    rng = np.random.default_rng(7)
    q, kn, kr, bt, ctx = _case(rng, 2, 8, 512, 64, 16, 3, [9, 40], pad_rows=1)
    kn8 = np.clip(np.round(kn / (1 / 32)), -128, 127).astype(np.int8)
    want = jda.decode_mla(jx(q, jnp.bfloat16), jx(kn8), jx(kr, jnp.bfloat16), jx(ctx),
                          576 ** -0.5, jx(bt), k_scale=1 / 32)
    got = tda.decode_mla(tt(q, torch.bfloat16), tt(kn8), tt(kr, torch.bfloat16), tt(ctx),
                         576 ** -0.5, tt(bt), k_scale=1 / 32)
    np.testing.assert_allclose(np32(got), np32(want), atol=3e-2, rtol=3e-2)
