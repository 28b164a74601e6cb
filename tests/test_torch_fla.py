"""Port parity: the gated delta rule (``ops/fla``: chunked and recurrent,
gating, the gated norm, ``l2norm``) and ``ops/tri_inv`` against the JAX
package on the same numpy inputs.

Tolerances: f32 within 2e-5 of the largest value where both sides run the
same algorithm in another summation order (1e-4 for the chunked rule, whose
inverse and state carry compound the order's error; 2e-3 against the numpy
goldens, as JAX's own tests hold its kernels); bf16 inputs within 2e-2;
the pool rows an index of -1 names stay bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops import tri_inv as jtri
from sgl_kernel_npu_tpu.ops.fla import chunk as jchunk
from sgl_kernel_npu_tpu.ops.fla import gating as jgating
from sgl_kernel_npu_tpu.ops.fla import norms as jnorms
from sgl_kernel_npu_tpu.ops.fla import recurrent as jrec
from sgl_kernel_npu_tpu_torch.ops import tri_inv as ttri
from sgl_kernel_npu_tpu_torch.ops.fla import chunk as tchunk
from sgl_kernel_npu_tpu_torch.ops.fla import gating as tgating
from sgl_kernel_npu_tpu_torch.ops.fla import norms as tnorms
from sgl_kernel_npu_tpu_torch.ops.fla import recurrent as trec


def _close(got, want, rel):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=rel * np.abs(want).max())


def _gdn_inputs(rng, b, t, h, hv, kd, vd):
    q = rng.standard_normal((b, t, h, kd)).astype(np.float32)
    k = rng.standard_normal((b, t, h, kd)).astype(np.float32)
    v = rng.standard_normal((b, t, hv, vd)).astype(np.float32) * 0.5
    g = -np.abs(rng.standard_normal((b, t, hv))).astype(np.float32) * 0.2
    beta = rng.random((b, t, hv)).astype(np.float32)
    return q, k, v, g, beta


@pytest.mark.parametrize("t,gqa,init,l2", [
    (64, False, False, True), (50, True, False, True), (37, True, True, True),
    (32, False, True, False)])
def test_chunk_gdn(t, gqa, init, l2):
    """The chunked rule against JAX's and both goldens (JAX's numpy loop and
    the port's copy of it): a length off the chunk, GQA, an initial state."""
    rng = np.random.default_rng(t)
    b, h, kd, vd = 2, 2, 32, 16
    hv = 2 * h if gqa else h
    arrs = _gdn_inputs(rng, b, t, h, hv, kd, vd)
    s0 = (rng.standard_normal((b, hv, kd, vd)).astype(np.float32) * 0.3) if init else None
    kw = dict(chunk_size=16, use_qk_l2norm_in_kernel=l2)
    o_j, s_j = jchunk.chunk_gated_delta_rule(*map(jx, arrs), initial_state=None if s0 is None
                                             else jx(s0), **kw)
    o_t, s_t = tchunk.chunk_gated_delta_rule(*map(tt, arrs), initial_state=None if s0 is None
                                             else tt(s0), **kw)
    _close(o_t, o_j, 1e-4)
    _close(s_t, s_j, 1e-4)
    o_r, s_r = jchunk.chunk_gated_delta_rule_ref(*arrs, initial_state=s0, **kw)
    o_rt, s_rt = tchunk.chunk_gated_delta_rule_ref(*map(tt, arrs), initial_state=None
                                                   if s0 is None else tt(s0), **kw)
    _close(o_rt, o_r, 1e-6)
    _close(s_rt, s_r, 1e-6)
    _close(o_t, o_r, 2e-3)
    _close(s_t, s_r, 2e-3)


def test_chunk_gdn_bf16_and_no_final_state():
    """bf16 q / k / v (l2norm and the scale round in bf16, as JAX's), and
    ``output_final_state=False``."""
    rng = np.random.default_rng(3)
    arrs = _gdn_inputs(rng, 1, 40, 2, 4, 32, 32)
    cast = (jnp.bfloat16, jnp.bfloat16, jnp.bfloat16, None, None)
    tcast = (torch.bfloat16, torch.bfloat16, torch.bfloat16, None, None)
    o_j, _ = jchunk.chunk_gated_delta_rule(*(jx(a, d) for a, d in zip(arrs, cast)),
                                           chunk_size=16, use_qk_l2norm_in_kernel=True)
    o_t, s_t = tchunk.chunk_gated_delta_rule(*(tt(a, d) for a, d in zip(arrs, tcast)),
                                             chunk_size=16, use_qk_l2norm_in_kernel=True,
                                             output_final_state=False)
    assert o_t.dtype == torch.bfloat16 and s_t is None
    _close(o_t, o_j, 2e-2)


def test_chunk_gdn_varlen():
    """Packed sequences of 5, 16, 1 and 22 tokens (boundaries inside
    chunks) against JAX's varlen and against each sequence run alone, within
    2e-2: the reset adds -1e4 to g, and the decays' differences of cumulative
    sums near -1e4 keep about 1e-3 of f32's precision, in JAX's algorithm
    as in the port's, so two summation orders differ at that level."""
    rng = np.random.default_rng(7)
    lens = [5, 16, 1, 22]
    q, k, v, g, beta = (a[0] for a in _gdn_inputs(rng, 1, sum(lens), 2, 4, 16, 16))
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    kw = dict(chunk_size=16, use_qk_l2norm_in_kernel=True)
    o_j, _ = jchunk.chunk_gated_delta_rule_varlen(*map(jx, (q, k, v, g, beta)), jx(cu), **kw)
    o_t, none = tchunk.chunk_gated_delta_rule_varlen(*map(tt, (q, k, v, g, beta)), tt(cu), **kw)
    assert none is None
    _close(o_t, o_j, 2e-2)
    for lo, hi in zip(cu[:-1], cu[1:]):
        alone, _ = tchunk.chunk_gated_delta_rule(*(tt(a[None, lo:hi]) for a in (q, k, v, g, beta)),
                                                 **kw)
        _close(o_t[lo:hi], alone[0], 2e-2)


def test_recurrent_update():
    """The recurrent update against JAX's over a pool with a -1 row (zero
    state, nothing written) and two tokens a row (MTP), then against the
    chunked rule on the same tokens."""
    rng = np.random.default_rng(11)
    b, t, h, hv, kd, vd, pool_n = 3, 2, 2, 4, 16, 16, 5
    q, k, v, _, _ = _gdn_inputs(rng, b, t, h, hv, kd, vd)
    A_log = rng.uniform(-2, 0, hv).astype(np.float32)
    a = rng.standard_normal((b, t, hv)).astype(np.float32)
    dt_bias = (rng.standard_normal(hv) * 0.1).astype(np.float32)
    bg = rng.standard_normal((b, t, hv)).astype(np.float32)
    pool = rng.standard_normal((pool_n, hv, kd, vd)).astype(np.float32) * 0.2
    idx = np.array([3, -1, 0], np.int32)
    args = (A_log, a, dt_bias, q, k, v, bg)
    o_j, pool_j = jrec.fused_sigmoid_gating_delta_rule_update(*map(jx, args), jx(pool), jx(idx))
    pool_t = tt(pool)
    o_t, ret = trec.fused_sigmoid_gating_delta_rule_update(*map(tt, args), pool_t, tt(idx))
    assert ret is pool_t                                  # updated in place
    _close(o_t, o_j, 2e-5)
    _close(pool_t, pool_j, 2e-5)
    untouched = [1, 2, 4]
    np.testing.assert_array_equal(np32(pool_t)[untouched], pool[untouched])
    # against the chunked rule from the same initial states
    g, beta = tgating.fused_gdn_gating(tt(A_log), tt(a), tt(bg), tt(dt_bias))
    s0 = tt(np.stack([pool[3], np.zeros_like(pool[0]), pool[0]]))
    o_c, s_c = tchunk.chunk_gated_delta_rule(tt(q), tt(k), tt(v), g, beta, chunk_size=16,
                                             initial_state=s0, use_qk_l2norm_in_kernel=True)
    _close(o_t, o_c, 2e-5)
    _close(pool_t[[3, 0]], s_c[[0, 2]], 2e-5)


def test_gating_and_norms():
    """``fused_gdn_gating`` (across softplus's threshold), ``layernorm_gated``
    in both gate orders, RMS and layer norm, with and without a bias, f32
    and bf16, and ``l2norm``."""
    rng = np.random.default_rng(5)
    A_log = rng.uniform(-2, 0, 8).astype(np.float32)
    a = (rng.standard_normal((3, 5, 8)) * 15).astype(np.float32)
    b = rng.standard_normal((3, 5, 8)).astype(np.float32)
    dt = rng.standard_normal(8).astype(np.float32)
    g_j, be_j = jgating.fused_gdn_gating(jx(A_log), jx(a), jx(b), jx(dt))
    g_t, be_t = tgating.fused_gdn_gating(tt(A_log), tt(a), tt(b), tt(dt))
    assert g_t.dtype == be_t.dtype == torch.float32
    _close(g_t, g_j, 2e-6)
    _close(be_t, be_j, 2e-6)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    z = rng.standard_normal((6, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    for jdt, tdt, tol in ((None, None, 2e-6), (jnp.bfloat16, torch.bfloat16, 2e-2)):
        for before in (True, False):
            for rms in (True, False):
                for bb in (None, bias):
                    kw = dict(eps=1e-6, group_size=16, norm_before_gate=before, is_rms_norm=rms)
                    want = jnorms.layernorm_gated(jx(x, jdt), jx(w), None if bb is None
                                                  else jx(bb), jx(z, jdt), **kw)
                    got = tnorms.layernorm_gated(tt(x, tdt), tt(w), None if bb is None
                                                 else tt(bb), tt(z, tdt), **kw)
                    _close(got, want, tol)
        _close(tchunk.l2norm(tt(x, tdt)), jchunk.l2norm(jx(x, jdt)), tol)
    _close(tnorms.layernorm_gated(tt(x), tt(w)), jnorms.layernorm_gated(jx(x), jx(w)), 2e-6)


@pytest.mark.parametrize("c", [16, 64])
def test_triangular_inverse(c):
    """``triangular_inverse`` (nilpotent squaring, f32) and its column-sweep
    golden against JAX's, batched, and the product with L the identity."""
    rng = np.random.default_rng(c)
    l = np.tril(rng.standard_normal((3, c, c)) * 0.1, -1).astype(np.float32) + np.eye(
        c, dtype=np.float32)
    got = ttri.triangular_inverse(tt(l))
    _close(got, jtri.triangular_inverse(jx(l)), 1e-5)
    _close(ttri.triangular_inverse_ref(tt(l)), jtri.triangular_inverse_ref(jx(l)), 1e-6)
    np.testing.assert_allclose(np32(got @ tt(l)), np.broadcast_to(np.eye(c), (3, c, c)),
                               atol=1e-4)
    a = np.tril(rng.standard_normal((2, c, c)) * 0.1, -1).astype(np.float32)
    _close(tchunk.tril_nilpotent_inverse(tt(a)), jchunk.tril_nilpotent_inverse(jx(a)), 1e-5)
