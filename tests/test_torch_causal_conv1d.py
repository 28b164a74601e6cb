"""Port parity: ``ops/mamba/causal_conv1d`` (the prefill conv with initial
and final states, the decode update over a state pool with pad slots and
the MTP windows) against the JAX package on the same numpy inputs.

Tolerances: f32 within 1e-6 of the largest value (the same W
multiply-adds in the same order), bf16 within 2e-2; pool rows that no
live index names stay bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops.mamba import causal_conv1d as jc
from sgl_kernel_npu_tpu_torch.ops.mamba import causal_conv1d as tc


def _close(got, want, rel):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("init,bias,act", [(False, True, "silu"), (True, False, None),
                                           (True, True, "swish")])
def test_conv_fn(dt, init, bias, act):
    jdt, tdt, tol = (None, None, 1e-6) if dt == "f32" else (jnp.bfloat16, torch.bfloat16, 2e-2)
    rng = np.random.default_rng(1)
    b, d, t, w = 2, 24, 9, 4
    x = rng.standard_normal((b, d, t)).astype(np.float32)
    wt = rng.standard_normal((d, w)).astype(np.float32)
    bs = rng.standard_normal(d).astype(np.float32) if bias else None
    s0 = rng.standard_normal((b, d, w - 1)).astype(np.float32) if init else None
    kw = dict(return_final_states=True, activation=act)
    o_j, f_j = jc.causal_conv1d_fn(jx(x, jdt), jx(wt), None if bs is None else jx(bs),
                                   None if s0 is None else jx(s0), **kw)
    o_t, f_t = tc.causal_conv1d_fn(tt(x, tdt), tt(wt), None if bs is None else tt(bs),
                                   None if s0 is None else tt(s0), **kw)
    assert o_t.dtype == f_t.dtype == (tdt or torch.float32)
    _close(o_t, o_j, tol)
    _close(f_t, f_j, tol)
    plain = tc.causal_conv1d_fn(tt(x), tt(wt), activation=act)
    _close(plain, jc.causal_conv1d_fn(jx(x), jx(wt), activation=act), 1e-6)


@pytest.mark.parametrize("s", [1, 3])
def test_conv_update_pool(s):
    """``[B, D]`` (s 1, squeezed) and ``[B, D, S]`` rows over a pool with a
    pad slot: outputs equal JAX's, the pool updated in place, the pad row's
    and the unnamed rows untouched."""
    rng = np.random.default_rng(s)
    b, d, w, pool_n = 3, 16, 4, 5
    x = rng.standard_normal((b, d) if s == 1 else (b, d, s)).astype(np.float32)
    pool = rng.standard_normal((pool_n, d, w - 1)).astype(np.float32)
    wt = rng.standard_normal((d, w)).astype(np.float32)
    bs = rng.standard_normal(d).astype(np.float32)
    idx = np.array([4, tc.PAD_SLOT_ID, 1], np.int32)
    o_j, p_j = jc.causal_conv1d_update(jx(x), jx(pool), jx(wt), jx(bs), "silu",
                                       conv_state_indices=jx(idx))
    p_t = tt(pool)
    o_t, ret = tc.causal_conv1d_update(tt(x), p_t, tt(wt), tt(bs), "silu",
                                       conv_state_indices=tt(idx))
    assert ret is p_t and o_t.shape == tuple(o_j.shape)
    _close(o_t, o_j, 1e-6)
    _close(p_t, p_j, 1e-6)
    np.testing.assert_array_equal(np32(p_t)[[0, 2, 3]], pool[[0, 2, 3]])
    # no indices: row i is slot i
    p2 = tt(pool)
    o2, _ = tc.causal_conv1d_update(tt(x), p2, tt(wt))
    o2j, p2j = jc.causal_conv1d_update(jx(x), jx(pool), jx(wt))
    _close(o2, o2j, 1e-6)
    _close(p2, p2j, 1e-6)


@pytest.mark.parametrize("s,s_prev", [(2, 3), (3, 3)])
def test_conv_update_mtp_windows(s, s_prev):
    """MTP: resume from the window of the last accepted draft token
    (``num_accepted_tokens``) and record a window a token (zeros past S),
    a pad row among them, bf16 pools."""
    rng = np.random.default_rng(10 + s)
    b, d, w, pool_n = 3, 8, 4, 4
    x = rng.standard_normal((b, d, s)).astype(np.float32)
    pool = rng.standard_normal((pool_n, d, w - 1)).astype(np.float32)
    win = rng.standard_normal((pool_n, s_prev, d, w - 1)).astype(np.float32)
    wt = rng.standard_normal((d, w)).astype(np.float32)
    idx = np.array([2, 0, tc.PAD_SLOT_ID], np.int32)
    acc = np.array([2, 1, 3], np.int32)
    o_j, p_j, w_j = jc.causal_conv1d_update(
        jx(x), jx(pool, jnp.bfloat16), jx(wt), None, "silu", conv_state_indices=jx(idx),
        num_accepted_tokens=jx(acc), intermediate_conv_window=jx(win, jnp.bfloat16))
    p_t, w_t = tt(pool, torch.bfloat16), tt(win, torch.bfloat16)
    o_t, p_r, w_r = tc.causal_conv1d_update(
        tt(x), p_t, tt(wt), None, "silu", conv_state_indices=tt(idx),
        num_accepted_tokens=tt(acc), intermediate_conv_window=w_t)
    assert p_r is p_t and w_r is w_t
    _close(o_t, o_j, 1e-6)
    np.testing.assert_array_equal(np32(p_t), np32(p_j))
    np.testing.assert_array_equal(np32(w_t), np32(w_j))
