"""Port parity: the MLA flash attention for training (K14a / K14b / K14c)
against the JAX package's, on the port's plain path.

The same numpy inputs go to JAX ``mla_flash_train`` (its Pallas kernels in
interpret mode, as ``tests/test_mla_train.py`` runs them) and to the port's
``mla_flash_train`` on CPU tensors.  Tolerances are JAX's own: the f32
forward 2e-5 absolute, f32 gradients 1e-4 of the largest |g| (the port sums
the whole score row at once where JAX walks chunks), bf16 3e-2 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops.attention import mla_train as jmt
from sgl_kernel_npu_tpu_torch.ops.attention import mla_train as tmt

SC = 0.13


def _inputs(rng, b, s, h, dl, dr):
    return tuple((rng.standard_normal(sh) * 0.3).astype(np.float32)
                 for sh in ((b, s, h, dl), (b, s, h, dr), (b, s, dl), (b, s, dr)))


def _rel(a, b):
    a, b = np32(a), np32(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-6)


@pytest.mark.parametrize("s,cq,ck", [(40, 16, 32), (64, 16, 16), (96, 32, 32)])
def test_forward_matches_jax(rng, s, cq, ck):
    x = _inputs(rng, 2, s, 4, 64, 32)
    want = jmt.mla_flash_train(*map(jx, x), SC, q_chunk=cq, k_chunk=ck)
    got = tmt.mla_flash_train(*map(tt, x), SC)
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-5)


def test_ref_matches_jax(rng):
    x = _inputs(rng, 2, 24, 4, 64, 32)
    np.testing.assert_allclose(np32(tmt.mla_train_ref(*map(tt, x), SC)),
                               np32(jmt.mla_train_ref(*map(jx, x), SC)), atol=1e-5)


def test_grads_match_jax(rng):
    """Gradients of sum(sin(out)) for all four inputs: the port's Function
    (plain K14b / K14c) against JAX's custom_vjp (Pallas interpret)."""
    x = _inputs(rng, 2, 40, 4, 64, 32)
    flash = lambda *a: jnp.sum(jnp.sin(jmt.mla_flash_train(*a, SC, q_chunk=16, k_chunk=32)))
    want = jax.grad(flash, argnums=(0, 1, 2, 3))(*map(jx, x))
    leaves = [tt(a).requires_grad_() for a in x]
    torch.sin(tmt.mla_flash_train(*leaves, SC)).sum().backward()
    for t, w in zip(leaves, want):
        assert _rel(t.grad, w) < 1e-4


def test_function_backward_matches_autograd_of_ref(rng):
    """The hand-written backward (K14b / K14c's plain versions behind the
    autograd Function) against autograd through the golden ``mla_train_ref``,
    in f32: 1e-4 of the largest |g|."""
    x = _inputs(rng, 1, 33, 3, 64, 32)
    go = torch.from_numpy(rng.standard_normal((1, 33, 3, 64)).astype(np.float32))
    grads = []
    for fn in (lambda *a: tmt.mla_flash_train(*a, SC), lambda *a: tmt.mla_train_ref(*a, SC)):
        leaves = [tt(a).requires_grad_() for a in x]
        (fn(*leaves) * go).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) < 1e-4


def test_bf16_long_sequence(rng):
    x = _inputs(rng, 1, 200, 2, 64, 32)
    want = jmt.mla_flash_train(*(jx(a, jnp.bfloat16) for a in x), 0.1, q_chunk=32, k_chunk=64)
    got = tmt.mla_flash_train(*(tt(a, torch.bfloat16) for a in x), 0.1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), atol=3e-2)


def test_plain_lse_and_backward_pieces(rng):
    """K14a's plain LSE is the row's log-sum-exp of the scaled causal scores;
    K14b / K14c's plain versions with delta = rowsum(dO o O) give autograd's
    gradients of the golden attention (f32, 1e-4)."""
    x = [tt(a) for a in _inputs(rng, 2, 17, 4, 64, 32)]
    out, lse = tmt.mla_flash_fwd_plain(*x, SC)
    s = torch.einsum("bqhl,bkl->bhqk", x[0], x[2]) + torch.einsum("bqhr,bkr->bhqk", x[1], x[3])
    s = torch.where(torch.tril(torch.ones(17, 17, dtype=torch.bool)), s * SC, -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).permute(0, 2, 1), atol=1e-5,
                               rtol=1e-5)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    delta = (do * out).sum(-1)
    dq = tmt.mla_flash_bwd_dq_plain(*x, do, lse, delta, SC)
    dk = tmt.mla_flash_bwd_dk_plain(*x, do, lse, delta, SC)
    leaves = [t.clone().requires_grad_() for t in x]
    (tmt.mla_train_ref(*leaves, SC) * do).sum().backward()
    for got, t in zip((*dq, *dk), leaves):
        assert _rel(got, t.grad) < 1e-4


def test_kernel_checks_refuse_what_the_kernels_do_not_take():
    """The wrappers' checks, on CPU tensors (no launch): f32, other widths and
    non-contiguous tensors raise ``ValueError`` naming ROADMAP §C."""
    def ops(dt=torch.bfloat16, dl=512, dr=64, h=4):
        return (torch.zeros((1, 8, h, dl), dtype=dt), torch.zeros((1, 8, h, dr), dtype=dt),
                torch.zeros((1, 8, dl), dtype=dt), torch.zeros((1, 8, dr), dtype=dt))

    tmt.check_train_operands(*ops())
    with pytest.raises(ValueError, match="ROADMAP"):
        tmt.check_train_operands(*ops(torch.float32))
    for kw in (dict(dl=128), dict(dr=32)):
        with pytest.raises(ValueError, match="ROADMAP"):
            tmt.check_train_operands(*ops(**kw))
    q_lat, q_pe, k_lat, k_pe = ops()
    with pytest.raises(ValueError, match="ROADMAP"):     # dO of another width
        tmt.check_train_operands(q_lat, q_pe, k_lat, k_pe, torch.zeros((1, 8, 4, 64),
                                                                      dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="f32"):         # bf16 statistics
        tmt.check_train_operands(q_lat, q_pe, k_lat, k_pe, torch.zeros_like(q_lat),
                                 torch.zeros((1, 8, 4), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        tmt.check_train_operands(q_lat.transpose(1, 2).contiguous().transpose(1, 2), q_pe,
                                 k_lat, k_pe)
    assert tmt.dk_bands(2, 520, 128, 132) == 8 and tmt.dk_items(520, 128, 8) == 297
    assert tmt.dk_bands(1, 1, 4, 132) == 8 and tmt.dk_items(1, 4, 8) == 1
