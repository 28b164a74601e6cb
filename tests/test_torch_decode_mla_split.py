"""Port parity: the split design of K2, the paged MLA decode kernel
(``csrc/decode_mla.cu``), in plain PyTorch.

The kernel cuts each row's keys into splits of ``split`` keys, walks each in
a block of its own (``mla_sparse.cuh``'s 64-row body) and merges the splits'
(m, l, O) in split order; an int8 latent's ``k_scale`` is folded into q_nope
as Q lands and into the output.  On the CPU two pieces of the port stand for
it: ``decode_attention.mla_split_size`` / ``split_plan`` (the split size from
shapes alone, each row's splits without a host sync) and
``decode_mla_split_plain`` (the kernel's algorithm: per split (m, l, o) with
P rounded to q's dtype for P V and the denominator over the rounded P, the
merge in split order, the fold's two roundings).  The mirror is held to JAX's
``decode_mla`` (in interpret mode, as ``tests/test_torch_decode_mla.py`` runs
it) and ``decode_mla_block_sparse`` (DSA page mode), and to the port's
``decode_mla_ref``, at split sizes 16, 32 and 64 so that the cases cross
several splits.

Cases: contexts 1, a page, a split and one more (16, 17, 32, 33, 64, 65) on a
table of 80 keys; two engine pad rows (context 1, a table of zeros); pages 4
and 16; bf16 and f32; int8 levels with a ``k_scale``; a DSA pruned table
(``pruned_block_table`` of ``select_decode_pages``).  Tolerance 3e-2 as
``test_torch_decode_mla.py`` (bf16 inputs and output; JAX multiplies the
probabilities by V in bf16, the reference keeps f32); f32 within 1e-5 of
the output's largest value against the reference (P is not rounded in
f32)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops.attention import decode_attention as jda
from sgl_kernel_npu_tpu_torch.ops.attention import decode_attention as tda

HQ, TABLE_KEYS = 8, 80
SPLITS = (16, 32, 64)
CTX = [1, 4, 16, 17, 32, 33, 64, 65, 80]
SM_SCALE = 576 ** -0.5
KS = 1 / 32                               # the int8 levels' k_scale


@functools.lru_cache(maxsize=None)
def _case(page, seed=0):
    """numpy q (two pad rows last), latent and rope caches of permuted pages,
    a block table a row (zeros for the pad rows), the contexts."""
    rng = np.random.default_rng(seed + page)
    max_pages = TABLE_KEYS // page
    b = len(CTX)
    n_pages = b * max_pages + 1
    q = (rng.standard_normal((b + 2, HQ, 576)) * 0.5).astype(np.float32)
    kn = (rng.standard_normal((n_pages, 1, page, 512)) * 0.5).astype(np.float32)
    kr = (rng.standard_normal((n_pages, 1, 64, page)) * 0.5).astype(np.float32)
    bt = np.zeros((b + 2, max_pages), np.int32)
    bt[:b] = (rng.permutation(n_pages - 1)[: b * max_pages] + 1).reshape(b, max_pages)
    return q, kn, kr, bt, np.asarray(CTX + [1, 1], np.int32)


def _levels(kn):
    return np.clip(np.round(kn / KS), -128, 127).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _jax(page, int8):
    q, kn, kr, bt, ctx = _case(page)
    if int8:
        out = jda.decode_mla(jx(q, jnp.bfloat16), jx(_levels(kn)), jx(kr, jnp.bfloat16), jx(ctx),
                             SM_SCALE, jx(bt), k_scale=KS)
    else:
        out = jda.decode_mla(jx(q, jnp.bfloat16), jx(kn, jnp.bfloat16), jx(kr, jnp.bfloat16),
                             jx(ctx), SM_SCALE, jx(bt))
    return np32(out)


def _port_args(page, int8, dtype=torch.bfloat16):
    q, kn, kr, bt, ctx = _case(page)
    kc = tt(_levels(kn)) if int8 else tt(kn, dtype)
    return (tt(q, dtype), kc, tt(kr, dtype), tt(ctx), SM_SCALE, tt(bt)), (
        dict(k_scale=KS) if int8 else {})


def _close(got, want, rel):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=rel * np.abs(want).max())


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_mla_split_plan_needs_no_host_sync():
    """K2's plan runs on tensors whose values no host can read (the meta
    device), and its split size comes from shapes alone: ``MLA_SPLIT`` keys,
    more (a multiple of the 64-key chunk) where a row would need more than
    16 splits, so a grid never has more than 16."""
    ctx = torch.empty(9, dtype=torch.int32, device="meta")
    split = tda.mla_split_size(768)
    n_splits, lo, hi, n_live = tda.split_plan(ctx, 0, 768, split)
    assert split == tda.MLA_SPLIT and n_splits == 768 // tda.MLA_SPLIT
    assert n_live.device.type == "meta" and n_live.shape == (9,)
    assert tda.mla_split_size(33 * 128) == 320 and tda.split_count(33 * 128, 0, 320) == 14
    for table_keys in (4, 80, 768, 4224, 32768, 131072):
        split = tda.mla_split_size(table_keys)
        assert split >= tda.MLA_SPLIT and split % 64 == 0
        assert tda.split_count(table_keys, 0, split) <= tda.DECODE_MAX_SPLITS


@pytest.mark.parametrize("split", SPLITS)
def test_mla_split_plan_covers_each_key_once(split):
    """Every context 0-100 on an 80-key table: a row's splits are non-empty
    and cover exactly its keys ``[0, min(ctx, 80))``, from split 0 on."""
    ctx = torch.arange(0, 101, dtype=torch.int32)
    n_splits, lo, hi, n_live = tda.split_plan(ctx, 0, TABLE_KEYS, split)
    assert n_splits == -(-TABLE_KEYS // split) and not lo.any()
    for c, h, n in zip(ctx.tolist(), hi.tolist(), n_live.tolist()):
        covered = [k for j in range(n) for k in range(j * split, min((j + 1) * split, h))]
        assert covered == list(range(min(c, TABLE_KEYS))) and n <= n_splits


# ---------------------------------------------------------------------------
# the mirror against JAX and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_mla_split_mirror_matches_jax(kind, page, split):
    """bf16 and int8 latents (the fold inside), pages 4 and 16: the mirror
    against JAX's ``decode_mla`` and the port's reference, pad rows
    included; a pad row returns latent row 0 of page 0."""
    int8 = kind == "int8"
    args, kw = _port_args(page, int8)
    got = tda.decode_mla_split_plain(*args, split=split, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (len(CTX) + 2, HQ, 512)
    _close(got, _jax(page, int8), 3e-2)
    _close(got, tda.decode_mla_ref(*args, **kw), 3e-2)
    row0 = args[1][0, 0, 0].float() * (KS if int8 else 1.0)
    np.testing.assert_allclose(np32(got[-1]), np.broadcast_to(np32(row0), (HQ, 512)), atol=2e-2)


@pytest.mark.parametrize("split", SPLITS)
def test_mla_split_mirror_f32_matches_reference(split):
    """f32 (P is not rounded): the merge of the splits equals the one
    softmax of the reference within 1e-5 of the output's largest value."""
    args, _ = _port_args(16, False, torch.float32)
    _close(tda.decode_mla_split_plain(*args, split=split), tda.decode_mla_ref(*args), 1e-5)


def test_mla_split_mirror_context_zero_is_zero():
    """A row of context 0 sees no key: exactly 0 (the kernel's split 0
    writes it), on both caches."""
    for int8 in (False, True):
        args, kw = _port_args(16, int8)
        ctx = args[3].clone()
        ctx[2] = 0
        got = tda.decode_mla_split_plain(*args[:3], ctx, *args[4:], split=16, **kw)
        assert not got[2].any() and got[3].abs().amax() > 0


@pytest.mark.parametrize("split", SPLITS)
def test_mla_split_mirror_int8_fold_bit_equal(split):
    """The in-kernel fold's two roundings: the mirror on int8 levels with
    ``k_scale`` equals, bit for bit, ``unfold_out_scale`` of the mirror over
    ``fold_q_scale(q)`` with the levels as they are (k_scale 1), the old
    wrapper path around the kernel."""
    args, kw = _port_args(16, True)
    got = tda.decode_mla_split_plain(*args, split=split, **kw)
    inner = tda.decode_mla_split_plain(tda.fold_q_scale(args[0], KS), *args[1:], split=split,
                                       k_scale=1.0)
    assert torch.equal(got, tda.unfold_out_scale(inner, KS))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_mla_split_mirror_on_pruned_table_matches_jax(kind, split):
    """DSA page mode: 3 of 5 pages of 16 chosen from indexer scores
    (``select_decode_pages``: the last partial page forced in, sorted), the
    mirror over ``pruned_block_table``'s table and lengths against JAX's
    ``decode_mla_block_sparse`` and the reference on the same table."""
    int8 = kind == "int8"
    args, kw = _port_args(16, int8)
    q, kc, kr, ctx, _, bt = args
    scores = np.random.default_rng(5).standard_normal((len(ctx), TABLE_KEYS)).astype(np.float32)
    sel = tda.select_decode_pages(tt(scores), ctx, 16, 3)
    bt_sel, seq_sel = tda.pruned_block_table(bt, ctx, sel, 16)
    got = tda.decode_mla_split_plain(q, kc, kr, seq_sel, SM_SCALE, bt_sel, split=split, **kw)
    jq, jn, jr, jb, jc = _case(16)
    jkn = jx(_levels(jn)) if int8 else jx(jn, jnp.bfloat16)
    want = jda.decode_mla_block_sparse(jx(jq, jnp.bfloat16), jkn, jx(jr, jnp.bfloat16), jx(jc),
                                       SM_SCALE, jx(jb), jx(scores), 3,
                                       k_scale=KS if int8 else None)
    _close(got, want, 3e-2)
    _close(got, tda.decode_mla_ref(q, kc, kr, seq_sel, SM_SCALE, bt_sel, **kw), 3e-2)
