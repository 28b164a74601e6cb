"""Port parity: ``Buffer.fused_deep_moe``, unfused and ``single_kernel=True``
(K16b's plain version), against JAX's on a one-device mesh.

Widths as JAX's ``test_fused_full.py`` (H 128, I 64, the gate / up packing at
full width, and narrower: 64 and 32 columns, K8a's ``dequant_swiglu`` unfused,
64 in K16b); the JAX
weights from its ``quantize_expert_weights`` go to both
sides.  The port runs on a one-rank gloo group of this process
(``_torch_parity.one_rank_group``).  Tolerances: the receive counts and the
drops exact; the combined output within a relative mean difference of 4e-4
(the JAX suite's own bar between its fused and unfused forms,
``tests/test_fused_full.py:80-82``): int8 requant levels may flip at a
rounding tie, JAX's reduce weighs in bf16 hi + lo where the port keeps f32."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_parity import jx, np32, one_rank_group, tt
from sgl_kernel_npu_tpu.config import EPConfig as JEPConfig
from sgl_kernel_npu_tpu.parallel.buffer import Buffer as JBuffer
from sgl_kernel_npu_tpu.parallel.fused_moe import quantize_expert_weights as jquant
from sgl_kernel_npu_tpu_torch.config import EPConfig
from sgl_kernel_npu_tpu_torch.parallel import fused_full, fused_moe
from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer

H, I, E, T, K = 128, 64, 16, 8, 4


def _weights(rng, e=E, tn=2 * I):
    wg, wu = ((rng.standard_normal((e, H, I)) * 0.05).astype(np.float32) for _ in range(2))
    wd = (rng.standard_normal((e, I, H)) * 0.05).astype(np.float32)
    return [np.asarray(a) for a in jquant(jx(wg), jx(wu), jx(wd), tn=tn)]


def _inputs(rng, t=T, e=E, k=K, dead=0.0):
    x = rng.standard_normal((t, H)).astype(np.float32)
    idx = np.stack([rng.choice(e, k, replace=False) for _ in range(t)]).astype(np.int32)
    idx[rng.random(idx.shape) < dead] = -1
    return x, idx, rng.random((t, k)).astype(np.float32)


def _rel_mean(got, want):
    g, w = np32(got), np32(want)
    return np.abs(g - w).mean() / (np.abs(w).mean() + 1e-9)


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("ep",))


CASES = [("unfused", dict(), {}), ("unfused-chunks2", dict(chunks=2), {}),
         ("unfused-narrow-packing", dict(pack_tn=64), {"tn": 64}),
         ("unfused-narrow-packing-pallas-ragged", dict(pack_tn=32),
          {"tn": 32, "backend": "pallas_ragged"}),
         ("unfused-float-wire", dict(use_int8_dispatch=False), {}),
         ("single-kernel", dict(single_kernel=True), {}),
         ("single-kernel-dead-slots", dict(single_kernel=True), {"dead": 0.3}),
         ("unfused-pallas-ragged", dict(), {"backend": "pallas_ragged"}),
         ("unfused-pallas", dict(), {"backend": "pallas"})]


@pytest.mark.parametrize("name,kw,opt", CASES, ids=[c[0] for c in CASES])
def test_fused_deep_moe_matches_jax(mesh1, name, kw, opt):
    rng = np.random.default_rng(5)
    w = _weights(rng, tn=opt.get("tn", 2 * I))
    x, idx, tw = _inputs(rng, dead=opt.get("dead", 0.0))
    cfg = dict(num_max_dispatch_tokens_per_rank=T)
    jbuf = JBuffer(mesh1, "ep", E, JEPConfig(**cfg))
    want, jcnt, jdrop = jbuf.fused_deep_moe(jx(x), jx(idx), jx(tw), *(jx(a) for a in w), **kw)
    buf = Buffer(one_rank_group(), E, EPConfig(comm_backend=opt.get("backend", "xla"), **cfg))
    got, cnt, drop = buf.fused_deep_moe(tt(x), tt(idx), tt(tw), *(tt(a) for a in w), **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (T, H)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt[0]))
    assert int(drop) == int(jdrop[0]) == 0
    assert _rel_mean(got, want) < 4e-4, _rel_mean(got, want)


def test_single_kernel_matches_unfused_with_drops():
    """A seg capacity below the routing's: K16b's plain version and the
    unfused form drop the same rows (JAX's pair capacity E_local · seg) and
    combine the same survivors."""
    rng = np.random.default_rng(6)
    w = [tt(a) for a in _weights(rng)]
    x, idx, tw = (tt(a) for a in _inputs(rng, t=16))
    idx[:, 0] = 3                                         # 16 rows on expert 3, seg 8
    idx[:, 1:] = torch.where(idx[:, 1:] == 3, 4, idx[:, 1:])
    group = one_rank_group()
    got, cnt, drop = fused_full.fused_deep_moe_full_rank(
        x, idx, tw, *w, group=group, num_experts=E, num_ranks=1, seg_capacity=8)
    want, cnt_u, drop_u = fused_moe.fused_deep_moe_rank(
        x, idx, tw, *w, group=group, num_experts=E, num_ranks=1, pair_capacity=8 * E,
        seg_capacity=8)
    assert int(drop) == int(drop_u) > 0 and int(cnt[3]) == 8
    np.testing.assert_array_equal(cnt.numpy(), cnt_u.numpy())
    assert _rel_mean(got, want) < 4e-4


def test_single_kernel_takes_narrow_packing(mesh1):
    """K16b (``single_kernel=True``) at a gate / up packing narrower than 2I
    (pack width 64 of 128: SwiGLU pairs each slab's halves) against JAX's
    single kernel at ``tn1`` 64 and against the unfused form on the same
    weights: counts exact, relative mean difference below 4e-4."""
    rng = np.random.default_rng(7)
    w = _weights(rng, tn=64)
    x, idx, tw = _inputs(rng)
    cfg = dict(num_max_dispatch_tokens_per_rank=T)
    jbuf = JBuffer(mesh1, "ep", E, JEPConfig(**cfg))
    want, jcnt, _ = jbuf.fused_deep_moe(jx(x), jx(idx), jx(tw), *(jx(a) for a in w), pack_tn=64,
                                        single_kernel=True)
    buf = Buffer(one_rank_group(), E, EPConfig(**cfg))
    args = (tt(x), tt(idx), tt(tw), *(tt(a) for a in w))
    got, cnt, drop = buf.fused_deep_moe(*args, pack_tn=64, single_kernel=True)
    unf, ucnt, _ = buf.fused_deep_moe(*args, pack_tn=64)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt[0]))
    assert torch.equal(cnt, ucnt) and int(drop) == 0
    assert _rel_mean(got, want) < 4e-4, _rel_mean(got, want)
    assert _rel_mean(got, unf) < 4e-4, _rel_mean(got, unf)
