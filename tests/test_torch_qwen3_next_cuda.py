"""Qwen3-Next on the card: K11a / K12d at head_dim 256 and the hybrid's steps.

Marked ``cuda``: they skip where no GPU is present.  On a machine with the
card:

    python -m pytest -m cuda tests/test_torch_qwen3_next_cuda.py -q

Held: K11a ``decode_gqa`` and K12a ``attention_sinks`` (the same decode
kernel) at head_dim 256, bf16 caches, against their plain versions within
2e-2 (f32 math in another order, bf16 output), at Qwen3-Next's 16 / 2
heads and at groups of 32 and 64 (the kernel's 2- and 4-row-tile instances,
3 and 2 ring stages), over contexts 0 (exactly 0), 1, split and page
boundaries, 8192 keys, and a pad row; K12d at head_dim 256 over packed
requests of 1 to 200 tokens and 3 pad rows (exactly 0), pages of 16 and 128
keys (TMA) and 12 (cp.async), with and without sinks and a window, one
launch a call, two calls bit-identical; a small bf16 hybrid at head_dim 256
(a 40-token prefill chunk then a decode step) through the kernels within
3e-2 of a row's largest value of ``plain=True`` with the routing replayed
(bf16 activations)."""

import pytest
import torch

from sgl_kernel_npu_tpu_torch.ops.attention import decode_attention as da
from sgl_kernel_npu_tpu_torch.ops.attention import sinks_attention as sa
from sgl_kernel_npu_tpu_torch.utils.common import kernels_available

pytestmark = pytest.mark.cuda

D = 256
DECODE_CTX = [0, 1, 16, 17, 255, 256, 257, 511, 512, 513, 1024, 2000, 8192, 1]
PREFILL_SEQ, PREFILL_CTX = [1, 37, 63, 64, 65, 200], [1, 50, 63, 100, 129, 700]


@pytest.fixture
def dev():
    if not kernels_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(gen, dev, n_rows, ctx_max, hq, hkv, n_tables, page=16):
    max_pages = -(-ctx_max // page)
    n_pages = n_tables * max_pages + 1
    kc = torch.randn((n_pages, hkv, page, D), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((n_pages, hkv, page, D), generator=gen, device=dev).to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(n_rows)) + 1
    bt = perm[: n_tables * max_pages].reshape(n_tables, max_pages).to(torch.int32).to(dev)
    q = torch.randn((n_rows, hq * D), generator=gen, device=dev).to(torch.bfloat16)
    sinks = torch.randn(hq, generator=gen, device=dev) * 2
    return q, kc, vc, bt, sinks


@pytest.mark.parametrize("hq,hkv", [(16, 2), (64, 2), (128, 2)])
def test_decode_gqa_d256(dev, hq, hkv):
    gen = torch.Generator(device=dev).manual_seed(hq)
    n = len(DECODE_CTX)
    q, kc, vc, bt, _ = _inputs(gen, dev, n, max(DECODE_CTX), hq, hkv, n)
    bt[-1] = 0
    ctx = torch.tensor(DECODE_CTX, dtype=torch.int32, device=dev)
    args = (q.reshape(n, hq, D), kc, vc, ctx, D ** -0.5, bt)
    before = da.decode_gqa.launches
    got = da.decode_gqa(*args)
    again = da.decode_gqa(*args)
    want = da.decode_gqa_plain(*args)
    torch.cuda.synchronize()
    assert da.decode_gqa.launches == before + 2
    assert torch.equal(got, again) and not got[0].any()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("window", [0, 600])
def test_attention_sinks_d256(dev, window):
    gen = torch.Generator(device=dev).manual_seed(window)
    n = len(DECODE_CTX)
    q, kc, vc, bt, sinks = _inputs(gen, dev, n, max(DECODE_CTX), 16, 2, n)
    bt[-1] = 0
    ctx = torch.tensor(DECODE_CTX, dtype=torch.int32, device=dev)
    args = (q, kc, vc, sinks, bt, ctx, D ** -0.5, window, 16, 2)
    got = sa.attention_sinks(*args)
    want = sa.attention_sinks_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("page", [16, 12, 128])
@pytest.mark.parametrize("window,with_sinks", [(0, False), (6, True), (0, True)])
@pytest.mark.parametrize("hq,hkv", [(16, 2), (3, 3), (32, 2)])
def test_attention_sinks_prefill_d256(dev, hq, hkv, window, with_sinks, page):
    gen = torch.Generator(device=dev).manual_seed(hq + window + with_sinks + page)
    q, kc, vc, bt, sinks = _inputs(gen, dev, sum(PREFILL_SEQ) + 3, max(PREFILL_CTX), hq, hkv,
                                   len(PREFILL_SEQ), page)
    seq = torch.tensor(PREFILL_SEQ, dtype=torch.int32, device=dev)
    ctx = torch.tensor(PREFILL_CTX, dtype=torch.int32, device=dev)
    args = (q, kc, vc, sinks if with_sinks else None, seq, bt, ctx, D ** -0.5, window, hq, hkv)
    before = sa.attention_sinks_prefill_pallas.launches
    got = sa.attention_sinks_prefill_pallas(*args, max_q=200)
    again = sa.attention_sinks_prefill_pallas(*args, max_q=200)
    want = sa.attention_sinks_prefill_plain(*args)
    torch.cuda.synchronize()
    assert sa.attention_sinks_prefill_pallas.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert not got[-3:].any()


def test_hybrid_steps_kernels_match_plain(dev):
    """A small bf16 hybrid at head_dim 256 (3 GDN layers and one attention
    layer, the output gate, q / k norms, partial rotary, 8 experts top-2): a
    40-token prefill chunk (8 pad rows) on state slot 1, then a decode step
    of that request's next token, a fresh request's first token on slot 2
    and a pad row, through the kernels (K12d / K11a once each a call) and
    through ``plain=True`` from the same state and routing."""
    from sgl_kernel_npu_tpu_torch.models import qwen3_next as qn

    cfg = qn.Qwen3NextHybridConfig(
        vocab_size=64, hidden=256, num_layers=4, attn_every=4, num_k_heads=2, num_v_heads=4,
        head_k_dim=64, head_v_dim=64, num_heads=8, num_kv_heads=2, head_dim=256, page_size=16,
        chunk_size=16, rotary_dim=64, attn_gate=True, qk_norm=True, moe_experts=8, moe_topk=2,
        moe_intermediate=64, shared_expert_intermediate=64)
    params = qn.init_hybrid_weights(cfg, 0, torch.bfloat16, device=dev)
    caches = qn.init_hybrid_cache(cfg, 16, 3, torch.bfloat16, device=dev)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    bt = i32([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]])
    n, s = 40, 48
    pos = torch.arange(n + 1, device=dev)
    slots0 = (bt[0, pos // 16] * 16 + pos % 16).to(torch.int32)
    slots = torch.cat([slots0[:n], i32([-1] * (s - n))])
    x = torch.randn((s + 3, cfg.hidden), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    router, routes, mode = qn._router, [], {"record": True}

    def replayed(cfg_, lw, x_):
        if mode["record"]:
            routes.append(router(cfg_, lw, x_))
            return routes[-1]
        return routes.pop(0)

    def twice(run, si):
        """The kernel run (recording its routing), then the plain run from
        the same state (taking it)."""
        snap = qn.hybrid_state_snapshot(cfg, caches, si)
        mode["record"] = True
        got = run(False)
        qn.hybrid_state_restore(cfg, caches, snap, si)
        mode["record"] = False
        want = run(True)
        assert not routes
        return got, want

    def prefill(plain):
        h, _ = qn.hybrid_prefill_step(cfg, params, x[:s], i32([n]), caches, bt[:1], i32([n]),
                                      slots, i32([1]), max_q=s, plain=plain)
        return h[:n].float()

    def decode(plain):
        h, _ = qn.hybrid_decode_step(cfg, params, x[s:s + 3], i32([n, 0, 0]), caches, bt,
                                     i32([n + 1, 1, 1]), i32([int(slots0[n]), 5 * 16, -1]),
                                     i32([1, 2, -1]), plain=plain)
        return h[:2].float()

    qn._router = replayed
    try:
        before = (da.decode_gqa.launches, sa.attention_sinks_prefill_pallas.launches)
        got, want = twice(prefill, i32([1]))
        got_d, want_d = twice(decode, i32([1, 2]))
    finally:
        qn._router = router
    torch.cuda.synchronize()
    assert (da.decode_gqa.launches, sa.attention_sinks_prefill_pallas.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in ((got, want), (got_d, want_d)):
        assert torch.isfinite(a).all()
        assert float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max()) <= 3e-2
