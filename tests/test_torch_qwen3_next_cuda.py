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
(bf16 activations).

The expert-parallel MoE at Qwen3-Next's 512 experts (H 2048, I 512): K8a's
``dequant_swiglu_quant`` (N 1024) and ``dequant`` (K 512) over 512 groups,
most of them empty at a decode step's rows, held to the plain version as
``test_torch_cuda_kernels.py::test_grouped_matmul_kernel`` holds them (one
int8 level, scales to 1e-6, bf16 to one ulp); K16b at ``E_local`` 512
against its plain version (1e-2 of a row's largest |value|) and the unfused
form (4e-4 relative mean); and a small hybrid with 512 experts top-10 and
``ep_buffer`` on a one-rank NCCL group: a decode step through the kernels
within 3e-2 of ``plain=True``, the routing replayed."""

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


def _nccl_group():
    """This process's default group: one NCCL rank over an in-process store."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    return dist.group.WORLD


E, H, I = 512, 2048, 512          # Qwen3-Next-80B-A3B's experts and widths


def _sizes(gen, rows, topk=10):
    """Group sizes of ``rows`` tokens routed top-``topk`` over ``E`` experts
    (distinct experts a token)."""
    idx = torch.argsort(torch.rand((rows, E), generator=gen), dim=-1)[:, :topk]
    return torch.bincount(idx.reshape(-1), minlength=E).to(torch.int32)


@pytest.mark.parametrize("tokens", [4, 512])
def test_grouped_matmul_512_groups(dev, tokens):
    """K8a's two int8 modes of the unfused EP MoE at 512 groups: GMM1 with
    the SwiGLU and requant (K 2048, N 1024) and GMM2 (K 512, N 2048), at a
    decode step's 40 rows (at least 472 empty groups) and a 512-token
    chunk's 5120, plus 8 rows past the total."""
    from sgl_kernel_npu_tpu_torch.ops import grouped_matmul as gm

    gen = torch.Generator().manual_seed(tokens)
    gs = _sizes(gen, tokens).to(dev)
    total = int(gs.sum())
    s = total + 8
    g = torch.Generator(device=dev).manual_seed(tokens)
    x = torch.randint(-127, 128, (s, H), generator=g, device=dev, dtype=torch.int8)
    w1 = torch.randint(-127, 128, (E, H, 2 * I), generator=g, device=dev, dtype=torch.int8)
    w2 = torch.randint(-127, 128, (E, I, H), generator=g, device=dev, dtype=torch.int8)
    sx = torch.rand(s, generator=g, device=dev) / 50 + 1e-3
    s1 = torch.rand((E, 2 * I), generator=g, device=dev) / 500 + 1e-4
    s2 = torch.rand((E, H), generator=g, device=dev) / 500 + 1e-4
    before = gm.grouped_matmul.launches
    h1, hs = gm.grouped_matmul(x, w1, gs, sx, s1, epilogue="dequant_swiglu_quant")
    h1_p, hs_p = gm.grouped_matmul_plain(x, w1, gs, sx, s1, epilogue="dequant_swiglu_quant")
    torch.cuda.synchronize()
    assert int((h1.int() - h1_p.int()).abs().max()) <= 1
    torch.testing.assert_close(hs, hs_p, rtol=1e-6, atol=0)
    assert not h1[total:].any() and not hs[total:].any()
    y = gm.grouped_matmul(h1_p, w2, gs, hs_p, s2, epilogue="dequant")
    y_p = gm.grouped_matmul_plain(h1_p, w2, gs, hs_p, s2, epilogue="dequant")
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and not y[total:].any()
    torch.testing.assert_close(y.float(), y_p.float(), atol=0, rtol=2 ** -7)
    assert gm.grouped_matmul.launches == before + 2


@pytest.mark.parametrize("tokens", [4, 512])
def test_fused_full_512_experts(dev, tokens):
    """K16b (``single_kernel=True``) at ``E_local`` 512, H 2048, I 512, top
    10, on a one-rank NCCL group: counts and drops equal to its plain
    version's and the unfused form's, ``combined`` within 1e-2 of a row's
    largest |value| of the plain version and 4e-4 (relative mean) of the
    unfused form; one launch."""
    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.parallel import fused_full
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer
    from sgl_kernel_npu_tpu_torch.parallel.fused_moe import quantize_expert_weights

    g = torch.Generator(device=dev).manual_seed(tokens + 1)
    w = quantize_expert_weights(*(torch.randn(sh, generator=g, device=dev) * 0.05
                                  for sh in ((E, H, I), (E, H, I), (E, I, H))))
    x = torch.randn((tokens, H), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.argsort(torch.rand((tokens, E), generator=g, device=dev), dim=-1)[:, :10]
    idx = idx.to(torch.int32)
    tw = torch.softmax(torch.rand((tokens, 10), generator=g, device=dev), dim=-1)
    buf = Buffer(_nccl_group(), E, EPConfig(comm_backend="pallas_ragged"))
    before = fused_full.fused_deep_moe_full_rank.launches
    got, cnt, drop = buf.fused_deep_moe(x, idx, tw, *w, single_kernel=True)
    want, wcnt, wdrop = buf.fused_deep_moe(x, idx, tw, *w, single_kernel=True, plain=True)
    unf, ucnt, udrop = buf.fused_deep_moe(x, idx, tw, *w)
    torch.cuda.synchronize()
    assert fused_full.fused_deep_moe_full_rank.launches == before + 1
    assert torch.equal(cnt, wcnt) and torch.equal(cnt, ucnt)
    assert int(drop) == int(wdrop) == int(udrop) == 0
    err = (got.float() - want.float()).abs().amax(-1) / want.float().abs().amax(-1)
    assert float(err.max()) <= 1e-2, float(err.max())
    rel = float((got.float() - unf.float()).abs().mean() / unf.float().abs().mean())
    assert rel < 4e-4, rel


def test_hybrid_ep_decode_step_matches_plain(dev):
    """A small bf16 hybrid (3 GDN layers and one attention layer at head_dim
    256) with Qwen3-Next's 512 experts top-10 on ``Buffer.fused_deep_moe``
    (``moe_weights_q`` + ``ep_buffer``, the window transport): a decode step
    of three live rows and a pad row through the kernels (K15b three times,
    K15a, K5 once and K8a twice a MoE call, no dense expert product) within
    3e-2 of a row's largest value of ``plain=True`` from the same state, the
    routing replayed."""
    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.models import qwen3_next as qn
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer
    from sgl_kernel_npu_tpu_torch.utils import counters

    cfg = qn.Qwen3NextHybridConfig(
        vocab_size=64, hidden=256, num_layers=4, attn_every=4, num_k_heads=2, num_v_heads=4,
        head_k_dim=64, head_v_dim=64, num_heads=8, num_kv_heads=2, head_dim=256, page_size=16,
        chunk_size=16, rotary_dim=64, attn_gate=True, qk_norm=True, moe_experts=E, moe_topk=10,
        moe_intermediate=128, shared_expert_intermediate=64)
    params = qn.init_hybrid_weights(cfg, 3, torch.bfloat16, device=dev)
    wq = qn.quantize_hybrid_moe_weights(cfg, params)
    buf = Buffer(_nccl_group(), E, EPConfig(comm_backend="pallas_ragged"))
    caches = qn.init_hybrid_cache(cfg, 16, 4, torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    for c in caches:
        for t in c.values():
            t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.3)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    bt = i32([[1, 2], [3, 4], [5, 6], [0, 0]])
    ctx = i32([7, 20, 32, 1])
    slots = i32([1 * 16 + 6, 4 * 16 + 3, 6 * 16 + 15, -1])
    si = i32([0, 2, 1, -1])
    x = torch.randn((4, cfg.hidden), generator=gen, device=dev).to(torch.bfloat16)
    router, routes, mode = qn._router, [], {"record": True}

    def replayed(cfg_, lw, x_):
        if mode["record"]:
            routes.append(router(cfg_, lw, x_))
            return routes[-1]
        return routes.pop(0)

    def decode(plain):
        h, _ = qn.hybrid_decode_step(cfg, params, x, ctx - 1, caches, bt, ctx, slots, si,
                                     moe_weights_q=wq, ep_buffer=buf, plain=plain)
        return h[:3].float()

    snap = qn.hybrid_state_snapshot(cfg, caches, si[:3])
    qn._router = replayed
    try:
        counters.reset()
        got = decode(False)
        launches = counters.read()
        qn.hybrid_state_restore(cfg, caches, snap, si[:3])
        mode["record"] = False
        want = decode(True)
        assert not routes
    finally:
        qn._router = router
    torch.cuda.synchronize()
    calls = cfg.num_layers
    assert {k: launches[k] for k in ("pallas_ragged_all_to_all", "pallas_all_to_all",
                                     "quant_per_token", "grouped_matmul")} == {
        "pallas_ragged_all_to_all": 3 * calls, "pallas_all_to_all": calls,
        "quant_per_token": calls, "grouped_matmul": 2 * calls}
    assert torch.isfinite(got).all()
    assert float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max()) <= 3e-2
