"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no GPU is present (a CUDA kernel has no CPU
mode).  On a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerances: bf16 attention outputs 2e-2 (f32 math, another summation order,
bf16 rounding of the output); ``decode_mla`` on int8 levels bit-equal to the
same kernel with the wrapper's old fold (``fold_q_scale`` / ``unfold_out_scale``)
around it, and two calls bit-identical (its splits merge in split order); int8 GMM1 outputs 1 level and scales rtol 1e-5;
f32 GMM2 + combine 1e-5 of the largest value (f32 sums in another order);
``quant_matmul`` exact (exact integer sums, the same f32 epilogue);
``quant_per_token`` and ``swiglu_quant`` int8 within one level (the SiLU's
exp differs by ulps between libraries), scales rtol 1e-6, and
``quant_per_token`` also bit-equal (its row max does not depend on the
order); ``rms_norm`` also bit-equal to ``rms_norm_rows_plain`` (its order of
operations on the CPU) and the same bits over 20 calls; each of the two one
CUDA kernel a call; ``grouped_matmul``
``dequant`` within one bf16 ulp (the same f32 operations; exact in f32 out),
``dequant_swiglu_quant`` int8 within one level and scales rtol 1e-6, its
bf16 modes (``grouped_matmul_float``, ``grouped_matmul_dx``) 1e-4 of the
largest |value| (f32 sums of exact bf16 products in another order), the
expert-parallel GPT-OSS steps and DeepSeek-V3 training step on one NCCL rank
as their model's kernel tests;
``lightning_indexer_scores_prefill_pallas`` the same -inf positions and
finite scores within 1e-4 of the row's largest |score| (f32 sums of exact
bf16 products in another order); ``mla_prefill_block_sparse`` as the MLA
kernels, 2e-2; ``rms_norm`` and ``swiglu_oai`` in bf16 within one bf16 ulp of
the output's largest value, in f32 within 1e-5 of it (f32 math in another
order); the sinks attention kernels 2e-2, as the MLA kernels, with pad rows
exactly 0; a small GPT-OSS's prefill and decode through the kernels within
3e-2 of a row's largest value of the plain path (bf16 activations, the
routing replayed); ``add_rms_norm_bias`` / ``add_gemma_rms_norm`` their
residual sums bit-equal and outputs within one ulp (int8 one level);
``l1_norm`` 1e-5 of the largest value; ``bgmv_fused`` and ``sgmv_fused``
1e-4 of the largest value (f32 sums of the same products in another
order), dead rows exactly 0; K12d on int8 levels bit-equal to K12d on the
levels cast to bf16 with the wrapper's old fold (``scale_heads``) around it
(the same chunks, products and roundings), and two K12d calls bit-identical;
the MLA training kernels (K14a-c): the output
as the MLA kernels (2e-2 + 2e-2 |plain|), the LSE 1e-4 absolute (f32 sums in
another order), dQ and dK 1e-2 of the tensor's largest |value| plus 1e-4
(dS rounds to bf16 on both sides, and a rounding tie moved by an f32 ulp
flips it; at S = 1 the true dQ is 0 and both sides are noise), a
small DeepSeek-V3 training step through the kernels within 2e-2 of each
gradient leaf's largest value of the plain step (bf16 end to end);
``grouped_matmul``'s int8 ``none`` and ``dequant`` to f32 bit-equal (exact
sums, the same f32 operations), ``dequant_swiglu`` 1e-5 of the largest |value|
in f32 (the SiLU's exp) and one ulp in bf16, ``dispatch_p`` bit-equal to the
gathered rows; ``grouped_matmul_combine`` 1e-5 of the largest |value|; K3 on
float tokens bit-equal to K5 then K3; ``fused_dispatch_gmm1_rank`` within one
bf16 ulp of each value; ``fused_deep_moe_full_rank`` bit-equal to its tiled
walk run on the card (``fused_full.fused_deep_moe_full_tiled_plain``: the same
exact sums and f32 operations in the same order), at any gate / up packing,
and over calls on other inputs (each call reads its own window half);
``bgmv_fused`` / ``sgmv_fused`` two CUDA kernels a call, the shrink and the
expand (a CUDA graph capture of a call), two calls bit-identical, and a call right after
an empty one (T = 0) right."""

import hashlib
import math

import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu_torch.ops import activation, gmm_ring, grouped_matmul, matmul, quant
from sgl_kernel_npu_tpu_torch.ops.attention import decode_attention as da
from sgl_kernel_npu_tpu_torch.ops.attention import lightning_indexer as li
from sgl_kernel_npu_tpu_torch.ops.attention import mla_prefill as mp
from sgl_kernel_npu_tpu_torch.ops.attention import mla_train as mt
from sgl_kernel_npu_tpu_torch.utils.common import kernels_available

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not kernels_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cache(gen, dev, n_pages, page, dtype):
    kn = torch.randn((n_pages, 1, page, 512), generator=gen, device=dev).to(dtype)
    kr = torch.randn((n_pages, 1, 64, page), generator=gen, device=dev).to(dtype)
    return kn, kr


@pytest.mark.parametrize("heads,page", [(128, 128), (8, 16), (20, 4), (64, 128), (16, 128),
                                        (128, 16)])
def test_decode_mla_kernel(dev, heads, page):
    """Rows of context 1, a page and 3, 5 pages and 2 and a pad row on a
    6-page table: at page 128 the keys cross K2's splits (768 keys in splits
    of ``MLA_SPLIT``)."""
    dtype = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    ctx = [1, page + 3, 5 * page, 2]
    b, max_pages = len(ctx), 6
    kn, kr = _cache(gen, dev, b * max_pages + 1, page, dtype)
    bt = (torch.arange(b * max_pages, device=dev, dtype=torch.int32) + 1).reshape(b, max_pages)
    bt = torch.cat([bt, torch.zeros((1, max_pages), dtype=torch.int32, device=dev)])  # pad row
    ctx_t = torch.tensor(ctx + [1], dtype=torch.int32, device=dev)
    q = torch.randn((b + 1, heads, 576), generator=gen, device=dev).to(dtype)
    before = da.decode_mla.launches
    got = da.decode_mla(q, kn, kr, ctx_t, 0.07, bt)
    want = da.decode_mla_ref(q, kn, kr, ctx_t, 0.07, bt)
    torch.cuda.synchronize()
    assert da.decode_mla.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def _int8_latent(kn):
    return torch.clamp(torch.round(kn.float() * 32), -128, 127).to(torch.int8)


@pytest.mark.parametrize("heads,page", [(128, 128), (8, 16), (64, 128), (16, 128)])
def test_decode_mla_kernel_int8_latent(dev, heads, page):
    """The int8 latent cache (levels round(k * 32), k_scale 1/32) against the
    plain version, which dequantizes."""
    gen = torch.Generator(device=dev).manual_seed(4)
    ctx = [1, page + 3, 5 * page, 2]
    b, max_pages = len(ctx), 6
    kn, kr = _cache(gen, dev, b * max_pages + 1, page, torch.bfloat16)
    kn8 = _int8_latent(kn)
    bt = (torch.arange(b * max_pages, device=dev, dtype=torch.int32) + 1).reshape(b, max_pages)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)
    q = torch.randn((b, heads, 576), generator=gen, device=dev).to(torch.bfloat16)
    got = da.decode_mla(q, kn8, kr, ctx_t, 0.07, bt, k_scale=1 / 32)
    want = da.decode_mla_ref(q, kn8, kr, ctx_t, 0.07, bt, 1 / 32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def _decode_mla_long(dev, heads, int8, seed=9):
    """[4c]'s decode shape at ``heads``: rows of 916-4016 keys, a row of
    context 1 and a pad row (ctx 1, a table of zeros) on a 33-page table of
    128 (4224 keys: 14 splits of 320), random pages; K2's arguments and
    keywords."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ctx = [916, 1816, 4016, 3516, 2616, 1, 1]
    b, max_pages, page = len(ctx), 33, 128
    kn, kr = _cache(gen, dev, b * max_pages + 1, page, torch.bfloat16)
    if int8:
        kn = _int8_latent(kn)
    bt = (torch.randperm(b * max_pages, generator=torch.Generator().manual_seed(seed)) + 1).to(
        dev, torch.int32).reshape(b, max_pages)
    bt[-1] = 0
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)
    q = torch.randn((b, heads, 576), generator=gen, device=dev).to(torch.bfloat16)
    return (q, kn, kr, ctx_t, 0.07, bt), dict(k_scale=1 / 32 if int8 else None)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("heads", [128, 64, 16])
def test_decode_mla_kernel_many_splits(dev, heads, int8):
    """A long table (up to 13 live splits a row, merged by the last split)
    with a row of context 1 and a pad row, one launch: the kernel against
    its plain version."""
    args, kw = _decode_mla_long(dev, heads, int8)
    before = da.decode_mla.launches
    got = da.decode_mla(*args, **kw)
    want = da.decode_mla_ref(*args, **kw)
    torch.cuda.synchronize()
    assert da.decode_mla.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("heads", [128, 16])
@pytest.mark.parametrize("table", ["long", "short"])
def test_decode_mla_int8_fold_bit_equal(dev, table, heads):
    """K2 on int8 levels with ``k_scale``, which folds it into q_nope and
    the output itself, equals bit for bit the old wrapper path around the
    same kernel: ``unfold_out_scale(decode_mla(fold_q_scale(q, ks), levels,
    k_scale=1), ks)`` (the same splits, chunks, products and roundings)."""
    if table == "long":
        args, kw = _decode_mla_long(dev, heads, True, seed=10)
    else:
        gen = torch.Generator(device=dev).manual_seed(11)
        kn, kr = _cache(gen, dev, 25, 16, torch.bfloat16)
        bt = torch.arange(24, device=dev, dtype=torch.int32).reshape(4, 6) + 1
        ctx = torch.tensor([1, 19, 80, 96], dtype=torch.int32, device=dev)
        q = torch.randn((4, heads, 576), generator=gen, device=dev).to(torch.bfloat16)
        args, kw = (q, _int8_latent(kn), kr, ctx, 0.07, bt), dict(k_scale=1 / 32)
    ks = kw["k_scale"]
    got = da.decode_mla(*args, **kw)
    inner = da.decode_mla(da.fold_q_scale(args[0], ks), *args[1:], k_scale=1.0)
    want = da.unfold_out_scale(inner, ks)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_mla_repeats_bit_identical(dev, int8):
    """Two K2 calls give the same bits (the splits merge in split order, not
    in arrival order), and every split counter is back at 0 after each."""
    args, kw = _decode_mla_long(dev, 128, int8, seed=12)
    first = da.decode_mla(*args, **kw)
    torch.cuda.synchronize()
    assert not any(bool(t.any()) for t in da._TICKETS.values())
    second = da.decode_mla(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert not any(bool(t.any()) for t in da._TICKETS.values())


def test_mla_prefill_kernel_int8_latent(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    page, max_pages = 16, 6
    seq, ctx = [1, 37, 64], [1, 50, 90]
    kn, kr = _cache(gen, dev, 3 * max_pages, page, torch.bfloat16)
    kn8 = _int8_latent(kn)
    bt = torch.arange(3 * max_pages, device=dev, dtype=torch.int32).reshape(3, max_pages)
    q = torch.randn((sum(seq) + 3, 128, 576), generator=gen, device=dev).to(torch.bfloat16)
    seq_t = torch.tensor(seq, dtype=torch.int32, device=dev)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)
    got = mp.mla_prefill_pallas(q, kn8, kr, seq_t, bt, ctx_t, 0.07, max_q=64, k_scale=1 / 32)
    want = mp.mla_prefill_ref(q, kn8, kr, seq_t, bt, ctx_t, 0.07, 1 / 32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert bool((got[-3:] == 0).all())


@pytest.mark.parametrize("heads", [128, 8])
def test_mla_prefill_kernel(dev, heads):
    gen = torch.Generator(device=dev).manual_seed(1)
    page, max_pages = 16, 6
    seq, ctx = [1, 37, 64], [1, 50, 90]
    kn, kr = _cache(gen, dev, 3 * max_pages, page, torch.bfloat16)
    bt = torch.arange(3 * max_pages, device=dev, dtype=torch.int32).reshape(3, max_pages)
    s = sum(seq) + 3
    q = torch.randn((s, heads, 576), generator=gen, device=dev).to(torch.bfloat16)
    seq_t = torch.tensor(seq, dtype=torch.int32, device=dev)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)
    got = mp.mla_prefill_pallas(q, kn, kr, seq_t, bt, ctx_t, 0.07, max_q=64)
    want = mp.mla_prefill_ref(q, kn, kr, seq_t, bt, ctx_t, 0.07)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert bool((got[-3:] == 0).all())


def _dense_case(dev, gen, heads, page, seq, ctx, int8, pad=3):
    """Requests packed into q with ``pad`` rows past them, each on its own
    pages of one shuffled cache (a table of ``ceil(max ctx / page)`` pages)."""
    max_pages = -(-max(ctx) // page)
    n_pages = len(seq) * max_pages
    kn, kr = _cache(gen, dev, n_pages, page, torch.bfloat16)
    if int8:
        kn = _int8_latent(kn)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(page)).to(dev)
    bt = perm.to(torch.int32).reshape(len(seq), max_pages)
    q = torch.randn((sum(seq) + pad, heads, 576), generator=gen, device=dev).to(torch.bfloat16)
    seq_t = torch.tensor(seq, dtype=torch.int32, device=dev)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)
    return q, kn, kr, seq_t, bt, ctx_t


# K9a's 64-row blocks: 1 token x 64 heads (128), 4 x 16, 8 x 8; pages of 16,
# 64 and 128 keys (TMA boxes of 16, 64 and 64 keys) and 12 (cp.async); causal
# ends on and beside 64-key chunk edges
K9A_SEQ, K9A_CTX = [1, 63, 64, 65, 130], [1, 64, 127, 129, 300]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("page", [16, 64, 128, 12])
@pytest.mark.parametrize("heads", [128, 16, 8])
def test_mla_prefill_kernel_pages(dev, heads, page, int8):
    """K9a on its wgmma body against the plain version; pad rows exactly 0."""
    gen = torch.Generator(device=dev).manual_seed(heads + page)
    args = _dense_case(dev, gen, heads, page, K9A_SEQ, K9A_CTX, int8)
    ks = 1 / 32 if int8 else None
    before = mp.mla_prefill_pallas.launches
    got = mp.mla_prefill_pallas(*args, 0.07, max_q=130, k_scale=ks)
    want = mp.mla_prefill_ref(*args, 0.07, k_scale=ks)
    torch.cuda.synchronize()
    assert mp.mla_prefill_pallas.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert bool((got[-3:] == 0).all())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("heads", [128, 16])
def test_mla_prefill_kernel_long_context(dev, heads, int8):
    """A context of 5000 keys at page 16 (313 pages: past the block-sparse
    kernel's 256-page selection) with 100 new tokens, next to a short
    request."""
    gen = torch.Generator(device=dev).manual_seed(11)
    args = _dense_case(dev, gen, heads, 16, [100, 7], [5000, 40], int8)
    ks = 1 / 32 if int8 else None
    got = mp.mla_prefill_pallas(*args, 0.07, max_q=100, k_scale=ks)
    want = mp.mla_prefill_ref(*args, 0.07, k_scale=ks)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert bool((got[-3:] == 0).all())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_mla_prefill_kernel_repeats_bit_identical(dev, int8):
    """Two K9a calls on the same inputs give the same bits (each output has
    one owner and a fixed order of sums)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    args = _dense_case(dev, gen, 128, 16, K9A_SEQ, K9A_CTX, int8)
    ks = 1 / 32 if int8 else None
    a = mp.mla_prefill_pallas(*args, 0.07, max_q=130, k_scale=ks)
    b = mp.mla_prefill_pallas(*args, 0.07, max_q=130, k_scale=ks)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("sizes", [(0, 5, 0, 17, 1, 0, 40, 1), (16,) * 8])
def test_gmm_ring_kernels(dev, sizes):
    gen = torch.Generator(device=dev).manual_seed(2)
    g, k, n, h, n_tok, ktop = 8, 1024, 512, 768, 12, 8
    s = sum(sizes)
    w1 = torch.randint(-127, 128, (g, k, n), generator=gen, device=dev, dtype=torch.int8)
    w2 = torch.randint(-127, 128, (g, n // 2, h), generator=gen, device=dev, dtype=torch.int8)
    s1 = torch.rand((g, n), generator=gen, device=dev) / 100
    s2 = torch.rand((g, h), generator=gen, device=dev) / 100
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    tok = torch.randint(0, n_tok + 1, (s,), generator=gen, device=dev, dtype=torch.int32)
    xq = torch.randint(-127, 128, (n_tok, k), generator=gen, device=dev, dtype=torch.int8)
    sx = torch.rand(n_tok, generator=gen, device=dev) / 50
    h1, hs = gmm_ring.gmm1_ring(xq, tok, w1, gs, sx, s1)
    h1_p, hs_p = gmm_ring.gmm1_ring_ref(xq, tok, w1, gs, sx, s1)
    torch.cuda.synchronize()
    assert int((h1.int() - h1_p.int()).abs().max()) <= 1
    torch.testing.assert_close(hs, hs_p, rtol=1e-5, atol=0)
    dest = torch.randint(0, s + 4, (n_tok, ktop), generator=gen, device=dev,
                         dtype=torch.int32)   # some rows past the groups' total
    topw = torch.rand((n_tok, ktop), generator=gen, device=dev)
    init = torch.randn((n_tok, h), generator=gen, device=dev)
    out = gmm_ring.gmm2_combine_ring(h1_p, w2, gs, hs_p, s2, dest, topw, init=init)
    out_p = gmm_ring.gmm2_combine_ring_ref(h1_p, w2, gs, hs_p, s2, dest, topw, init=init)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5 * float(out_p.abs().max()))


def test_decode_step_kernels_match_plain(dev):
    """A small model with the kernels' widths (latent 512, rope 64): one decode
    step through the kernels equals the plain path (bf16 activations)."""
    from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as m

    cfg = m.DeepSeekV3Config(vocab_size=256, hidden=512, num_layers=2, num_heads=16,
                             kv_lora_rank=512, qk_nope_dim=64, q_lora_rank=128,
                             v_head_dim=64, num_experts=16, topk=4, moe_intermediate=256,
                             page_size=16, router_scoring="sigmoid_v3", n_group=4,
                             topk_group=2, routed_scaling_factor=2.5)
    params = m.init_weights(cfg, 0, torch.bfloat16, device=dev)
    moe = m.quantize_moe_weights(cfg, m.init_weights(cfg, 1, torch.float32, device=dev))
    caches = m.init_kv_cache(cfg, 40, torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    for c in caches:
        c["nope"].copy_(torch.randn(c["nope"].shape, generator=gen, device=dev))
        c["rope"].copy_(torch.randn(c["rope"].shape, generator=gen, device=dev))
    b = 6
    ctx = torch.tensor([1, 9, 30, 64, 17, 2], dtype=torch.int32, device=dev)
    bt = (torch.arange(b * 6, dtype=torch.int32, device=dev) + 1).reshape(b, 6)
    pos = ctx - 1
    slots = bt[torch.arange(b, device=dev), pos // 16] * 16 + pos % 16
    slots[-1] = -1
    x = torch.randn((b, cfg.hidden), generator=gen, device=dev).to(torch.bfloat16)
    y_k, _ = m.decode_step(cfg, params, x, pos, caches, bt, ctx, slots, moe)
    y_p, _ = m.decode_step(cfg, params, x, pos, caches, bt, ctx, slots, moe, plain=True)
    torch.cuda.synchronize()
    rel = float((y_k.float() - y_p.float()).abs().max() / y_p.float().abs().max())
    assert rel < 3e-2, rel


# (M, N, K): the W8A8 GEMMs of the path at DeepSeek-V3 width (wdqkv as made
# and lane-padded, wuq, wo, shared gate || up, shared down) at decode rows,
# a 64-row prefill chunk and a 2048-row one; then ragged edges on both paths
# (up to 16 rows the decode kernel, above the wgmma tiles of 128 rows: 17,
# 63-65 and 77 rows, 2048 = 16 tiles; N not a multiple of the 64- or
# 128-wide tiles, K not a multiple of a stage's 128 bytes)
QMM_CASES = ([(m, n, k) for m in (1, 8, 64, 2048)
              for n, k in ((2112, 7168), (2176, 7168), (24576, 1536), (7168, 16384),
                           (4096, 7168), (7168, 2048))]
             + [(m, n, k) for m in (1, 8, 16, 17, 63, 64, 65, 77, 2048)
                for n, k in ((100, 64), (264, 208), (1000, 1552))])


@pytest.mark.parametrize("m,n,k", QMM_CASES)
def test_quant_matmul_kernel(dev, m, n, k):
    gen = torch.Generator(device=dev).manual_seed(n + m)
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    w = torch.randint(-128, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    ds = torch.rand(n, generator=gen, device=dev) / 1000
    bias = torch.randint(-1000, 1000, (n,), generator=gen, device=dev, dtype=torch.int32)
    for b in (None, bias):
        for dt in (torch.float32, torch.bfloat16):
            got = matmul.quant_matmul(x, w, ds, b, out_dtype=dt)
            want = matmul.quant_matmul_ref(x, w, ds, b, out_dtype=dt)
            torch.cuda.synchronize()
            assert got.dtype == dt
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_quant_matmul_rejects(dev):
    """What the kernel does not take raises; nothing falls back."""
    w = torch.zeros((8, 24), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="K % 16"):
        matmul.quant_matmul(torch.zeros((2, 24), dtype=torch.int8, device=dev), w,
                            torch.ones(8, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        matmul.quant_matmul(torch.zeros((32, 2), dtype=torch.int8, device=dev).T,
                            torch.zeros((8, 32), dtype=torch.int8, device=dev),
                            torch.ones(8, device=dev))


@pytest.mark.parametrize("rows,hidden", [(8, 16384), (8, 7168), (64, 16384), (3, 100)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quant_per_token_kernel(dev, rows, hidden, dtype):
    gen = torch.Generator(device=dev).manual_seed(rows + hidden)
    x = (torch.randn((rows, hidden), generator=gen, device=dev) * 3).to(dtype)
    x[1] = 0
    q, s = quant.quant_per_token(x)
    q_p, s_p = quant.quant_per_token_ref(x)
    torch.cuda.synchronize()
    assert int((q.int() - q_p.int()).abs().max()) <= 1
    torch.testing.assert_close(s, s_p, rtol=1e-6, atol=0)
    assert float(s[1]) == pytest.approx(1e-12) and not q[1].any()


@pytest.mark.parametrize("rows,hidden", [(8, 16384), (8, 7168), (64, 7168), (2048, 7168),
                                         (3, 100)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quant_per_token_kernel_bit_equal(dev, rows, hidden, dtype):
    """K5 on ``csrc/row_reduce.cuh``: q and the scales bit-equal to the plain
    version, a zero row included (the row's max does not depend on the order;
    IEEE division, round half to even, saturate), on clusters of 8 / 8 / 4 /
    1 blocks and the element path of (3, 100); and again from a tensor that
    starts 2 bytes past a 16-byte boundary (the element path)."""
    gen = torch.Generator(device=dev).manual_seed(7 * rows + hidden)
    x = (torch.randn((rows, hidden), generator=gen, device=dev) * 3).to(dtype)
    x[rows // 2] = 0
    flat = torch.empty(rows * hidden + 1, dtype=dtype, device=dev)
    shifted = flat[1:].view(rows, hidden)
    shifted.copy_(x)
    for t in (x, shifted):
        q, s = quant.quant_per_token(t)
        q_p, s_p = quant.quant_per_token_ref(t)
        torch.cuda.synchronize()
        assert torch.equal(q, q_p) and torch.equal(s, s_p), int((q.int() - q_p.int()).abs().max())


@pytest.mark.parametrize("rows,h", [(8, 4096), (64, 4096), (5, 200)])
@pytest.mark.parametrize("group", [None, 0, 1])
@pytest.mark.parametrize("need_quant", [True, False])
def test_swiglu_quant_kernel(dev, rows, h, group, need_quant):
    gen = torch.Generator(device=dev).manual_seed(rows + h)
    x = (torch.randn((rows, h), generator=gen, device=dev) * 2).to(torch.bfloat16)
    x[0] = 0
    counts = torch.tensor([1, 0, rows // 2], dtype=torch.int32, device=dev)
    gl = None if group is None else (torch.cumsum(counts, 0).to(torch.int32) if group == 0
                                     else counts)
    kw = dict(group_list_type=1 if group is None else group, need_quant=need_quant)
    out, s = activation.swiglu_quant(x, gl, **kw)
    out_p, s_p = activation.swiglu_quant_ref(x, gl, **kw)
    torch.cuda.synchronize()
    live = rows if gl is None else 1 + rows // 2
    assert float(s[0]) == 0.0 and not s[live:].any()
    if need_quant:
        assert int((out.int() - out_p.int()).abs().max()) <= 1
        torch.testing.assert_close(s, s_p, rtol=1e-6, atol=0)
        assert not out[0].any() and not out[live:].any()
    else:
        assert out.dtype == torch.bfloat16 and not s.any()
        torch.testing.assert_close(out.float(), out_p.float(), rtol=1e-2, atol=1e-2)


def test_fully_w8a8_decode_step_kernels_match_plain(dev):
    """The fused W8A8 prologue and the W8A8 dense weights on a small model
    with the kernels' widths: one decode step through the kernels equals the
    plain path within 3% of the largest output (int8 requant flips)."""
    from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as m

    cfg = m.DeepSeekV3Config(vocab_size=256, hidden=512, num_layers=2, num_heads=16,
                             kv_lora_rank=512, qk_nope_dim=64, q_lora_rank=128,
                             v_head_dim=64, num_experts=16, topk=4, moe_intermediate=256,
                             page_size=16)
    params = m.init_weights(cfg, 0, torch.bfloat16, device=dev)
    moe = m.quantize_moe_weights(cfg, m.init_weights(cfg, 1, torch.float32, device=dev))
    gen = torch.Generator(device=dev).manual_seed(3)
    sample = torch.randn((16, cfg.hidden), generator=gen, device=dev)
    kw = dict(mla_wq=m.make_mla_preprocess_weights(cfg, params, sample),
              dense_wq=m.quantize_dense_weights(cfg, params))
    caches = m.init_kv_cache(cfg, 40, torch.bfloat16, device=dev)
    for c in caches:
        c["nope"].copy_(torch.randn(c["nope"].shape, generator=gen, device=dev))
        c["rope"].copy_(torch.randn(c["rope"].shape, generator=gen, device=dev))
    b = 6
    ctx = torch.tensor([1, 9, 30, 64, 17, 2], dtype=torch.int32, device=dev)
    bt = (torch.arange(b * 6, dtype=torch.int32, device=dev) + 1).reshape(b, 6)
    pos = ctx - 1
    slots = bt[torch.arange(b, device=dev), pos // 16] * 16 + pos % 16
    slots[-1] = -1
    x = torch.randn((b, cfg.hidden), generator=gen, device=dev).to(torch.bfloat16)
    before = {f: getattr(f, "launches") for f in (matmul.quant_matmul, quant.quant_per_token,
                                                  activation.swiglu_quant)}
    y_k, _ = m.decode_step(cfg, params, x, pos, caches, bt, ctx, slots, moe, **kw)
    y_p, _ = m.decode_step(cfg, params, x, pos, caches, bt, ctx, slots, moe, plain=True, **kw)
    torch.cuda.synchronize()
    assert all(f.launches > n for f, n in before.items())
    assert y_k.dtype == y_p.dtype == torch.float32
    rel = float((y_k - y_p).abs().max() / y_p.abs().max())
    assert rel < 3e-2, rel


# (group sizes, S, K, I): empty groups and rows past the total; a single row;
# K not a multiple of the 128-byte stage (and of 32); groups above 64 and 128 rows
GMM_CASES = [((0, 5, 0, 17, 1, 0, 40, 1), 80, 1024, 256),
             ((0, 1, 0, 0), 1, 256, 128),
             ((3, 0, 70, 9), 100, 336, 160),
             ((130, 64, 65, 0, 200), 500, 512, 512),
             # the 128-row work items at DeepSeek-V3's K: groups of 65-128, 129 and 257
             # rows (one, two, three items), N = 2880 (a half column tile) and 4096
             ((100, 0, 129, 257, 1), 500, 7168, 1440),
             ((65, 128, 0, 257), 460, 7168, 2048)]


@pytest.mark.parametrize("sizes,s,k,i", GMM_CASES)
def test_grouped_matmul_kernel(dev, sizes, s, k, i):
    gen = torch.Generator(device=dev).manual_seed(s + k)
    g = len(sizes)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    x = torch.randint(-127, 128, (s, k), generator=gen, device=dev, dtype=torch.int8)
    w1 = torch.randint(-127, 128, (g, k, 2 * i), generator=gen, device=dev, dtype=torch.int8)
    w2 = torch.randint(-127, 128, (g, i, k), generator=gen, device=dev, dtype=torch.int8)
    sx = torch.rand(s, generator=gen, device=dev) / 50 + 1e-3
    s1 = torch.rand((g, 2 * i), generator=gen, device=dev) / 500 + 1e-4
    s2 = torch.rand((g, k), generator=gen, device=dev) / 500 + 1e-4
    total = sum(sizes)
    before = grouped_matmul.grouped_matmul.launches
    h1, hs = grouped_matmul.grouped_matmul(x, w1, gs, sx, s1, epilogue="dequant_swiglu_quant")
    h1_p, hs_p = grouped_matmul.grouped_matmul_plain(x, w1, gs, sx, s1,
                                                     epilogue="dequant_swiglu_quant")
    torch.cuda.synchronize()
    assert int((h1.int() - h1_p.int()).abs().max()) <= 1
    torch.testing.assert_close(hs, hs_p, rtol=1e-6, atol=0)
    assert not h1[total:].any() and not hs[total:].any()
    y = grouped_matmul.grouped_matmul(h1_p, w2, gs, hs_p, s2, epilogue="dequant")
    y_p = grouped_matmul.grouped_matmul_plain(h1_p, w2, gs, hs_p, s2, epilogue="dequant")
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and not y[total:].any()
    torch.testing.assert_close(y.float(), y_p.float(), atol=0, rtol=2 ** -7)
    assert grouped_matmul.grouped_matmul.launches == before + 2


# the bf16 modes' 128-row work items: groups of 65-128 rows (one item) and
# of 129 and more (two, three), N = 2880 (GPT-OSS-20B's width: a half
# 128-column tile), K = 520 (a partial 64-k stage)
GMM_BF16_CASES = GMM_CASES + [((100, 0, 128, 65), 300, 520, 1440),
                              ((129, 3, 257), 400, 256, 64)]


@pytest.mark.parametrize("contract_last", [False, True], ids=["none", "rhs_contract_last"])
@pytest.mark.parametrize("sizes,s,k,i", GMM_BF16_CASES)
def test_grouped_matmul_bf16_kernel(dev, sizes, s, k, i, contract_last):
    """K8a's bf16 modes on ragged groups (empty ones, a single row, groups
    of more than one 128-row item, rows past the total) against the plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(s + k + contract_last)
    g, n = len(sizes), 2 * i
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    x = torch.randn((s, k), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((g, n, k) if contract_last else (g, k, n), generator=gen,
                    device=dev).to(torch.bfloat16)
    fn = grouped_matmul.grouped_matmul_dx if contract_last else grouped_matmul.grouped_matmul_float
    before = fn.launches
    y = fn(x, w, gs)
    y_p = grouped_matmul.grouped_matmul_float_plain(x, w, gs, rhs_contract_last=contract_last)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and y.dtype == torch.float32
    assert not y[sum(sizes):].any()
    assert float((y - y_p).abs().max()) <= 1e-4 * float(y_p.abs().max()) + 1e-6


def test_grouped_matmul_bf16_rejects(dev):
    """f32 input and non-contiguous weights raise ValueError on the card."""
    gs = torch.tensor([3, 5], dtype=torch.int32, device=dev)
    x = torch.randn((8, 64), device=dev)
    w = torch.randn((2, 64, 32), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        grouped_matmul.grouped_matmul_float(x, w, gs)
    with pytest.raises(ValueError, match="contiguous"):
        grouped_matmul.grouped_matmul_dx(x.bfloat16(), w.bfloat16().transpose(1, 2), gs)


def test_gmm_train_kernels_match_plain(dev):
    """``gmm_train``'s forward (K8a ``none``) and dx (``rhs_contract_last``)
    against ``plain=True``: the output 1e-4, dx (bf16) 1e-2 of the largest
    |value|; dw is the same library product on both sides, exact."""
    gen = torch.Generator(device=dev).manual_seed(0)
    gs = torch.tensor([0, 70, 1, 0, 33], dtype=torch.int32, device=dev)
    x0 = torch.randn((120, 256), generator=gen, device=dev).to(torch.bfloat16)
    w0 = (torch.randn((5, 256, 192), generator=gen, device=dev) / 16).to(torch.bfloat16)
    ct = torch.randn((120, 192), generator=gen, device=dev)
    res = []
    for plain in (False, True):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        before = (grouped_matmul.grouped_matmul_float.launches,
                  grouped_matmul.grouped_matmul_dx.launches)
        out = grouped_matmul.gmm_train(x, w, gs, plain=plain)
        (out * ct).sum().backward()
        after = (grouped_matmul.grouped_matmul_float.launches,
                 grouped_matmul.grouped_matmul_dx.launches)
        assert after == tuple(b + (0 if plain else 1) for b in before)
        res.append((out.detach(), x.grad, w.grad))
    torch.cuda.synchronize()
    (o, dx, dw), (o_p, dx_p, dw_p) = res
    assert float((o - o_p).abs().max()) <= 1e-4 * float(o_p.abs().max())
    _grad_close(dx, dx_p)
    assert not dx[104:].any()
    torch.testing.assert_close(dw, dw_p, rtol=0, atol=0)


def test_moe_above_512_tokens_kernels_match_plain(dev):
    """A small model's 600-token prefill chunk: the MoE on K8a, through the
    kernels and through the plain versions, on the int8 latent cache."""
    from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as m

    cfg = m.DeepSeekV3Config(vocab_size=256, hidden=512, num_layers=2, num_heads=16,
                             kv_lora_rank=512, qk_nope_dim=64, q_lora_rank=128,
                             v_head_dim=64, num_experts=16, topk=4, moe_intermediate=256,
                             page_size=16, kv_cache_dtype="int8")
    params = m.init_weights(cfg, 0, torch.bfloat16, device=dev)
    moe = m.quantize_moe_weights(cfg, m.init_weights(cfg, 1, torch.float32, device=dev))
    n = 600
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((n, cfg.hidden), generator=gen, device=dev).to(torch.bfloat16)
    mla_wq = m.make_mla_preprocess_weights(cfg, params, x[:64].float())
    bt = torch.arange(1, 41, dtype=torch.int32, device=dev)[None, :]
    slots = (bt[0, torch.arange(n, device=dev) // 16] * 16
             + torch.arange(n, device=dev) % 16).to(torch.int32)
    sl = torch.tensor([n], dtype=torch.int32, device=dev)
    outs = []
    for plain in (False, True):
        caches = m.init_kv_cache(cfg, 41, torch.bfloat16, device=dev)
        before = grouped_matmul.grouped_matmul.launches
        y, _ = m.prefill_step(cfg, params, x, sl, caches, bt, sl, slots, max_q=n,
                              moe_weights_q=moe, mla_wq=mla_wq, plain=plain)
        torch.cuda.synchronize()
        assert grouped_matmul.grouped_matmul.launches == before + (0 if plain else 4)
        assert caches[0]["nope"].dtype == torch.int8
        outs.append(y.float())
    rel = (outs[0] - outs[1]).abs().amax(-1) / outs[1].abs().amax()
    assert float(torch.quantile(rel, 0.9)) < 3e-2, rel.max()


def _scores_close(got, want):
    """The indexer's rule: -inf exactly where the plain version has it, the
    finite scores within 1e-4 of each row's largest |score|."""
    dead = torch.isinf(want)
    assert bool((torch.isinf(got) == dead).all()) and bool((got[dead] < 0).all())
    scale = torch.where(dead, 0.0, want).abs().amax(-1, keepdim=True).clamp_min(1e-30)
    err = torch.where(dead, 0.0, (got - want).abs()) / scale
    assert float(err.max()) <= 1e-4, float(err.max())


# (lens_q, lens_k, max_q, page, max_pages, causal): full width (a 2048-token
# chunk at context 4096 on a 33-page table), ragged (page 16, requests of 1, 5
# and 40 new tokens after earlier context, max_q 45 not a multiple of the
# chunk), the decode shape (8 rows of one token: the key range split across
# blocks), non-causal, and 300 tokens at context 700 (max_q not a multiple of
# the kernel's token tile at 16-64 heads; a causal walk over several tiles)
LI_CASES = [([2048], [4096], 2048, 128, 33, True),
            ([1, 5, 40], [17, 60, 40], 45, 16, 5, True),
            ([1] * 8, [916, 1816, 4016, 3516, 2616, 1, 1, 1], 1, 128, 33, True),
            ([3, 12], [30, 12], 12, 16, 2, False),
            ([300, 37], [700, 37], 300, 16, 45, True)]


@pytest.mark.parametrize("heads", [64, 16, 32, 128])
@pytest.mark.parametrize("lens_q,lens_k,max_q,page,max_pages,causal", LI_CASES)
def test_lightning_indexer_kernel(dev, heads, lens_q, lens_k, max_q, page, max_pages, causal):
    gen = torch.Generator(device=dev).manual_seed(7)
    b = len(lens_q)
    n_pages = b * max_pages + 1
    key = torch.randn((n_pages, 1, page, 128), generator=gen, device=dev).to(torch.bfloat16)
    bt = torch.randperm(n_pages - 1, device=dev)[: b * max_pages].reshape(b, max_pages) + 1
    bt = bt.to(torch.int32)
    q = torch.randn((b, max_q, heads, 128), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((b, max_q, heads), generator=gen, device=dev)
    lq = torch.tensor(lens_q, dtype=torch.int32, device=dev)
    lk = torch.tensor(lens_k, dtype=torch.int32, device=dev)
    before = li.lightning_indexer_scores_prefill_pallas.launches
    got = li.lightning_indexer_scores_prefill_pallas(q, w, key, lq, lk, bt, causal=causal)
    want = li.lightning_indexer_scores_prefill_ref(q, w, key, lq, lk, bt, causal=causal)
    torch.cuda.synchronize()
    assert li.lightning_indexer_scores_prefill_pallas.launches == before + 1
    assert got.shape == want.shape and got.shape[1] % min(64, max(8, max_q)) == 0
    _scores_close(got, want)


def _sparse_case(dev, gen, heads, page, seq, ctx, max_pages, pos_sel, int8):
    kn, kr = _cache(gen, dev, len(seq) * max_pages, page, torch.bfloat16)
    if int8:
        kn = _int8_latent(kn)
    bt = torch.arange(len(seq) * max_pages, device=dev, dtype=torch.int32).reshape(len(seq),
                                                                                  max_pages)
    q = torch.randn((sum(seq) + 2, heads, 576), generator=gen, device=dev).to(torch.bfloat16)
    seq_t = torch.tensor(seq, dtype=torch.int32, device=dev)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)
    return q, kn, kr, seq_t, bt, ctx_t, torch.tensor(pos_sel, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("heads,page", [(128, 16), (64, 16), (20, 16), (16, 16), (8, 16),
                                        (16, 24), (128, 12), (8, 12)],
                         ids=["128", "64", "20", "16", "8", "16-page24", "128-page12", "8-page12"])
def test_mla_prefill_block_sparse_kernel(dev, heads, page, int8):
    """Chunks of 8 tokens (max_q 16): dead slots, a dead page walked before
    the live ones, a chunk whose rows straddle two pages, and a chunk whose
    first rows see none of its pages (the mean of the walked latents, as in
    JAX).  Heads 128 and 64 (64 heads of one token a block), 20 (3 tokens a
    block, a partial last tile), 16 and 8 (4 and 8 tokens a block); the
    latent in TMA boxes of 16 keys (page 16) and 8 (page 24); page 12 loads
    it in 16-byte pieces and the rope element by element."""
    gen = torch.Generator(device=dev).manual_seed(8)
    seq, ctx, max_pages = [16, 5], [60, 20], 60 // page + 1
    last = 59 // page
    pos_sel = [[[last, 2, 1, 0], [last, -1, 0, -1]],  # request 0: rows at 44..59
               [[1, -1, -1, 1], [-1, -1, -1, -1]]]    # request 1: rows 15..19; chunk 1 dead
    args = _sparse_case(dev, gen, heads, page, seq, ctx, max_pages, pos_sel, int8)
    ks = 1 / 32 if int8 else None
    before = mp.mla_prefill_block_sparse.launches
    got = mp.mla_prefill_block_sparse(*args[:6], 0.07, args[6], max_q=16, q_chunk=8, k_scale=ks)
    want = mp.mla_prefill_block_sparse_ref(*args[:6], 0.07, args[6], max_q=16, q_chunk=8,
                                           k_scale=ks)
    torch.cuda.synchronize()
    assert mp.mla_prefill_block_sparse.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert bool((got[-2:] == 0).all())


def k9b_digest(dev, int8: bool) -> str:
    """A fixed K9b case (128 heads, page 16, 40 tokens at context 300, 8
    selected pages a 16-token chunk), its inputs from a numpy seed: the first
    16 hex digits of the SHA-256 of its output's bits."""
    rng = np.random.default_rng(14)
    seq, ctx, page, heads, max_pages = [40], [300], 16, 128, 19
    r = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(  # noqa: E731
        dev, torch.bfloat16)
    kn, kr = r(max_pages, 1, page, 512), r(max_pages, 1, 64, page)
    if int8:
        kn = _int8_latent(kn)
    q = r(sum(seq), heads, 576)
    sel = np.stack([rng.permutation((260 + min(16 * c + 15, 39)) // page + 1)[:8]
                    for c in range(3)])                  # 8 of each chunk's causal pages
    args = (q, kn, kr, torch.tensor(seq, dtype=torch.int32, device=dev),
            torch.arange(max_pages, dtype=torch.int32, device=dev)[None],
            torch.tensor(ctx, dtype=torch.int32, device=dev), 0.07,
            torch.from_numpy(sel[None].astype(np.int32)).to(dev))
    out = mp.mla_prefill_block_sparse(*args, max_q=40, q_chunk=16,
                                      k_scale=1 / 32 if int8 else None)
    return hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]


# k9b_digest of K9b (mla_sparse.cuh) as recorded on an NVIDIA H100 80GB HBM3 before K14a
# and K8a took its helpers (wgmma.cuh)
K9B_DIGESTS = {False: "2b3346e6769c9d0f", True: "3a3238fc75290426"}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_mla_prefill_block_sparse_output_unchanged(dev, int8):
    """K9b's output is bit-identical to its recorded bits on a fixed case:
    K14a's and K8a's bodies share its helpers (wgmma.cuh), not its source."""
    assert k9b_digest(dev, int8) == K9B_DIGESTS[int8]


@pytest.mark.parametrize("heads", [128, 16])
def test_mla_prefill_block_sparse_all_pages_equals_dense_kernel(dev, heads):
    """Every causal page selected, in reverse order: K9b equals K9a."""
    gen = torch.Generator(device=dev).manual_seed(9)
    seq, ctx, page, max_pages = [64, 40], [300, 40], 128, 3
    n_chunks = 1
    pos_sel = [[[2, 1, 0]], [[0, -1, -1]]]
    q, kn, kr, seq_t, bt, ctx_t, sel = _sparse_case(dev, gen, heads, page, seq, ctx, max_pages,
                                                    pos_sel, False)
    assert sel.shape[1] == n_chunks
    got = mp.mla_prefill_block_sparse(q, kn, kr, seq_t, bt, ctx_t, 0.07, sel, max_q=64)
    want = mp.mla_prefill_pallas(q, kn, kr, seq_t, bt, ctx_t, 0.07, max_q=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("heads", [128, 16])
def test_mla_prefill_block_sparse_kernel_long_context(dev, heads, int8):
    """DeepSeek-V3.2's shape at a few hundred rows: 200 new tokens at context
    4096, page 128, 16 of each 64-token chunk's causal pages selected
    (its last causal page among them, in random order); pad rows zero."""
    gen = torch.Generator(device=dev).manual_seed(10)
    seq, ctx, page, max_pages, n_sel = [200], [4096], 128, 32, 16
    pos_sel = []
    for c in range(-(-seq[0] // 64)):
        last = (ctx[0] - seq[0] + min(64 * (c + 1), seq[0]) - 1) // page
        others = torch.randperm(last, generator=torch.Generator().manual_seed(c))[: n_sel - 1]
        pages = torch.cat([torch.tensor([last]), others])[torch.randperm(n_sel)]
        pos_sel.append(pages.tolist())
    args = _sparse_case(dev, gen, heads, page, seq, ctx, max_pages, [pos_sel], int8)
    ks = 1 / 32 if int8 else None
    got = mp.mla_prefill_block_sparse(*args[:6], 0.07, args[6], max_q=200, k_scale=ks)
    want = mp.mla_prefill_block_sparse_ref(*args[:6], 0.07, args[6], max_q=200, k_scale=ks)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert bool((got[-2:] == 0).all())


@pytest.mark.parametrize("gran", ["page", "token"])
def test_dsa_steps_kernels_match_plain(dev, gran):
    """A small DSA model (64 index heads x 128, page 16) on the int8 latent
    cache with the fused prologue: a 96-token prefill chunk after 64 tokens of
    context and a decode step, through the kernels and the plain versions,
    the selections and the routing replayed; hidden rows within 5e-2 of
    their largest value (the rule of ``chip_smoke.routing_rule``: the W8A8
    prologue's static int8 quant and the experts' requant turn bf16 rounding
    in the attention kernels into whole int8 levels, measured 1.5-3e-2)."""
    from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as m

    cfg = m.DeepSeekV3Config(vocab_size=256, hidden=512, num_layers=2, num_heads=16,
                             kv_lora_rank=512, qk_nope_dim=64, q_lora_rank=128,
                             v_head_dim=64, num_experts=16, topk=4, moe_intermediate=128,
                             page_size=16, kv_cache_dtype="int8", sparse_count=48,
                             idx_heads=64, idx_dim=128, sparse_granularity=gran)
    params = m.init_weights(cfg, 0, torch.bfloat16, device=dev)
    moe = m.quantize_moe_weights(cfg, m.init_weights(cfg, 1, torch.float32, device=dev))
    gen = torch.Generator(device=dev).manual_seed(10)
    n = 160
    x = torch.randn((n + 1, cfg.hidden), generator=gen, device=dev).to(torch.bfloat16)
    mla_wq = m.make_mla_preprocess_weights(cfg, params, x[:64].float())
    bt = torch.arange(1, 12, dtype=torch.int32, device=dev)[None, :]
    pos = torch.arange(n + 1, device=dev)
    slots = (bt[0, pos // 16] * 16 + pos % 16).to(torch.int32)
    kw = dict(moe_weights_q=moe, mla_wq=mla_wq)

    def run(plain, replay):
        caches = m.init_kv_cache(cfg, 12, torch.bfloat16, device=dev)
        one = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)  # noqa: E731
        m.prefill_step(cfg, params, x[:64], one(64), caches, bt, one(64), slots[:64],
                       max_q=64, plain=plain, **kw)
        y, _ = m.prefill_step(cfg, params, x[64:n], one(96), caches, bt, one(n), slots[64:n],
                              max_q=96, plain=plain, **kw)
        d, _ = m.decode_step(cfg, params, x[n:], pos[n:].to(torch.int32), caches, bt,
                             one(n + 1), slots[n:], plain=plain, **kw)
        return torch.cat([y, d]).float()

    record, sel, router, selected = [], [], m._router, m._selected
    try:
        m._router = lambda c, lw, h: record.append(router(c, lw, h)) or record[-1]
        m._selected = lambda s: sel.append(s) or s
        launches = li.lightning_indexer_scores_prefill_pallas.launches
        got = run(False, False)
        torch.cuda.synchronize()
        launches = li.lightning_indexer_scores_prefill_pallas.launches - launches
        it_r, it_s = iter(record), iter(sel)
        m._router = lambda c, lw, h: next(it_r)
        m._selected = lambda s: next(it_s)
        want = run(True, True)
    finally:
        m._router, m._selected = router, selected
    assert launches == (4 if gran == "page" else 2)      # 2 prefill calls / 1 decode step
    rel = (got - want).abs().amax(-1) / want.abs().amax(-1)
    assert bool(torch.isfinite(got).all()) and float(rel.max()) < 5e-2, float(rel.max())


# ---------------------------------------------------------------------------
# GPT-OSS: rms_norm (K6a), swiglu_oai (K7b), sinks attention (K12a, K12d)
# ---------------------------------------------------------------------------

def _ulp_close(got, want, dtype):
    """bf16: within one bf16 ulp of the output's largest value (the f32
    results differ by a rounding, the bf16 rounding can then flip); f32:
    within 1e-5 of it."""
    scale = float(want.float().abs().max())
    tol = 2.0 ** (math.floor(math.log2(scale)) - 7) if dtype == torch.bfloat16 else 1e-5 * scale
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("x_dt,w_dt", [(torch.bfloat16, torch.bfloat16),
                                       (torch.float32, torch.float32),
                                       (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("rows,hidden", [(1, 2880), (512, 2880), (7, 100), (3, 4097)])
def test_rms_norm_kernel(dev, rows, hidden, x_dt, w_dt):
    from sgl_kernel_npu_tpu_torch.ops import norm

    gen = torch.Generator(device=dev).manual_seed(rows + hidden)
    x = (torch.randn((rows, hidden), generator=gen, device=dev) * 3).to(x_dt)
    w = (1 + 0.1 * torch.randn(hidden, generator=gen, device=dev)).to(w_dt)
    before = norm.rms_norm.launches
    got = norm.rms_norm(x, w, 1e-5)
    want = norm.rms_norm_ref(x, w, 1e-5)
    torch.cuda.synchronize()
    assert norm.rms_norm.launches == before + 1 and got.dtype == x_dt
    _ulp_close(got, want, x_dt)


# one shape for each cluster size on the H100 (8, 4, 2, 1 blocks a row in
# bf16; 1 with two rows a block at 512), and the element path (a width not a
# multiple of 16 bytes; in a cluster of 8 at 32771)
ROW_PLAN_SHAPES = [(8, 32768), (8, 16384), (100, 16384), (512, 2880), (8, 2880), (3, 100),
                   (3, 32771)]


def test_row_plan_clusters_on_card(dev):
    from sgl_kernel_npu_tpu_torch.ops import row_reduce

    x = {(r, h): torch.zeros((r, h), dtype=torch.bfloat16, device=dev)
         for r, h in ROW_PLAN_SHAPES}
    plans = {k: row_reduce.launch_plan(t) for k, t in x.items()}
    assert {p.cluster for p in plans.values()} == {1, 2, 4, 8}, plans
    assert plans[(3, 100)].elems == 1 and plans[(8, 2880)].elems == 8


@pytest.mark.parametrize("x_dt,w_dt", [(torch.bfloat16, torch.bfloat16),
                                       (torch.float32, torch.float32),
                                       (torch.bfloat16, torch.float32),
                                       (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("rows,hidden", ROW_PLAN_SHAPES)
def test_rms_norm_kernel_bit_equal_to_row_plain(dev, rows, hidden, x_dt, w_dt):
    """K6a on ``csrc/row_reduce.cuh`` is bit-equal to its CPU mirror
    ``rms_norm_rows_plain`` on the launch's plan, the same bits over 20
    calls, and within a bf16 ulp of the plain version; from a tensor 4 bytes
    past a 16-byte boundary it takes the element path, bit-equal too."""
    from sgl_kernel_npu_tpu_torch.ops import norm, row_reduce

    gen = torch.Generator(device=dev).manual_seed(3 * rows + hidden)
    x = (torch.randn((rows, hidden), generator=gen, device=dev) * 3).to(x_dt)
    w = (1 + 0.1 * torch.randn(hidden, generator=gen, device=dev)).to(w_dt)
    first = norm.rms_norm(x, w, 1e-5)
    runs = [norm.rms_norm(x, w, 1e-5) for _ in range(20)]
    torch.cuda.synchronize()
    want = norm.rms_norm_rows_plain(x.cpu(), w.cpu(), 1e-5, row_reduce.launch_plan(x, w))
    assert torch.equal(first.cpu(), want)
    assert all(torch.equal(first, r) for r in runs)
    _ulp_close(first, norm.rms_norm_ref(x, w, 1e-5), x_dt)
    flat = torch.empty(rows * hidden + 4 // x.element_size(), dtype=x_dt, device=dev)
    shifted = flat[4 // x.element_size():].view(rows, hidden)
    shifted.copy_(x)
    plan = row_reduce.launch_plan(shifted, w)
    assert plan.elems == 1
    got = norm.rms_norm(shifted, w, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), norm.rms_norm_rows_plain(x.cpu(), w.cpu(), 1e-5, plan))


def test_row_reduce_kernels_one_launch(dev):
    """K5 and K6a each enqueue exactly one CUDA kernel a call (a CUDA graph
    capture), at a decode shape (a cluster launch) and a chunk's."""
    from sgl_kernel_npu_tpu_torch.ops import norm
    from sgl_kernel_npu_tpu_torch.utils.trace_profile import graph_kernels

    gen = torch.Generator(device=dev).manual_seed(5)
    for rows, hidden in ((8, 16384), (512, 2880)):
        x = torch.randn((rows, hidden), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.ones(hidden, dtype=torch.bfloat16, device=dev)
        for name, fn in (("quant_per_token_kernel", lambda: quant.quant_per_token(x)),
                         ("rms_norm_kernel", lambda: norm.rms_norm(x, w, 1e-5))):
            acts = graph_kernels(fn)
            assert len(acts) == 1 and acts[0][1] == 1 and name in acts[0][0], (rows, acts)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,inter", [(256, 2880), (3, 3), (5, 6)])
def test_swiglu_oai_kernel(dev, rows, inter, dtype):
    """Interleaved gate / up with values past ±limit; (3, 3) and (5, 6) take
    the one-pair-at-a-time path or a ragged vector count."""
    gen = torch.Generator(device=dev).manual_seed(rows + inter)
    x = (torch.randn((rows, 2 * inter), generator=gen, device=dev) * 5).to(dtype)
    before = activation.swiglu_oai.launches
    got = activation.swiglu_oai(x, 1.702, 7.0)
    want = activation.swiglu_oai_ref(x, 1.702, 7.0)
    torch.cuda.synchronize()
    assert activation.swiglu_oai.launches == before + 1 and got.shape == (rows, inter)
    _ulp_close(got, want, dtype)


def _sinks_inputs(gen, dev, n_rows, ctx_max, hq, hkv, d, n_tables, page=16):
    max_pages = -(-ctx_max // page)
    n_pages = n_tables * max_pages + 1
    kc = torch.randn((n_pages, hkv, page, d), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((n_pages, hkv, page, d), generator=gen, device=dev).to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(n_rows)) + 1
    bt = perm[: n_tables * max_pages].reshape(n_tables, max_pages).to(torch.int32).to(dev)
    q = torch.randn((n_rows, hq * d), generator=gen, device=dev).to(torch.bfloat16)
    sinks = torch.randn(hq, generator=gen, device=dev) * 2
    return q, kc, vc, bt, sinks


# decode contexts: none (exactly 0), the new token alone, a page and one
# more, window 8's first key mid-page (37) and on a page boundary (40); the
# decode kernel's split boundaries and one key either side: on this 8192-key
# table full attention splits by 512 (511-513, 1024), a window of 600 by 256
# from its first key (ctx 855-857: the first key is 256 there); rows across
# several splits and one at 8192 keys (16 splits); then a pad row (ctx 1, a
# table of zeros)
DECODE_CTX = [0, 1, 16, 17, 37, 40, 255, 256, 257, 511, 512, 513, 855, 856, 857, 1024, 2000,
              8192, 1]


@pytest.mark.parametrize("window", [0, 8, 128, 600])
@pytest.mark.parametrize("hq,hkv,d", [(64, 8, 64), (16, 4, 128), (6, 2, 64)])
def test_attention_sinks_kernel(dev, hq, hkv, d, window):
    """``DECODE_CTX`` against the golden; window 600 spans three splits."""
    from sgl_kernel_npu_tpu_torch.ops.attention import sinks_attention as sa

    gen = torch.Generator(device=dev).manual_seed(hq + d + window)
    ctx_l = DECODE_CTX
    q, kc, vc, bt, sinks = _sinks_inputs(gen, dev, len(ctx_l), max(ctx_l), hq, hkv, d,
                                         len(ctx_l))
    bt[-1] = 0
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    args = (q, kc, vc, sinks, bt, ctx, d ** -0.5, window, hq, hkv)
    before = sa.attention_sinks.launches
    got = sa.attention_sinks(*args)
    want = sa.attention_sinks_ref(*args)
    torch.cuda.synchronize()
    assert sa.attention_sinks.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


# prefill requests (new tokens, context): one token at context 1, 37 at 50,
# 63 / 64 / 65 rows (a 64-row block and one row either side at group 1, a
# chunk edge of keys), 200 at 700; three pad rows follow
PREFILL_SEQ, PREFILL_CTX = [1, 37, 63, 64, 65, 200], [1, 50, 63, 100, 129, 700]


@pytest.mark.parametrize("page", [16, 12, 128])
@pytest.mark.parametrize("window,with_sinks", [(0, True), (6, True), (128, True), (0, False)])
@pytest.mark.parametrize("hq,hkv,d", [(64, 8, 64), (16, 4, 128), (3, 3, 64), (32, 2, 64)])
def test_attention_sinks_prefill_kernel(dev, hq, hkv, d, window, with_sinks, page):
    """``PREFILL_SEQ`` / ``PREFILL_CTX`` and 3 pad rows, which stay exactly
    0; windows across pages; groups 8, 4, 1 and 16 (a 64-row block inside a
    token's heads at 16 x 5 rows); pages of 16 and 128 keys (TMA boxes of a
    page and of 64 keys of one) and of 12 (cp.async)."""
    from sgl_kernel_npu_tpu_torch.ops.attention import sinks_attention as sa

    gen = torch.Generator(device=dev).manual_seed(hq + d + window + with_sinks + page)
    seq_l, ctx_l = PREFILL_SEQ, PREFILL_CTX
    q, kc, vc, bt, sinks = _sinks_inputs(gen, dev, sum(seq_l) + 3, max(ctx_l), hq, hkv, d,
                                         len(seq_l), page)
    seq = torch.tensor(seq_l, dtype=torch.int32, device=dev)
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    args = (q, kc, vc, sinks if with_sinks else None, seq, bt, ctx, d ** -0.5, window, hq, hkv)
    before = sa.attention_sinks_prefill_pallas.launches
    got = sa.attention_sinks_prefill_pallas(*args, max_q=200)
    want = sa.attention_sinks_prefill_plain(*args)
    torch.cuda.synchronize()
    assert sa.attention_sinks_prefill_pallas.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert not got[-3:].any()


@pytest.mark.parametrize("moe", [False, True])
def test_gpt_oss_steps_kernels_match_plain(dev, moe):
    """A small GPT-OSS at the kernels' widths (head_dim 64, 8 q heads a kv
    head): a 40-token prefill then a decode step through the kernels equal
    the plain path (bf16; the routing replayed)."""
    from sgl_kernel_npu_tpu_torch.models import gpt_oss as g

    cfg = g.GptOssConfig(vocab_size=256, hidden=256, num_layers=2, num_heads=16,
                         num_kv_heads=2, head_dim=64, intermediate=256, sliding_window=16,
                         **(dict(num_experts=8, topk=2, attention_bias=True) if moe else {}))
    params = g.init_weights(cfg, 0, torch.bfloat16, device=dev, bias_scale=0.02)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((41, cfg.hidden), generator=gen, device=dev).to(torch.bfloat16)
    bt = torch.arange(1, 5, dtype=torch.int32, device=dev)[None, :]
    pos = torch.arange(41, device=dev)
    slots = (bt[0, pos // 16] * 16 + pos % 16).to(torch.int32)
    one = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)  # noqa: E731

    def run(plain):
        caches = g.init_kv_cache(cfg, 5, torch.bfloat16, device=dev)
        y, _ = g.prefill_step(cfg, params, x[:40], one(40), caches, bt, one(40), slots[:40],
                              max_q=40, plain=plain)
        d, _ = g.decode_step(cfg, params, x[40:], pos[40:], caches, bt, one(41), slots[40:],
                             plain=plain)
        return torch.cat([y, d]).float()

    record, router = [], g._router
    try:
        g._router = lambda c, lw, h: record.append(router(c, lw, h)) or record[-1]
        got = run(False)
        replay = iter(record)
        g._router = lambda c, lw, h: next(replay)
        want = run(True)
    finally:
        g._router = router
    torch.cuda.synchronize()
    rel = (got - want).abs().amax(-1) / want.abs().amax(-1)
    assert bool(torch.isfinite(got).all()) and float(rel.max()) < 3e-2, float(rel.max())


# ---------------------------------------------------------------------------
# int8 and packed caches (K12a, K12b / K12c, K12d), paged GQA decode (K11a /
# K11b), GPT-OSS's cache modes and W8A8, Llama
# ---------------------------------------------------------------------------

def _levels(x):
    """int8 levels of N(0, 1) values at scale 1/32."""
    return torch.clamp(torch.round(x.float() * 32), -128, 127).to(torch.int8)


def _cache_mode(kc, vc, kind, hkv, dev):
    """The caches in ``kind``'s form (int8 levels and / or the packed layout)
    and the per-kv-head scales the int8 ones need."""
    from sgl_kernel_npu_tpu_torch.ops.attention import sinks_attention as sa

    sc = {}
    if "int8" in kind:
        kc, vc = _levels(kc), _levels(vc)
        ramp = 1 + 0.1 * torch.arange(hkv, device=dev)
        sc = dict(k_scale=ramp / 32, v_scale=ramp.flip(0) / 32)
    if "packed" in kind:
        kc, vc = sa.pack_kv_sinks(kc), sa.pack_kv_sinks(vc)
    return kc, vc, sc


@pytest.mark.parametrize("kind", ["int8", "packed", "packed_int8"])
@pytest.mark.parametrize("window", [0, 8, 600])
@pytest.mark.parametrize("hq,hkv,d", [(64, 8, 64), (32, 2, 32), (32, 4, 128)])
def test_attention_sinks_cache_modes_kernel(dev, hq, hkv, d, window, kind):
    """K12a on int8 levels (per-kv-head scales) and K12b / K12c on the
    packed cache against their plain versions: ``DECODE_CTX``, a group of 16
    at head_dim 32."""
    from sgl_kernel_npu_tpu_torch.ops.attention import sinks_attention as sa

    gen = torch.Generator(device=dev).manual_seed(hq + d + window + len(kind))
    ctx_l = DECODE_CTX
    q, kc, vc, bt, sinks = _sinks_inputs(gen, dev, len(ctx_l), max(ctx_l), hq, hkv, d,
                                         len(ctx_l))
    bt[-1] = 0
    kc, vc, sc = _cache_mode(kc, vc, kind, hkv, dev)
    packed = "packed" in kind
    fn = sa.attention_sinks_packed if packed else sa.attention_sinks
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    args = (q, kc, vc, sinks, bt, ctx, d ** -0.5, window, hq, hkv)
    before = fn.launches
    got = fn(*args, **sc)
    want = sa.attention_sinks_plain(*args, packed=packed, **sc)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (32, 2, 32), (64, 4, 64)])
def test_decode_gqa_kernel(dev, hq, hkv, d, int8):
    """K11a at Llama-3.1-8B's heads (32 / 8 x 128), a group of 16 at head_dim
    32 and 16 at 64, bf16 and int8 (per-kv-head scales), over
    ``DECODE_CTX``; K11b launches the same kernel and counts under K11a."""
    gen = torch.Generator(device=dev).manual_seed(hq + d + int8)
    ctx_l = DECODE_CTX
    q, kc, vc, bt, _ = _sinks_inputs(gen, dev, len(ctx_l), max(ctx_l), hq, hkv, d, len(ctx_l))
    bt[-1] = 0
    kc, vc, sc = _cache_mode(kc, vc, "int8" if int8 else "", hkv, dev)
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    args = (q.reshape(len(ctx_l), hq, d), kc, vc, ctx, d ** -0.5, bt)
    before = da.decode_gqa.launches
    got = da.decode_gqa(*args, **sc)
    hp = da.decode_gqa_high_performance(*args, **sc)
    want = da.decode_gqa_plain(*args, **sc)
    torch.cuda.synchronize()
    assert da.decode_gqa.launches == before + 2 and got.shape == (len(ctx_l), hq, d)
    assert torch.equal(got, hp)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def _decode_case(dev, kind, hq, hkv, d, seed, with_sinks=True):
    """``DECODE_CTX``'s rows in ``kind``'s cache: the wrapper of the mode and
    its arguments (``attention_sinks`` / ``_packed``, or ``decode_gqa``
    without sinks) and the int8 scales."""
    from sgl_kernel_npu_tpu_torch.ops.attention import sinks_attention as sa

    gen = torch.Generator(device=dev).manual_seed(seed)
    n = len(DECODE_CTX)
    q, kc, vc, bt, sinks = _sinks_inputs(gen, dev, n, max(DECODE_CTX), hq, hkv, d, n)
    bt[-1] = 0
    kc, vc, sc = _cache_mode(kc, vc, kind, hkv, dev)
    ctx = torch.tensor(DECODE_CTX, dtype=torch.int32, device=dev)
    if not with_sinks:
        return da.decode_gqa, (q.reshape(n, hq, d), kc, vc, ctx, d ** -0.5, bt), sc
    fn = sa.attention_sinks_packed if "packed" in kind else sa.attention_sinks
    return fn, (q, kc, vc, sinks.to(torch.bfloat16), bt, ctx, d ** -0.5, 600, hq, hkv), sc


@pytest.mark.parametrize("kind,with_sinks", [("", True), ("int8", True), ("packed_int8", True),
                                             ("", False), ("int8", False)])
def test_paged_decode_repeats_bit_identical(dev, kind, with_sinks):
    """Two calls give the same bits (the splits merge in a fixed order, not
    in arrival order), and every split counter is back at 0 after each
    (the merging block resets its own); bf16 sinks are read as stored."""
    fn, args, sc = _decode_case(dev, kind, 32, 8, 128, 5 + len(kind), with_sinks)
    first = fn(*args, **sc)
    torch.cuda.synchronize()
    assert not any(bool(t.any()) for t in da._TICKETS.values())
    second = fn(*args, **sc)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert not any(bool(t.any()) for t in da._TICKETS.values())


@pytest.mark.parametrize("scales", ["scalar", "per_head"])
@pytest.mark.parametrize("kind,with_sinks", [("int8", True), ("packed_int8", True),
                                             ("int8", False)])
@pytest.mark.parametrize("hq,hkv,d", [(64, 8, 64), (32, 8, 128), (32, 2, 32)])
def test_paged_decode_int8_fold_bit_equal(dev, hq, hkv, d, kind, with_sinks, scales):
    """The int8 kernel, which folds k_scale into q and v_scale into the
    output itself, equals bit for bit the bf16 kernel over the same levels
    cast to bf16 with the wrappers' old fold (``scale_heads``) applied to q
    before and to the output after: the same split size, chunks and
    products (the split size comes from shapes alone, so the two take the
    same).  Scalar scales go to the kernel by value."""
    fn, args, sc = _decode_case(dev, kind, hq, hkv, d, hq + d + len(kind), with_sinks)
    if scales == "scalar":
        sc = dict(k_scale=0.031, v_scale=0.027)
    q, kc, vc = args[:3]
    n = len(DECODE_CTX)
    got = fn(*args, **sc)
    qf = da.scale_heads(q.reshape(n, hkv, hq // hkv, d), sc["k_scale"], hkv).reshape(q.shape)
    ref = fn(qf, kc.to(torch.bfloat16), vc.to(torch.bfloat16), *args[3:])
    want = da.scale_heads(ref.reshape(n, hkv, hq // hkv, d), sc["v_scale"], hkv)
    torch.cuda.synchronize()
    assert torch.equal(got.reshape(want.shape), want)


def _prefill_case(dev, kind, hq, hkv, d, window, with_sinks, seed):
    """``PREFILL_SEQ`` / ``PREFILL_CTX`` and 3 pad rows over ``kind``'s
    cache: K12d's arguments, keywords and the int8 scales."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    seq_l, ctx_l = PREFILL_SEQ, PREFILL_CTX
    q, kc, vc, bt, sinks = _sinks_inputs(gen, dev, sum(seq_l) + 3, max(ctx_l), hq, hkv, d,
                                         len(seq_l))
    kc, vc, sc = _cache_mode(kc, vc, kind, hkv, dev)
    seq = torch.tensor(seq_l, dtype=torch.int32, device=dev)
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    args = (q, kc, vc, sinks if with_sinks else None, seq, bt, ctx, d ** -0.5, window, hq, hkv)
    return args, dict(max_q=200, packed="packed" in kind), sc


@pytest.mark.parametrize("kind", ["int8", "packed", "packed_int8"])
@pytest.mark.parametrize("window,with_sinks", [(128, True), (0, False)])
@pytest.mark.parametrize("hq,hkv,d", [(64, 8, 64), (32, 8, 128), (16, 2, 32), (32, 2, 64)])
def test_attention_sinks_prefill_cache_modes_kernel(dev, hq, hkv, d, window, with_sinks, kind):
    """K12d on int8 levels and on the packed cache, with sinks and a window,
    and without either (Llama's prefill, group 4 at 128; a group of 16):
    ``PREFILL_SEQ`` / ``PREFILL_CTX`` and 3 pad rows, which stay exactly 0."""
    from sgl_kernel_npu_tpu_torch.ops.attention import sinks_attention as sa

    args, kw, sc = _prefill_case(dev, kind, hq, hkv, d, window, with_sinks,
                                 hq + d + window + len(kind))
    before = sa.attention_sinks_prefill_pallas.launches
    got = sa.attention_sinks_prefill_pallas(*args, **kw, **sc)
    want = sa.attention_sinks_prefill_plain(*args, **kw, **sc)
    torch.cuda.synchronize()
    assert sa.attention_sinks_prefill_pallas.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert not got[-3:].any()


@pytest.mark.parametrize("scales", ["scalar", "per_head"])
@pytest.mark.parametrize("kind,with_sinks", [("int8", True), ("packed_int8", True),
                                             ("int8", False)])
@pytest.mark.parametrize("hq,hkv,d", [(64, 8, 64), (32, 8, 128), (32, 2, 32)])
def test_attention_sinks_prefill_int8_fold_bit_equal(dev, hq, hkv, d, kind, with_sinks, scales):
    """K12d on int8 levels, which folds k_scale into q and v_scale into the
    output itself, equals bit for bit K12d on the same levels cast to bf16
    with the wrapper's old fold (``scale_heads``) applied to q before and to
    the output after: the same chunks, products and roundings.  Scalar
    scales go to the kernel by value."""
    from sgl_kernel_npu_tpu_torch.ops.attention import sinks_attention as sa

    args, kw, sc = _prefill_case(dev, kind, hq, hkv, d, 128 if with_sinks else 0, with_sinks,
                                 hq + d + len(kind))
    if scales == "scalar":
        sc = dict(k_scale=0.031, v_scale=0.027)
    q, kc, vc = args[:3]
    n = q.shape[0]
    got = sa.attention_sinks_prefill_pallas(*args, **kw, **sc)
    qf = da.scale_heads(q.reshape(n, hkv, hq // hkv, d), sc["k_scale"], hkv).reshape(q.shape)
    ref = sa.attention_sinks_prefill_pallas(qf, kc.to(torch.bfloat16), vc.to(torch.bfloat16),
                                            *args[3:], **kw)
    want = da.scale_heads(ref.reshape(n, hkv, hq // hkv, d), sc["v_scale"], hkv)
    torch.cuda.synchronize()
    assert torch.equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("kind,with_sinks", [("", True), ("int8", True), ("packed_int8", False)])
def test_attention_sinks_prefill_repeats_bit_identical(dev, kind, with_sinks):
    """Two K12d calls give the same bits (no atomics: each row's keys are
    summed in one order by one block)."""
    from sgl_kernel_npu_tpu_torch.ops.attention import sinks_attention as sa

    args, kw, sc = _prefill_case(dev, kind, 32, 8, 128, 0, with_sinks, 3 + len(kind))
    first = sa.attention_sinks_prefill_pallas(*args, **kw, **sc)
    second = sa.attention_sinks_prefill_pallas(*args, **kw, **sc)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_attention_kernels_reject_what_they_do_not_take(dev):
    """What the kernels do not take raises ValueError on the card, nothing
    falls back: Dk ≠ Dv, an f32 cache, K and V of two types, and an int8
    cache at head_dim 256 (bf16 caches at 256 are taken)."""
    from sgl_kernel_npu_tpu_torch.ops.attention import sinks_attention as sa

    bt = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    ctx = torch.ones(1, dtype=torch.int32, device=dev)
    q = torch.zeros((1, 8, 192), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((2, 2, 16, 192), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="Dk = Dv"):
        da.decode_gqa(q, k, k[..., :128].contiguous(), ctx, 0.1, bt)
    q256 = torch.zeros((1, 8 * 256), dtype=torch.bfloat16, device=dev)
    k256 = torch.zeros((2, 2, 16, 256), dtype=torch.int8, device=dev)
    sinks = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="int8 caches at head_dim"):
        sa.attention_sinks(q256, k256, k256, sinks, bt, ctx, 0.1, 0, 8, 2, k_scale=0.1,
                           v_scale=0.1)
    with pytest.raises(ValueError, match="int8 caches at head_dim"):
        da.decode_gqa(q256.reshape(1, 8, 256), k256, k256, ctx, 0.1, bt, k_scale=0.1,
                      v_scale=0.1)
    with pytest.raises(ValueError, match="int8 caches at head_dim"):
        sa.attention_sinks_prefill_pallas(q256, k256, k256, None, ctx, bt, ctx, 0.1, 0, 8, 2,
                                          k_scale=0.1, v_scale=0.1)
    q64 = torch.zeros((1, 8 * 64), dtype=torch.bfloat16, device=dev)
    k64 = torch.zeros((2, 2, 16, 64), device=dev)
    with pytest.raises(ValueError, match="bf16 or int8"):
        sa.attention_sinks(q64, k64, k64, sinks, bt, ctx, 0.1, 0, 8, 2)
    with pytest.raises(ValueError, match="bf16 or int8"):
        sa.attention_sinks(q64, k64.to(torch.int8), k64.to(torch.bfloat16), sinks, bt, ctx, 0.1,
                           0, 8, 2)
    with pytest.raises(ValueError, match="bf16 or int8"):
        sa.attention_sinks_prefill_pallas(q256, k256.float(), k256.float(), None, ctx, bt, ctx,
                                          0.1, 0, 8, 2)


def _small_gpt_oss(dev, **fields):
    from sgl_kernel_npu_tpu_torch.models import gpt_oss as g

    cfg = g.GptOssConfig(vocab_size=256, hidden=256, num_layers=2, num_heads=16, num_kv_heads=2,
                         head_dim=64, intermediate=256, sliding_window=16, **fields)
    return cfg, g.init_weights(cfg, 0, torch.bfloat16, device=dev)


def test_gpt_oss_adapter_defaults_serve(dev):
    """``gpt_oss_adapter(cfg, params)`` with its defaults serves on the card
    (a bf16 cache); an explicit f32 cache raises at the first attention
    call."""
    from sgl_kernel_npu_tpu_torch.runtime.engine import Engine, gpt_oss_adapter

    cfg, params = _small_gpt_oss(dev)
    eng = Engine(gpt_oss_adapter(cfg, params), 32, max_batch=2, max_pages_per_req=8,
                 prefill_chunk=32)
    assert eng.caches[0][0].dtype == torch.bfloat16
    outs = eng.run([list(range(3, 40)), [7, 8, 9]], 4)
    assert [len(o) for o in outs] == [4, 4]
    assert eng.cm.free_pages + eng.cm.cached_pages == 32
    eng32 = Engine(gpt_oss_adapter(cfg, params, torch.float32), 32, max_batch=2,
                   max_pages_per_req=8, prefill_chunk=32)
    with pytest.raises(ValueError, match="bf16 or int8"):
        eng32.run([[1, 2, 3]], 2)


@pytest.mark.parametrize("mode", ["int8", "packed", "packed_int8", "weights_q"])
def test_gpt_oss_modes_kernels_match_plain(dev, mode):
    """A small dense GPT-OSS (head_dim 64, 8 q heads a kv head): a 40-token
    prefill then a decode step through the kernels equal the plain path
    within 3e-2 of a row's largest value (5e-2 where int8 levels or W8A8
    take part), on the int8 cache with per-kv-head scales, the packed cache,
    both, and W8A8 projections; packed decode launches K12b / K12c."""
    from sgl_kernel_npu_tpu_torch.models import gpt_oss as g
    from sgl_kernel_npu_tpu_torch.ops.attention import sinks_attention as sa

    fields = {"int8": dict(kv_cache_dtype="int8"), "packed": dict(packed_kv=True),
              "packed_int8": dict(packed_kv=True, kv_cache_dtype="int8"), "weights_q": {}}[mode]
    cfg, params = _small_gpt_oss(dev, **fields)
    kw = {}
    if "int8" in mode:
        ramp = (1 + 0.1 * torch.arange(2, device=dev)) / 64
        kw["kv_scales"] = [(ramp, ramp.flip(0))] * 2
    if mode == "weights_q":
        kw["weights_q"] = g.quantize_weights(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((41, cfg.hidden), generator=gen, device=dev).to(torch.bfloat16)
    bt = torch.arange(1, 5, dtype=torch.int32, device=dev)[None, :]
    pos = torch.arange(41, device=dev)
    slots = (bt[0, pos // 16] * 16 + pos % 16).to(torch.int32)
    one = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)  # noqa: E731

    def run(plain):
        caches = g.init_kv_cache(cfg, 5, torch.bfloat16, device=dev)
        y, _ = g.prefill_step(cfg, params, x[:40], one(40), caches, bt, one(40), slots[:40],
                              max_q=40, plain=plain, **kw)
        d, _ = g.decode_step(cfg, params, x[40:], pos[40:], caches, bt, one(41), slots[40:],
                             plain=plain, **kw)
        return torch.cat([y, d]).float()

    decode = sa.attention_sinks_packed if cfg.packed_kv else sa.attention_sinks
    before = decode.launches
    got = run(False)
    want = run(True)
    torch.cuda.synchronize()
    assert decode.launches == before + cfg.num_layers
    rel = (got - want).abs().amax(-1) / want.abs().amax(-1)
    tol = 3e-2 if mode == "packed" else 5e-2
    assert bool(torch.isfinite(got).all()) and float(rel.max()) < tol, float(rel.max())


@pytest.mark.parametrize("mode", ["float", "w8a8_int8"])
def test_llama_steps_kernels_match_plain(dev, mode):
    """A small Llama (8 q / 2 kv heads of 32, JAX's default widths): a
    40-token prefill then a decode step through the kernels (K11a, K12d
    without sinks, K6a; with W8A8 on the int8 cache K1, K5, K7a too) equal
    the plain path within 3e-2 of a row's largest value (5e-2 with W8A8 and
    int8 levels)."""
    from sgl_kernel_npu_tpu_torch.models import llama as lm

    w8 = mode == "w8a8_int8"
    cfg = lm.LlamaConfig(vocab_size=256, hidden=256, num_layers=2,
                         **(dict(kv_cache_dtype="int8", kv_scale=0.02) if w8 else {}))
    params = lm.init_weights(cfg, 0, torch.bfloat16, device=dev)
    kw = {"weights_q": lm.quantize_weights(cfg, params)} if w8 else {}
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((41, cfg.hidden), generator=gen, device=dev).to(torch.bfloat16)
    bt = torch.arange(1, 5, dtype=torch.int32, device=dev)[None, :]
    pos = torch.arange(41, device=dev)
    slots = (bt[0, pos // 16] * 16 + pos % 16).to(torch.int32)
    one = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)  # noqa: E731

    def run(plain):
        caches = lm.init_kv_cache(cfg, 5, torch.bfloat16, device=dev)
        y, _ = lm.prefill_step(cfg, params, x[:40], one(40), caches, bt, one(40), slots[:40],
                               max_q=40, plain=plain, **kw)
        d, _ = lm.decode_step(cfg, params, x[40:], pos[40:], caches, bt, one(41), slots[40:],
                              plain=plain, **kw)
        return torch.cat([y, d]).float()

    before = (da.decode_gqa.launches, matmul.quant_matmul.launches)
    got = run(False)
    want = run(True)
    torch.cuda.synchronize()
    assert da.decode_gqa.launches == before[0] + cfg.num_layers
    assert matmul.quant_matmul.launches == before[1] + (12 * cfg.num_layers if w8 else 0)
    rel = (got - want).abs().amax(-1) / want.abs().amax(-1)
    tol = 5e-2 if w8 else 3e-2
    assert bool(torch.isfinite(got).all()) and float(rel.max()) < tol, float(rel.max())


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("mode", ["bias", "bias_quant", "gemma"])
@pytest.mark.parametrize("x_dt,w_dt", [(torch.bfloat16, torch.bfloat16),
                                       (torch.float32, torch.float32),
                                       (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("rows,hidden", [(1, 4096), (512, 4096), (7, 100), (3, 4097)])
def test_add_rms_norm_kernel(dev, rows, hidden, x_dt, w_dt, mode):
    """K6b (with and without its static int8 quant) and K6c on K6b's kernel:
    the residual sum bit-equal, the normed output within one ulp of x's type
    (int8 within one level: the kernel's 1 / sqrt and torch's rsqrt may
    differ by an ulp); (7, 100) and (3, 4097) take the one-element path."""
    from sgl_kernel_npu_tpu_torch.ops import norm

    gen = torch.Generator(device=dev).manual_seed(rows + hidden)
    x = (torch.randn((rows, hidden), generator=gen, device=dev) * 2).to(x_dt)
    res = torch.randn((rows, hidden), generator=gen, device=dev).to(x_dt)
    w = (1 + 0.1 * torch.randn(hidden, generator=gen, device=dev)).to(w_dt)
    b = (0.1 * torch.randn(hidden, generator=gen, device=dev)).to(w_dt)
    if mode == "gemma":
        fn, before = norm.add_gemma_rms_norm, norm.add_gemma_rms_norm.launches
        (got, added), (want, want_added) = (fn(x, w, res, 1e-5),
                                            norm.add_gemma_rms_norm_ref(x, w, res, 1e-5))
    else:
        q = {}
        if mode == "bias_quant":
            q = {"quant_scale": 60 + 40 * torch.rand(hidden, generator=gen, device=dev),
                 "quant_offset": 6 * torch.rand(hidden, generator=gen, device=dev) - 3}
        fn, before = norm.add_rms_norm_bias, norm.add_rms_norm_bias.launches
        (got, added), (want, want_added) = (fn(x, res, w, b, 1e-5, **q),
                                            norm.add_rms_norm_bias_ref(x, res, w, b, 1e-5, **q))
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and torch.equal(added, want_added)
    if mode == "bias_quant":
        diff = (got.int() - want.int()).abs()
        assert got.dtype == torch.int8 and int(diff.max()) <= 1
        assert float((diff == 0).float().mean()) > 0.99
    else:
        assert got.dtype == x_dt
        _ulp_close(got, want, x_dt)


# K6b / K6c on row_reduce.cuh (in bf16): clusters of 8, 4 and 2 blocks a
# row, four rows a block at 512 (Llama's width and DeepSeek's), one block a
# row at [8, 4096], the element path
ADD_ROW_SHAPES = [(8, 32768), (8, 8192), (100, 8192), (512, 4096), (512, 7168), (8, 4096),
                  (7, 100), (3, 4097)]


@pytest.mark.parametrize("mode", ["bias", "quant", "gemma"])
@pytest.mark.parametrize("x_dt,w_dt", [(torch.bfloat16, torch.bfloat16),
                                       (torch.float32, torch.float32),
                                       (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("rows,hidden", ADD_ROW_SHAPES)
def test_add_rms_norm_kernel_bit_equal_to_row_plain(dev, rows, hidden, x_dt, w_dt, mode):
    """K6b (with and without its quant) and K6c are bit-equal to their CPU
    mirror ``add_rms_norm_rows_plain`` on the launch's plan, ``added``
    bit-equal to the plain version's, the same bits over 5 calls; from
    tensors 4 bytes past a 16-byte boundary they take the element path,
    bit-equal too."""
    from sgl_kernel_npu_tpu_torch.ops import norm, row_reduce

    gen = torch.Generator(device=dev).manual_seed(5 * rows + hidden)
    x = (torch.randn((rows, hidden), generator=gen, device=dev) * 2).to(x_dt)
    res = torch.randn((rows, hidden), generator=gen, device=dev).to(x_dt)
    w = (1 + 0.1 * torch.randn(hidden, generator=gen, device=dev)).to(w_dt)
    b = (0.1 * torch.randn(hidden, generator=gen, device=dev)).to(w_dt)
    qs = 60 + 40 * torch.rand(hidden, generator=gen, device=dev)
    qo = 6 * torch.rand(hidden, generator=gen, device=dev) - 3

    def call(xx, rr):
        if mode == "gemma":
            return norm.add_gemma_rms_norm(xx, w, rr, 1e-5)
        q = {"quant_scale": qs, "quant_offset": qo} if mode == "quant" else {}
        return norm.add_rms_norm_bias(xx, rr, w, b, 1e-5, **q)

    def mirror(plan):
        q = (qs.cpu(), qo.cpu()) if mode == "quant" else (None, None)
        return norm.add_rms_norm_rows_plain(x.cpu(), res.cpu(), w.cpu(), b.cpu(), *q, mode, 1e-5,
                                            plan)

    got, added = call(x, res)
    runs = [call(x, res) for _ in range(5)]
    torch.cuda.synchronize()
    want, want_added = mirror(row_reduce.launch_plan(x, res, w, inputs=2))
    assert torch.equal(got.cpu(), want) and torch.equal(added.cpu(), want_added)
    assert torch.equal(added, (x + res).to(x_dt))
    assert all(torch.equal(got, g) and torch.equal(added, a) for g, a in runs)
    shift = 4 // x.element_size()
    flat = torch.empty((2, rows * hidden + shift), dtype=x_dt, device=dev)
    xs, rs = (flat[i, shift:].view(rows, hidden) for i in range(2))
    xs.copy_(x)
    rs.copy_(res)
    plan = row_reduce.launch_plan(xs, rs, w, inputs=2)
    assert plan.elems == 1
    got, added = call(xs, rs)
    torch.cuda.synchronize()
    want, want_added = mirror(plan)
    assert torch.equal(got.cpu(), want) and torch.equal(added.cpu(), want_added)


@pytest.mark.parametrize("need_quant", [True, False])
@pytest.mark.parametrize("rows,width,total", [(8, 28672, None), (8, 28672, 3),
                                              (512, 28672, None), (512, 28672, 301),
                                              (8, 4096, 5), (2048, 4096, None), (5, 200, 4),
                                              (3, 16400, None)])
def test_swiglu_quant_kernel_row_reduce(dev, rows, width, total, need_quant):
    """K7a on ``csrc/row_reduce.cuh`` at Llama-3.1-8B's gate ‖ up (clusters
    of 8 at decode, two rows a block at a 512-row chunk), DeepSeek-V3's, a
    ragged width (the element path) and a width whose halves take 16-byte
    vectors in a cluster: int8 within one level of the plain version (the
    SiLU's exp differs by ulps between libraries), scales rtol 1e-6, rows
    past the group list's total zeros with scale 0 (at 3 a cluster whose row
    is dead, at 301 a block of one live and one dead row), two calls
    bit-identical; without quant within 1e-2."""
    from sgl_kernel_npu_tpu_torch.ops import row_reduce

    gen = torch.Generator(device=dev).manual_seed(rows + width)
    x = (torch.randn((rows, width), generator=gen, device=dev) * 2).to(torch.bfloat16)
    x[0] = 0
    gl = None if total is None else torch.tensor([total], dtype=torch.int32, device=dev)
    kw = dict(group_list_type=1, need_quant=need_quant)
    out, s = activation.swiglu_quant(x, gl, **kw)
    again = activation.swiglu_quant(x, gl, **kw)
    out_p, s_p = activation.swiglu_quant_ref(x, gl, **kw)
    torch.cuda.synchronize()
    plan = row_reduce.launch_plan(x, out, halves=2)
    if width == 28672:
        assert plan.cluster == (8 if rows == 8 else 1) and plan.elems == 8
    assert plan.elems == (1 if width == 200 else 8)
    live = rows if total is None else total
    assert torch.equal(out, again[0]) and torch.equal(s, again[1])
    assert float(s[0]) == 0.0 and not s[live:].any() and not out[live:].any()
    if need_quant:
        assert int((out.int() - out_p.int()).abs().max()) <= 1
        torch.testing.assert_close(s, s_p, rtol=1e-6, atol=0)
    else:
        assert out.dtype == torch.bfloat16 and not s.any()
        torch.testing.assert_close(out.float(), out_p.float(), rtol=1e-2, atol=1e-2)


def test_k7a_k6b_one_launch(dev):
    """K7a, K6b and K6c each enqueue exactly one CUDA kernel a call (a CUDA
    graph capture), at a decode shape (a cluster launch) and a chunk's."""
    from sgl_kernel_npu_tpu_torch.ops import norm
    from sgl_kernel_npu_tpu_torch.utils.trace_profile import graph_kernels

    gen = torch.Generator(device=dev).manual_seed(6)
    for rows, hidden in ((8, 16384), (512, 4096)):
        x = torch.randn((rows, 2 * hidden), generator=gen, device=dev).to(torch.bfloat16)
        h, r = x[:, :hidden].contiguous(), x[:, hidden:].contiguous()
        w = torch.ones(hidden, dtype=torch.bfloat16, device=dev)
        for name, fn in (("swiglu_quant_kernel", lambda: activation.swiglu_quant(x)),
                         ("add_rms_norm_kernel", lambda: norm.add_rms_norm_bias(h, r, w, w)),
                         ("add_rms_norm_kernel", lambda: norm.add_gemma_rms_norm(h, w, r))):
            acts = graph_kernels(fn)
            assert len(acts) == 1 and acts[0][1] == 1 and name in acts[0][0], (rows, acts)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,hidden", [(1, 4096), (512, 4096), (7, 100), (3, 4097)])
def test_l1_norm_kernel(dev, rows, hidden, dtype):
    """K6d: a row over its signed sum, f32 out, within 1e-5 of the largest
    value (f32 sums in another order; IEEE division on both sides)."""
    from sgl_kernel_npu_tpu_torch.ops import norm

    gen = torch.Generator(device=dev).manual_seed(rows * hidden)
    x = (torch.randn((rows, hidden), generator=gen, device=dev) + 0.5).to(dtype)
    before = norm.l1_norm.launches
    got = norm.l1_norm(x)
    want = norm.l1_norm_ref(x)
    torch.cuda.synchronize()
    assert norm.l1_norm.launches == before + 1 and got.dtype == torch.float32
    assert _rel_err(got, want) < 1e-5


# K6d on row_reduce.cuh: clusters of 8 and 4 blocks a row, two rows a block
# at chunk sizes, one block a row at [8, 4096], the element path
L1_ROW_SHAPES = [(8, 32768), (8, 16384), (512, 4096), (2048, 4096), (8, 4096), (1, 4096),
                 (7, 100), (3, 4097)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,hidden", L1_ROW_SHAPES)
def test_l1_norm_kernel_bit_equal_to_row_plain(dev, rows, hidden, dtype):
    """K6d is bit-equal to its CPU mirror ``l1_norm_rows_plain`` on the
    launch's plan, the same bits over 5 calls; from a tensor 4 bytes past a
    16-byte boundary it takes the element path, bit-equal too."""
    from sgl_kernel_npu_tpu_torch.ops import norm, row_reduce

    gen = torch.Generator(device=dev).manual_seed(3 * rows + hidden)
    x = (torch.randn((rows, hidden), generator=gen, device=dev) + 0.5).to(dtype)
    got = norm.l1_norm(x)
    runs = [norm.l1_norm(x) for _ in range(5)]
    torch.cuda.synchronize()
    out = torch.empty(x.shape, device=dev)
    assert torch.equal(got.cpu(), norm.l1_norm_rows_plain(x.cpu(), norm.l1_launch_plan(x, out)))
    assert all(torch.equal(got, g) for g in runs)
    shift = 4 // x.element_size()
    flat = torch.empty(rows * hidden + shift, dtype=dtype, device=dev)
    xs = flat[shift:].view(rows, hidden)
    xs.copy_(x)
    plan = norm.l1_launch_plan(xs, out)
    assert plan.elems == 1
    got = norm.l1_norm(xs)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), norm.l1_norm_rows_plain(x.cpu(), plan))


def test_sample_tokens_card_equals_cpu(dev):
    """``sample_tokens`` and ``apply_penalties`` on the card against the
    CPU's on a copy of the same f32 logits (DeepSeek-V3's vocabulary): the
    PRNG's bits bit-equal, penalties bit-equal (IEEE division on both), the
    same tokens for greedy, temperature, top-k, top-p, min-p and composed
    rows."""
    from sgl_kernel_npu_tpu_torch.ops import sampling
    from sgl_kernel_npu_tpu_torch.utils import prng

    gen = torch.Generator(device=dev).manual_seed(9)
    b, v = 12, 129280
    logits = torch.randn((b, v), generator=gen, device=dev) * 3
    counts = torch.randint(0, 3, (b, v), generator=gen, device=dev, dtype=torch.int32)
    host = (torch.arange(b, dtype=torch.int32) * 5 - 20, torch.arange(b, dtype=torch.int32) * 3,
            torch.tensor([0.0, 0.7, 1.0, 1.0, 1.0, 0.9, 1.2, 0.8, 0.0, 1.0, 0.6, 1.0]),
            torch.tensor([0, 0, 50, 0, 0, 40, 0, 50, 5, 1, 0, 0], dtype=torch.int32),
            torch.tensor([1.0, 1.0, 1.0, 0.9, 1.0, 0.95, 0.8, 0.9, 1.0, 1.0, 1.0, 0.5]),
            torch.tensor([0.0, 0.0, 0.0, 0.0, 0.1, 0.05, 0.0, 0.05, 0.0, 0.0, 0.2, 0.0]))
    pen = (torch.rand(b) + 0.5, torch.rand(b), torch.rand(b))
    pc = sampling.apply_penalties(logits, counts, *(t.to(dev) for t in pen))
    ph = sampling.apply_penalties(logits.cpu(), counts.cpu(), *pen)
    assert torch.equal(pc.cpu(), ph)
    got = sampling.sample_tokens(pc, *(t.to(dev) for t in host))
    want = sampling.sample_tokens(ph, *host)
    assert torch.equal(got.cpu(), want)
    key = prng.fold_in(prng.key(host[0]), host[1])
    card = prng.random_bits(tuple(k.to(dev) for k in key), v).cpu()
    assert torch.equal(card, prng.random_bits(key, v))


def _lora_weights(gen, dev, t, h, l, r, d, dtype):
    x = torch.randn((t, h), generator=gen, device=dev).to(dtype)
    a = (0.1 * torch.randn((l, r, h), generator=gen, device=dev)).to(dtype)
    b = (0.1 * torch.randn((l, d, r), generator=gen, device=dev)).to(dtype)
    return x, a, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["b", "bt"])
@pytest.mark.parametrize("t,h,l,r,d", [(8, 4096, 4, 16, 4096), (512, 4096, 4, 16, 1024),
                                       (8, 4096, 64, 16, 4096), (5, 100, 3, 3, 70)])
def test_bgmv_fused_kernel(dev, t, h, l, r, d, layout, dtype):
    """K13a against its plain version within 1e-4 of the largest value (f32
    sums of the same products in another order), B in its stored layout or
    as ``bt``; ids outside ``[0, L)`` give exact zeros; (5, 100, 3, 3, 70)
    takes the one-element paths."""
    from sgl_kernel_npu_tpu_torch.ops import lora_pallas as lp

    gen = torch.Generator(device=dev).manual_seed(t + l + r)
    x, a, b = _lora_weights(gen, dev, t, h, l, r, d, dtype)
    idx = torch.randint(0, l, (t,), generator=gen, device=dev, dtype=torch.int32)
    idx[0], idx[-1] = -1, l
    kw = {"bt": b.transpose(1, 2).contiguous()} if layout == "bt" else {}
    bb = None if kw else b
    before = lp.bgmv_fused.launches
    got = lp.bgmv_fused(x, a, bb, idx, scaling=0.5, **kw)
    want = lp.bgmv_fused_plain(x, a, bb, idx, scaling=0.5, **kw)
    torch.cuda.synchronize()
    assert lp.bgmv_fused.launches == before + 1 and got.dtype == torch.float32
    assert not got[0].any() and not got[-1].any()
    assert _rel_err(got, want) < 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lens,s", [([100, 0, 250, 140], 512), ([1], 3), ([0, 0, 7], 9),
                                    ([i % 3 for i in range(300)], 310)])
def test_sgmv_fused_kernel(dev, lens, s, dtype):
    """K13b against its plain version within 1e-4 of the largest value:
    empty sequences, a tail of rows past the sequences (exactly 0), ranks
    below the stored 16 and mixed scalings; 300 sequences take the shrink's
    scan of the lengths over three chunks of 128."""
    from sgl_kernel_npu_tpu_torch.ops import lora_pallas as lp

    gen = torch.Generator(device=dev).manual_seed(s + len(lens))
    x, a, b = _lora_weights(gen, dev, s, 4096, 4, 16, 4096, dtype)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    widx = i32([(3 * i + 1) % 4 for i in range(len(lens))])
    args = (widx, i32(lens), i32([16, 8, 4, 16]),
            torch.tensor([1.0, 0.5, 2.0, 0.25], device=dev))
    before = lp.sgmv_fused.launches
    got = lp.sgmv_fused(x, a, b, *args)
    want = lp.sgmv_fused_plain(x, a, b, *args)
    torch.cuda.synchronize()
    assert lp.sgmv_fused.launches == before + 1
    assert not got[sum(lens):].any()
    assert _rel_err(got, want) < 1e-4


@pytest.mark.parametrize("t,l", [(8, 4), (512, 4), (8, 64)])
def test_lora_kernels_two_launches_and_repeat_bit_identical(dev, t, l):
    """K13a (bgmv, both B layouts) and K13b (sgmv) each enqueue exactly two
    CUDA kernels a call, the shrink and the expand, and nothing else (no
    scratch fill, no prefix sum); two calls are bit-identical, and so is a
    third after a call on no rows."""
    from sgl_kernel_npu_tpu_torch.ops import lora_pallas as lp
    from sgl_kernel_npu_tpu_torch.utils.trace_profile import graph_kernels

    gen = torch.Generator(device=dev).manual_seed(t + l)
    x, a, b = _lora_weights(gen, dev, t, 4096, l, 16, 4096, torch.bfloat16)
    idx = torch.randint(0, l, (t,), generator=gen, device=dev, dtype=torch.int32)
    bt = b.transpose(1, 2).contiguous()
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    sg = (i32([(3 * i + 1) % l for i in range(4)]), i32([t // 4, 0, t // 2, t - t // 4 - t // 2]),
          i32([16, 8, 4, 16] + [16] * (l - 4)), torch.rand(l, generator=gen, device=dev))
    calls = {"bgmv": lambda n=t: lp.bgmv_fused(x[:n], a, b, idx[:n]),
             "bgmv bt": lambda n=t: lp.bgmv_fused(x[:n], a, None, idx[:n], bt=bt),
             "sgmv": lambda n=t: lp.sgmv_fused(x[:n], a, b, sg[0], sg[1] if n else 0 * sg[1],
                                               *sg[2:])}
    for name, fn in calls.items():
        acts = graph_kernels(fn)
        assert len(acts) == 2 and [c for _, c in acts] == [1, 1] and any(
            "shrink_kernel" in n for n, _ in acts) and any(
            "expand_kernel" in n for n, _ in acts), (name, acts)
        first, second = fn(), fn()
        empty = fn(0)
        third = fn()
        torch.cuda.synchronize()
        assert torch.equal(first, second) and torch.equal(first, third), name
        assert empty.shape == (0, 4096), name


@pytest.mark.parametrize("w8a8", [False, True])
def test_llama_lora_steps_kernels_match_plain(dev, w8a8):
    """A small Llama with 4 adapters of rank 8 (adapter 0 zero): a 40-token
    prefill under adapter 2, then a decode step of rows under adapters 1, 3,
    0 through the kernels (K13a twice a layer a call) equal the plain path
    within 3e-2 of a row's largest value (5e-2 with W8A8)."""
    from sgl_kernel_npu_tpu_torch.models import llama as lm
    from sgl_kernel_npu_tpu_torch.ops import lora_pallas as lp

    cfg = lm.LlamaConfig(vocab_size=256, hidden=256, num_layers=2)
    params = lm.init_weights(cfg, 0, torch.bfloat16, device=dev)
    lora = lm.init_lora(1, cfg, 4, 8, torch.bfloat16, device=dev)
    kw = {"weights_q": lm.quantize_weights(cfg, params)} if w8a8 else {}
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((43, cfg.hidden), generator=gen, device=dev).to(torch.bfloat16)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    bt = torch.arange(1, 13, dtype=torch.int32, device=dev).reshape(3, 4)
    pos = torch.arange(40, device=dev)
    slots = (bt[0, pos // 16] * 16 + pos % 16).to(torch.int32)
    dpos = i32([40, 7, 3])
    dslots = (bt[torch.arange(3, device=dev), dpos // 16] * 16 + dpos % 16).to(torch.int32)

    def run(plain):
        caches = lm.init_kv_cache(cfg, 13, torch.bfloat16, device=dev)
        y, _ = lm.prefill_step(cfg, params, x[:40], i32([40]), caches, bt[:1], i32([40]), slots,
                               max_q=40, lora=lora, lora_idx=torch.full_like(slots, 2),
                               plain=plain, **kw)
        d, _ = lm.decode_step(cfg, params, x[40:], dpos, caches, bt, dpos + 1, dslots, lora=lora,
                              lora_idx=i32([1, 3, 0]), plain=plain, **kw)
        return torch.cat([y, d]).float()

    before = lp.bgmv_fused.launches
    got = run(False)
    want = run(True)
    torch.cuda.synchronize()
    assert lp.bgmv_fused.launches == before + 4 * cfg.num_layers
    rel = (got - want).abs().amax(-1) / want.abs().amax(-1)
    tol = 5e-2 if w8a8 else 3e-2
    assert bool(torch.isfinite(got).all()) and float(rel.max()) < tol, float(rel.max())


# (B, S, H): the training slice's shape, one token, a 16-row block of one
# token's heads, 16 heads, 4 heads (a block spans 4 tokens), 20 heads (K14c's
# steps cross tokens; a K14a block boundary inside a token); K14a's 64-key
# chunk edges at 128 heads (S = 64, 65, 129: two blocks a token); three batch rows
TRAIN_CASES = [(2, 520, 128), (1, 1, 16), (1, 17, 128), (1, 40, 16), (2, 33, 4), (1, 70, 20),
               (1, 64, 128), (1, 65, 128), (1, 129, 128), (3, 65, 20)]


def _train_inputs(gen, dev, b, s, h):
    r = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    return r(b, s, h, 512), r(b, s, h, 64), r(b, s, 512), r(b, s, 64)


def _grad_close(got, want, tol=1e-2):
    """Within ``tol`` of the largest |value|, plus 1e-4: at S = 1 the true dQ
    is 0 (a softmax over one key) and both sides are f32 cancellation noise."""
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()) + 1e-4, err


@pytest.mark.parametrize("b,s,h", TRAIN_CASES)
def test_mla_train_kernels(dev, b, s, h):
    gen = torch.Generator(device=dev).manual_seed(b * 1000 + s + h)
    x = _train_inputs(gen, dev, b, s, h)
    sc = 1 / math.sqrt(192)
    before = [f.launches for f in (mt.mla_flash_fwd, mt.mla_flash_bwd_dq, mt.mla_flash_bwd_dk)]
    out, lse = mt.mla_flash_fwd(*x, sc)
    out2, lse2 = mt.mla_flash_fwd(*x, sc)
    out_p, lse_p = mt.mla_flash_fwd_plain(*x, sc)
    out_t, lse_t = mt.mla_flash_fwd_tiled_plain(*x, sc)
    do = torch.randn((b, s, h, 512), generator=gen, device=dev).to(torch.bfloat16)
    delta = (do.float() * out_p.float()).sum(-1)
    args = (*x, do, lse_p, delta, sc)
    dq, dq_p = mt.mla_flash_bwd_dq(*args), mt.mla_flash_bwd_dq_plain(*args)
    dk, dk_p = mt.mla_flash_bwd_dk(*args), mt.mla_flash_bwd_dk_plain(*args)
    dq2, dk2 = mt.mla_flash_bwd_dq(*args), mt.mla_flash_bwd_dk(*args)
    torch.cuda.synchronize()
    after = [f.launches for f in (mt.mla_flash_fwd, mt.mla_flash_bwd_dq, mt.mla_flash_bwd_dk)]
    assert after == [before[0] + 2, before[1] + 2, before[2] + 2]
    assert torch.equal(out2, out) and torch.equal(lse2, lse)   # K14a is deterministic
    assert all(torch.equal(a, w) for a, w in zip((*dq2, *dk2), (*dq, *dk)))  # so are K14b / K14c
    for want, want_lse in ((out_p, lse_p), (out_t, lse_t)):
        torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    dq_t = mt.mla_flash_bwd_dq_tiled_plain(*args)
    dk_t = mt.mla_flash_bwd_dk_tiled_plain(*args, _dk_bands(dev, b, s, h))
    for got, want in zip((*dq, *dk) * 2, (*dq_p, *dk_p, *dq_t, *dk_t)):
        assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
        _grad_close(got, want)


def _dk_bands(dev, b, s, h):
    return mt.dk_bands(b, s, h, torch.cuda.get_device_properties(dev).multi_processor_count)


def test_mla_train_backward_repeats_at_long_context(dev):
    """K14b / K14c at B 1 x S 4096 x 128 heads, where K14c adds the most
    partials a key chunk (64 bands): two calls bit-identical, both within the
    tolerance of their tiled mirrors (the plain versions' [H, S, S] scores
    take ~35 GB)."""
    b, s, h = 1, 4096, 128
    gen = torch.Generator(device=dev).manual_seed(4096)
    x = _train_inputs(gen, dev, b, s, h)
    sc = 1 / math.sqrt(192)
    out, lse = mt.mla_flash_fwd(*x, sc)
    do = torch.randn((b, s, h, 512), generator=gen, device=dev).to(torch.bfloat16)
    delta = (do.float() * out.float()).sum(-1)
    args = (*x, do, lse, delta, sc)
    got = [(*mt.mla_flash_bwd_dq(*args), *mt.mla_flash_bwd_dk(*args)) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(*got))
    want = (*mt.mla_flash_bwd_dq_tiled_plain(*args),
            *mt.mla_flash_bwd_dk_tiled_plain(*args, _dk_bands(dev, b, s, h)))
    for a, w in zip(got[0], want):
        assert bool(torch.isfinite(a.float()).all())
        _grad_close(a, w)


def test_mla_flash_train_function_matches_plain(dev):
    """The autograd Function on the kernels against ``plain=True``: out and
    the four gradients of (out . G).sum()."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = _train_inputs(gen, dev, 2, 96, 32)
    go = torch.randn((2, 96, 32, 512), generator=gen, device=dev).to(torch.bfloat16)
    res = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in x]
        out = mt.mla_flash_train(*leaves, 0.07, plain=plain)
        (out.float() * go.float()).sum().backward()
        res.append([out] + [t.grad for t in leaves])
    torch.testing.assert_close(res[0][0].float(), res[1][0].float(), atol=2e-2, rtol=2e-2)
    for got, want in zip(res[0][1:], res[1][1:]):
        _grad_close(got, want)


def test_mla_train_kernels_reject_what_they_do_not_take(dev):
    """f32 and other widths raise ValueError on the card (ROADMAP §C)."""
    x = [t.float() for t in _train_inputs(torch.Generator(device=dev).manual_seed(0), dev, 1,
                                           8, 4)]
    with pytest.raises(ValueError, match="bf16"):
        mt.mla_flash_fwd(*x, 0.1)
    narrow = [t[..., :256].contiguous().to(torch.bfloat16) for t in x]
    with pytest.raises(ValueError, match="latent 512"):
        mt.mla_flash_fwd(*narrow, 0.1)


def test_deepseek_train_step_kernels_match_plain(dev):
    """A small bf16 DeepSeek-V3 (latent 512 + 64, 16 heads, 8 experts) through
    ``loss_and_grads(flash=True)`` on the kernels against ``plain=True``, the
    routing of the kernel run replayed: the loss within 1e-2 relative, each
    gradient leaf within 2e-2 of its largest value."""
    from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as m

    cfg = m.DeepSeekV3Config(vocab_size=256, hidden=256, num_layers=1, num_heads=16,
                             kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=32, q_lora_rank=128,
                             v_head_dim=32, num_experts=8, topk=2, moe_intermediate=64)
    params = m.init_weights(cfg, 0, torch.bfloat16, device=dev)
    tokens = torch.randint(0, 256, (2, 40), generator=torch.Generator().manual_seed(1)).to(dev)
    chosen, routed = [], m._routed
    m._routed = lambda ids: chosen.append(ids) or ids
    try:
        before = mt.mla_flash_bwd_dk.launches
        lk, gk = m.loss_and_grads(cfg, params, tokens, flash=True)
        assert mt.mla_flash_bwd_dk.launches == before + 1
        replay = iter(chosen)
        m._routed = lambda ids: next(replay)
        lp, gp = m.loss_and_grads(cfg, params, tokens, flash=True, plain=True)
    finally:
        m._routed = routed
    assert abs(float(lk) - float(lp)) <= 1e-2 * abs(float(lp))
    for a, b in zip(m._flatten(gk), m._flatten(gp)):
        if b.any():
            _grad_close(a, b, 2e-2)


# ---------------------------------------------------------------------------
# the expert-parallel MoE on one NCCL rank (K8a's bf16 modes)
# ---------------------------------------------------------------------------

def _nccl_group():
    """This process's default group: one NCCL rank over an in-process store."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    return dist.group.WORLD

def test_gpt_oss_ep_steps_kernels_match_plain(dev):
    """A small GPT-OSS with ``ep_buffer`` (a one-rank NCCL group): a 40-token
    prefill then a decode step through the kernels (K8a ``none`` twice a
    layer a call) against ``plain=True``, the routing replayed, within 3e-2
    of a row's largest value; no drops at the exact capacity."""
    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.models import gpt_oss as g
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer

    cfg = g.GptOssConfig(vocab_size=256, hidden=256, num_layers=2, num_heads=16,
                         num_kv_heads=2, head_dim=64, intermediate=256, sliding_window=16,
                         num_experts=8, topk=2, attention_bias=True)
    params = g.init_weights(cfg, 0, torch.bfloat16, device=dev, bias_scale=0.02)
    buf = Buffer(_nccl_group(), num_experts=8, config=EPConfig())
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((41, cfg.hidden), generator=gen, device=dev).to(torch.bfloat16)
    bt = torch.arange(1, 5, dtype=torch.int32, device=dev)[None, :]
    pos = torch.arange(41, device=dev)
    slots = (bt[0, pos // 16] * 16 + pos % 16).to(torch.int32)
    one = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)  # noqa: E731

    def run(plain):
        caches = g.init_kv_cache(cfg, 5, torch.bfloat16, device=dev)
        y, _ = g.prefill_step(cfg, params, x[:40], one(40), caches, bt, one(40), slots[:40],
                              max_q=40, plain=plain, ep_buffer=buf)
        d, _ = g.decode_step(cfg, params, x[40:], pos[40:], caches, bt, one(41), slots[40:],
                             plain=plain, ep_buffer=buf)
        return torch.cat([y, d]).float()

    record, router = [], g._router
    try:
        g._router = lambda c, lw, h: record.append(router(c, lw, h)) or record[-1]
        before = grouped_matmul.grouped_matmul_float.launches
        got = run(False)
        assert grouped_matmul.grouped_matmul_float.launches == before + 2 * 2 * cfg.num_layers
        replay = iter(record)
        g._router = lambda c, lw, h: next(replay)
        want = run(True)
    finally:
        g._router = router
    torch.cuda.synchronize()
    rel = (got - want).abs().amax(-1) / want.abs().amax(-1)
    assert bool(torch.isfinite(got).all()) and float(rel.max()) < 3e-2, float(rel.max())


def test_deepseek_ep_train_step_kernels_match_plain(dev):
    """A small bf16 DeepSeek-V3 through ``loss_and_grads(mesh=<one NCCL
    rank>, flash=True)``: K8a ``none`` and ``rhs_contract_last`` three times
    each, against ``plain=True`` with the routing replayed; the loss within
    1e-2 relative, each gradient leaf within 2e-2 of its largest value."""
    from torch.distributed.device_mesh import init_device_mesh

    from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as m

    cfg = m.DeepSeekV3Config(vocab_size=256, hidden=256, num_layers=1, num_heads=16,
                             kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=32, q_lora_rank=128,
                             v_head_dim=32, num_experts=8, topk=2, moe_intermediate=64)
    params = m.init_weights(cfg, 0, torch.bfloat16, device=dev)
    tokens = torch.randint(0, 256, (2, 40), generator=torch.Generator().manual_seed(1)).to(dev)
    _nccl_group()
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("dp", "ep"))
    chosen, routed = [], m._routed
    m._routed = lambda ids: chosen.append(ids) or ids
    try:
        before = (grouped_matmul.grouped_matmul_float.launches,
                  grouped_matmul.grouped_matmul_dx.launches)
        lk, gk = m.loss_and_grads(cfg, params, tokens, mesh=mesh, flash=True)
        assert (grouped_matmul.grouped_matmul_float.launches,
                grouped_matmul.grouped_matmul_dx.launches) == (before[0] + 3, before[1] + 3)
        replay = iter(chosen)
        m._routed = lambda ids: next(replay)
        lp, gp = m.loss_and_grads(cfg, params, tokens, mesh=mesh, flash=True, plain=True)
    finally:
        m._routed = routed
    assert abs(float(lk) - float(lp)) <= 1e-2 * abs(float(lp))
    for a, b in zip(m._flatten(gk), m._flatten(gp)):
        if b.any():
            _grad_close(a, b, 2e-2)


# ---------------------------------------------------------------------------
# the window all-to-alls (K15a-c) and the single-kernel MoE (K16b)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((1, 300, 7168), torch.int8), ((1, 5, 3), torch.float32),
                                         ((1, 1, 256), torch.int32)],
                         ids=["rows", "thin", "counts"])
def test_pallas_all_to_all_kernel(dev, shape, dtype):
    """K15a on one rank (its own only peer) against ``all_to_all_single``
    on the NCCL group: bit-exact."""
    from sgl_kernel_npu_tpu_torch.parallel import pallas_a2a as pa

    group = _nccl_group()
    x = torch.randint(-100, 100, shape, device=dev).to(dtype)
    before = pa.pallas_all_to_all.launches
    got = pa.pallas_all_to_all(x, group=group)
    want = pa.pallas_all_to_all_plain(x, group=group)
    torch.cuda.synchronize()
    assert pa.pallas_all_to_all.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("count,chunk", [(0, 32), (1, 32), (77, 32), (300, 32), (300, 7)])
def test_pallas_ragged_all_to_all_kernel(dev, count, chunk):
    """K15b: the live rows and the counts bit-exact, counts 0 and full, for
    int8 rows and a two-column int32 blob."""
    from sgl_kernel_npu_tpu_torch.parallel import pallas_a2a as pa

    group = _nccl_group()
    counts = torch.tensor([count], dtype=torch.int32, device=dev)
    for x in (torch.randint(-128, 128, (1, 300, 7168), device=dev).to(torch.int8),
              torch.randint(-2**30, 2**30, (1, 300, 2), device=dev).to(torch.int32)):
        before = pa.pallas_ragged_all_to_all.launches
        got, rc = pa.pallas_ragged_all_to_all(x, counts, group=group, chunk_rows=chunk)
        want, wrc = pa.pallas_ragged_all_to_all_plain(x, counts, group=group)
        torch.cuda.synchronize()
        assert pa.pallas_ragged_all_to_all.launches == before + 1
        assert torch.equal(rc, wrc) and int(rc[0]) == count
        assert torch.equal(got[0, :count], want[0, :count])


@pytest.mark.parametrize("nbytes", [65535, 65536, 65537, 300 * 1024])
def test_pallas_all_to_all_one_block_threshold(dev, nbytes):
    """K15a just below, at and just above one chunk (64 KB, the one-block
    launch) and at several blocks: bit-exact against ``all_to_all_single``."""
    from sgl_kernel_npu_tpu_torch.parallel import pallas_a2a as pa

    group = _nccl_group()
    x = torch.randint(-128, 128, (1, nbytes), device=dev).to(torch.int8)
    assert (pa.a2a_blocks(1, nbytes, pa.FIXED_CHUNK) == 1) == (nbytes <= pa.FIXED_CHUNK)
    got = pa.pallas_all_to_all(x, group=group)
    want = pa.pallas_all_to_all_plain(x, group=group)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows", [31, 32, 33])
def test_pallas_ragged_all_to_all_one_block_threshold(dev, rows):
    """K15b at a capacity just below, at and just above one chunk of 32 rows
    (the one-block launch), full and short counts: bit-exact."""
    from sgl_kernel_npu_tpu_torch.parallel import pallas_a2a as pa

    group = _nccl_group()
    x = torch.randint(-128, 128, (1, rows, 7168), device=dev).to(torch.int8)
    for count in (rows, rows - 1):
        c = torch.tensor([count], dtype=torch.int32, device=dev)
        got, rc = pa.pallas_ragged_all_to_all(x, c, group=group, chunk_rows=32)
        want, wrc = pa.pallas_ragged_all_to_all_plain(x, c, group=group)
        torch.cuda.synchronize()
        assert torch.equal(rc, wrc) and torch.equal(got[0, :count], want[0, :count])


def test_monitored_kernel_stats_and_timeout(dev):
    """K15c: without a fault the rows arrive and the statistics read no
    timeout (col 3 = col 0, cols 1, 2, 4, 5 zero); with this rank muted the
    wait returns after ``max_poll_rounds`` polls with the timeout and
    missing-payload flags set and count 0; the next call runs normally."""
    from sgl_kernel_npu_tpu_torch.parallel import pallas_a2a as pa

    group = _nccl_group()
    x = torch.randint(-128, 128, (1, 64, 512), device=dev).to(torch.int8)
    counts = torch.tensor([40], dtype=torch.int32, device=dev)
    got, rc, st = pa.pallas_ragged_all_to_all(x, counts, group=group, monitor=True)
    torch.cuda.synchronize()
    assert int(rc[0]) == 40 and torch.equal(got[0, :40], x[0, :40])
    assert int(st[0, 3]) == int(st[0, 0]) and not st[0, [1, 2, 4, 5]].any()
    _, rc, st = pa.pallas_ragged_all_to_all(x, counts, group=group, monitor=True,
                                            max_poll_rounds=1000, inject_send_fault=True)
    torch.cuda.synchronize()
    assert int(rc[0]) == 0 and st[0].tolist() == [1000, 1, 0, 1000, 1, 0]
    got, rc = pa.pallas_ragged_all_to_all(x, counts, group=group)
    torch.cuda.synchronize()
    assert int(rc[0]) == 40 and torch.equal(got[0, :40], x[0, :40])


def _deep_moe_inputs(gen, dev, t, e=32, k=8, h=512, i=256, dead=0.0):
    from sgl_kernel_npu_tpu_torch.parallel.fused_moe import quantize_expert_weights

    w = quantize_expert_weights(*(torch.randn(s, generator=gen, device=dev) * 0.05
                                  for s in ((e, h, i), (e, h, i), (e, i, h))))
    x = torch.randn((t, h), generator=gen, device=dev).to(torch.bfloat16)
    idx = torch.argsort(torch.rand((t, e), generator=gen, device=dev), dim=-1)[:, :k]
    idx = idx.to(torch.int32)
    idx[torch.rand(idx.shape, generator=gen, device=dev) < dead] = -1
    return x, idx, torch.rand((t, k), generator=gen, device=dev), w


@pytest.mark.parametrize("t,dead", [(1, 0.0), (6, 0.0), (100, 0.2), (300, 0.0)])
def test_fused_full_kernel_matches_plain_and_unfused(dev, t, dead):
    """K16b on one NCCL rank against its plain version (counts and drops
    exact, ``combined`` within 1e-2 of a row's largest |value|) and against
    the unfused ``fused_deep_moe`` on the window transport (relative mean
    difference < 4e-4, JAX's bar); empty experts and inactive slots."""
    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.parallel import fused_full
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer

    gen = torch.Generator(device=dev).manual_seed(t)
    x, idx, tw, w = _deep_moe_inputs(gen, dev, t, dead=dead)
    buf = Buffer(_nccl_group(), 32, EPConfig(comm_backend="pallas_ragged"))
    before = fused_full.fused_deep_moe_full_rank.launches
    got, cnt, drop = buf.fused_deep_moe(x, idx, tw, *w, single_kernel=True)
    want, wcnt, wdrop = buf.fused_deep_moe(x, idx, tw, *w, single_kernel=True, plain=True)
    unf, ucnt, _ = buf.fused_deep_moe(x, idx, tw, *w)
    torch.cuda.synchronize()
    assert fused_full.fused_deep_moe_full_rank.launches == before + 1
    assert torch.equal(cnt, wcnt) and torch.equal(cnt, ucnt) and int(drop) == int(wdrop) == 0
    err = (got.float() - want.float()).abs().amax(-1) / want.float().abs().amax(-1).clamp_min(1e-6)
    assert float(err.max()) <= 1e-2, float(err.max())
    rel = float((got.float() - unf.float()).abs().mean() / unf.float().abs().mean())
    assert rel < 4e-4, rel


def _k16b_and_walk(buf, x, idx, tw, w, tn):
    """K16b through ``Buffer.fused_deep_moe(single_kernel=True)`` at pack
    width ``tn`` and its tiled walk on the card, on the same wire quant and
    layout."""
    from sgl_kernel_npu_tpu_torch.ops.quant import wire_quant
    from sgl_kernel_npu_tpu_torch.parallel import fused_full

    got, cnt, drop = buf.fused_deep_moe(x, idx, tw, *w, pack_tn=tn, single_kernel=True)
    seg = max(buf.config.num_max_dispatch_tokens_per_rank, x.shape[0])
    _, lay = fused_full.full_layout(idx, group=buf.group, num_experts=buf.num_experts,
                                    num_ranks=1, seg_capacity=seg)
    want = fused_full.fused_deep_moe_full_tiled_plain(*wire_quant(x), tw, *w, lay, tn=tn,
                                                      group=buf.group)
    return got, want, cnt, lay


@pytest.mark.parametrize("tn", [512, 128, 64], ids=["full", "tn128", "tn64"])
@pytest.mark.parametrize("t,dead", [(3, 0.0), (300, 0.3)])
def test_fused_full_kernel_bit_equal_to_tiled_walk(dev, t, dead, tn):
    """K16b at the full gate / up packing and two narrower ones, bit-equal
    to its tiled walk on the card (the walk's operations are the kernel's:
    exact sums, CUDA's ``expf``, true divisions, the reduce's fused
    multiply-add), and within 4e-4 (relative mean) of the unfused form;
    experts of 0 to ~150 rows, dead slots."""
    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer
    from sgl_kernel_npu_tpu_torch.ops.grouped_matmul import pack_gmm1_scales, pack_gmm1_weights

    gen = torch.Generator(device=dev).manual_seed(t + tn)
    x, idx, tw, w = _deep_moe_inputs(gen, dev, t, dead=dead)
    if tn != 512:                                      # repack gate / up at width tn
        i = w[0].shape[-1] // 2
        w1, s1 = w[0], w[1]
        w = [pack_gmm1_weights(w1[..., :i], w1[..., i:], tn),
             pack_gmm1_scales(s1[..., :i], s1[..., i:], tn), w[2], w[3]]
    buf = Buffer(_nccl_group(), 32, EPConfig(comm_backend="pallas_ragged"))
    got, want, cnt, _ = _k16b_and_walk(buf, x, idx, tw, w, tn)
    unf, ucnt, _ = buf.fused_deep_moe(x, idx, tw, *w, pack_tn=tn)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(cnt, ucnt)
    rel = float((got.float() - unf.float()).abs().mean() / unf.float().abs().mean())
    assert rel < 4e-4, rel


def test_fused_full_kernel_repeats_and_reads_this_calls_window(dev):
    """Calls on inputs A, B, A, C: the two A calls bit-identical; B and C (C
    in the window half B used, two epochs on) bit-equal to the tiled walk
    of their own inputs: no TMA read sees a row of an earlier call."""
    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer

    gen = torch.Generator(device=dev).manual_seed(77)
    buf = Buffer(_nccl_group(), 32, EPConfig(comm_backend="pallas_ragged"))
    cases = [_deep_moe_inputs(gen, dev, 200) for _ in range(3)]
    w = cases[0][3]
    runs = [_k16b_and_walk(buf, *cases[c][:3], w, 512) for c in (0, 1, 0, 2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[2][0])
    for got, want, _, _ in runs:
        assert torch.equal(got, want)
    assert not torch.equal(runs[1][0], runs[3][0])


def test_fused_full_kernel_phase_stamps(dev):
    """``phase_stamps`` takes each block's 11 phase times (``%globaltimer``),
    in order within a block, and leaves the output as without them."""
    from sgl_kernel_npu_tpu_torch.parallel import fused_full

    gen = torch.Generator(device=dev).manual_seed(11)
    x, idx, tw, w = _deep_moe_inputs(gen, dev, 50)
    kw = dict(group=_nccl_group(), num_experts=32, num_ranks=1, seg_capacity=50)
    st = torch.zeros((fused_full.fused_full_blocks(), fused_full.PHASE_STAMPS),
                     dtype=torch.int64, device=dev)
    got = fused_full.fused_deep_moe_full_rank(x, idx, tw, *w, phase_stamps=st, **kw)[0]
    want = fused_full.fused_deep_moe_full_rank(x, idx, tw, *w, **kw)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((st > 0).all()) and bool((st.diff(dim=1) >= 0).all())


def test_fused_full_kernel_refuses_what_it_does_not_take(dev):
    """K16b takes H % 128 == 0 and I % 64 == 0 (the plain version on the
    CPU takes any width)."""
    from sgl_kernel_npu_tpu_torch.parallel import fused_full

    gen = torch.Generator(device=dev).manual_seed(1)
    x, idx, tw, w = _deep_moe_inputs(gen, dev, 4, e=4, k=2, h=192, i=64)
    with pytest.raises(ValueError, match="H % 128"):
        fused_full.fused_deep_moe_full_rank(x, idx, tw, *w, group=_nccl_group(), num_experts=4,
                                            num_ranks=1, seg_capacity=4)


def test_two_processes_on_one_card(dev, tmp_path):
    """Two processes on the one card, ranks of a gloo group over a
    ``FileStore``: each opens the other's window by CUDA IPC and runs K15a
    (the per-expert counts on one block, a payload on several), K15b, K16b
    and K16a, held to the plain versions of the same two-rank exchange on the
    CPU (``tests/_torch_ipc_ranks.py``)."""
    import os
    import pathlib
    import subprocess
    import sys

    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(here.parent), OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen([sys.executable, str(here / "_torch_ipc_ranks.py"), str(tmp_path),
                               str(r)], cwd=here.parent, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
        assert "ok" in log, log[-3000:]


# --- K8a's remaining modes, K8b, K3 on float tokens, K16a -----------------------------

_MODE_SIZES = [((0, 5, 0, 17, 1, 0, 40, 1), 80, 1024, 256), ((0, 1, 0, 0), 1, 256, 128),
               ((3, 0, 70, 9), 100, 336, 160), ((130, 64, 65, 0, 200), 500, 512, 512)]


def _int8_case(gen, dev, sizes, s, k, n):
    g = len(sizes)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    x = torch.randint(-127, 128, (s, k), generator=gen, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (g, k, n), generator=gen, device=dev, dtype=torch.int8)
    sx = torch.rand(s, generator=gen, device=dev) / 50 + 1e-3
    sw = torch.rand((g, n), generator=gen, device=dev) / 500 + 1e-4
    return x, w, gs, sx, sw


@pytest.mark.parametrize("mode", ["none-f32", "none-bf16", "none-f16", "dequant-f32",
                                  "dequant-f16", "swiglu-f32-full", "swiglu-bf16-tn64",
                                  "swiglu-f32-tn32"])
@pytest.mark.parametrize("sizes,s,k,i", _MODE_SIZES)
def test_grouped_matmul_remaining_modes_kernel(dev, sizes, s, k, i, mode):
    """K8a's int8 ``none`` (exact sums to f32 / bf16 / f16: bit-equal),
    ``dequant`` to f32 / f16 (the same f32 operations: bit-equal) and
    ``dequant_swiglu`` at
    full width and at pack widths 64 / 32 (f32 within 1e-5 of the largest
    |value|: the SiLU's exp; bf16 within one ulp) against the plain version;
    rows past the total zero; one launch each, counted under its mode."""
    gen = torch.Generator(device=dev).manual_seed(len(sizes) + s)
    x, w, gs, sx, sw = _int8_case(gen, dev, sizes, s, k, 2 * i)
    epi, dt, *tn = mode.split("-")
    kw = {"epilogue": {"swiglu": "dequant_swiglu"}.get(epi, epi),
          "out_dtype": {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[dt]}
    if tn:
        kw["tn"] = 2 * i if tn[0] == "full" else int(tn[0][2:])
    key = {"none": "none_int8", "dequant": "dequant_f32", "swiglu": "dequant_swiglu"}[epi]
    before = grouped_matmul.grouped_matmul.modes[key]
    got = grouped_matmul.grouped_matmul(x, w, gs, sx, sw, **kw)
    want = grouped_matmul.grouped_matmul_plain(x, w, gs, sx, sw, **kw)
    torch.cuda.synchronize()
    assert grouped_matmul.grouped_matmul.modes[key] == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    total = sum(sizes)
    assert not got[total:].any()
    if epi in ("none", "dequant"):
        assert torch.equal(got, want)
    elif dt == "f32":
        assert max_abs(got, want) <= 1e-5 * float(want.abs().max().clamp_min(1e-30))
    else:
        rel = (got.float() - want.float()).abs() / want.float().abs().clamp_min(1e-30)
        assert float(rel[:total].max()) <= 2 ** -7 if total else True


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def test_grouped_matmul_int8_rhs_contract_last_kernel(dev):
    """Int8 ``none`` with ``rhs_contract_last`` (``w [G, N, K]``) on the
    card: bit-equal to the plain version (exact sums)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x, w, gs, _, _ = _int8_case(gen, dev, (3, 0, 70, 9), 100, 336, 160)
    wt = w.transpose(1, 2).contiguous()
    got = grouped_matmul.grouped_matmul(x, wt, gs, rhs_contract_last=True)
    want = grouped_matmul.grouped_matmul_plain(x, wt, gs, rhs_contract_last=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# K8a's int8 kernel at DeepSeek-V3's K: groups of one, two and three 128-row
# items, rows past the total
_WIDE_SIZES = ((100, 0, 129, 257, 1), 500, 7168)


@pytest.mark.parametrize("tn", [32, 1024, 4096], ids=["tn32", "tn1024", "full"])
def test_grouped_matmul_pack_widths_kernel(dev, tn):
    """``dequant_swiglu`` to f32 at N = 4096 packed at widths 32 (a 64-column
    gate half of four slabs: boxes of 16 columns), 1024 and full, within
    1e-5 of the largest |value| of the plain version (the SiLU's exp); the
    full width's activation equals ``dequant_swiglu_quant``'s before the
    requant (the same tile and epilogue: its scales and levels match the
    plain version's within one level)."""
    gen = torch.Generator(device=dev).manual_seed(tn)
    sizes, s, k = _WIDE_SIZES
    x, w, gs, sx, sw = _int8_case(gen, dev, sizes, s, k, 4096)
    kw = dict(epilogue="dequant_swiglu", tn=tn, out_dtype=torch.float32)
    got = grouped_matmul.grouped_matmul(x, w, gs, sx, sw, **kw)
    want = grouped_matmul.grouped_matmul_plain(x, w, gs, sx, sw, **kw)
    torch.cuda.synchronize()
    total = sum(sizes)
    assert not got[total:].any()
    assert max_abs(got, want) <= 1e-5 * float(want.abs().max())
    if tn == 4096:
        h1, hs = grouped_matmul.grouped_matmul(x, w, gs, sx, sw, epilogue="dequant_swiglu_quant")
        h1_p, hs_p = grouped_matmul.grouped_matmul_plain(x, w, gs, sx, sw,
                                                         epilogue="dequant_swiglu_quant")
        torch.cuda.synchronize()
        assert int((h1.int() - h1_p.int()).abs().max()) <= 1
        torch.testing.assert_close(hs, hs_p, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [2880, 4096])
def test_grouped_matmul_int8_contract_last_and_dispatch_wide_kernel(dev, n):
    """Int8 ``rhs_contract_last`` (``w [G, N, K]`` read K-major as stored,
    no transposed copy) bit-equal to the plain version, and ``dispatch_p``
    bit-equal to the gathered rows, on 128-row items at K = 7168."""
    gen = torch.Generator(device=dev).manual_seed(n)
    sizes, s, k = _WIDE_SIZES
    x, w, gs, sx, sw = _int8_case(gen, dev, sizes, s, k, n)
    wt = w.transpose(1, 2).contiguous()
    got = grouped_matmul.grouped_matmul(x, wt, gs, rhs_contract_last=True)
    want = grouped_matmul.grouped_matmul_plain(x, wt, gs, rhs_contract_last=True)
    n_tok = 40
    xt = torch.randint(-127, 128, (n_tok, k), generator=gen, device=dev, dtype=torch.int8)
    tok = torch.randint(0, n_tok + 1, (s,), generator=gen, device=dev, dtype=torch.int32)
    p = grouped_matmul.dispatch_onehot(tok, n_tok)
    gathered = torch.where((tok < n_tok)[:, None], xt[tok.clamp(max=n_tok - 1).long()], 0)
    kw = dict(epilogue="dequant", out_dtype=torch.float32)
    a = grouped_matmul.grouped_matmul(xt, w, gs, sx, sw, dispatch_p=p, **kw)
    b = grouped_matmul.grouped_matmul(gathered.contiguous(), w, gs, sx, sw, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["none", "dequant", "dequant-f32", "swiglu-tn64",
                                  "swiglu_quant", "dispatch_p", "contract_last"])
def test_grouped_matmul_int8_repeats_bit_identical(dev, mode):
    """Two runs of each int8 mode give the same bits (exact sums; each output
    has one owner; the requant's per-row atomicMax is order-free)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    sizes, s, k = _WIDE_SIZES
    x, w, gs, sx, sw = _int8_case(gen, dev, sizes, s, 1024, 512)
    kw = {"none": dict(epilogue="none"), "dequant": dict(epilogue="dequant"),
          "dequant-f32": dict(epilogue="dequant", out_dtype=torch.float32),
          "swiglu-tn64": dict(epilogue="dequant_swiglu", tn=64),
          "swiglu_quant": dict(epilogue="dequant_swiglu_quant"),
          "dispatch_p": dict(epilogue="dequant_swiglu_quant",
                             dispatch_p=grouped_matmul.dispatch_onehot(
                                 torch.randint(0, s, (s,), generator=gen, device=dev,
                                               dtype=torch.int32), s)),
          "contract_last": dict(rhs_contract_last=True)}[mode]
    if mode == "contract_last":
        w = w.transpose(1, 2).contiguous()
    runs = [grouped_matmul.grouped_matmul(x, w, gs, sx, sw, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*(r if isinstance(r, tuple) else (r,) for r in runs)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("epilogue", ["dequant_swiglu_quant", "dequant", "none"])
@pytest.mark.parametrize("sizes,s,k,i", _MODE_SIZES[:3])
def test_grouped_matmul_dispatch_p_kernel(dev, sizes, s, k, i, epilogue):
    """``dispatch_p``: the one-hot P of ``dispatch_onehot`` (a pad id gives
    a zero row) into K8a equals K8a on the gathered rows bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(s)
    _, w, gs, sx, sw = _int8_case(gen, dev, sizes, s, k, 2 * i)
    n_tok = 9
    x = torch.randint(-127, 128, (n_tok, k), generator=gen, device=dev, dtype=torch.int8)
    tok = torch.randint(0, n_tok + 1, (s,), generator=gen, device=dev, dtype=torch.int32)
    p = grouped_matmul.dispatch_onehot(tok, n_tok)
    gathered = torch.where((tok < n_tok)[:, None], x[tok.clamp(max=n_tok - 1).long()], 0)
    before = grouped_matmul.grouped_matmul.modes["dispatch_p"]
    got = grouped_matmul.grouped_matmul(x, w, gs, sx, sw, epilogue=epilogue, dispatch_p=p)
    want = grouped_matmul.grouped_matmul(gathered.contiguous(), w, gs, sx, sw, epilogue=epilogue)
    plain = grouped_matmul.grouped_matmul_plain(x, w, gs, sx, sw, epilogue=epilogue,
                                                dispatch_p=p)
    torch.cuda.synchronize()
    assert grouped_matmul.grouped_matmul.modes["dispatch_p"] == before + 1
    for a, b, c in zip(*(v if isinstance(v, tuple) else (v,) for v in (got, want, plain))):
        assert torch.equal(a, b)
        assert max_abs(a, c) <= (1 if a.dtype == torch.int8 else
                                 2 ** -7 * float(c.float().abs().max().clamp_min(1e-30)))


@pytest.mark.parametrize("sizes,k,n,n_tok", [((0, 40, 1, 0, 70), 96, 136, 20),
                                              ((130, 0, 65, 128), 520, 2880, 300)],
                         ids=["small", "items-of-128"])
@pytest.mark.parametrize("contract_last", [False, True])
def test_grouped_matmul_bf16_out_and_dispatch_kernel(dev, contract_last, sizes, k, n, n_tok):
    """K8a's bf16 modes to a bf16 and an f16 output (the f32 output rounded)
    and with a bf16 ``dispatch_p`` (bit-equal to the gathered rows), on
    small groups and on groups of one and two 128-row items at GPT-OSS's
    N = 2880 and a partial k stage."""
    gen = torch.Generator(device=dev).manual_seed(3)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    s = sum(sizes) + 7
    x = torch.randn((n_tok, k), generator=gen, device=dev).to(torch.bfloat16)
    shape = (len(sizes), n, k) if contract_last else (len(sizes), k, n)
    w = (torch.randn(shape, generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
    tok = torch.randint(0, n_tok, (s,), generator=gen, device=dev, dtype=torch.int32)
    fn = grouped_matmul.grouped_matmul_dx if contract_last else grouped_matmul.grouped_matmul_float
    rows = x[tok.long()].contiguous()
    f32 = fn(rows, w, gs)
    b16 = fn(rows, w, gs, out_dtype=torch.bfloat16)
    f16 = fn(rows, w, gs, out_dtype=torch.float16)
    disp = fn(x, w, gs, dispatch_p=grouped_matmul.dispatch_onehot(tok, n_tok, torch.bfloat16))
    want = grouped_matmul.grouped_matmul_float_plain(rows, w, gs, rhs_contract_last=contract_last)
    torch.cuda.synchronize()
    assert float((f32 - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-6
    assert not f32[sum(sizes):].any()
    assert b16.dtype == torch.bfloat16 and torch.equal(b16, f32.to(torch.bfloat16))
    assert f16.dtype == torch.float16 and torch.equal(f16, f32.to(torch.float16))
    assert torch.equal(disp, f32)


@pytest.mark.parametrize("p_kind", ["two-nonzeros", "value-2", "bf16-value-half"])
def test_grouped_matmul_dispatch_p_not_one_hot_raises_on_card(dev, p_kind):
    """The card's ``dispatch_p`` prologue finds each row's token instead of
    multiplying, so a P with a row that is neither one-hot nor zero raises
    (the plain version computes ``P @ x`` for any P); a one-hot P with zero
    rows passes."""
    gen = torch.Generator(device=dev).manual_seed(13)
    sizes, s, k, i = (3, 0, 5), 8, 64, 32
    _, w, gs, sx, sw = _int8_case(gen, dev, sizes, s, k, 2 * i)
    n_tok = 4
    tok = torch.tensor([0, 1, 2, 3, 4, 0, 1, 4], dtype=torch.int32, device=dev)   # 4: zero rows
    if p_kind.startswith("bf16"):
        x = torch.randn((n_tok, k), generator=gen, device=dev).to(torch.bfloat16)
        wb = torch.randn((len(sizes), k, 2 * i), generator=gen, device=dev).to(torch.bfloat16)
        p = grouped_matmul.dispatch_onehot(tok, n_tok, torch.bfloat16)
        grouped_matmul.grouped_matmul_float(x, wb, gs, dispatch_p=p)
        p[2, 2] = 0.5
        with pytest.raises(ValueError, match="one-hot"):
            grouped_matmul.grouped_matmul_float(x, wb, gs, dispatch_p=p)
        return
    x = torch.randint(-127, 128, (n_tok, k), generator=gen, device=dev, dtype=torch.int8)
    p = grouped_matmul.dispatch_onehot(tok, n_tok)
    grouped_matmul.grouped_matmul(x, w, gs, sx, sw, epilogue="dequant", dispatch_p=p)
    if p_kind == "two-nonzeros":
        p[5, 3] = 1
    else:
        p[1, 1] = 2
    with pytest.raises(ValueError, match="one-hot"):
        grouped_matmul.grouped_matmul(x, w, gs, sx, sw, epilogue="dequant", dispatch_p=p)


def test_grouped_matmul_float_rows_into_epilogue_raise_on_card(dev):
    x = torch.zeros((4, 32), device=dev, dtype=torch.bfloat16)
    w = torch.zeros((1, 32, 32), device=dev, dtype=torch.bfloat16)
    gs = torch.tensor([4], dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        grouped_matmul.grouped_matmul(x, w, gs, torch.ones(4, device=dev),
                                      torch.ones((1, 32), device=dev), epilogue="dequant")


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("sizes,s,n_tok", [((30, 26, 0, 40), 100, 24), ((0, 0, 7, 0), 9, 1),
                                           ((64, 0, 130, 1), 260, 70), ((0, 0, 0, 0), 5, 3),
                                           ((30, 26, 0, 40), 104, 24), ((64, 64, 64, 64), 256, 130),
                                           ((0, 3, 0, 0), 8, 200), ((200, 0, 56, 0), 256, 8)])
def test_grouped_matmul_combine_kernel(dev, sizes, s, n_tok, out_dtype):
    """K8b against its plain version: empty groups, S % 64 != 0, S % 8 != 0
    (the masks gathered by plain loads) and S % 8 == 0 (the masks by TMA, a
    stage straddling the total by plain loads), rows past the total (their
    mask columns weigh nothing), more than 128 tokens, within 1e-5 of the
    largest |value| (exact bf16 products summed in f32 in another order),
    plus one ulp of each value in a bf16 / f16 output; one launch."""
    gen = torch.Generator(device=dev).manual_seed(s)
    k, n = 256, 384
    x, w, gs, sx, sw = _int8_case(gen, dev, sizes, s, k, n)
    mask = torch.rand((n_tok, s), generator=gen, device=dev)
    mask = torch.where(torch.rand((n_tok, s), generator=gen, device=dev) < 0.1, mask, 0.0)
    hi = mask.to(torch.bfloat16)
    lo = (mask - hi.float()).to(torch.bfloat16)
    before = grouped_matmul.grouped_matmul_combine.launches
    got = grouped_matmul.grouped_matmul_combine(x, w, gs, sx, sw, hi, lo, out_dtype=out_dtype)
    want = grouped_matmul.grouped_matmul_combine_plain(x, w, gs, sx, sw, hi, lo,
                                                       out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert grouped_matmul.grouped_matmul_combine.launches == before + 1
    assert got.shape == (n_tok, n) and got.dtype == out_dtype
    ulp = {torch.float32: 0.0, torch.bfloat16: 2 ** -8, torch.float16: 2 ** -11}[out_dtype]
    g, wv = got.float(), want.float()
    excess = (g - wv).abs() - ulp * 2 * wv.abs() - 1e-5 * float(wv.abs().max().clamp_min(1e-30))
    assert float(excess.max()) <= 0 if excess.numel() else True


@pytest.mark.parametrize("sizes,s,n_tok", [((30, 26, 0, 40), 100, 24), ((64, 64, 64, 64), 256, 130),
                                           ((200, 0, 56, 0), 300, 8)])
def test_grouped_matmul_combine_rows_bit_equal_to_k8a_dequant(dev, sizes, s, n_tok):
    """K8b's first pass writes d bit-equal to K8a ``dequant`` to bf16 on the
    same rows (the same ring and epilogue), rows past the total 0; its
    output within 1e-5 of the largest |value| of the mask products of that
    d in f64 (the kernel's f32 sums in another order)."""
    gen = torch.Generator(device=dev).manual_seed(s + n_tok)
    x, w, gs, sx, sw = _int8_case(gen, dev, sizes, s, 256, 384)
    mask = torch.rand((n_tok, s), generator=gen, device=dev)
    hi = mask.to(torch.bfloat16)
    lo = (mask - hi.float()).to(torch.bfloat16)
    out, d = grouped_matmul._combine_launch(x, w, gs, sx, sw, hi, lo, torch.float32)
    want_d = grouped_matmul.grouped_matmul(x, w, gs, sx, sw, epilogue="dequant",
                                           out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(d, want_d)
    total = min(sum(sizes), s)
    ref = (hi[:, :total].double() @ d[:total].double() + lo[:, :total].double()
           @ d[:total].double())
    assert float((out.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_k8b_and_k16a_enqueue_their_kernels_alone(dev):
    """A CUDA graph capture of a K8b call holds its three kernels once each
    (the offsets, the rows, the mask products) and nothing else; of a K16a
    call, its one cooperative kernel."""
    from sgl_kernel_npu_tpu_torch.parallel import fused_kernel
    from sgl_kernel_npu_tpu_torch.utils.trace_profile import graph_kernels

    gen = torch.Generator(device=dev).manual_seed(3)
    x, w, gs, sx, sw = _int8_case(gen, dev, (30, 26, 0, 40), 96, 256, 384)
    hi = torch.rand((24, 96), generator=gen, device=dev).to(torch.bfloat16)
    acts = graph_kernels(lambda: grouped_matmul.grouped_matmul_combine(x, w, gs, sx, sw, hi, hi))
    names = [n for n, _ in acts]
    assert [c for _, c in acts] == [1, 1, 1] and all(
        any(k in n for n in names) for k in ("combine_offsets_kernel", "combine_rows_kernel",
                                             "combine_kernel")), acts
    e, seg, h, n = 4, 70, 512, 256
    xsend = torch.randint(-40, 40, (1, e * seg, h), generator=gen, device=dev, dtype=torch.int8)
    w1 = torch.randint(-40, 40, (e, h, n), generator=gen, device=dev, dtype=torch.int8)
    sw1 = torch.rand((e, n), generator=gen, device=dev) / 100
    sx1 = torch.rand((e, seg), generator=gen, device=dev) / 10 + 0.01
    acts = graph_kernels(lambda: fused_kernel.fused_dispatch_gmm1_rank(
        xsend, w1, sw1, sx1, group=_nccl_group(), num_ranks=1, seg=seg))
    assert len(acts) == 1 and acts[0][1] == 1 and "fused_kernel_kernel" in acts[0][0], acts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gmm1_ring_float_input_kernel(dev, dtype):
    """K3 on float tokens: bit-equal to K5 (``quant_per_token``) then K3 on
    the int8 tokens, a pad row included; counted under its mode."""
    gen = torch.Generator(device=dev).manual_seed(5)
    g, k, n, n_tok = 8, 256, 512, 6
    w1 = torch.randint(-127, 128, (g, k, n), generator=gen, device=dev, dtype=torch.int8)
    s1 = torch.rand((g, n), generator=gen, device=dev) / 100
    gsizes = torch.tensor([0, 2, 0, 0, 3, 0, 1, 0], dtype=torch.int32, device=dev)
    tok = torch.tensor([0, 2, 1, 6, 5, 2], dtype=torch.int32, device=dev)   # 6 = pad (n_tok)
    x = torch.randn((n_tok, k), generator=gen, device=dev).to(dtype)
    before = gmm_ring.gmm1_ring.modes["float_x"]
    h1, hs = gmm_ring.gmm1_ring(x, tok, w1, gsizes, None, s1)
    xq, sx = quant.quant_per_token(x)
    h1_q, hs_q = gmm_ring.gmm1_ring(xq, tok, w1, gsizes, sx, s1)
    torch.cuda.synchronize()
    assert gmm_ring.gmm1_ring.modes["float_x"] == before + 1
    assert torch.equal(h1, h1_q) and torch.equal(hs, hs_q)


@pytest.mark.parametrize("seg,counts", [(8, None), (70, [[0, 5, 70, 1]]), (8, [[8, 0, 3, 2]])])
def test_fused_dispatch_gmm1_rank_kernel(dev, seg, counts):
    """K16a on one rank (the window's own sends) against its plain version
    within one bf16 ulp of each value (exact int sums, the same two f32
    scale products); rows past a segment's count exactly 0; one launch."""
    from sgl_kernel_npu_tpu_torch.parallel import fused_kernel

    gen = torch.Generator(device=dev).manual_seed(seg)
    e, h, n = 4, 512, 256
    xsend = torch.randint(-40, 40, (1, e * seg, h), generator=gen, device=dev, dtype=torch.int8)
    cnt = None if counts is None else torch.tensor(counts, dtype=torch.int32, device=dev)
    if cnt is not None:                    # the wrapper's placement: zeros past the counts
        live = torch.arange(seg, device=dev)[None, :] < cnt.reshape(e, 1)
        xsend = torch.where(live.reshape(1, e * seg, 1), xsend, 0)
    w1 = torch.randint(-40, 40, (e, h, n), generator=gen, device=dev, dtype=torch.int8)
    sw = torch.rand((e, n), generator=gen, device=dev) / 100
    sx = torch.rand((e, seg), generator=gen, device=dev) / 10 + 0.01
    kw = dict(group=_nccl_group(), num_ranks=1, seg=seg, counts=cnt)
    before = fused_kernel.fused_dispatch_gmm1_rank.launches
    got = fused_kernel.fused_dispatch_gmm1_rank(xsend, w1, sw, sx, **kw)
    want = fused_kernel.fused_dispatch_gmm1_rank(xsend, w1, sw, sx, plain=True, **kw)
    torch.cuda.synchronize()
    assert fused_kernel.fused_dispatch_gmm1_rank.launches == before + 1
    rel = (got.float() - want.float()).abs() / want.float().abs().clamp_min(1e-30)
    assert float(rel.max()) <= 2 ** -7
    assert torch.equal(got == 0, want == 0)


def _k16a_case(gen, dev, seg, counts, e=4, h=512, n=256):
    """K16a's inputs on one rank: rows placed as the wrapper places them
    (zeros past each segment's count), and the K8a ``dequant`` call on the
    same placed rows (every segment a group of seg rows)."""
    xsend = torch.randint(-40, 40, (1, e * seg, h), generator=gen, device=dev, dtype=torch.int8)
    cnt = torch.tensor(counts, dtype=torch.int32, device=dev).reshape(1, e)
    live = torch.arange(seg, device=dev)[None, :] < cnt.reshape(e, 1)
    xsend = torch.where(live.reshape(1, e * seg, 1), xsend, 0)
    w1 = torch.randint(-40, 40, (e, h, n), generator=gen, device=dev, dtype=torch.int8)
    sw = torch.rand((e, n), generator=gen, device=dev) / 100
    sx = torch.rand((e, seg), generator=gen, device=dev) / 10 + 0.01
    gs = torch.full((e,), seg, dtype=torch.int32, device=dev)
    k8a = lambda: grouped_matmul.grouped_matmul(xsend.reshape(e * seg, h), w1, gs,  # noqa: E731
                                                sx.reshape(-1), sw, epilogue="dequant")
    return xsend, w1, sw, sx, cnt, k8a


@pytest.mark.parametrize("seg,counts", [(8, [0, 5, 8, 1]), (70, [0, 70, 33, 0]),
                                        (128, [128, 0, 1, 127]), (256, [256, 129, 0, 64]),
                                        (200, [0, 0, 0, 0])])
def test_fused_dispatch_gmm1_rank_bit_equal_to_k8a_dequant(dev, seg, counts):
    """K16a on one rank bit-equal to K8a ``dequant`` on the placed rows (the
    same ring and epilogue; rows past a count 0 on both sides) at segments
    of 8, 70 (items not aligned to 128 rows in the window), 128 and 256 rows
    (two items a segment) with dead, partial and full segments; one launch,
    the unit counter back at 0."""
    from sgl_kernel_npu_tpu_torch.parallel import fused_kernel

    gen = torch.Generator(device=dev).manual_seed(seg + 1)
    xsend, w1, sw, sx, cnt, k8a = _k16a_case(gen, dev, seg, counts)
    before = fused_kernel.fused_dispatch_gmm1_rank.launches
    got = fused_kernel.fused_dispatch_gmm1_rank(xsend, w1, sw, sx, group=_nccl_group(),
                                                num_ranks=1, seg=seg, counts=cnt)
    want = k8a()
    torch.cuda.synchronize()
    assert fused_kernel.fused_dispatch_gmm1_rank.launches == before + 1
    assert torch.equal(got.reshape(want.shape), want)
    assert all(int(t.item()) == 0 for t in fused_kernel._TICKETS.values())


def test_fused_dispatch_gmm1_rank_after_a_call_on_no_rows(dev):
    """A K16a call whose counts are all zero (every unit zero fill) between
    two real calls on other rows: it gives zeros, and the third call is
    right (bit-equal to K8a ``dequant``): the window's epoch, its flags and
    the unit counter carry nothing over."""
    from sgl_kernel_npu_tpu_torch.parallel import fused_kernel

    gen = torch.Generator(device=dev).manual_seed(11)
    kw = dict(group=_nccl_group(), num_ranks=1, seg=70)
    first = _k16a_case(gen, dev, 70, [5, 70, 0, 33])
    empty = _k16a_case(gen, dev, 70, [0, 0, 0, 0])
    third = _k16a_case(gen, dev, 70, [70, 1, 69, 0])
    outs = [fused_kernel.fused_dispatch_gmm1_rank(*c[:4], counts=c[4], **kw)
            for c in (first, empty, third)]
    wants = [c[5]() for c in (first, third)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0].reshape(wants[0].shape), wants[0])
    assert not outs[1].any()
    assert torch.equal(outs[2].reshape(wants[1].shape), wants[1])


def test_fused_dispatch_gmm1_kernel_matches_plain(dev):
    """The routed wrapper on one NCCL rank (32 experts, top-8, seg 16 so
    that pairs drop): K5 and K16a against the plain path, outputs within one
    bf16 ulp, counts exact."""
    from sgl_kernel_npu_tpu_torch.parallel import fused_kernel

    gen = torch.Generator(device=dev).manual_seed(9)
    x, idx, _, w = _deep_moe_inputs(gen, dev, 40, e=32, k=8)
    idx[:, 0] = 3
    kw = dict(group=_nccl_group(), num_experts=32, num_ranks=1, seg_capacity=16)
    got, cnt, _ = fused_kernel.fused_dispatch_gmm1(x, idx, w[0], w[1], **kw)
    want, wcnt, _ = fused_kernel.fused_dispatch_gmm1(x, idx, w[0], w[1], plain=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(cnt, wcnt) and int(cnt[3]) == 16
    rel = (got.float() - want.float()).abs() / want.float().abs().clamp_min(1e-30)
    assert float(rel.max()) <= 2 ** -7


# ---------------------------------------------------------------------------
# the rest of the Buffer surface on one NCCL rank: low-latency mode,
# validated exchange, multi-round dispatch, the layered node hop
# ---------------------------------------------------------------------------

def _ll_inputs(dev, t=64, h=512, e=32, k=8, seed=40):
    """Tokens, top-k ids with about a quarter of the slots -1, and weights."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.stack([torch.randperm(e, generator=gen)[:k] for _ in range(t)]).to(torch.int32)
    idx[torch.rand((t, k), generator=gen) < 0.25] = -1
    x = torch.randn((t, h), generator=gen).to(torch.bfloat16)
    w = torch.rand((t, k), generator=gen)
    return x.to(dev), idx.to(dev), w.to(dev)


@pytest.mark.parametrize("use_int8", [True, False], ids=["int8", "bf16"])
def test_low_latency_window_transports_bit_identical(dev, use_int8):
    """``low_latency_dispatch`` / ``combine`` on ``"pallas"`` (K15a) and
    ``"pallas_ragged"`` (K15b; monitored, K15c) against ``"xla"``: packed
    rows, scales, counts, drops and the combine bit-identical, the
    validation flags and timeout flags zero, each window kernel launched."""
    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer
    from sgl_kernel_npu_tpu_torch.utils import counters

    x, idx, w = _ll_inputs(dev)
    eid = torch.arange(1, 33, device=dev, dtype=torch.float32)
    runs = {}
    for backend in ("xla", "pallas", "pallas_ragged"):
        buf = Buffer(_nccl_group(), 32, EPConfig(comm_backend=backend))
        counters.reset()
        mon = backend == "pallas_ragged"
        rx, sc, cnt, h, st = buf.low_latency_dispatch(x, idx, use_int8=use_int8, monitor=mon,
                                                      validate=True)
        deq = rx.float() * sc[..., None] if use_int8 else rx.float()
        out = buf.low_latency_combine((deq * eid[:, None, None]).to(torch.bfloat16), w, h,
                                      monitor=mon)
        torch.cuda.synchronize()
        if mon:
            out, cst = out
            assert not st["timeout_flags"].any() and not cst["timeout_flags"].any()
        # "pallas": the counts, rows, slots (and scales) and the return on K15a;
        # "pallas_ragged": the counts on K15a, the slot blob on K15b, the rows
        # both ways on K15c
        launched = counters.read()
        assert launched["pallas_all_to_all"] == {"xla": 0, "pallas": 4 + use_int8,
                                                 "pallas_ragged": 1}[backend]
        assert launched["pallas_ragged_all_to_all"] == int(mon)
        assert launched["pallas_ragged_all_to_all_monitored"] == 2 * mon
        assert launched["quant_per_token"] == int(use_int8)
        assert not st["validation_flags"].any()
        runs[backend] = (rx, sc, cnt, st["recv_count_matrix"], st["num_dropped"], out)
    for backend in ("pallas", "pallas_ragged"):
        for a, b in zip(runs[backend], runs["xla"]):
            assert (a is None and b is None) or torch.equal(a, b), backend


def test_placements_on_card_tensors(dev):
    """``shared_expert_layout``'s tables on their default device (the card)
    and a ``rank_remap`` on the card: ``dispatch_core`` on one NCCL rank
    equals the call without placements, and ``make_routing_plan`` at 4 ranks
    (rank 0 shared, rank 1's experts rehomed to rank 3, rank 2 dead) on card ids equals the
    same plan on the CPU, with the tables given on either device."""
    from sgl_kernel_npu_tpu_torch.parallel import ep_core

    x, idx, _ = _ll_inputs(dev)
    owner, slot, slots = ep_core.shared_expert_layout(32, 1, 0)
    assert owner.device.type == slot.device.type == "cuda"
    kw = dict(group=_nccl_group(), num_experts=32, num_ranks=1, pair_capacity=64 * 8,
              seg_capacity=64, use_int8=True)
    d = ep_core.dispatch_core(x, idx, rank_remap=torch.zeros(1, dtype=torch.int32, device=dev),
                              expert_owner=owner, expert_slot=slot, num_local_slots=slots, **kw)
    ref = ep_core.dispatch_core(x, idx, **kw)
    for key in ("recv_x", "recv_scales", "recv_count_matrix", "num_dropped"):
        assert torch.equal(d[key], ref[key]), key
    ids = idx.clone()
    ids[:, 0] = 24                                     # the shared expert's virtual id
    remap = torch.tensor([0, 3, -1, 3], dtype=torch.int32)
    plan_kw = dict(num_experts=24, num_ranks=4, my_rank=1, pair_capacity=64 * 8,
                   seg_capacity=64)
    cpu_tables = ep_core.shared_expert_layout(24, 4, 1, device="cpu")
    want = ep_core.make_routing_plan(ids.cpu(), rank_remap=remap, expert_owner=cpu_tables[0],
                                     expert_slot=cpu_tables[1], num_local_slots=cpu_tables[2],
                                     **plan_kw)
    assert int(want.num_dropped) > 0
    for owner, slot, slots, rm in (ep_core.shared_expert_layout(24, 4, 1) + (remap.to(dev),),
                                   cpu_tables + (remap,)):
        got = ep_core.make_routing_plan(ids, rank_remap=rm, expert_owner=owner,
                                        expert_slot=slot, num_local_slots=slots, **plan_kw)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("backend", ["xla", "pallas_ragged"])
def test_multi_round_dispatch_equals_one_round(dev, backend):
    """``dispatch(rounds=4)`` of 256 tokens (int8), the experts' step per
    row, ``combine``: group sizes and the combine bit-identical to one round
    (the rows and their scales are the same, each row requantized alone)."""
    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer, MultiRoundHandle

    x, idx, w = _ll_inputs(dev, t=256)
    buf = Buffer(_nccl_group(), 32, EPConfig(comm_backend=backend))
    outs = []
    for rounds in (4, 1):
        xs, sc, gs, h, _ = buf.dispatch(x, idx, rounds=rounds)
        assert isinstance(h, MultiRoundHandle) == (rounds > 1)
        out = buf.combine((xs.float() * sc[:, None] * 3.0).to(torch.bfloat16), w, h)
        outs.append((gs, out))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_layered_monitored_node_hop_on_one_rank_groups(dev):
    """``dispatch_layered`` on one-rank node and ICI groups (NCCL), int8:
    the monitored node hop (K15c, once) gives the collective hop's rows,
    scales and counts bit for bit, no timeout, and the same combine."""
    from sgl_kernel_npu_tpu_torch.parallel import layered
    from sgl_kernel_npu_tpu_torch.parallel import pallas_a2a as pa

    group = _nccl_group()
    x, idx, w = _ll_inputs(dev, t=32)
    kw = dict(node_group=group, ici_group=group, num_nodes=1, ranks_per_node=1)
    runs = []
    for transport in ("xla", "monitored"):
        before = pa.pallas_ragged_all_to_all_monitored.launches
        d = layered.dispatch_layered(x, idx, num_experts=32, phase1_capacity=32,
                                     phase2_capacity=32 * 8, seg_capacity=32, use_int8=True,
                                     monitor=True, dcn_transport=transport, **kw)
        y = d["recv_x"].float() * d["recv_scales"][..., None]
        out = layered.combine_layered(y, w, d["handle"], seg_capacity=32, num_tokens=32,
                                      out_dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        assert pa.pallas_ragged_all_to_all_monitored.launches == before + (
            transport == "monitored")
        runs.append((d["recv_x"], d["recv_scales"], d["recv_count_matrix"], out))
    assert not d["stats"]["dcn_timeout_flags"].any()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
