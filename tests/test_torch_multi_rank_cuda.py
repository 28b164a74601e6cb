"""The multi-rank serving layouts' kernels and ops on the card.

Marked ``cuda``: they skip where no GPU is present.  On a machine with the
card:

    python -m pytest -m cuda tests/test_torch_multi_rank_cuda.py -q

K2 (``decode_mla``) at a head-parallel rank's share of DeepSeek-V3's 128
heads (64 at tp 2, 16 at tp 8) on the serving test's decode contexts,
against its plain version (2e-2, as the MLA kernels' tests); the int8 route
of ``batch_matmul_transpose`` on the card bit-equal to the CPU's (exact
integer sums, the same f32 epilogue); ``decode_step_tp`` on one rank
bit-equal to ``decode_step`` on the card (the same kernels on the same
heads); ``prefill_step_cp`` on one rank (``gathered_attention`` in torch ops)
within 2e-2 of a row's largest value of ``prefill_step`` (K12d), the caches
bit-equal.  The two-process runs are ``chip_smoke.py``'s phases [4q] and
[4r]."""

import pytest
import torch

from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as ds
from sgl_kernel_npu_tpu_torch.models import llama as lm
from sgl_kernel_npu_tpu_torch.ops import matmul
from sgl_kernel_npu_tpu_torch.ops.attention import decode_attention as da
from sgl_kernel_npu_tpu_torch.utils.common import kernels_available

pytestmark = pytest.mark.cuda

CTX = [716, 612, 556, 470, 320, 166, 112, 400]      # chip_smoke's [4] decode contexts, page 128


@pytest.fixture
def dev():
    if not kernels_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("heads", [64, 16])
def test_decode_mla_at_a_tp_ranks_heads(dev, heads):
    gen = torch.Generator(device=dev).manual_seed(heads)
    page, max_pages = 128, 6
    b = len(CTX)
    kn = torch.randn((b * max_pages + 1, 1, page, 512), generator=gen, device=dev)
    kr = torch.randn((b * max_pages + 1, 1, 64, page), generator=gen, device=dev)
    kn, kr = kn.to(torch.bfloat16), kr.to(torch.bfloat16)
    bt = (torch.arange(b * max_pages, device=dev, dtype=torch.int32) + 1).reshape(b, max_pages)
    ctx = torch.tensor(CTX, dtype=torch.int32, device=dev)
    q = torch.randn((b, heads, 576), generator=gen, device=dev).to(torch.bfloat16)
    before = da.decode_mla.launches
    got = da.decode_mla(q, kn, kr, ctx, 0.0722, bt)
    want = da.decode_mla_ref(q, kn, kr, ctx, 0.0722, bt)
    torch.cuda.synchronize()
    assert da.decode_mla.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("mode", ["per_channel_symm", "per_channel_asymm", "per_token_symm"])
def test_batch_matmul_transpose_int8_exact_on_card(dev, mode):
    gen = torch.Generator().manual_seed(1)
    a = torch.randint(-128, 128, (33, 16, 512), generator=gen, dtype=torch.int8)
    b = torch.randint(-128, 128, (16, 512, 128), generator=gen, dtype=torch.int8)
    kw = dict(quant_mode=mode, de_scale=torch.rand((16, 128), generator=gen) * 1e-3,
              bias=torch.randint(-5000, 5000, (16, 128), generator=gen, dtype=torch.int32),
              per_token_scale=torch.rand((33, 16), generator=gen))
    want = matmul.batch_matmul_transpose(a, b, torch.float32, **kw)
    got = matmul.batch_matmul_transpose(a.to(dev), b.to(dev), torch.float32,
                                        **{k: v.to(dev) for k, v in kw.items()
                                           if k != "quant_mode"},
                                        quant_mode=mode)
    assert torch.equal(got.cpu(), want)


def test_decode_step_tp_on_one_rank_equals_decode_step(dev):
    cfg = ds.DeepSeekV3Config(num_layers=1, page_size=16, vocab_size=61, num_heads=16,
                              kv_lora_rank=512, qk_rope_dim=64)
    params = ds.init_weights(cfg, 3, torch.bfloat16, device=dev)
    b, max_pages = 4, 2
    gen = torch.Generator(device=dev).manual_seed(2)
    hidden = (torch.randn((b, cfg.hidden), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
    bt = (torch.arange(b * max_pages, device=dev, dtype=torch.int32) + 1).reshape(b, max_pages)
    pos = torch.tensor([5, 20, 12, 30], device=dev)
    slots = (bt[torch.arange(b, device=dev), pos // 16] * 16 + pos % 16).int()
    runs = []
    for step in (ds.decode_step, lambda *a: ds.decode_step_tp(*a, group=None)):
        caches = ds.init_kv_cache(cfg, b * max_pages + 1, torch.bfloat16, device=dev)
        before = da.decode_mla.launches
        h, caches = step(cfg, params, hidden, pos, caches, bt, (pos + 1).int(), slots)
        assert da.decode_mla.launches == before + 1
        runs.append((h, caches))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    for name in ("nope", "rope"):
        assert torch.equal(runs[0][1][0][name], runs[1][1][0][name])


def test_prefill_step_cp_on_one_rank_against_prefill_step(dev):
    cfg = lm.LlamaConfig(vocab_size=128, hidden=512, num_layers=2, num_heads=8, num_kv_heads=2,
                         head_dim=64, intermediate=1024, page_size=16)
    params = lm.init_weights(cfg, 5, torch.bfloat16, device=dev)
    s, live = 64, 57
    bt = torch.arange(1, 5, dtype=torch.int32, device=dev)[None]
    slots = torch.full((s,), -1, dtype=torch.int32, device=dev)
    slots[:live] = torch.arange(16, 16 + live, dtype=torch.int32, device=dev)
    seq = torch.tensor([live], dtype=torch.int32, device=dev)
    x = lm.embed(params, torch.randint(0, 128, (s,), device=dev))
    outs = []
    for cp in (False, True):
        caches = lm.init_kv_cache(cfg, 5, torch.bfloat16, device=dev)
        if cp:
            h, caches = lm.prefill_step_cp(cfg, params, x, seq, caches, bt, seq, slots,
                                           group=None)
        else:
            h, caches = lm.prefill_step(cfg, params, x, seq, caches, bt, seq, slots, max_q=s)
        outs.append((h[:live].float(), caches))
    err = (outs[1][0] - outs[0][0]).abs().amax(dim=-1) / outs[0][0].abs().amax(dim=-1)
    assert float(err.max()) < 2e-2
    k0, v0 = outs[0][1][0]
    k1, v1 = outs[1][1][0]              # layer 0's K / V come before any attention
    assert torch.equal(k0, k1) and torch.equal(v0, v1)
