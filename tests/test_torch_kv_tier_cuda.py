"""The KV memory tier on the card: pinned host pools and ``MemorySaver``.

Marked ``cuda``: they skip where no GPU is present.  On a machine with the
card:

    python -m pytest -m cuda tests/test_torch_kv_tier_cuda.py -q

Held: ``transfer_kv_dim_exchange`` between bf16 / int8 layers on the card
and a pinned page-major pool round-trips bit-equal (host ids in several
runs, out of order; unnamed pages untouched); ``MemorySaver.pause`` hands
at least 90 % of the registered bytes back to CUDA
(``torch.cuda.mem_get_info``), even for regions allocated between live
tensors, and ``resume`` restores them bit-equal into the same tensor objects
(zeros without a backup); an engine's host pool is pinned, and a decode
engine restoring from it gives the prefill engine's tokens."""

import pytest
import torch

from sgl_kernel_npu_tpu_torch.models import llama as tlm
from sgl_kernel_npu_tpu_torch.runtime.engine import Engine, HostKVPool, cache_tensors, llama_adapter
from sgl_kernel_npu_tpu_torch.utils import kvcacheio
from sgl_kernel_npu_tpu_torch.utils.common import kernels_available
from sgl_kernel_npu_tpu_torch.utils.memory_saver import MemorySaver

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not kernels_available():
        pytest.skip("needs an NVIDIA GPU: the pinned pools and the memory release are the card's")
    return torch.device("cuda")


def test_transfer_round_trip_pinned(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    layers, pages = 3, 24
    k = [torch.randint(-128, 128, (pages, 1, 16, 64), generator=gen, dtype=torch.int8,
                       device=dev) for _ in range(layers)]
    v = [torch.randn((pages, 1, 32, 16), generator=gen, device=dev).to(torch.bfloat16)
         for _ in range(layers)]
    orig = [t.clone() for t in k + v]
    host = [torch.full((40, layers) + tuple(t.shape[1:]), 5, dtype=t.dtype, pin_memory=True)
            for t in (k[0], v[0])]
    assert all(p.is_pinned() for p in host)
    d_idx = [3, 0, 7, 8, 9, 20, 1]
    h_idx = [30, 31, 2, 3, 4, 10, 39]                 # four runs
    D2H, H2D = kvcacheio.TransferDirection.D2H, kvcacheio.TransferDirection.H2D
    kvcacheio.transfer_kv_dim_exchange(d_idx, h_idx, k, host[0], v, host[1], direction=D2H)
    for t in k + v:
        t.zero_()
    kvcacheio.transfer_kv_dim_exchange(d_idx, h_idx, k, host[0], v, host[1], direction=H2D)
    rest = [p for p in range(pages) if p not in d_idx]
    for t, o in zip(k + v, orig):
        assert torch.equal(t[d_idx], o[d_idx]) and not t[rest].any()
    untouched = [p for p in range(40) if p not in h_idx]
    assert all((pool[untouched] == 5).all() for pool in host)


def test_memory_saver_returns_bytes_to_cuda(dev):
    saver = MemorySaver()
    gen = torch.Generator(device=dev).manual_seed(1)
    keep, regions = [], []
    for i in range(6):                                # 4 MB regions between live 3 MB tensors
        keep.append(torch.empty((3 << 20,), dtype=torch.uint8, device=dev))
        t = torch.randn((1 << 20,), generator=gen, device=dev)
        regions.append(saver.register(f"r{i}", t, tag="kv", cpu_backup=i != 5))
    before = [t.clone().cpu() for t in regions]
    registered = sum(t.nbytes for t in regions)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    assert saver.pause("kv") == registered
    assert torch.cuda.mem_get_info()[0] - free0 >= 0.9 * registered
    with pytest.raises(RuntimeError, match="paused"):
        saver.get("r0")
    saver.resume("kv")
    for i, (t, b) in enumerate(zip(regions, before)):
        assert saver.get(f"r{i}") is t
        assert torch.equal(t.cpu(), b) if i != 5 else not t.any()
    assert saver.device_bytes() == registered


def test_engine_host_pool_pinned_and_disaggregated(dev):
    cfg = tlm.LlamaConfig(vocab_size=64, num_layers=2, page_size=16)
    params = tlm.init_weights(cfg, 0, torch.bfloat16, device=dev)
    pool = HostKVPool(32, cfg.page_size)

    def engine():
        return Engine(llama_adapter(cfg, params, device=dev), 32, max_batch=2,
                      max_pages_per_req=8, prefill_chunk=32, host_pool=pool, device=dev)

    prompts = [list(range(1, 41)), list(range(7, 60))]
    p = engine()
    p.run(prompts, 1)
    assert p.stats["host_offloaded_pages"] == 2 + 3
    assert all(t.is_pinned() and t.device.type == "cpu" for t in cache_tensors(pool.pool))
    again = p.run(prompts, 4)
    d = engine()
    assert d.run(prompts, 4) == again
    assert d.stats["host_restored_tokens"] == 32 + 48
