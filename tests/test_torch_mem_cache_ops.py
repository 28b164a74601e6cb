"""Port: the KV-slot ops (``ops/mem_cache/allocator.py``, ``cache_ops.py``),
``transfer_kv_dim_exchange`` (``utils/kvcacheio.py``) and ``MemorySaver``
(``utils/memory_saver.py``) against the JAX package's.

The slot and cache-location ops take seeded numpy inputs through both
packages and must give the same integers exactly: JAX's cases of
tests/test_mem_cache.py, an uneven last page, outputs past the total,
negative and out-of-range indices (JAX counts negative ones from the end,
drops what a scatter then puts outside the array, clamps what a gather
reads outside it).  The transfer round-trips both ways bit-equal to JAX's,
named pages only; ``MemorySaver`` follows tests/test_aux.py:51 and keeps
the registered tensor object; an engine whose caches were paused and resumed
serves the same tokens again."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_config
from sgl_kernel_npu_tpu.models import llama as jlm
from sgl_kernel_npu_tpu.ops import mem_cache as jmc
from sgl_kernel_npu_tpu.utils import kvcacheio as jkv
from sgl_kernel_npu_tpu.utils.memory_saver import MemorySaver as JMemorySaver
from sgl_kernel_npu_tpu_torch.models import llama as tlm
from sgl_kernel_npu_tpu_torch.ops import mem_cache as tmc
from sgl_kernel_npu_tpu_torch.runtime.engine import Engine, cache_tensors, llama_adapter
from sgl_kernel_npu_tpu_torch.utils import kvcacheio as tkv
from sgl_kernel_npu_tpu_torch.utils.memory_saver import MemorySaver


def _i32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def _same(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


# (pre_lens, seq_lens, page, free pages, max_extend_tokens): JAX's case, an
# uneven last page, one request, a request that does not grow, page 1
EXTEND = {
    "jax case": ([5, 16, 0, 30], [40, 16, 20, 33], 16, 64, 128),
    "uneven tail": ([3, 0, 7], [13, 9, 8], 4, 16, 40),
    "one request": ([0], [129], 128, 4, 256),
    "no growth": ([8, 8], [8, 11], 4, 4, 8),
    "page 1": ([2, 0], [5, 3], 1, 16, 10),
}


@pytest.mark.parametrize("case", sorted(EXTEND))
def test_alloc_extend_matches_jax(case):
    pre, seq, page, n_free, out = EXTEND[case]
    rng = np.random.default_rng(len(case))
    last = rng.integers(0, 1000, len(pre)).astype(np.int32)
    free = rng.permutation(n_free).astype(np.int32)
    want = jmc.alloc_extend(jnp.asarray(pre, jnp.int32), jnp.asarray(seq, jnp.int32),
                            jnp.asarray(last), jnp.asarray(free), page_size=page,
                            max_extend_tokens=out)
    got = tmc.alloc_extend(_i32(pre), _i32(seq), _i32(last), _i32(free), page_size=page,
                           max_extend_tokens=out)
    _same(got, want)
    total = sum(s - p for p, s in zip(pre, seq))
    assert (got[total:] == -1).all()


@pytest.mark.parametrize("page", [1, 4, 128])
def test_alloc_decode_matches_jax(page):
    rng = np.random.default_rng(page)
    seq = rng.integers(1, 4 * page + 2, 12).astype(np.int32)
    seq[:3] = [1, page + 1, 2 * page]                 # a new page, another, a page's last slot
    last = rng.integers(0, 5000, 12).astype(np.int32)
    free = rng.permutation(40).astype(np.int32)
    want = jmc.alloc_decode(jnp.asarray(seq), jnp.asarray(last), jnp.asarray(free),
                            page_size=page)
    _same(tmc.alloc_decode(_i32(seq), _i32(last), _i32(free), page_size=page), want)


# (req_pool_indices, start, end, max_total): JAX's case, rows past the total,
# a negative row and column, a row and columns outside the pool
LOCS = {
    "jax case": ([3, 7, 1], [5, 0, 60], [10, 4, 64], 13),
    "past the total": ([0, 9, 4, 2], [0, 30, 7, 63], [12, 31, 7, 64], 24),
    "negative": ([-1, 2], [-3, 5], [-1, 9], 8),
    "outside": ([12, 3], [60, 62], [66, 70], 14),
}


@pytest.mark.parametrize("case", sorted(LOCS))
def test_cache_loc_assign_and_update_match_jax(case):
    req, start, end, total = LOCS[case]
    rng = np.random.default_rng(len(case) + 7)
    pool = rng.integers(0, 1000, (10, 64)).astype(np.int32)
    vals = rng.integers(0, 9999, total).astype(np.int32)
    args = [np.asarray(a, np.int32) for a in (req, start, end)]
    want = jmc.cache_loc_assign(jnp.asarray(args[0]), jnp.asarray(pool), jnp.asarray(args[1]),
                                jnp.asarray(args[2]), jnp.asarray(vals))
    tpool = _i32(pool)
    got = tmc.cache_loc_assign(_i32(args[0]), tpool, _i32(args[1]), _i32(args[2]), _i32(vals))
    assert got is tpool
    _same(got, want)
    back_want = jmc.cache_loc_update(jnp.asarray(args[0]), want, jnp.asarray(args[1]),
                                     jnp.asarray(args[2]), max_total=total)
    _same(tmc.cache_loc_update(_i32(args[0]), got, _i32(args[1]), _i32(args[2]), total),
          back_want)


# (dst rows, src rows, dst_start, dst_end, src_start, src_end, width)
ASSIGN = {
    "jax case": (32, 32, 4, 12, 20, 28, 8),
    "src shorter": (16, 16, 2, 12, 10, 14, 3),
    "past the end": (6, 6, 4, 9, 3, 9, 0),
    "negative start": (6, 6, -2, 3, -1, 4, 0),
}


@pytest.mark.parametrize("case", sorted(ASSIGN))
def test_assign_cache_op_matches_jax(case):
    n_dst, n_src, d0, d1, s0, s1, width = ASSIGN[case]
    rng = np.random.default_rng(n_dst + width)
    shape = (lambda n: (n, width) if width else (n,))
    dst = rng.integers(0, 100, shape(n_dst)).astype(np.int32)
    src = rng.integers(0, 100, shape(n_src)).astype(np.int32)
    want = jmc.assign_cache_op(jnp.asarray(dst), jnp.asarray(src), d0, d1, s0, s1)
    tdst = _i32(dst)
    got = tmc.assign_cache_op(tdst, _i32(src), d0, d1, s0, s1)
    assert got is tdst
    _same(got, want)
    # the bounds as 0-d tensors, as a traced caller passes them
    bounds = [torch.tensor(v, dtype=torch.int32) for v in (d0, d1, s0, s1)]
    _same(tmc.assign_cache_op(_i32(dst), _i32(src), *bounds), want)


@pytest.mark.parametrize("dev_dtype", [torch.float32, torch.bfloat16])
def test_transfer_kv_dim_exchange_round_trip_matches_jax(dev_dtype):
    """tests/test_aux.py:32 with K and V: D2H into a page-major pool (the
    host ids in two runs and out of order), the pool equal to JAX's; then
    H2D into zeroed layers: the named pages back bit-equal, cast to the
    layers' dtype, the others still 0, equal to JAX's."""
    layers, pages, page, d = 3, 8, 4, 16
    rng = np.random.default_rng(1)
    jdt = jnp.bfloat16 if dev_dtype == torch.bfloat16 else jnp.float32
    k = [rng.standard_normal((pages, page, d)).astype(np.float32) for _ in range(layers)]
    v = [rng.standard_normal((pages, 2, page, d)).astype(np.float32) for _ in range(layers)]
    d_idx, h_idx = np.array([1, 5, 7, 2]), np.array([10, 11, 3, 0])
    jk, jv = [jnp.asarray(a, jdt) for a in k], [jnp.asarray(a, jdt) for a in v]
    tk, tv = [torch.from_numpy(a).to(dev_dtype) for a in k], [torch.from_numpy(a).to(dev_dtype)
                                                              for a in v]
    pools = {}
    for name, dt in (("k", np.float32), ("v", np.float32)):
        shape = (20, layers) + ((page, d) if name == "k" else (2, page, d))
        pools[name] = (np.full(shape, 7.0, dt), torch.full(shape, 7.0))
    D2H, H2D = jkv.TransferDirection.D2H, jkv.TransferDirection.H2D
    jkv.transfer_kv_dim_exchange(d_idx, h_idx, jk, pools["k"][0], jv, pools["v"][0], direction=D2H)
    out = tkv.transfer_kv_dim_exchange(d_idx, h_idx, tk, pools["k"][1], tv, pools["v"][1],
                                       direction=tkv.TransferDirection.D2H)
    assert out[1] is pools["k"][1] and out[3] is pools["v"][1]
    for jpool, tpool in pools.values():
        np.testing.assert_array_equal(tpool.numpy(), jpool)
    jk0, jv0 = [jnp.zeros_like(a) for a in jk], [jnp.zeros_like(a) for a in jv]
    tk0, tv0 = [torch.zeros_like(a) for a in tk], [torch.zeros_like(a) for a in tv]
    jk0, _, jv0, _ = jkv.transfer_kv_dim_exchange(d_idx, h_idx, jk0, pools["k"][0], jv0,
                                                  pools["v"][0], direction=H2D)
    got = tkv.transfer_kv_dim_exchange(d_idx, h_idx, tk0, pools["k"][1], tv0, pools["v"][1],
                                       direction=tkv.TransferDirection.H2D)
    assert got[0] is tk0 and got[2] is tv0
    rest = np.setdiff1d(np.arange(pages), d_idx)
    for jl, tl, orig in zip(jk0 + jv0, tk0 + tv0, tk + tv, strict=True):
        assert tl.dtype == dev_dtype
        np.testing.assert_array_equal(tl.float().numpy(), np.asarray(jl, np.float32))
        assert torch.equal(tl[d_idx], orig[d_idx]) and not tl[rest].any()


def test_host_runs_and_refusals():
    assert tkv.host_runs([10, 11, 3, 0, 1]) == [(0, 2, 10), (2, 3, 3), (3, 5, 0)]
    assert tkv.host_runs([]) == []
    pool, rows = torch.zeros((4, 2)), torch.ones((2, 2))
    with pytest.raises(ValueError, match="host page ids"):
        tkv.rows_to_host(pool, [3, 4], rows)
    with pytest.raises(ValueError, match="host page ids"):
        tkv.rows_to_device(pool, [-1], "cpu")
    with pytest.raises(ValueError, match="device pages against"):
        tkv.transfer_kv_dim_exchange([0], [0, 1], [torch.zeros((2, 2))], torch.zeros((4, 1, 2)))


def test_memory_saver_matches_jax():
    """tests/test_aux.py:51 on both packages: the freed bytes, the
    backed-up region restored bit-equal into the same tensor object, the
    discarded one resumed to zeros, ``get`` on a paused region raising,
    ``device_bytes`` equal at every step."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    js, ts = JMemorySaver(), MemorySaver()
    js.register("w", jnp.asarray(w), tag="weights")
    js.register("kv", jnp.ones((32, 8)), tag="kv", cpu_backup=False)
    tw = ts.register("w", torch.tensor(w), tag="weights")
    tkv_ = ts.register("kv", torch.ones((32, 8)), tag="kv", cpu_backup=False)
    assert ts.device_bytes() == js.device_bytes() == 64 * 64 * 4 + 32 * 8 * 4
    assert ts.pause("weights") == js.pause("weights") == 64 * 64 * 4
    assert tw.untyped_storage().nbytes() == 0
    with pytest.raises(RuntimeError, match="paused"):
        ts.get("w")
    assert ts.pause("weights") == js.pause("weights") == 0       # nothing left to pause
    js.pause("kv")
    ts.pause("kv")
    assert ts.device_bytes() == js.device_bytes() == 0
    js.resume("weights")
    ts.resume("weights")
    assert ts.get("w") is tw
    np.testing.assert_array_equal(tw.numpy(), np.asarray(js.get("w")))
    js.resume("kv")
    ts.resume("kv")
    assert ts.get("kv") is tkv_ and not tkv_.any() and not np.asarray(js.get("kv")).any()
    assert ts.device_bytes() == js.device_bytes()
    with pytest.raises(ValueError, match="whole of a"):
        ts.register("view", torch.zeros((4, 4))[1:])
    with pytest.raises(ValueError, match="whole of a"):          # numpy's memory: not resizable
        ts.register("numpy", torch.from_numpy(w))
    with pytest.raises(ValueError, match="registered already"):
        ts.register("w", torch.zeros(2))


def test_engine_serves_again_after_caches_paused():
    """An engine serves two prompts, its caches (every tensor) are paused
    with ``cpu_backup=True`` and resumed, and it serves them again: the same
    tokens, from the radix-cached pages, as an engine never paused."""
    jcfg = jlm.LlamaConfig(vocab_size=61, num_layers=2, page_size=4)
    tparams = tlm.from_jax_params(
        jax.tree.map(np.asarray, jlm.init_weights(jax.random.key(7), jcfg)), device="cpu")
    cfg = port_config(jcfg, tlm.LlamaConfig)
    prompts = [[5, 9, 2, 33, 17, 4, 8, 21, 60, 3], [40, 41, 42, 43, 44, 45, 46, 47, 48]]

    def engine():
        return Engine(llama_adapter(cfg, tparams, device="cpu"), 32, max_batch=2,
                      max_pages_per_req=8, prefill_chunk=8, device="cpu")

    paused, plain = engine(), engine()
    first = paused.run(prompts, 5)
    assert first == plain.run(prompts, 5)
    saver = MemorySaver()
    caches = cache_tensors(paused.caches)
    before = [t.clone() for t in caches]
    for i, t in enumerate(caches):
        saver.register(f"kv{i}", t, tag="kv")
    assert saver.pause("kv") == sum(t.nbytes for t in before)
    saver.resume("kv")
    assert all(torch.equal(t, b) for t, b in zip(cache_tensors(paused.caches), before, strict=True))
    again = paused.run(prompts, 5)
    assert again == plain.run(prompts, 5)
    assert paused.stats["cached_tokens"] == plain.stats["cached_tokens"] >= 12
