"""Port parity: paged KV-cache writes (sgl_kernel_npu_tpu_torch/ops/mem_cache)."""

import numpy as np
import pytest

from _torch_parity import jx, np32, tt
from sgl_kernel_npu_tpu.ops.mem_cache import kv_cache as jkv
from sgl_kernel_npu_tpu_torch.ops.mem_cache import kv_cache as tkv


@pytest.mark.parametrize("page", [4, 16])
def test_reshape_and_cache_drops_slot_minus_one(page):
    """Slot -1 writes nothing — in particular not into the last page, where a
    naive ``-1 // page`` index would land.  Exact equality with JAX."""
    rng = np.random.default_rng(0)
    n_pages, d = 6, 32
    cache = rng.standard_normal((n_pages, 1, page, d)).astype(np.float32)
    cache_t = rng.standard_normal((n_pages, 1, d, page)).astype(np.float32)
    vals = rng.standard_normal((5, 1, d)).astype(np.float32)
    slots = np.array([3, -1, page * 2 + 1, -1, page * n_pages - 1], np.int32)

    want = np32(jkv.reshape_and_cache(jx(vals), jx(cache), jx(slots)))
    got = tkv.reshape_and_cache(tt(vals), tt(cache), tt(slots))
    np.testing.assert_array_equal(np32(got), want)

    want_t = np32(jkv.reshape_and_cache_transposed(jx(vals), jx(cache_t), jx(slots)))
    got_t = tkv.reshape_and_cache_transposed(tt(vals), tt(cache_t), tt(slots))
    np.testing.assert_array_equal(np32(got_t), want_t)

    # every -1 row dropped: only 3 slots differ from the input
    assert (np.abs(np32(got) - cache).sum(-1) > 0).sum() == 3
    assert (np.abs(np32(got_t) - cache_t).sum(-2) > 0).sum() == 3


def test_reshape_and_cache_writes_in_place():
    rng = np.random.default_rng(1)
    cache = tt(np.zeros((3, 1, 4, 8), np.float32))
    vals = tt(rng.standard_normal((2, 1, 8)).astype(np.float32))
    out = tkv.reshape_and_cache(vals, cache, tt(np.array([5, -1], np.int32)))
    assert out is cache
    np.testing.assert_array_equal(np32(cache[1, 0, 1]), np32(vals[0, 0]))
    assert float(cache.abs().sum()) == float(vals[0].abs().sum())


def test_reshape_and_cache_int8_latent_cache():
    """The int8 latent cache takes the same writes: levels copied exactly,
    slot -1 dropped."""
    rng = np.random.default_rng(2)
    page, n_pages = 16, 4
    cache = rng.integers(-128, 128, (n_pages, 1, page, 64)).astype(np.int8)
    vals = rng.integers(-128, 128, (4, 1, 64)).astype(np.int8)
    slots = np.array([-1, 5, page * n_pages - 1, -1], np.int32)
    want = np.asarray(jkv.reshape_and_cache(jx(vals), jx(cache), jx(slots)))
    got = tkv.reshape_and_cache(tt(vals), tt(cache), tt(slots))
    assert got.dtype == tt(cache).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != cache).any(axis=-1).sum() <= 2
