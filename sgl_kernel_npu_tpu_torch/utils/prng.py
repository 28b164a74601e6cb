"""A counter-based PRNG that draws ``jax.random``'s bits, bit for bit.

The sampler of the JAX package draws ``jax.random.categorical(
jax.random.fold_in(jax.random.key(seed), step), row)`` for each row.  Its
default generator is Threefry-2x32 with ``jax_threefry_partitionable`` on
(JAX 0.9): a key is a pair of 32-bit words, and the bits of an array of shape
``s`` are ``y1 ^ y2`` where ``(y1, y2) = threefry2x32(key, hi, lo)`` of each
element's flat row-major index split into its high and low 32-bit halves.
This module repeats that (``jax/_src/prng.py``: ``threefry_seed``,
``_threefry2x32_lowering``, ``threefry_fold_in``,
``_threefry_random_bits_partitionable``; ``jax/_src/random.py``:
``_uniform``, ``_gumbel`` in its default ``"low"`` mode, ``categorical``) in
torch integer ops on the device of its inputs: every 32-bit word lives in an
int64 tensor masked to 32 bits, so additions wrap as uint32 and shifts stay
logical.  Keys are batched: ``(k1, k2)`` tensors of shape ``[B]``, one key a
row; no operation reads a value back to the host.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _u32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as uint32 words in an int64 tensor (two's complement bits of
    negative ints, as JAX's conversion to uint32)."""
    return x.to(torch.int64) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x1, x2)``
    under the key ``(k1, k2)``; all uint32 words in int64 tensors, broadcast
    together."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0, x1 = (x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.key(seed)`` of int32 seeds ``[B]``: the key ``(0, seed)``
    (the high word of a 32-bit seed is 0)."""
    s = _u32(seed)
    return torch.zeros_like(s), s


def fold_in(k: tuple[torch.Tensor, torch.Tensor], data: torch.Tensor):
    """``jax.random.fold_in(k, data)`` for each row: the hash of the counter
    pair ``(0, data)`` under ``k`` is the new key."""
    d = _u32(data)
    return threefry2x32(k[0], k[1], torch.zeros_like(d), d)


def random_bits(k: tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """32 random bits ``[B, n]``: row ``b`` is ``jax.random.bits(key_b,
    (n,), uint32)`` (the partitionable layout: element ``j`` hashes the
    counter pair ``(0, j)``; ``n`` < 2³²), as uint32 words in int64."""
    j = torch.arange(n, dtype=torch.int64, device=k[0].device)[None, :]
    y1, y2 = threefry2x32(k[0][:, None], k[1][:, None], torch.zeros_like(j), j)
    return y1 ^ y2


def uniform(k: tuple[torch.Tensor, torch.Tensor], n: int, minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key_b, (n,), float32, minval, 1)`` for each row:
    the top 23 bits as a mantissa of [1, 2), minus 1, scaled to
    ``[minval, 1)`` and clipped below at ``minval``, each step in f32."""
    bits = (random_bits(k, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=bits.device) - lo
    return torch.maximum(lo, floats * span + lo)


def gumbel(k: tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """``jax.random.gumbel(key_b, (n,), float32)`` in its default ``"low"``
    mode for each row: ``-log(-log(u))`` of ``u`` uniform on ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(k, n, _TINY)))


def categorical(k: tuple[torch.Tensor, torch.Tensor], logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key_b, logits[b])`` for each row of ``logits
    [B, V]`` (f32): the Gumbel-max trick, ``argmax(logits + gumbel)``, ties to
    the lower index.  ``log`` is the device's: a token can differ from JAX's
    only where two of a row's sums lie within an ulp of each other."""
    return torch.argmax(gumbel(k, logits.shape[-1]) + logits, dim=-1)
