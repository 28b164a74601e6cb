"""Typed configuration for the expert-parallel communication layer.

Counterpart of ``sgl_kernel_npu_tpu/config.py``: the same dataclass, fields
and defaults, and the same capacity rule.  The port moves the payloads on
the three transports of JAX's ``comm_backend``: ``"xla"`` (an all-to-all
collective of the process group, NCCL on the card), ``"pallas"`` and
``"pallas_ragged"`` (the one-sided window all-to-alls K15a / K15b,
``parallel/pallas_a2a.py``).  ``monitor_comm`` takes effect on
``"pallas_ragged"`` (K15c), as in JAX; ``validate_comm`` (the dispatch's
checksum guard) and ``normal_round_tokens`` (multi-round dispatch) on every
transport.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class EPConfig:
    """Static sizing for expert-parallel dispatch / combine.

    Attributes (as in the JAX package):
        num_max_dispatch_tokens_per_rank: worst-case local tokens per rank;
            bounds the per-(expert, source rank) segment.
        capacity_factor: sizes the per-(src, dst)-rank send buffer as
            ``ceil(mean · f + 3 sqrt(mean · f))`` with ``mean = T K / R``;
            ``None`` is the exact worst case ``T · min(K, E_local)`` (never
            drops).  Smaller values may drop rows (counted).
        use_int8_dispatch: int8 per-token payloads on the dispatch wire.
        normal_round_tokens: per-round token chunk of multi-round dispatch
            (``None`` disables it).
        comm_backend: ``"xla"`` (the all-to-all collective), ``"pallas"`` or
            ``"pallas_ragged"`` (the one-sided window all-to-alls).
        monitor_comm: the ragged exchange's wait-cost and timeout statistics
            (``"pallas_ragged"`` only, as in JAX).
        validate_comm: the dispatch's per-source payload checksum guard
            (``stats["validation_flags"]``), on every transport.
    """

    num_max_dispatch_tokens_per_rank: int = 128
    capacity_factor: float | None = None
    use_int8_dispatch: bool = True
    normal_round_tokens: int | None = None
    comm_backend: str = "xla"
    monitor_comm: bool = False
    validate_comm: bool = False

    def pair_capacity(self, num_tokens: int, topk: int, num_ranks: int,
                      experts_per_rank: int) -> int:
        """Rows a single source rank may send to a single destination rank."""
        exact = num_tokens * min(topk, experts_per_rank)
        if self.capacity_factor is None:
            return exact
        scaled_mean = num_tokens * topk * self.capacity_factor / num_ranks
        est = math.ceil(scaled_mean + 3.0 * math.sqrt(scaled_mean))
        return int(min(exact, max(1, est)))


def check_backend(backend: str) -> None:
    """Raise unless ``backend`` is one of JAX's transports."""
    if backend not in ("xla", "pallas", "pallas_ragged"):
        raise ValueError(f"unknown comm backend {backend!r}; expected 'xla', 'pallas', or "
                         "'pallas_ragged'")


def check_supported(config: EPConfig) -> None:
    """Raise on a setting of ``config`` the port does not take: an unknown
    transport."""
    check_backend(config.comm_backend)
