"""DeepEP-style user API over a ``torch.distributed`` process group.

Counterpart of ``sgl_kernel_npu_tpu/parallel/buffer.py``.  JAX binds the
buffer to a mesh axis and its methods take global arrays sharded over it,
returning results stacked by rank; the port binds it to a process group (one
process a rank, as ``torch.distributed`` runs) and its methods take this
rank's rows and return this rank's results: the ``shard_map`` body's view,
without the leading rank dimension (ROADMAP §C).  Shapes are static worst
cases, as in JAX: no host sync on the serving path.

JAX's whole surface: :meth:`Buffer.get_dispatch_layout`,
:meth:`~Buffer.get_routing_plan`, the low-latency (decode) mode
:meth:`~Buffer.low_latency_dispatch` / :meth:`~Buffer.low_latency_combine`
(JAX's packed layout ``[E_local, R·seg, H]``), the normal mode
:meth:`~Buffer.dispatch` / :meth:`~Buffer.combine` (multi-round with
``rounds`` or ``config.normal_round_tokens``: a :class:`MultiRoundHandle`),
DeepSeek-V3's :meth:`~Buffer.fused_deep_moe` (unfused, or the single kernel
K16b) and GPT-OSS's :meth:`~Buffer.fused_oai_moe`, on the three transports
of ``config.comm_backend`` (the collective, and the one-sided window
all-to-alls K15a / K15b), with the monitored exchange (K15c) and the
checksum guard (``validate``).  The four exchange entry points log their
parameters at DEBUG level (:func:`~sgl_kernel_npu_tpu_torch.utils.common.log_parameters`),
as JAX's.

``fused_deep_moe`` and multi-round dispatch honour ``config.comm_backend``,
where JAX's always run their default transport: the results are the same,
and the serve then runs on the window kernels.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

from sgl_kernel_npu_tpu_torch.config import EPConfig, check_backend, check_supported
from sgl_kernel_npu_tpu_torch.parallel import ep_core, fused_full, fused_moe
from sgl_kernel_npu_tpu_torch.parallel.layout import get_dispatch_layout
from sgl_kernel_npu_tpu_torch.utils.common import log_parameters


class EventOverlap:
    """JAX's no-op event, kept for the reference API: the exchanges run on
    the caller's stream, in order with its other work."""

    def current_stream_wait(self) -> None:
        pass


class MultiRoundHandle(NamedTuple):
    """What a multi-round :meth:`Buffer.dispatch` hands :meth:`Buffer.combine`
    (JAX's dict): each round's handle and its rows' places in the merged
    matrix (``ep_core.dispatch_ragged_multi_round``)."""

    rounds: int
    seg: int
    handles: tuple
    positions: tuple


@dataclasses.dataclass
class Buffer:
    """Expert-parallel communication buffer bound to a process group.

    Args:
        group: the EP process group (None: the default group).
        num_experts: total expert count (divisible by the group's size).
        config: static capacity configuration.
    """

    group: object = None
    num_experts: int = 8
    config: EPConfig = EPConfig()

    def __post_init__(self):
        check_supported(self.config)
        self.group_size, self.rank = ep_core.group_info(self.group)
        if self.num_experts % self.group_size:
            raise ValueError(f"num_experts={self.num_experts} not divisible by EP size "
                             f"{self.group_size}")
        self.num_local_experts = self.num_experts // self.group_size

    def _capacities(self, num_tokens: int, topk: int) -> tuple[int, int]:
        """``(pair, seg)`` capacities of a call on ``num_tokens`` tokens a
        rank.  Every rank must pass the same count: the exchanges and the
        windows are sized from it (JAX's global arrays are sharded evenly).
        On a group of more than one rank one all-reduce of ``[T, -T]`` checks
        it, and every rank raises ``ValueError`` together on a mismatch."""
        if self.group_size > 1:
            self._check_equal_tokens(num_tokens)
        seg = max(self.config.num_max_dispatch_tokens_per_rank, num_tokens)
        pair = self.config.pair_capacity(num_tokens, topk, self.group_size,
                                         self.num_local_experts)
        return pair, seg

    def _check_equal_tokens(self, num_tokens: int) -> None:
        nccl = dist.get_backend(self.group) == "nccl"
        dev = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
        t = torch.tensor([num_tokens, -num_tokens], dtype=torch.int64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        most, least = int(t[0]), -int(t[1])
        if most != least:
            raise ValueError(f"the EP group's ranks pass unequal token counts ({least} to "
                             f"{most}; this rank {num_tokens}): every rank must pass the same "
                             "T, as JAX's evenly sharded global arrays do")

    def _local(self, w: torch.Tensor) -> torch.Tensor:
        """This rank's experts of ``w [E, ...]`` (a view)."""
        if w.shape[0] != self.num_experts:
            raise ValueError(f"expert tensor of {w.shape[0]} experts; want {self.num_experts}")
        e = self.num_local_experts
        return w[self.rank * e : (self.rank + 1) * e]

    # -- layout ----------------------------------------------------------------

    def get_dispatch_layout(self, topk_idx: torch.Tensor):
        """This rank's routing statistics: ``(num_tokens_per_rank [R],
        num_tokens_per_expert [E], is_token_in_rank [T, R])``."""
        return get_dispatch_layout(topk_idx, self.num_experts, self.group_size)

    def get_routing_plan(self, topk_idx: torch.Tensor) -> ep_core.RoutingPlan:
        """This rank's source-side routing metadata."""
        pair, seg = self._capacities(*topk_idx.shape)
        return ep_core.make_routing_plan(topk_idx, num_experts=self.num_experts,
                                         num_ranks=self.group_size, my_rank=self.rank,
                                         pair_capacity=pair, seg_capacity=seg)

    # -- low latency (decode) ---------------------------------------------------

    @log_parameters
    def low_latency_dispatch(self, x: torch.Tensor, topk_idx: torch.Tensor,
                             num_max_dispatch_tokens_per_rank: int | None = None, *,
                             use_int8: bool | None = None, backend: str | None = None,
                             monitor: bool | None = None, validate: bool | None = None):
        """Decode-mode dispatch of this rank's ``x [T, H]`` by ``topk_idx [T,
        K]`` → ``(packed_recv_x [E_local, R·seg, H], packed_recv_scales
        [E_local, R·seg] | None, packed_recv_count [E_local], handle,
        stats)``: JAX's packed layout, a segment per (local expert, source
        rank), ``seg`` = ``num_max_dispatch_tokens_per_rank`` (the config's,
        at least T, by default).  int8 with ``use_int8``
        (``config.use_int8_dispatch`` by default), on ``backend``
        (``config.comm_backend``).  ``stats`` holds ``recv_count_matrix [R,
        E_local]`` and ``num_dropped``; with ``monitor`` (``"pallas_ragged"``
        only, K15c) ``wait_recv_cost_stats`` and ``timeout_flags [R]``; with
        ``validate`` (``config.validate_comm``) ``validation_flags [R]``."""
        use_int8 = self.config.use_int8_dispatch if use_int8 is None else use_int8
        backend = backend or self.config.comm_backend
        check_backend(backend)
        monitor = self.config.monitor_comm if monitor is None else monitor
        monitor = monitor and backend == "pallas_ragged"
        validate = self.config.validate_comm if validate is None else validate
        pair, seg = self._capacities(*topk_idx.shape)
        res = ep_core.dispatch_core(
            x, topk_idx, group=self.group, num_experts=self.num_experts,
            num_ranks=self.group_size, pair_capacity=pair,
            seg_capacity=num_max_dispatch_tokens_per_rank or seg, use_int8=use_int8,
            backend=backend, monitor=monitor, validate=validate)
        stats = {"recv_count_matrix": res["recv_count_matrix"], "num_dropped": res["num_dropped"]}
        if monitor:
            stats.update({k: res[k] for k in ("wait_recv_cost_stats", "timeout_flags")})
        if validate:
            stats["validation_flags"] = res["validation_flags"]
        return (res["recv_x"], res.get("recv_scales"), res["recv_count"], res["handle"], stats)

    @log_parameters
    def low_latency_combine(self, y: torch.Tensor, topk_weights: torch.Tensor,
                            handle: ep_core.DispatchHandle, *, out_dtype=torch.bfloat16,
                            backend: str | None = None, monitor: bool | None = None):
        """Decode-mode combine: the experts' outputs ``y`` in
        :meth:`low_latency_dispatch`'s packed layout back to this rank's
        tokens, weighed by ``topk_weights [T, K]`` in f32 → ``[T, H]`` in
        ``out_dtype``.  ``"pallas_ragged"`` returns only the live rows (K15b);
        ``monitor`` (K15c) also returns ``{"combine_wait_cost_stats",
        "payload_wait_cost_stats", "timeout_flags"}`` (each ``[R]``).  A
        handle without send counts combines with zero counts, as JAX's."""
        backend = backend or self.config.comm_backend
        check_backend(backend)
        monitor = self.config.monitor_comm if monitor is None else monitor
        monitor = monitor and backend == "pallas_ragged"
        if self.group_size > 1:
            self._check_equal_tokens(topk_weights.shape[0])
        if handle.sent_counts is None:
            zero = torch.zeros((self.group_size, self.num_local_experts), dtype=torch.int32,
                               device=y.device)
            handle = handle._replace(sent_counts=zero, recv_counts=zero)
        out = ep_core.combine_core(
            y, topk_weights, handle, group=self.group, num_ranks=self.group_size,
            seg_capacity=y.shape[1] // self.group_size, out_dtype=out_dtype, backend=backend,
            monitor=monitor)
        if not monitor:
            return out
        out, st = out
        return out, {"combine_wait_cost_stats": st[:, 0], "payload_wait_cost_stats": st[:, 3],
                     "timeout_flags": st[:, 1] | st[:, 4]}

    # -- normal mode (prefill) ---------------------------------------------------

    @log_parameters
    def dispatch(self, x: torch.Tensor, topk_idx: torch.Tensor, *, use_int8: bool | None = None,
                 rounds: int | None = None, backend: str | None = None,
                 monitor: bool | None = None):
        """Normal-mode dispatch of this rank's ``x [T, H]`` by ``topk_idx [T,
        K]`` → ``(recv_x_sorted [R·C, H], recv_scales [R·C] | None,
        group_sizes [E_local], handle, stats)``: the rows this rank's experts
        receive, grouped by local expert, ready for the grouped GEMMs
        (int8 with ``use_int8``, ``config.use_int8_dispatch`` by default),
        on ``backend`` (``config.comm_backend`` by default); ``stats`` holds
        ``recv_count_matrix`` and ``num_dropped``, and with ``monitor``
        (``config.monitor_comm`` by default; ``"pallas_ragged"`` only, K15c)
        ``wait_recv_cost_stats``, ``timeout_flags`` and
        ``payload_wait_cost_stats [R]`` of the payload exchange.

        ``rounds`` (by default ``T // config.normal_round_tokens``, at least
        1, where that is set) above 1 moves ``T / rounds`` tokens a round
        through a round's buffers and merges the rows
        (``ep_core.dispatch_ragged_multi_round``: the same rows, ``R·C``
        and the handle a round's; T must divide into the rounds): the
        handle is then a :class:`MultiRoundHandle` and ``monitor`` is not
        taken, as in JAX."""
        use_int8 = self.config.use_int8_dispatch if use_int8 is None else use_int8
        backend = backend or self.config.comm_backend
        check_backend(backend)
        monitor = self.config.monitor_comm if monitor is None else monitor
        monitor = monitor and backend == "pallas_ragged"
        t, k = topk_idx.shape
        if rounds is None and self.config.normal_round_tokens:
            rounds = max(1, t // self.config.normal_round_tokens)
        if rounds and rounds > 1:
            return self._dispatch_multi_round(x, topk_idx, use_int8, rounds, backend)
        pair, seg = self._capacities(t, k)
        res = ep_core.dispatch_ragged_core(
            x, topk_idx, group=self.group, num_experts=self.num_experts,
            num_ranks=self.group_size, pair_capacity=pair, seg_capacity=seg, use_int8=use_int8,
            backend=backend, monitor=monitor)
        stats = {"recv_count_matrix": res["recv_count_matrix"], "num_dropped": res["num_dropped"]}
        if monitor:
            stats.update({k: res[k] for k in ("wait_recv_cost_stats", "timeout_flags",
                                              "payload_wait_cost_stats")})
        return (res["recv_x_sorted"], res.get("recv_scales_sorted"), res["group_sizes"],
                res["handle"], stats)

    def _dispatch_multi_round(self, x, topk_idx, use_int8, rounds, backend):
        t, k = topk_idx.shape
        if self.group_size > 1:
            self._check_equal_tokens(t)
        seg = t // rounds
        pair = self.config.pair_capacity(seg, k, self.group_size, self.num_local_experts)
        res = ep_core.dispatch_ragged_multi_round(
            x, topk_idx, rounds=rounds, group=self.group, num_experts=self.num_experts,
            num_ranks=self.group_size, pair_capacity=pair, seg_capacity=seg, use_int8=use_int8,
            backend=backend)
        handle = MultiRoundHandle(rounds, seg, tuple(res["round_handles"]),
                                  tuple(res["round_positions"]))
        stats = {"recv_count_matrix": res["recv_count_matrix"], "num_dropped": res["num_dropped"]}
        return (res["recv_x_sorted"], res.get("recv_scales_sorted"), res["group_sizes"], handle,
                stats)

    @log_parameters
    def combine(self, y_sorted: torch.Tensor, topk_weights: torch.Tensor, handle, *,
                out_dtype=torch.bfloat16, backend: str | None = None) -> torch.Tensor:
        """Normal-mode combine: the experts' outputs ``y_sorted`` (in
        :meth:`dispatch`'s order) back to this rank's tokens, weighed by
        ``topk_weights [T, K]`` in f32 → ``[T, H]`` in ``out_dtype``, on
        ``backend`` (``config.comm_backend`` by default).  ``handle`` is a
        :class:`~sgl_kernel_npu_tpu_torch.parallel.ep_core.DispatchHandle`
        or a :class:`MultiRoundHandle`."""
        backend = backend or self.config.comm_backend
        check_backend(backend)
        if isinstance(handle, MultiRoundHandle):
            if self.group_size > 1:
                self._check_equal_tokens(topk_weights.shape[0])
            return ep_core.combine_ragged_multi_round(
                y_sorted, topk_weights, handle.handles, handle.positions, group=self.group,
                num_ranks=self.group_size, num_local_experts=self.num_local_experts,
                seg_capacity=handle.seg, out_dtype=out_dtype, backend=backend)
        _, seg = self._capacities(*topk_weights.shape)
        return ep_core.combine_ragged_core(
            y_sorted, topk_weights, handle, group=self.group, num_ranks=self.group_size,
            num_local_experts=self.num_local_experts, seg_capacity=seg, out_dtype=out_dtype,
            backend=backend)

    # -- fused MoE ----------------------------------------------------------------

    def fused_oai_moe(self, x, topk_idx, topk_weights, w_gate_up, b_gate_up, w_down, b_down,
                      *, alpha: float = 1.702, limit: float = 7.0, plain: bool = False):
        """GPT-OSS's expert-parallel MoE on this rank's tokens: dispatch at
        x's dtype → biased gate | up grouped GEMM → clamped interleaved SwiGLU
        → biased down grouped GEMM → combine
        (:func:`~sgl_kernel_npu_tpu_torch.parallel.fused_moe.fused_oai_moe_rank`;
        ``plain`` runs the grouped GEMM's plain version).  The expert tensors
        are the whole ``[E, ...]``; each rank reads its slice.  Returns
        ``(combined [T, H], group_sizes [E_local], num_dropped [])``."""
        pair, seg = self._capacities(*topk_idx.shape)
        return fused_moe.fused_oai_moe_rank(
            x, topk_idx, topk_weights, *(self._local(w) for w in (w_gate_up, b_gate_up, w_down,
                                                                   b_down)),
            group=self.group, num_experts=self.num_experts, num_ranks=self.group_size,
            pair_capacity=pair, seg_capacity=seg, alpha=alpha, limit=limit, plain=plain)

    def fused_deep_moe(self, x, topk_idx, topk_weights, w1, w1_scale, w2, w2_scale, *,
                       gmm_tiles=None, pack_tn: int | None = None, chunks: int = 1,
                       use_int8_dispatch: bool = True, single_kernel: bool = False,
                       full_tiles=None, plain: bool = False):
        """DeepSeek-V3's expert-parallel W8A8 MoE on this rank's tokens:
        dispatch → GMM1 → SwiGLU → requant → GMM2 → combine.  Unfused
        (:func:`~sgl_kernel_npu_tpu_torch.parallel.fused_moe.fused_deep_moe_rank`:
        the exchanges on ``config.comm_backend`` and K8a twice), or with
        ``single_kernel`` in one launch
        (:func:`~sgl_kernel_npu_tpu_torch.parallel.fused_full.fused_deep_moe_full_rank`,
        K16b; ``chunks`` and ``use_int8_dispatch`` apply to the unfused form
        only, as in JAX).  ``w1 [E, H, 2I]`` int8 with gate / up packed at
        width ``pack_tn`` (``moe_pack_tn``'s by default; narrower than 2I
        the unfused form runs K8a's ``dequant_swiglu`` and a requant, K16b
        pairs gate and up by the pack width), ``w1_scale [E, 2I]``, ``w2 [E,
        I, H]``, ``w2_scale [E, H]``: the whole expert tensors, each rank reading its
        slice.  ``gmm_tiles`` and
        ``full_tiles`` (the TPU's tiles) are not taken.  ``plain`` runs the
        plain versions: the group's collective for the exchanges, K8a's or
        K16b's plain version.  Returns ``(combined [T, H] bf16, recv_count
        [E_local], num_dropped [])``."""
        pair, seg = self._capacities(*topk_idx.shape)
        local = [self._local(w) for w in (w1, w1_scale, w2, w2_scale)]
        if single_kernel:
            return fused_full.fused_deep_moe_full_rank(
                x, topk_idx, topk_weights, *local, group=self.group,
                num_experts=self.num_experts, num_ranks=self.group_size, seg_capacity=seg,
                pack_tn=pack_tn, plain=plain)
        return fused_moe.fused_deep_moe_rank(
            x, topk_idx, topk_weights, *local, group=self.group, num_experts=self.num_experts,
            num_ranks=self.group_size, pair_capacity=pair, seg_capacity=seg, pack_tn=pack_tn,
            chunks=chunks, use_int8_dispatch=use_int8_dispatch,
            backend="xla" if plain else self.config.comm_backend, plain=plain)
