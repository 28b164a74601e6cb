"""DeepEP-style user API over a ``torch.distributed`` process group.

Counterpart of ``sgl_kernel_npu_tpu/parallel/buffer.py``.  JAX binds the
buffer to a mesh axis and its methods take global arrays sharded over it,
returning results stacked by rank; the port binds it to a process group (one
process a rank, as ``torch.distributed`` runs) and its methods take this
rank's rows and return this rank's results: the ``shard_map`` body's view,
without the leading rank dimension (ROADMAP §C).  Shapes are static worst
cases, as in JAX: no host sync on the serving path.

Ported: :meth:`Buffer.get_dispatch_layout`, :meth:`~Buffer.get_routing_plan`,
the normal mode :meth:`~Buffer.dispatch` / :meth:`~Buffer.combine` and
GPT-OSS's :meth:`~Buffer.fused_oai_moe`, on the default transport.  The
low-latency (decode) mode and ``fused_deep_moe`` raise ``NotImplementedError``
(ROADMAP item 16).
"""

from __future__ import annotations

import dataclasses

import torch

from sgl_kernel_npu_tpu_torch.config import EPConfig, check_backend, check_supported
from sgl_kernel_npu_tpu_torch.parallel import ep_core, fused_moe
from sgl_kernel_npu_tpu_torch.parallel.layout import get_dispatch_layout


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
        seg = max(self.config.num_max_dispatch_tokens_per_rank, num_tokens)
        pair = self.config.pair_capacity(num_tokens, topk, self.group_size,
                                         self.num_local_experts)
        return pair, seg

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

    # -- not ported --------------------------------------------------------------

    def low_latency_dispatch(self, *args, **kwargs):
        raise NotImplementedError("Buffer.low_latency_dispatch (the decode mode) is not "
                                  "ported yet (ROADMAP item 16)")

    def low_latency_combine(self, *args, **kwargs):
        raise NotImplementedError("Buffer.low_latency_combine (the decode mode) is not "
                                  "ported yet (ROADMAP item 16)")

    def fused_deep_moe(self, *args, **kwargs):
        raise NotImplementedError(
            "Buffer.fused_deep_moe is not ported yet (ROADMAP item 16): its unfused form "
            "runs on K8a's int8 modes, which are; single_kernel=True is K16")

    # -- normal mode (prefill) ---------------------------------------------------

    def dispatch(self, x: torch.Tensor, topk_idx: torch.Tensor, *, use_int8: bool | None = None,
                 rounds: int | None = None, backend: str | None = None,
                 monitor: bool | None = None):
        """Normal-mode dispatch of this rank's ``x [T, H]`` by ``topk_idx [T,
        K]`` → ``(recv_x_sorted [R·C, H], recv_scales [R·C] | None,
        group_sizes [E_local], handle, stats)``: the rows this rank's experts
        receive, grouped by local expert, ready for the grouped GEMMs
        (int8 with ``use_int8``, ``config.use_int8_dispatch`` by default);
        ``stats`` holds ``recv_count_matrix`` and ``num_dropped``."""
        use_int8 = self.config.use_int8_dispatch if use_int8 is None else use_int8
        check_backend(backend or self.config.comm_backend)
        if monitor or (rounds or 1) > 1:
            raise NotImplementedError("monitored and multi-round dispatch are not ported yet "
                                      "(ROADMAP item 16)")
        pair, seg = self._capacities(*topk_idx.shape)
        res = ep_core.dispatch_ragged_core(
            x, topk_idx, group=self.group, num_experts=self.num_experts,
            num_ranks=self.group_size, pair_capacity=pair, seg_capacity=seg, use_int8=use_int8)
        stats = {"recv_count_matrix": res["recv_count_matrix"], "num_dropped": res["num_dropped"]}
        return (res["recv_x_sorted"], res.get("recv_scales_sorted"), res["group_sizes"],
                res["handle"], stats)

    def combine(self, y_sorted: torch.Tensor, topk_weights: torch.Tensor,
                handle: ep_core.DispatchHandle, *, out_dtype=torch.bfloat16,
                backend: str | None = None) -> torch.Tensor:
        """Normal-mode combine: the experts' outputs ``y_sorted`` (in
        :meth:`dispatch`'s order) back to this rank's tokens, weighed by
        ``topk_weights [T, K]`` in f32 → ``[T, H]`` in ``out_dtype``."""
        check_backend(backend or self.config.comm_backend)
        _, seg = self._capacities(*topk_weights.shape)
        return ep_core.combine_ragged_core(
            y_sorted, topk_weights, handle, group=self.group, num_ranks=self.group_size,
            num_local_experts=self.num_local_experts, seg_capacity=seg, out_dtype=out_dtype)

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
