"""Continuous-batching serving engine over the native radix cache.

Counterpart of ``sgl_kernel_npu_tpu/runtime/engine.py`` (``ModelAdapter``,
``deepseek_adapter``, ``gpt_oss_adapter``, ``llama_adapter``,
``SamplingParams``, ``Engine``): request admission → radix prefix reuse
(``csrc/cache_manager.cpp``) → chunked varlen prefill → batched paged
decode, mixed with prefill or prefill first (``mixed=False``) → greedy or
sampled tokens (temperature / top-k / top-p / min-p, repetition / presence /
frequency penalties, ``ops/sampling.py``) with their log-probabilities and
stop tokens, or speculative decoding (a draft adapter's chains verified by
one packed varlen prefill of the target, ``ops/speculative.py``; chain or
root-branching tree) → refcounted release.  The penalties' occurrence
counts stay on the host (numpy), as in JAX: a sampled decode call with
penalties copies them to the card, ``[max_batch, V]`` int32.  Where JAX jits
each call with the caches donated, the port runs eagerly and the model
updates the cache tensors in place.  The engine keeps the JAX engine's fixed batch widths
(``prefill_chunk`` rows per prefill call, ``max_batch`` rows per decode
call, ``max_batch`` sequences of ``spec_k + 1`` rows per verify call): pad
rows carry slot -1, context 1 and a block table of zeros.  A request's
pages are bounded by ``max_pages_per_req`` (33 pages of 128 hold a
4096-token prompt and its decode).

Adapters: ``deepseek_adapter``, ``gpt_oss_adapter``, ``llama_adapter``,
``llama_cp_adapter``, ``llama_pp_adapter`` and
``qwen3_hybrid_adapter`` (Qwen3-Next: GDN layers with recurrent state pools
beside paged attention layers, one request a prefill call).  Their KV cache
is bf16 on the card and f32 on the CPU unless the caller names a dtype: the
card's attention kernels take bf16 or int8 caches, where JAX defaults to f32
everywhere.  Every model call passes each row's recurrent-state slot
(``state_idx``: the request's, -1 on pad rows; ``init_cache`` sizes the
pools for ``max_batch + 1`` slots, as JAX) and each row's LoRA adapter
(``lora_idx``: the request's on every prefill row, 0 on decode pad rows);
adapters without recurrent state ignore the first, all but Llama's the
second.  Multi-LoRA: ``llama_adapter(lora=...)`` and
``add_request(lora_id=...)``.  ``llama_cp_adapter`` and
``llama_pp_adapter`` serve Llama context or pipeline parallel over a process
group, one ``Engine`` a rank over the same requests (every rank takes the
same decisions: the hidden state that reaches the head has the same bits on
every rank).  A target with recurrent state or one-request prefill
(Qwen3-Next) under tree speculation raises (item 14).

The L2 host KV tier (``HostKVPool``, ``Engine(host_pool_pages=...)`` or
``Engine(host_pool=...)``): a finished prompt's full pages are offloaded into
a second radix cache over a host pool (the adapters' ``gather_pages`` hook,
then the pool's rows), and admission restores a longer prefix from it after
a device-radix miss (the pool's rows, then ``scatter_pages``).  Engines over
one model that share a ``HostKVPool`` disaggregate prefill and decode: a
prefill engine offloads, a decode engine restores and prefills only the
tail.  On the card the pool is pinned host memory; each leaf moves by one
device gather or scatter and one asynchronous copy a run of consecutive
host pages (``utils/kvcacheio.py``), synchronised before the host reads the
pool.  The tier is refused with a draft adapter, as in JAX.

Prefix reuse and LoRA (a departure from the JAX engine, whose radix is keyed
by tokens alone): LoRA on the q and o projections makes every layer's K / V
after the first depend on the adapter, so a request with ``lora_id != 0``
neither matches nor inserts into the radix; adapter-0 requests share pages
as before; likewise it neither restores from the host tier nor offloads to
it.  JAX reuses one adapter's pages for another's request on the same
prompt, on the device and through the host pool.

Recurrent state (two departures from the JAX engine, which gives wrong
tokens in both cases): (a) at admission the request's state slot is set to
a zero state (the adapter's ``restore_state`` with a zero snapshot shaped
like ``snapshot_state``'s), where JAX starts a reused slot from the previous
request's final state; (b) a request on an adapter with recurrent state
neither matches nor inserts into the radix (the LoRA rule, at the same
places): a matched prefix would skip the recurrence over its tokens, which
the pages alone cannot stand for.  JAX matches it and its GDN layers never
see the matched tokens.

Radix refcount protocol (single-threaded engine; see csrc/cache_manager.cpp):
  admit       — match(prompt[:-1]) holds the shared prefix; allocate the tail
  prompt done — insert(span, ref=0) then one match(span) = one hold per page;
                duplicates beyond the admit prefix were raced in by an
                identical in-flight prompt: remap to canonical pages, free ours
  finish      — release(span); free the private (uncached) pages
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np
import torch

from sgl_kernel_npu_tpu_torch.ops.sampling import apply_penalties, sample_tokens, token_logprobs
from sgl_kernel_npu_tpu_torch.ops.speculative import verify_tree_greedy
from sgl_kernel_npu_tpu_torch.runtime.cache_manager import RadixCacheManager
from sgl_kernel_npu_tpu_torch.utils.common import resolve_device, top_k
from sgl_kernel_npu_tpu_torch.utils.kvcacheio import rows_to_device, rows_to_host, synchronize


@dataclasses.dataclass
class ModelAdapter:
    """The callables the engine drives, all on ``device``."""

    page_size: int
    device: torch.device
    embed: Callable            # ids [N] → hidden [N, H]
    lm_head: Callable          # hidden [N, H] → logits [N, V]
    # (x, seq_lens, caches, bt, ctx, slots, state_idx, lora_idx) → (h, caches)
    prefill_step: Callable
    # (x, pos, caches, bt, ctx, slots, state_idx, lora_idx) → (h, caches)
    decode_step: Callable
    init_cache: Callable       # (num_pages, state_slots) → caches
    # recurrent-state hooks (hybrid models; None for paged KV alone):
    # snapshot_state(caches, state_idx [B]) → snap; restore_state(caches,
    # snap, state_idx) writes it back in place → caches
    snapshot_state: Callable | None = None
    restore_state: Callable | None = None
    # True where prefill_step takes one request a call (the GDN recurrence)
    prefill_single: bool = False
    # True where prefill_step takes a request's whole prompt from position 0
    # in one call (context-parallel prefill): its requests take no prefix
    # match, and add_request refuses a prompt longer than prefill_chunk
    prefill_whole: bool = False
    # host-tier hooks: gather_pages(caches, ids [n]) → every cache tensor's
    # rows at those pages (the caches' structure); scatter_pages(caches, ids,
    # payload) writes them back in place → caches
    gather_pages: Callable | None = None
    scatter_pages: Callable | None = None


def _map_cache(fn, caches):
    """``caches``' structure (a layer's ``(k, v)`` tuple or its ``{"nope",
    "rope"[, "kidx"]}`` dict) with ``fn(tensor)`` at each tensor."""
    return [{k: fn(t) for k, t in layer.items()} if isinstance(layer, dict)
            else tuple(fn(t) for t in layer) for layer in caches]


def cache_tensors(caches) -> list[torch.Tensor]:
    """Every tensor of every layer's cache, layer by layer."""
    return [t for layer in caches for t in (layer.values() if isinstance(layer, dict) else layer)]


def paged_gather_pages(caches, page_ids: torch.Tensor):
    """The host-offload gather for any cache whose tensors lead with the
    page dimension (Llama's and GPT-OSS's ``(k, v)``, plain, int8 or packed;
    DeepSeek's latent, rope and index-key caches): each tensor's rows at
    ``page_ids`` (int64, on the caches' device), in the caches' structure."""
    return _map_cache(lambda t: t.index_select(0, page_ids), caches)


def paged_scatter_pages(caches, page_ids: torch.Tensor, payload):
    """Write ``payload`` (:func:`paged_gather_pages`' structure) into pages
    ``page_ids`` of every cache tensor, cast to its dtype, in place; returns
    ``caches``."""
    for t, p in zip(cache_tensors(caches), cache_tensors(payload), strict=True):
        t.index_copy_(0, page_ids, p.to(t.dtype))
    return caches


def _cache_dtype(dtype, dev: torch.device):
    """The KV cache's dtype: ``dtype``, or when None bf16 on the card (its
    attention kernels take bf16 or int8 caches) and f32 on the CPU (JAX's
    default).  An explicit f32 on the card raises at the first attention
    call."""
    if dtype is not None:
        return dtype
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def deepseek_adapter(cfg, params, dtype=None, *, moe_weights_q=None, mla_wq=None,
                     ep_buffer=None, eplb_tables=None, device="cuda") -> ModelAdapter:
    """DeepSeek-V3: ``moe_weights_q``
    (``models.deepseek_v3.quantize_moe_weights`` or ``init_quantized_experts``)
    serves W8A8 routed experts, without it the float experts of ``params``
    serve on the dense MoE (every expert for every token).  Adding
    ``ep_buffer`` (a ``parallel.buffer.Buffer`` built for the expert count)
    serves the W8A8 MoE expert parallel through ``Buffer.fused_deep_moe``;
    ``eplb_tables`` (``parallel.eplb.make_remap_tables``) serves an EPLB
    placement (pass physically gathered ``moe_weights_q`` and a Buffer built
    for the physical expert count).  ``mla_wq``
    (``models.deepseek_v3.make_mla_preprocess_weights``) runs the fused W8A8
    prologue on prefill and decode.  ``dtype`` is the KV cache's
    (:func:`_cache_dtype`); the int8 latent cache rides on
    ``cfg.kv_cache_dtype``, as in JAX.  Each prefill call takes ``max_q`` =
    its row count, the engine's ``prefill_chunk``: a chunk above 512 tokens
    runs its single-GPU W8A8 MoE on ``grouped_matmul`` (K8a)."""
    from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as m

    dev = resolve_device(device)
    dtype = _cache_dtype(dtype, dev)
    ep = dict(ep_buffer=ep_buffer, eplb_tables=eplb_tables)
    return ModelAdapter(
        page_size=cfg.page_size,
        device=dev,
        embed=lambda ids: m.embed(params, ids),
        lm_head=lambda x: m.lm_head(params, x),
        prefill_step=lambda x, sl, c, bt, ctx, slots, si, li: m.prefill_step(
            cfg, params, x, sl, c, bt, ctx, slots, max_q=x.shape[0],
            moe_weights_q=moe_weights_q, mla_wq=mla_wq, **ep),
        decode_step=lambda x, pos, c, bt, ctx, slots, si, li: m.decode_step(
            cfg, params, x, pos, c, bt, ctx, slots, moe_weights_q=moe_weights_q,
            mla_wq=mla_wq, **ep),
        init_cache=lambda n, s_=0: m.init_kv_cache(cfg, n, dtype, device=dev),
        gather_pages=paged_gather_pages,
        scatter_pages=paged_scatter_pages,
    )


def gpt_oss_adapter(cfg, params, dtype=None, *, weights_q=None, ep_buffer=None,
                    device="cuda") -> ModelAdapter:
    """GPT-OSS (``models.gpt_oss``): ``dtype`` is the KV cache's
    (:func:`_cache_dtype`; the int8 and packed caches ride on ``cfg``, their
    scale ``cfg.kv_scale``, as JAX's adapter passes no ``kv_scales``);
    ``weights_q`` (``models.gpt_oss.quantize_weights``) serves W8A8;
    ``ep_buffer`` (a ``parallel.buffer.Buffer`` built for
    ``cfg.num_experts``) serves the MoE expert parallel through
    ``Buffer.fused_oai_moe``.  Each prefill call takes ``max_q`` = its row
    count, the engine's ``prefill_chunk``."""
    from sgl_kernel_npu_tpu_torch.models import gpt_oss as m

    dev = resolve_device(device)
    dtype = _cache_dtype(dtype, dev)
    return ModelAdapter(
        page_size=cfg.page_size,
        device=dev,
        embed=lambda ids: m.embed(params, ids),
        lm_head=lambda x: m.lm_head(params, x),
        prefill_step=lambda x, sl, c, bt, ctx, slots, si, li: m.prefill_step(
            cfg, params, x, sl, c, bt, ctx, slots, max_q=x.shape[0], weights_q=weights_q,
            ep_buffer=ep_buffer),
        decode_step=lambda x, pos, c, bt, ctx, slots, si, li: m.decode_step(
            cfg, params, x, pos, c, bt, ctx, slots, weights_q=weights_q, ep_buffer=ep_buffer),
        init_cache=lambda n, s_=0: m.init_kv_cache(cfg, n, dtype, device=dev),
        gather_pages=paged_gather_pages,
        scatter_pages=paged_scatter_pages,
    )


def llama_adapter(cfg, params, dtype=None, *, lora=None, weights_q=None,
                  device="cuda") -> ModelAdapter:
    """Llama (``models.llama``): ``dtype`` is the KV cache's
    (:func:`_cache_dtype`; the int8 cache rides on ``cfg``, its scale
    ``cfg.kv_scale``); ``weights_q`` (``models.llama.quantize_weights``)
    serves W8A8; ``lora`` (``models.llama.init_lora`` or ``from_jax_lora``)
    serves multiple adapters, each request choosing one by
    ``Engine.add_request(lora_id=...)``.  Each prefill call takes ``max_q`` =
    its row count."""
    from sgl_kernel_npu_tpu_torch.models import llama as m

    dev = resolve_device(device)
    dtype = _cache_dtype(dtype, dev)
    return ModelAdapter(
        page_size=cfg.page_size,
        device=dev,
        embed=lambda ids: m.embed(params, ids),
        lm_head=lambda x: m.lm_head(params, x),
        prefill_step=lambda x, sl, c, bt, ctx, slots, si, li: m.prefill_step(
            cfg, params, x, sl, c, bt, ctx, slots, max_q=x.shape[0], lora=lora, lora_idx=li,
            weights_q=weights_q),
        decode_step=lambda x, pos, c, bt, ctx, slots, si, li: m.decode_step(
            cfg, params, x, pos, c, bt, ctx, slots, lora=lora, lora_idx=li, weights_q=weights_q),
        init_cache=lambda n, s_=0: m.init_kv_cache(cfg, n, dtype, device=dev),
        gather_pages=paged_gather_pages,
        scatter_pages=paged_scatter_pages,
    )


def llama_cp_adapter(cfg, params, group, dtype=None, *, device="cuda") -> ModelAdapter:
    """Context-parallel Llama over the ranks of ``group`` (a
    ``torch.distributed`` process group; each rank runs its own ``Engine``
    over the same requests): prefill is ``models.llama.prefill_step_cp``
    (the sequence sharded over the ranks, each attending the gathered K /
    V), decode the ordinary ``decode_step`` (K11a) on the cache every rank
    holds whole.  CP replaces chunked prefill: build the Engine with
    ``prefill_chunk`` at least the longest prompt and divisible by the ring
    size (JAX documents the restriction): ``Engine.add_request`` refuses a
    longer prompt with ``ValueError`` and the first prefill call a chunk the
    ring cannot split.  Its requests take no prefix match from the radix
    (``prefill_whole``): the CP prefill starts every prompt at position
    0."""
    from sgl_kernel_npu_tpu_torch.models import llama as m

    dev = resolve_device(device)
    dtype = _cache_dtype(dtype, dev)
    return ModelAdapter(
        page_size=cfg.page_size,
        device=dev,
        embed=lambda ids: m.embed(params, ids),
        lm_head=lambda x: m.lm_head(params, x),
        prefill_step=lambda x, sl, c, bt, ctx, slots, si, li: m.prefill_step_cp(
            cfg, params, x, sl, c, bt, ctx, slots, group=group),
        decode_step=lambda x, pos, c, bt, ctx, slots, si, li: m.decode_step(
            cfg, params, x, pos, c, bt, ctx, slots),
        init_cache=lambda n, s_=0: m.init_kv_cache(cfg, n, dtype, device=dev),
        prefill_whole=True,
        gather_pages=paged_gather_pages,
        scatter_pages=paged_scatter_pages,
    )


def llama_pp_adapter(cfg, params, group, dtype=None, *, device="cuda") -> ModelAdapter:
    """Pipeline-parallel Llama over the ranks of ``group`` (each rank runs
    its own ``Engine`` over the same requests): the layer stack cut into one
    stage a rank (``models.llama_pp``); this rank keeps its stage's weights
    (``stack_stage_params(..., rank=)``) and its stage's KV slice, the
    embedding and the head replicated.  No host tier (no page hooks, as
    JAX's)."""
    from sgl_kernel_npu_tpu_torch.models import llama as m
    from sgl_kernel_npu_tpu_torch.models import llama_pp as mp
    from sgl_kernel_npu_tpu_torch.parallel.collectives import group_rank, group_size

    dev = resolve_device(device)
    dtype = _cache_dtype(dtype, dev)
    stages = group_size(group)
    pp_params = mp.stack_stage_params(cfg, params, stages, rank=group_rank(group))
    shared = {k: params[k] for k in ("wte", "w_lm") if k in params}
    return ModelAdapter(
        page_size=cfg.page_size,
        device=dev,
        embed=lambda ids: m.embed(shared, ids),
        lm_head=lambda x: m.lm_head(shared, x),
        prefill_step=lambda x, sl, c, bt, ctx, slots, si, li: mp.prefill_step_pp(
            cfg, pp_params, x, sl, c, bt, ctx, slots, group=group, max_q=x.shape[0]),
        decode_step=lambda x, pos, c, bt, ctx, slots, si, li: mp.decode_step_pp(
            cfg, pp_params, x, pos, c, bt, ctx, slots, group=group),
        init_cache=lambda n, s_=0: mp.init_kv_cache_pp(cfg, n, stages, dtype, device=dev),
    )


def qwen3_hybrid_adapter(cfg, params, dtype=None, *, weights_q=None, moe_weights_q=None,
                         ep_buffer=None, device="cuda") -> ModelAdapter:
    """Qwen3-Next's hybrid (``models.qwen3_next``): GDN state pools (one
    slot a running request, ``state_idx``) beside paged attention layers,
    one request a prefill call (``prefill_single``), the snapshot / restore
    hooks over the pools.  ``dtype`` is the KV cache's and the conv pools'
    (:func:`_cache_dtype`; the ssm pools are f32); ``weights_q``
    (``models.qwen3_next.quantize_hybrid_weights``) serves W8A8;
    ``moe_weights_q`` (``models.qwen3_next.quantize_hybrid_moe_weights``)
    with ``ep_buffer`` (a ``parallel.buffer.Buffer`` built for
    ``cfg.moe_experts``) serves the routed experts expert parallel through
    ``Buffer.fused_deep_moe``; one of the two alone raises ``ValueError``.
    No host tier (no page hooks, as JAX's).  Each prefill call takes
    ``max_q`` = its row count."""
    from sgl_kernel_npu_tpu_torch.models import qwen3_next as m

    m.check_ep(moe_weights_q, ep_buffer)
    kw = dict(weights_q=weights_q, moe_weights_q=moe_weights_q, ep_buffer=ep_buffer)
    dev = resolve_device(device)
    dtype = _cache_dtype(dtype, dev)
    return ModelAdapter(
        page_size=cfg.page_size,
        device=dev,
        embed=lambda ids: m.hybrid_embed(params, ids),
        lm_head=lambda x: m.hybrid_lm_head(params, x),
        prefill_step=lambda x, sl, c, bt, ctx, slots, si, li: m.hybrid_prefill_step(
            cfg, params, x, sl, c, bt, ctx, slots, si, max_q=x.shape[0], **kw),
        decode_step=lambda x, pos, c, bt, ctx, slots, si, li: m.hybrid_decode_step(
            cfg, params, x, pos, c, bt, ctx, slots, si, **kw),
        init_cache=lambda n, s_: m.init_hybrid_cache(cfg, n, s_, dtype, device=dev),
        snapshot_state=lambda c, si: m.hybrid_state_snapshot(cfg, c, si),
        restore_state=lambda c, snap, si: m.hybrid_state_restore(cfg, c, snap, si),
        prefill_single=True,
    )


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling (``ops/sampling.py``): ``temperature=0`` is
    greedy; the filters compose top-k → top-p → min-p; deterministic in
    ``(seed, step)``."""

    temperature: float = 0.0
    top_k: int = 0          # <= 0: off
    top_p: float = 1.0      # >= 1: off
    min_p: float = 0.0      # <= 0: off
    seed: int = 0
    # occurrence penalties over prompt + generated tokens (HF / OpenAI semantics)
    repetition_penalty: float = 1.0   # 1 = off
    presence_penalty: float = 0.0     # 0 = off
    frequency_penalty: float = 0.0    # 0 = off

    @property
    def needs_counts(self) -> bool:
        return (self.repetition_penalty != 1.0 or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray            # int32 token ids
    max_new_tokens: int
    lora_id: int = 0              # LoRA adapter (0 = none)
    state_slot: int = -1          # recurrent-state pool slot (hybrid models)
    pages: list = dataclasses.field(default_factory=list)   # block table (physical)
    pos: int = 0                  # tokens whose KV is in the cache
    sampling: SamplingParams | None = None    # None = greedy
    stop_tokens: frozenset = frozenset()       # finish early on any of these
    want_logprobs: bool = False
    out_logprobs: list = dataclasses.field(default_factory=list)
    tok_counts: np.ndarray | None = None       # [V] occurrence counts (penalties)
    admit_matched: int = 0        # tokens held via the admit-time match
    inserted_span: int = 0        # tokens held via the post-prefill insert
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    def token_at(self, i: int) -> int:
        """Full sequence view: prompt then generated tokens."""
        return int(self.prompt[i]) if i < self.prompt_len else self.out_tokens[
            i - self.prompt_len]


@dataclasses.dataclass
class DecodeBatch:
    """One decode call's inputs (``max_batch`` rows, pad rows after the live ones)."""

    ids: torch.Tensor
    pos: torch.Tensor
    block_table: torch.Tensor
    ctx: torch.Tensor
    slots: torch.Tensor
    state_idx: torch.Tensor       # each row's recurrent-state slot, -1 on pad rows
    lora_idx: torch.Tensor        # each row's adapter, 0 on pad rows


def _copy_pages(caches, src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy pages ``src`` onto pages ``dst`` in every tensor of every
    layer's cache, in place."""
    paged_scatter_pages(caches, dst, paged_gather_pages(caches, src))


class HostKVPool:
    """A host KV pool and its radix index, shareable by several engines over
    one model.

    Engines that share one pool disaggregate prefill and decode: a prefill
    engine offloads each finished prompt's pages here, and a decode engine
    matches the same prompt at admission, restores the prefix from the pool
    and decodes without computing that prefill again.  This is the serving
    role of the reference's ``transfer_kv_dim_exchange`` (device <-> host KV
    migration, ``utils/kvcacheio.py``).  ``pool`` has the caches' structure:
    a CPU tensor ``[num_pages, ...]`` for each cache tensor, in its dtype,
    made at the first offload (pinned when the caches are on the card).
    """

    def __init__(self, num_pages: int, page_size: int):
        self.cm = RadixCacheManager(num_pages, page_size)
        self.pool = None
        self.page = page_size


class Engine:
    """Continuous-batching engine: ``add_request`` then ``step`` until drained.

    ``mixed=True`` (the default) advances every decoding request and
    prefills one chunk each tick; ``mixed=False`` prefills first.
    ``spec_k > 0`` with a ``draft_adapter`` (the target's page geometry; its
    own KV pool on the same pages) decodes speculatively: ``spec_k`` draft
    tokens a round, one varlen verify (a verify a request, the recurrent
    state rolled back, for a target with ``prefill_single`` or the snapshot
    hooks); ``spec_tree_width > 1`` branches the first draft token top-B
    with copy-on-write suffix pages (width 1: the chain).
    ``host_pool_pages > 0`` gives the engine an L2 host KV tier of its own,
    ``host_pool`` attaches a shared one (:class:`HostKVPool`)."""

    def __init__(self, adapter: ModelAdapter, num_pages: int, *, max_batch: int = 8,
                 max_pages_per_req: int = 16, prefill_chunk: int = 64, mixed: bool = True,
                 spec_k: int = 0, draft_adapter: ModelAdapter | None = None,
                 spec_tree_width: int = 1, host_pool_pages: int = 0,
                 host_pool: HostKVPool | None = None, device="cuda"):
        dev = resolve_device(device)
        if dev.type != adapter.device.type:
            raise ValueError(f"engine device {dev} differs from the adapter's "
                             f"{adapter.device}")
        self.a = adapter
        self.device = adapter.device
        self.page = adapter.page_size
        self.cm = RadixCacheManager(num_pages, self.page)
        self.caches = adapter.init_cache(num_pages, max_batch + 1)
        self._free_state_slots = list(range(max_batch))
        self.max_batch = max_batch
        self.max_pages_per_req = max_pages_per_req
        self.prefill_chunk = prefill_chunk
        self.mixed = mixed
        self.waiting: deque[_Request] = deque()
        self.running: list[_Request] = []
        self.finished: dict[int, list[int]] = {}
        self.logprobs: dict[int, list[float]] = {}
        self.stats = {"prefill_tokens": 0, "decode_steps": 0, "cached_tokens": 0,
                      "spec_rounds": 0, "spec_accepted": 0,
                      "host_offloaded_pages": 0, "host_restored_tokens": 0}
        self._next_rid = 0
        # --- L2 host KV tier: finished prompts' pages offload into a second
        # radix cache over a host pool; admission checks it after the device
        # radix and restores the longer prefix ---
        self._host = host_pool
        if host_pool_pages > 0 and self._host is None:
            self._host = HostKVPool(host_pool_pages, self.page)
        if self._host is not None:
            if adapter.gather_pages is None or adapter.scatter_pages is None:
                raise ValueError("adapter lacks gather/scatter_pages hooks")
            if draft_adapter is not None:
                raise ValueError("host KV tier + speculative decoding is not supported (the "
                                 "draft pool is not offloaded)")
            if self._host.page != self.page:
                raise ValueError("host pool page size != engine page size")
        # --- speculative decoding (EAGLE-chain style) ---
        # The draft model shares the target's page geometry, so one block
        # table and slot mapping drive both KV pools.  Rejected tokens need no
        # rollback in paged KV: their stale cache rows sit beyond every later
        # context length until the position is written again.  A target with
        # recurrent state or one-request prefill is verified a request at a
        # time, its state rolled back past rejected tokens (the chain only).
        self.spec_k = spec_k
        self.draft = draft_adapter
        self.spec_width = spec_tree_width
        self._one_request = adapter.prefill_single or adapter.snapshot_state is not None
        if spec_k > 0 and draft_adapter is None:
            raise ValueError("spec_k > 0 requires a draft_adapter")
        if draft_adapter is not None:
            if spec_k <= 0:
                raise ValueError("spec_k must be > 0 with a draft_adapter")
            if draft_adapter.page_size != adapter.page_size:
                raise ValueError("draft/target page_size mismatch")
            if draft_adapter.device.type != adapter.device.type:
                raise ValueError(f"draft device {draft_adapter.device} differs from the "
                                 f"target's {adapter.device}")
            if draft_adapter.snapshot_state is not None:
                raise ValueError("draft adapters must be paged-KV (no recurrent state): "
                                 "stale draft state cannot be rolled back across rounds")
            if adapter.prefill_whole or draft_adapter.prefill_whole:
                raise ValueError("speculative decoding verifies chunks that continue a "
                                 "prompt; a whole-prompt (context-parallel) prefill cannot")
        if spec_tree_width > 1:
            if draft_adapter is None:
                raise ValueError("spec_tree_width > 1 requires a draft_adapter")
            if self._one_request:
                raise ValueError("tree speculation needs a paged-KV target "
                                 "(no recurrent state / single-prefill)")
            if spec_tree_width > max_batch:
                raise ValueError("spec_tree_width must be <= max_batch")
        if draft_adapter is not None:
            self.draft_caches = draft_adapter.init_cache(num_pages, max_batch + 1)

    # ---------------- public API ----------------

    @property
    def host_cm(self):
        """Radix index of the attached host tier (None: no L2 tier)."""
        return self._host.cm if self._host is not None else None

    @property
    def host_pool(self):
        return self._host.pool if self._host is not None else None

    @host_pool.setter
    def host_pool(self, v):
        self._host.pool = v

    def add_request(self, prompt, max_new_tokens: int, lora_id: int = 0,
                    sampling: SamplingParams | None = None, stop_tokens=(),
                    logprobs: bool = False) -> int:
        if sampling is not None and sampling.temperature > 0 and self.spec_k:
            raise ValueError("sampled requests are not supported with speculative "
                             "decoding (greedy tree verify)")
        if logprobs and self.spec_k:
            raise ValueError("logprobs are not recorded on the speculative path (tokens "
                             "emerge from the tree verify)")
        if self.a.prefill_whole and len(prompt) > self.prefill_chunk:
            raise ValueError(f"a {len(prompt)}-token prompt exceeds prefill_chunk "
                             f"{self.prefill_chunk}: this adapter prefills a whole prompt in "
                             "one call")
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(_Request(rid, np.asarray(prompt, np.int32), max_new_tokens,
                                     lora_id=lora_id, sampling=sampling, want_logprobs=logprobs,
                                     stop_tokens=frozenset(int(t) for t in stop_tokens)))
        return rid

    def run(self, prompts, max_new_tokens: int,
            sampling: SamplingParams | None = None) -> list[list[int]]:
        rids = [self.add_request(p, max_new_tokens, sampling=sampling) for p in prompts]
        while self.waiting or self.running:
            self.step()
        return [self.finished[r] for r in rids]

    def step(self) -> None:
        """One scheduling tick.  ``mixed=True`` advances every decode-phase
        request by one token (or one speculative round) AND prefills one
        chunk of one prompt (a decoding request never stalls behind a long
        admission); ``mixed=False`` prefills first and decodes only when no
        prompt is left to prefill."""
        self._admit()
        dec = [r for r in self.running if r.pos >= r.prompt_len]
        pre = [r for r in self.running if r.pos < r.prompt_len]
        if dec and (self.mixed or not pre):
            if self.draft is not None:
                self._spec_decode_tree(dec)
            else:
                self._decode(dec)
        if pre:
            self._prefill(pre[0])
        self._retire()

    def decode_inputs(self, live: list[_Request]) -> DecodeBatch:
        """The batch a decode call over ``live`` takes (allocating the pages
        the new tokens need)."""
        b = self.max_batch
        ids = np.zeros((b,), np.int32)
        pos = np.zeros((b,), np.int32)
        ctx = np.ones((b,), np.int32)
        slots = np.full((b,), -1, np.int32)
        state_idx = np.full((b,), -1, np.int32)   # -1: a dead row (the pools skip it)
        bt = np.zeros((b, self.max_pages_per_req), np.int32)
        lora_idx = np.zeros((b,), np.int32)
        for i, r in enumerate(live):
            seq_i = r.prompt_len + len(r.out_tokens)   # includes the new token
            self._ensure_pages(r, seq_i)
            ids[i] = r.token_at(seq_i - 1)
            pos[i] = seq_i - 1
            ctx[i] = seq_i
            slots[i] = self._slot(r, seq_i - 1)
            state_idx[i] = r.state_slot
            bt[i, : len(r.pages)] = r.pages
            lora_idx[i] = r.lora_id
        t = self._tensor
        return DecodeBatch(t(ids), t(pos), t(bt), t(ctx), t(slots), t(state_idx), t(lora_idx))

    def decode_logits(self, batch: DecodeBatch, decode_step: Callable | None = None):
        """Run one decode call → logits ``[max_batch, V]`` (writes the batch's
        KV rows).  ``decode_step`` replaces the adapter's (same signature)."""
        step = decode_step or self.a.decode_step
        x = self.a.embed(batch.ids)
        h, self.caches = step(x, batch.pos, self.caches, batch.block_table, batch.ctx,
                              batch.slots, batch.state_idx, batch.lora_idx)
        return self.a.lm_head(h)

    # ---------------- internals ----------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sampling_inputs(self, live: list[_Request]):
        """The sampler's and the penalties' per-row inputs for a decode call
        over ``live`` (pad rows greedy, no penalty) → ``(sampling, penalties)``
        tensor tuples: ``(seeds, steps, temperature, top_k, top_p, min_p)``
        and ``(counts, repetition, presence, frequency)``; ``counts`` is ``[b,
        1]`` zeros (a no-op) unless a row carries occurrence counts, then
        ``[b, V]``, copied from the host each call."""
        b = self.max_batch
        seeds, steps = np.zeros((b,), np.int32), np.zeros((b,), np.int32)
        temp, tk = np.zeros((b,), np.float32), np.zeros((b,), np.int32)
        tp, mp = np.ones((b,), np.float32), np.zeros((b,), np.float32)
        rep, pres, freq = np.ones((b,), np.float32), np.zeros((b,), np.float32), np.zeros(
            (b,), np.float32)
        width = max((r.tok_counts.shape[0] for r in live if r.tok_counts is not None),
                    default=1)
        counts = np.zeros((b, width), np.int32)
        for i, r in enumerate(live):
            sp = r.sampling
            if sp is not None:
                seeds[i], steps[i] = sp.seed, len(r.out_tokens)
                temp[i], tk[i] = sp.temperature, sp.top_k
                tp[i], mp[i] = sp.top_p, sp.min_p
                if r.tok_counts is not None:
                    counts[i] = r.tok_counts
                    rep[i], pres[i] = sp.repetition_penalty, sp.presence_penalty
                    freq[i] = sp.frequency_penalty
        t = self._tensor
        return (tuple(t(a) for a in (seeds, steps, temp, tk, tp, mp)),
                tuple(t(a) for a in (counts, rep, pres, freq)))

    def _private(self, r: _Request) -> bool:
        """Whether ``r`` keeps out of the radix: a LoRA request (its K / V
        depend on its adapter), or any request on an adapter with recurrent
        state (a matched prefix would skip the recurrence over its tokens)
        or one that prefills whole prompts (``prefill_whole``)."""
        return bool(r.lora_id) or self.a.snapshot_state is not None or self.a.prefill_whole

    def _admit(self) -> None:
        while self.waiting and len(self.running) < self.max_batch:
            r = self.waiting.popleft()
            # match only up to prompt_len-1: the last prompt token always
            # re-prefills so there is a live row to take logits from
            private = self._private(r)
            matched, pages = (0, []) if private else self.cm.match(r.prompt[: r.prompt_len - 1])
            pages = [int(p) for p in pages]
            if self.host_cm is not None and not private and matched < r.prompt_len - 1:
                matched, pages = self._host_restore(r, matched, pages)
            r.admit_matched = matched
            r.pages = pages
            r.pos = matched
            r.state_slot = self._free_state_slots.pop()
            if self.a.snapshot_state is not None:
                # the slot starts from a zero state, not its last request's
                idx = self._tensor(np.asarray([r.state_slot], np.int64))
                snap = self.a.snapshot_state(self.caches, idx)
                zero = [tuple(torch.zeros_like(t) for t in layer) for layer in snap]
                self.caches = self.a.restore_state(self.caches, zero, idx)
            self.stats["cached_tokens"] += matched
            self.running.append(r)

    def _host_restore(self, r: _Request, matched: int, pages: list):
        """Extend a device-radix miss from the host tier: copy the host
        pool's longer prefix into fresh device pages and register it in the
        device radix, so that refcounting and sharing work as if it had been
        computed here."""
        hm, hpages = self.host_cm.match(r.prompt[: r.prompt_len - 1])
        try:
            if hm <= matched or self.host_pool is None:
                return matched, pages
            s_pg, n_pg = matched // self.page, hm // self.page
            new_dev = self.cm.alloc(n_pg - s_pg)
            if len(new_dev) < n_pg - s_pg:
                self.cm.free(new_dev)
                return matched, pages
            sel = hpages[s_pg:n_pg]
            payload = _map_cache(lambda pool: rows_to_device(pool, sel, self.device),
                                 self.host_pool)
            self.caches = self.a.scatter_pages(
                self.caches, self._tensor(new_dev.astype(np.int64)), payload)
            synchronize(self.device)
            allp = pages + [int(p) for p in new_dev]
            _, dup = self.cm.insert(r.prompt[:hm], np.asarray(allp, np.int32), ref=0)
            m2, canon = self.cm.match(r.prompt[:hm])      # the long-term hold
            if matched:
                self.cm.release(r.prompt[:matched])        # swap the short hold
            if len(dup) > s_pg:
                self.cm.free(dup[s_pg:])
            self.stats["host_restored_tokens"] += m2 - matched
            return m2, [int(p) for p in canon]
        finally:
            if hm:
                self.host_cm.release(r.prompt[:hm])

    def _host_offload(self, r: _Request) -> None:
        """Copy a finished prompt's cached span into the host pool and index
        it in the host radix (ref=0: the L2 tier is best-effort, evicted
        least recently used first)."""
        span = r.inserted_span
        if not span:
            return
        npg = span // self.page
        have, hpages = self.host_cm.match(r.prompt[:span])
        try:
            h_pg = have // self.page
            if h_pg >= npg:
                return
            got = self.host_cm.alloc(npg - h_pg)
            if len(got) < npg - h_pg:
                self.host_cm.free(got)
                return
            payload = self.a.gather_pages(
                self.caches, self._tensor(np.asarray(r.pages[h_pg:npg], np.int64)))
            if self.host_pool is None:
                n_host, pin = self.host_cm.num_pages, self.device.type == "cuda"
                self.host_pool = _map_cache(
                    lambda a: torch.zeros((n_host,) + tuple(a.shape[1:]), dtype=a.dtype,
                                          pin_memory=pin), payload)
            for pool, rows in zip(cache_tensors(self.host_pool), cache_tensors(payload)):
                rows_to_host(pool, got, rows)
            synchronize(self.device)
            allp = [int(p) for p in hpages] + [int(p) for p in got]
            _, dup = self.host_cm.insert(r.prompt[:span], np.asarray(allp, np.int32), ref=0)
            if len(dup) > h_pg:
                self.host_cm.free(dup[h_pg:])
            self.stats["host_offloaded_pages"] += npg - h_pg
        finally:
            if have:
                self.host_cm.release(r.prompt[:have])

    def _ensure_pages(self, r: _Request, upto_tokens: int) -> None:
        need = -(-upto_tokens // self.page) - len(r.pages)
        if need > 0:
            got = self.cm.alloc(need)
            if len(got) < need:
                self.cm.free(got)
                raise RuntimeError("out of KV pages (raise num_pages)")
            r.pages.extend(int(p) for p in got)
        if len(r.pages) > self.max_pages_per_req:
            raise RuntimeError(f"request needs {len(r.pages)} pages > max_pages_per_req "
                               f"{self.max_pages_per_req}")

    def _slot(self, r: _Request, i: int) -> int:
        return r.pages[i // self.page] * self.page + i % self.page

    def _append_token(self, r: _Request, tok: int) -> None:
        """Record a generated token, its occurrence count (penalty-bearing
        requests) and the completion checks (length, stop set)."""
        r.out_tokens.append(tok)
        if r.tok_counts is not None:
            r.tok_counts[tok] += 1
        if len(r.out_tokens) >= r.max_new_tokens or tok in r.stop_tokens:
            r.done = True

    def _ensure_counts(self, r: _Request, vocab: int) -> None:
        if r.tok_counts is None and r.sampling is not None and r.sampling.needs_counts:
            c = np.zeros((vocab,), np.int32)
            np.add.at(c, r.prompt, 1)
            np.add.at(c, np.asarray(r.out_tokens, np.int64), 1)
            r.tok_counts = c

    def _pick_token(self, r: _Request, logits: torch.Tensor) -> int:
        """The first generated token (the prefill's) from ``logits [1, V]``:
        greedy or sampled."""
        sp = r.sampling
        if sp is None or sp.temperature <= 0:
            return int(torch.argmax(logits[0]))
        self._ensure_counts(r, logits.shape[-1])
        t = self._tensor
        f32 = lambda v: t(np.asarray([v], np.float32))     # noqa: E731
        i32 = lambda v: t(np.asarray([v], np.int32))       # noqa: E731
        if r.tok_counts is not None:
            logits = apply_penalties(logits, t(r.tok_counts[None]), f32(sp.repetition_penalty),
                                     f32(sp.presence_penalty), f32(sp.frequency_penalty))
        tok = sample_tokens(logits, i32(sp.seed), i32(len(r.out_tokens)), f32(sp.temperature),
                            i32(sp.top_k), f32(sp.top_p), f32(sp.min_p))
        return int(tok[0])

    def _draft_decode(self, ids, pos, bt, ctx, slots, lora) -> torch.Tensor:
        """One draft decode call → each row's argmax token ``[b]`` (on the
        device; writes the draft KV rows)."""
        x = self.draft.embed(ids)
        h, self.draft_caches = self.draft.decode_step(x, pos, self.draft_caches, bt, ctx, slots,
                                                      self._dead_states(ids.shape[0]), lora)
        return torch.argmax(self.draft.lm_head(h), dim=-1).to(torch.int32)

    def _dead_states(self, b: int) -> torch.Tensor:
        """``state_idx`` of ``b`` rows without recurrent state (-1): the
        speculative calls, whose adapters are paged KV alone."""
        return torch.full((b,), -1, dtype=torch.int32, device=self.device)

    def _verify(self, ids, seq_lens, bt, ctx, slots, lora) -> torch.Tensor:
        """Score all requests' [root] + drafts rows in ONE packed varlen
        prefill of the target (a chain's attention mask is the causal mask)
        → every row's argmax ``[rows]`` on the device."""
        x = self.a.embed(ids)
        h, self.caches = self.a.prefill_step(x, seq_lens, self.caches, bt, ctx, slots,
                                             self._dead_states(seq_lens.shape[0]), lora)
        return torch.argmax(self.a.lm_head(h), dim=-1).to(torch.int32)

    def _verify_one(self, ids, seq_len: int, bt, ctx: int, slots, r: _Request) -> torch.Tensor:
        """One request's verify or catch-up prefill on its own state slot
        (JAX's ``_verify_one_call``, for targets whose prefill takes one
        request: a recurrence is per request) → every row's argmax on the
        device."""
        t = self._tensor
        n = ids.shape[0]
        x = self.a.embed(ids)
        h, self.caches = self.a.prefill_step(
            x, t(np.asarray([seq_len], np.int32)), self.caches, t(bt[None]),
            t(np.asarray([ctx], np.int32)), slots, t(np.asarray([r.state_slot], np.int32)),
            t(np.full((n,), r.lora_id, np.int32)))
        return torch.argmax(self.a.lm_head(h), dim=-1).to(torch.int32)

    def _prefill(self, r: _Request) -> None:
        chunk = min(self.prefill_chunk, r.prompt_len - r.pos)
        self._ensure_pages(r, r.pos + chunk)
        s = self.prefill_chunk                      # fixed packed width
        ids = np.zeros((s,), np.int32)
        slots = np.full((s,), -1, np.int32)
        ids[:chunk] = r.prompt[r.pos : r.pos + chunk]
        for j in range(chunk):
            slots[j] = self._slot(r, r.pos + j)
        bt = np.zeros((1, self.max_pages_per_req), np.int32)
        bt[0, : len(r.pages)] = r.pages
        t = self._tensor
        ids_t, sl_t, bt_t, slots_t = t(ids), t(np.asarray([chunk], np.int32)), t(bt), t(slots)
        ctx_t, lora_t = t(np.asarray([r.pos + chunk], np.int32)), t(np.full((s,), r.lora_id,
                                                                            np.int32))
        si_t = t(np.asarray([r.state_slot], np.int32))
        h, self.caches = self.a.prefill_step(self.a.embed(ids_t), sl_t, self.caches, bt_t, ctx_t,
                                             slots_t, si_t, lora_t)
        if self.draft is not None:
            # mirror the chunk into the draft model's KV pool (same pages)
            _, self.draft_caches = self.draft.prefill_step(
                self.draft.embed(ids_t), sl_t, self.draft_caches, bt_t, ctx_t, slots_t, si_t,
                lora_t)
        r.pos += chunk
        self.stats["prefill_tokens"] += chunk
        if r.pos == r.prompt_len:
            logits = self.a.lm_head(h[chunk - 1 : chunk])
            tok = self._pick_token(r, logits)
            if r.want_logprobs:
                r.out_logprobs.append(float(token_logprobs(
                    logits, torch.tensor([tok], device=logits.device))[0]))
            self._append_token(r, tok)
            self._share_prefix(r)

    def _share_prefix(self, r: _Request) -> None:
        span = (r.prompt_len // self.page) * self.page
        if span == 0 or self._private(r):              # adapter-specific K / V, or state
            return
        npg = span // self.page
        _, dup = self.cm.insert(r.prompt[:span], np.asarray(r.pages[:npg]), ref=0)
        m2, canon = self.cm.match(r.prompt[:span])     # the single long-term hold
        if m2 != span:
            raise RuntimeError(f"radix insert of {span} tokens matched {m2}")
        admit_pages = r.admit_matched // self.page
        for i, p in enumerate(int(c) for c in canon):
            r.pages[i] = p
        if r.admit_matched:
            self.cm.release(r.prompt[: r.admit_matched])
        if len(dup) > admit_pages:                     # raced-in duplicates: ours
            self.cm.free(dup[admit_pages:])
        r.inserted_span = span
        r.admit_matched = 0

    def _decode(self, live: list[_Request]) -> None:
        logits = self.decode_logits(self.decode_inputs(live))
        if any(r.sampling is not None and r.sampling.temperature > 0 for r in live):
            sampling, penalties = self._sampling_inputs(live)
            toks = sample_tokens(apply_penalties(logits, *penalties), *sampling)
        else:
            toks = torch.argmax(logits, dim=-1)
        lps = token_logprobs(logits, toks).cpu().numpy()
        toks = toks.cpu().numpy()
        for i, r in enumerate(live):
            if r.want_logprobs and not r.done:
                r.out_logprobs.append(float(lps[i]))
            self._append_token(r, int(toks[i]))
        self.stats["decode_steps"] += 1

    def _commit(self, r: _Request, new: list[int]) -> None:
        """Append a round's accepted tokens and its bonus token up to the
        request's end (length or a stop token)."""
        for tok in new:
            if not r.done and len(r.out_tokens) < r.max_new_tokens:
                self._append_token(r, tok)

    def _spec_decode_tree(self, live: list[_Request]) -> None:
        """One speculative round: each request's ``B = spec_tree_width``
        root-branched draft chains (B = 1: the chain, JAX's ``_spec_decode``)
        verified together, so the packed verify holds ``B x group`` virtual
        requests: process in groups that fit."""
        g = max(1, self.max_batch // self.spec_width)
        for i0 in range(0, len(live), g):
            self._spec_tree_round(live[i0 : i0 + g])
        self.stats["spec_rounds"] += 1
        self.stats["decode_steps"] += 1

    def _spec_tree_round(self, live: list[_Request]) -> None:
        """One tree round (EAGLE-2-style root branching; at B = 1 the chain
        round of JAX's ``_spec_decode``: k + 1 draft calls, one verify, no
        page copy).

        Position bookkeeping (L = tokens known for a request): a path feeds
        the draft tokens at positions L-1..L+k-1 (writing draft KV as it
        goes; the last step feeds d_k so that the draft KV covers L+k-1 when
        every draft is accepted); its verify rows are [last token, d1..dk]
        at positions L-1..L+k-1.  After n accepted drafts and the bonus
        token both pools are KV-correct through position L+n-1 and the next
        round starts there: rejected tokens' stale rows are never read
        (masked by the context length) and are written again when their
        position comes round.  The drafts stay on the device; the round
        reads the verify's results to the host once.

        Draft: ONE decode on the request's real pages feeds the root token
        and yields the top-B choices of d1; each branch then chains k-1 more
        draft tokens.  Branches would collide in the paged KV (same logical
        positions), so every branch >= 1 gets COPY-ON-WRITE suffix pages: the
        pages covering positions L-1..L+k-1 are copied in every tensor of
        both pools' caches, and the branch's block table points at the
        copies, so each path is a plain causal chain, verified by the same
        packed varlen verify as chain mode.  Acceptance walks the real tree
        (``verify_tree_greedy``, sibling chains at the root); if a branch >= 1
        wins, its suffix pages are copied back into the real pages (a swap
        would break radix-shared refcounts)."""
        b, k, B, ps = self.max_batch, self.spec_k, self.spec_width, self.page
        n, d = len(live), self.spec_k + 1
        if n * B > b:
            raise RuntimeError(f"{n} requests x width {B} > max_batch {b}")
        t = self._tensor
        Ls = [r.prompt_len + len(r.out_tokens) for r in live]
        bt0 = np.zeros((b, self.max_pages_per_req), np.int32)
        lora = np.zeros((b,), np.int32)
        for i, r in enumerate(live):
            self._ensure_pages(r, Ls[i] + k)
            bt0[i, : len(r.pages)] = r.pages
            lora[i] = r.lora_id
        lora_t = t(lora)

        # --- draft step 0 (real pages): root token → top-B first drafts ---
        root = np.zeros((b,), np.int32)
        pos = np.zeros((b,), np.int32)
        ctx = np.ones((b,), np.int32)
        slots = np.full((b,), -1, np.int32)
        for i, r in enumerate(live):
            p = Ls[i] - 1
            root[i] = r.token_at(p)
            pos[i], ctx[i], slots[i] = p, p + 1, self._slot(r, p)
        x = self.draft.embed(t(root))
        h, self.draft_caches = self.draft.decode_step(x, t(pos), self.draft_caches, t(bt0),
                                                      t(ctx), t(slots), self._dead_states(b),
                                                      lora_t)
        topb = top_k(self.draft.lm_head(h), B)[1][:n].to(torch.int32)    # [n, B]

        # --- copy-on-write suffix pages for branches 1..B-1 ---
        plo = [(L - 1) // ps for L in Ls]
        phi = [(L - 1 + k) // ps for L in Ls]
        scratch: dict[tuple[int, int], list[int]] = {}
        src_ids, dst_ids = [], []
        for i, r in enumerate(live):
            npg = phi[i] - plo[i] + 1
            for p in range(1, B):
                got = self.cm.alloc(npg)
                if len(got) < npg:
                    self.cm.free(got)
                    for pages in scratch.values():
                        self.cm.free(np.asarray(pages, np.int32))
                    raise RuntimeError("out of KV pages for tree branches")
                scratch[(i, p)] = [int(x) for x in got]
                src_ids += r.pages[plo[i] : plo[i] + npg]
                dst_ids += scratch[(i, p)]
        if src_ids:
            src_t, dst_t = t(np.asarray(src_ids, np.int64)), t(np.asarray(dst_ids, np.int64))
            _copy_pages(self.caches, src_t, dst_t)
            _copy_pages(self.draft_caches, src_t, dst_t)
        btp = np.repeat(bt0[None], B, axis=0)              # [B, b, max_pages]
        for (i, p), pages in scratch.items():
            btp[p, i, plo[i] : plo[i] + len(pages)] = pages

        def path_slot(i, p, position):
            return int(btp[p, i, position // ps]) * ps + position % ps

        # --- draft chains per branch (steps 1..k on the branch's pages) ---
        chains = []                                        # B x [n, k]
        for p in range(B):
            cur = torch.zeros((b,), dtype=torch.int32, device=self.device)
            cur[:n] = topb[:, p]
            chain = [cur[:n]]
            for j in range(1, k + 1):
                for i in range(n):
                    q = Ls[i] - 1 + j
                    pos[i], ctx[i], slots[i] = q, q + 1, path_slot(i, p, q)
                cur = self._draft_decode(cur, t(pos), t(btp[p]), t(ctx), t(slots), lora_t)
                if j < k:
                    chain.append(cur[:n])
            chains.append(torch.stack(chain, dim=1))
        drafts = torch.stack(chains, dim=1)                # [n, B, k]

        # --- one packed varlen verify over n*B virtual chain-requests, or
        # (one-request targets, B = 1) a verify a request, its recurrent
        # state snapshotted first ---
        cand = torch.cat([t(root[:n])[:, None, None].expand(n, B, 1), drafts], dim=2)
        seq_lens = np.zeros((b,), np.int32)
        vctx = np.ones((b,), np.int32)
        vslots = np.full((b * d,), -1, np.int32)
        btv = np.zeros((b, self.max_pages_per_req), np.int32)
        vlora = np.zeros((b,), np.int32)
        for i, r in enumerate(live):
            for p in range(B):
                vi = i * B + p
                seq_lens[vi], vctx[vi], vlora[vi] = d, Ls[i] + k, r.lora_id
                btv[vi] = btp[p, i]
                vslots[vi * d : (vi + 1) * d] = [path_slot(i, p, Ls[i] - 1 + j)
                                                 for j in range(d)]
        vslots_t = t(vslots)
        snaps = []
        if self._one_request:
            rows = []
            for i, r in enumerate(live):
                if self.a.snapshot_state is not None:
                    snaps.append(self.a.snapshot_state(self.caches,
                                                       t(np.asarray([r.state_slot], np.int32))))
                rows.append(self._verify_one(cand[i, 0], d, btv[i], Ls[i] + k,
                                             vslots_t[i * d : (i + 1) * d], r))
            target = torch.stack(rows)[:, None]
        else:
            ids = torch.zeros((b * d,), dtype=torch.int32, device=self.device)
            ids[: n * B * d] = cand.reshape(-1)
            target = self._verify(ids, t(seq_lens), t(btv), t(vctx), vslots_t,
                                  t(np.repeat(vlora, d)))
            target = target.reshape(b, d)[: n * B].reshape(n, B, d)

        # --- acceptance over the REAL tree (root + B sibling chains) ---
        nodes = 1 + B * k
        cand_nodes = torch.cat([cand[:, 0, :1], drafts.reshape(n, B * k)], dim=1)
        tgt_nodes = torch.cat([target[:, 0, :1], target[:, :, 1:].reshape(n, B * k)], dim=1)
        nt = np.full((n, nodes), -1, np.int32)
        ns = np.full((n, nodes), -1, np.int32)
        nt[:, 0] = 1
        for p in range(B):
            s0 = 1 + p * k
            if p + 1 < B:
                ns[:, s0] = 1 + (p + 1) * k
            nt[:, s0 : s0 + k - 1] = np.arange(s0 + 1, s0 + k)
        ridx = np.arange(n * nodes, dtype=np.int32).reshape(n, nodes)
        predicts, accept_index, accept_num = verify_tree_greedy(cand_nodes, t(ridx), t(nt),
                                                                t(ns), tgt_nodes)
        predicts, accept_index = predicts.cpu().numpy(), accept_index.cpu().numpy()
        accept_num, cand_nodes = accept_num.cpu().numpy(), cand_nodes.cpu().numpy()

        # --- commit: emit tokens; adopt a winning branch's pages by copy-back ---
        src_ids, dst_ids = [], []
        for i, r in enumerate(live):
            n_acc = int(accept_num[i])
            local = [int(accept_index[i, j]) - i * nodes for j in range(1, n_acc + 1)]
            new = [int(cand_nodes[i, x]) for x in local]
            new.append(int(predicts[int(accept_index[i, n_acc])]))    # the bonus token
            win = 0 if n_acc == 0 else (local[-1] - 1) // k
            if win != 0:
                src_ids += scratch[(i, win)]
                dst_ids += r.pages[plo[i] : plo[i] + len(scratch[(i, win)])]
            self._commit(r, new)
            self.stats["spec_accepted"] += n_acc
            if snaps and n_acc < k:
                # the verify advanced the state through rejected rows: roll it
                # back, then advance it through exactly the accepted ones
                # ([last, d1..d_nacc]); n_acc == k needs neither
                m = n_acc + 1
                self.caches = self.a.restore_state(self.caches, snaps[i],
                                                   t(np.asarray([r.state_slot], np.int32)))
                cu_ids = np.zeros((d,), np.int32)
                cu_ids[:m] = cand_nodes[i, :m]
                cu_slots = np.full((d,), -1, np.int32)
                cu_slots[:m] = vslots[i * d : i * d + m]
                self._verify_one(t(cu_ids), m, btv[i], Ls[i] - 1 + m, t(cu_slots), r)
        if src_ids:
            src_t, dst_t = t(np.asarray(src_ids, np.int64)), t(np.asarray(dst_ids, np.int64))
            _copy_pages(self.caches, src_t, dst_t)
            _copy_pages(self.draft_caches, src_t, dst_t)
        for pages in scratch.values():
            self.cm.free(np.asarray(pages, np.int32))

    def _retire(self) -> None:
        for r in [x for x in self.running if x.done]:
            if self.host_cm is not None:
                self._host_offload(r)
            if r.inserted_span:
                self.cm.release(r.prompt[: r.inserted_span])
            elif r.admit_matched:
                self.cm.release(r.prompt[: r.admit_matched])
            shared = (r.inserted_span or r.admit_matched) // self.page
            if len(r.pages) > shared:
                self.cm.free(np.asarray(r.pages[shared:], np.int32))
            self.finished[r.rid] = list(r.out_tokens)
            if r.want_logprobs:
                self.logprobs[r.rid] = list(r.out_logprobs)
            if r.state_slot >= 0:
                self._free_state_slots.append(r.state_slot)
            self.running.remove(r)
