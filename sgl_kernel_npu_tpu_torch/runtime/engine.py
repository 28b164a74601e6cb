"""Continuous-batching serving engine over the native radix cache.

Counterpart of ``sgl_kernel_npu_tpu/runtime/engine.py`` (``ModelAdapter``,
``deepseek_adapter``, ``gpt_oss_adapter``, ``llama_adapter``, ``Engine``):
request admission → radix prefix reuse (``csrc/cache_manager.cpp``) →
chunked varlen prefill → batched paged decode,
mixed with prefill → greedy tokens with their log-probabilities → refcounted
release.  Where JAX jits each call with the caches donated, the port runs
eagerly and the model updates the cache tensors in place.  The engine keeps
the JAX engine's fixed batch widths (``prefill_chunk`` rows per prefill call,
``max_batch`` rows per decode call): pad rows carry slot -1, context 1 and a
block table of zeros.  A request's pages are bounded by
``max_pages_per_req`` (33 pages of 128 hold a 4096-token prompt and its
decode).

Adapters: ``deepseek_adapter``, ``gpt_oss_adapter`` and ``llama_adapter``.
Their KV cache is bf16 on the card and f32 on the CPU unless the caller
names a dtype: the card's attention kernels take bf16 or int8 caches, where
JAX defaults to f32 everywhere.  Multi-LoRA: ``llama_adapter(lora=...)`` and
``add_request(lora_id=...)``; every model call passes each row's adapter
(``lora_idx``: the request's on every prefill row, 0 on decode pad rows),
and the other adapters ignore it.  Not ported yet (ROADMAP): speculative
decoding, the host KV tier, sampled decoding and penalties, stop tokens,
prefill-priority (unmixed) scheduling, the context- and pipeline-parallel
Llama adapters, and the other model adapters.

Prefix reuse and LoRA (a departure from the JAX engine, whose radix is keyed
by tokens alone): LoRA on the q and o projections makes every layer's K / V
after the first depend on the adapter, so a request with ``lora_id != 0``
neither matches nor inserts into the radix; adapter-0 requests share pages
as before.  JAX reuses one adapter's pages for another's request on the same
prompt.

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

from sgl_kernel_npu_tpu_torch.ops.sampling import token_logprobs
from sgl_kernel_npu_tpu_torch.runtime.cache_manager import RadixCacheManager
from sgl_kernel_npu_tpu_torch.utils.common import resolve_device


@dataclasses.dataclass
class ModelAdapter:
    """The callables the engine drives, all on ``device``."""

    page_size: int
    device: torch.device
    embed: Callable            # ids [N] → hidden [N, H]
    lm_head: Callable          # hidden [N, H] → logits [N, V]
    prefill_step: Callable     # (x, seq_lens, caches, bt, ctx, slots, lora_idx) → (h, caches)
    decode_step: Callable      # (x, pos, caches, bt, ctx, slots, lora_idx) → (h, caches)
    init_cache: Callable       # num_pages → caches


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
        prefill_step=lambda x, sl, c, bt, ctx, slots, li: m.prefill_step(
            cfg, params, x, sl, c, bt, ctx, slots, max_q=x.shape[0],
            moe_weights_q=moe_weights_q, mla_wq=mla_wq, **ep),
        decode_step=lambda x, pos, c, bt, ctx, slots, li: m.decode_step(
            cfg, params, x, pos, c, bt, ctx, slots, moe_weights_q=moe_weights_q,
            mla_wq=mla_wq, **ep),
        init_cache=lambda n: m.init_kv_cache(cfg, n, dtype, device=dev),
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
        prefill_step=lambda x, sl, c, bt, ctx, slots, li: m.prefill_step(
            cfg, params, x, sl, c, bt, ctx, slots, max_q=x.shape[0], weights_q=weights_q,
            ep_buffer=ep_buffer),
        decode_step=lambda x, pos, c, bt, ctx, slots, li: m.decode_step(
            cfg, params, x, pos, c, bt, ctx, slots, weights_q=weights_q, ep_buffer=ep_buffer),
        init_cache=lambda n: m.init_kv_cache(cfg, n, dtype, device=dev),
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
        prefill_step=lambda x, sl, c, bt, ctx, slots, li: m.prefill_step(
            cfg, params, x, sl, c, bt, ctx, slots, max_q=x.shape[0], lora=lora, lora_idx=li,
            weights_q=weights_q),
        decode_step=lambda x, pos, c, bt, ctx, slots, li: m.decode_step(
            cfg, params, x, pos, c, bt, ctx, slots, lora=lora, lora_idx=li, weights_q=weights_q),
        init_cache=lambda n: m.init_kv_cache(cfg, n, dtype, device=dev),
    )


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray            # int32 token ids
    max_new_tokens: int
    lora_id: int = 0              # LoRA adapter (0 = none)
    pages: list = dataclasses.field(default_factory=list)   # block table (physical)
    pos: int = 0                  # tokens whose KV is in the cache
    want_logprobs: bool = False
    out_logprobs: list = dataclasses.field(default_factory=list)
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
    lora_idx: torch.Tensor        # each row's adapter, 0 on pad rows


class Engine:
    """Continuous-batching engine: ``add_request`` then ``step`` until drained."""

    def __init__(self, adapter: ModelAdapter, num_pages: int, *, max_batch: int = 8,
                 max_pages_per_req: int = 16, prefill_chunk: int = 64, device="cuda"):
        dev = resolve_device(device)
        if dev.type != adapter.device.type:
            raise ValueError(f"engine device {dev} differs from the adapter's "
                             f"{adapter.device}")
        self.a = adapter
        self.device = adapter.device
        self.page = adapter.page_size
        self.cm = RadixCacheManager(num_pages, self.page)
        self.caches = adapter.init_cache(num_pages)
        self.max_batch = max_batch
        self.max_pages_per_req = max_pages_per_req
        self.prefill_chunk = prefill_chunk
        self.waiting: deque[_Request] = deque()
        self.running: list[_Request] = []
        self.finished: dict[int, list[int]] = {}
        self.logprobs: dict[int, list[float]] = {}
        self.stats = {"prefill_tokens": 0, "decode_steps": 0, "cached_tokens": 0}
        self._next_rid = 0

    # ---------------- public API ----------------

    def add_request(self, prompt, max_new_tokens: int, lora_id: int = 0,
                    logprobs: bool = False) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(_Request(rid, np.asarray(prompt, np.int32), max_new_tokens,
                                     lora_id=lora_id, want_logprobs=logprobs))
        return rid

    def run(self, prompts, max_new_tokens: int) -> list[list[int]]:
        rids = [self.add_request(p, max_new_tokens) for p in prompts]
        while self.waiting or self.running:
            self.step()
        return [self.finished[r] for r in rids]

    def step(self) -> None:
        """One scheduling tick: every decode-phase request advances by one
        token AND one chunk of one prompt is prefilled (mixed batching: a
        decoding request never stalls behind a long admission)."""
        self._admit()
        dec = [r for r in self.running if r.pos >= r.prompt_len]
        pre = [r for r in self.running if r.pos < r.prompt_len]
        if dec:
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
        bt = np.zeros((b, self.max_pages_per_req), np.int32)
        lora_idx = np.zeros((b,), np.int32)
        for i, r in enumerate(live):
            seq_i = r.prompt_len + len(r.out_tokens)   # includes the new token
            self._ensure_pages(r, seq_i)
            ids[i] = r.token_at(seq_i - 1)
            pos[i] = seq_i - 1
            ctx[i] = seq_i
            slots[i] = self._slot(r, seq_i - 1)
            bt[i, : len(r.pages)] = r.pages
            lora_idx[i] = r.lora_id
        t = self._tensor
        return DecodeBatch(t(ids), t(pos), t(bt), t(ctx), t(slots), t(lora_idx))

    def decode_logits(self, batch: DecodeBatch, decode_step: Callable | None = None):
        """Run one decode call → logits ``[max_batch, V]`` (writes the batch's
        KV rows).  ``decode_step`` replaces the adapter's (same signature)."""
        step = decode_step or self.a.decode_step
        x = self.a.embed(batch.ids)
        h, self.caches = step(x, batch.pos, self.caches, batch.block_table, batch.ctx,
                              batch.slots, batch.lora_idx)
        return self.a.lm_head(h)

    # ---------------- internals ----------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _admit(self) -> None:
        while self.waiting and len(self.running) < self.max_batch:
            r = self.waiting.popleft()
            # match only up to prompt_len-1: the last prompt token always
            # re-prefills so there is a live row to take logits from; a LoRA
            # request's K / V depend on its adapter, so it shares no pages
            matched, pages = (0, []) if r.lora_id else self.cm.match(
                r.prompt[: r.prompt_len - 1])
            r.admit_matched = matched
            r.pages = [int(p) for p in pages]
            r.pos = matched
            self.stats["cached_tokens"] += matched
            self.running.append(r)

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
        x = self.a.embed(t(ids))
        h, self.caches = self.a.prefill_step(
            x, t(np.asarray([chunk], np.int32)), self.caches, t(bt),
            t(np.asarray([r.pos + chunk], np.int32)), t(slots),
            t(np.full((s,), r.lora_id, np.int32)))
        r.pos += chunk
        self.stats["prefill_tokens"] += chunk
        if r.pos == r.prompt_len:
            logits = self.a.lm_head(h[chunk - 1 : chunk])
            tok = torch.argmax(logits, dim=-1)
            if r.want_logprobs:
                r.out_logprobs.append(float(token_logprobs(logits, tok)[0]))
            self._append_token(r, int(tok[0]))
            self._share_prefix(r)

    def _share_prefix(self, r: _Request) -> None:
        span = (r.prompt_len // self.page) * self.page
        if span == 0 or r.lora_id:                     # adapter-specific K / V: private
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

    def _append_token(self, r: _Request, tok: int) -> None:
        r.out_tokens.append(tok)
        if len(r.out_tokens) >= r.max_new_tokens:
            r.done = True

    def _decode(self, live: list[_Request]) -> None:
        logits = self.decode_logits(self.decode_inputs(live))
        toks = torch.argmax(logits, dim=-1)
        lps = token_logprobs(logits, toks).cpu().numpy()
        toks = toks.cpu().numpy()
        for i, r in enumerate(live):
            if r.want_logprobs and not r.done:
                r.out_logprobs.append(float(lps[i]))
            self._append_token(r, int(toks[i]))
        self.stats["decode_steps"] += 1

    def _retire(self) -> None:
        for r in [x for x in self.running if x.done]:
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
            self.running.remove(r)
