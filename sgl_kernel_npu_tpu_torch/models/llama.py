"""Dense GQA (Llama-class) models for serving: paged decode and varlen prefill
over the layer stack.

Counterpart of ``sgl_kernel_npu_tpu/models/llama.py`` on one GPU: decode on
the paged GQA decode kernel (``decode_gqa``, K11a), prefill on the varlen
prefill kernel without sinks or window (``attention_sinks_prefill_pallas``,
K12d, as JAX), RMSNorm (``rms_norm``, K6a) and the SwiGLU MLP (``silu(x
w_gate) · x w_up`` in torch ops: JAX has no kernel there).  The KV cache is
bf16 / f32, or int8 levels ``round(x / kv_scale)`` (``kv_cache_dtype="int8"``;
``kv_scales`` per layer and kv head from ``w8a8.calibrate_kv_scales``, else
``cfg.kv_scale``).  ``weights_q`` (:func:`quantize_weights`) runs every
projection W8A8: q / k / v off one ``quant_per_token`` (K5) and three
``quant_matmul`` (K1), ``wo`` by ``w8a8.project``, and the MLP by
``w8a8.mlp_swiglu`` (gate ‖ up in one K1, ``swiglu_quant`` K7a, down).

The steps return the final-normed hidden state, as JAX's; :func:`lm_head`
applies no norm.  Weights are a plain dict of tensors with the JAX package's
names and layouts; caches a list of per-layer ``(k_cache, v_cache)`` updated
in place; ``plain=True`` runs the kernels' plain versions.  Multi-LoRA
(``lora`` from :func:`init_lora` or :func:`from_jax_lora`, ``lora_idx`` an
adapter per row, 0 = adapter 0, all zeros) adds a delta to the q and o
projections through ``fused_lora_delta`` (K13a ``bgmv_fused``), on the float
and the W8A8 path alike.  :func:`prefill_step_cp` prefills one request's
prompt context parallel over a process group (each rank's rows attend the
all-gathered K / V, ``parallel/ring_attention.gathered_attention``);
``models/llama_pp.py`` runs the layer stack
in pipeline stages on :func:`_stack`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sgl_kernel_npu_tpu_torch.models import gpt_oss, w8a8
from sgl_kernel_npu_tpu_torch.ops.attention.decode_attention import decode_gqa, decode_gqa_plain
from sgl_kernel_npu_tpu_torch.ops.attention.sinks_attention import (
    attention_sinks_prefill,
    attention_sinks_prefill_pallas,
    attention_sinks_prefill_plain,
    packed_rows,
)
from sgl_kernel_npu_tpu_torch.ops.lora import fused_lora_delta
from sgl_kernel_npu_tpu_torch.ops.lora_pallas import bgmv_fused_plain
from sgl_kernel_npu_tpu_torch.ops.mem_cache.kv_cache import write_kv
from sgl_kernel_npu_tpu_torch.ops.norm import rms_norm, rms_norm_ref
from sgl_kernel_npu_tpu_torch.ops.quant import quant_per_token, quant_per_token_ref
from sgl_kernel_npu_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from sgl_kernel_npu_tpu_torch.utils.common import resolve_device, to_torch


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The JAX package's config, fields and defaults alike."""

    vocab_size: int = 128
    hidden: int = 256
    num_layers: int = 2
    num_heads: int = 8
    num_kv_heads: int = 2
    head_dim: int = 32
    intermediate: int = 512
    page_size: int = 16
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    kv_cache_dtype: str = "bf16"   # "int8": K / V pages hold round(x / kv_scale)
    kv_scale: float = 1.0 / 64     # the int8 cache's scale when no kv_scales are given


# ---------------------------------------------------------------------------
# weights and caches
# ---------------------------------------------------------------------------

def init_weights(cfg: LlamaConfig, seed: int = 0, dtype=torch.float32, device="cuda", *,
                 untied_lm_head: bool = False) -> dict:
    """Random weights from ``seed`` with the JAX package's shapes and scales
    (N(0, 0.02²), norms 1, the embedding tied to the head);
    ``untied_lm_head`` adds ``w_lm [hidden, vocab]`` (drawn last), as an
    untied checkpoint carries it."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, d = cfg.hidden, cfg.head_dim

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    layers = [{"ln1": ones(h), "wq": rnd(h, cfg.num_heads * d), "wk": rnd(h, cfg.num_kv_heads * d),
               "wv": rnd(h, cfg.num_kv_heads * d), "wo": rnd(cfg.num_heads * d, h),
               "ln2": ones(h), "w_gate": rnd(h, cfg.intermediate), "w_up": rnd(h, cfg.intermediate),
               "w_down": rnd(cfg.intermediate, h)} for _ in range(cfg.num_layers)]
    params = {"layers": layers, "ln_f": ones(h), "wte": rnd(cfg.vocab_size, h)}
    if untied_lm_head:
        params["w_lm"] = rnd(h, cfg.vocab_size)
    return params


def from_jax_params(params_np: dict, device="cuda", dtype=None) -> dict:
    """The JAX package's weight pytree (numpy leaves) → the port's
    (``gpt_oss.from_jax_params``: the same dict of layers, ``w_lm`` when
    present)."""
    return gpt_oss.from_jax_params(params_np, device, dtype)


def quantize_weights(cfg: LlamaConfig, params: dict) -> dict:
    """Per-out-channel int8 quant of every projection (W8A8 serving,
    ``models/w8a8.py``); gate ‖ up stack into one matrix, so that the MLP's
    front half is one GEMM feeding ``swiglu_quant``."""
    return {"layers": [{
        **{name: w8a8.quantize_matrix(lw[name]) for name in ("wq", "wk", "wv", "wo", "w_down")},
        "w_gate_up": w8a8.quantize_matrix(torch.cat([lw["w_gate"], lw["w_up"]], dim=1)),
    } for lw in params["layers"]]}


def init_lora(seed: int, cfg: LlamaConfig, num_adapters: int, rank: int, dtype=torch.float32,
              device="cuda") -> dict:
    """Per-layer LoRA on the q and o projections with the JAX package's
    shapes: ``qA [L, R, hidden]``, ``qB [L, Hq·D, R]``, ``oA [L, R, Hq·D]``,
    ``oB [L, hidden, R]``, N(0, 0.1²) from ``seed``.  Adapter 0 is all zeros
    (the "no adapter" row); each adapter's scaling is folded into its B."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, hq = cfg.hidden, cfg.num_heads * cfg.head_dim

    def rnd(*shape):
        w = torch.randn(shape, generator=gen, device=dev) * 0.1
        w[0] = 0.0
        return w.to(dtype)

    return {"layers": [{"qA": rnd(num_adapters, rank, h), "qB": rnd(num_adapters, hq, rank),
                        "oA": rnd(num_adapters, rank, hq), "oB": rnd(num_adapters, h, rank)}
                       for _ in range(cfg.num_layers)]}


def from_jax_lora(lora_np: dict, device="cuda", dtype=None) -> dict:
    """The JAX package's LoRA weights (``init_lora``'s pytree, numpy leaves)
    → the port's (the same dict; cast to ``dtype`` when given)."""
    dev = resolve_device(device)

    def conv(a):
        t = to_torch(a, dev)
        return t if dtype is None else t.to(dtype)

    return {"layers": [{k: conv(v) for k, v in layer.items()} for layer in lora_np["layers"]]}


def _lora_delta(x, a, b, idx, plain: bool):
    """``(x @ A[i]ᵀ) @ B[i]ᵀ`` per row in x's type: K13a, or its plain
    version."""
    if plain:
        return bgmv_fused_plain(x, a, b, idx).to(x.dtype)
    return fused_lora_delta(x, a, b, idx)


def init_kv_cache(cfg: LlamaConfig, num_pages: int, dtype=torch.float32,
                  device="cuda") -> list[tuple]:
    """Per-layer ``(k_cache, v_cache)`` of zeros ``[pages, Hkv, page, D]``,
    int8 when ``cfg.kv_cache_dtype == "int8"``, else ``dtype``."""
    dev = resolve_device(device)
    shape = (num_pages, cfg.num_kv_heads, cfg.page_size, cfg.head_dim)
    dtype = torch.int8 if cfg.kv_cache_dtype == "int8" else dtype
    return [(torch.zeros(shape, dtype=dtype, device=dev),
             torch.zeros(shape, dtype=dtype, device=dev)) for _ in range(cfg.num_layers)]


def _kv_scale(cfg: LlamaConfig, scale=None):
    """The int8 cache's dequant scale (``cfg.kv_scale`` or a calibrated
    per-kv-head ``[Hkv]``), None on the float path."""
    if cfg.kv_cache_dtype != "int8":
        return None
    return cfg.kv_scale if scale is None else scale


def embed(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """Token ids → hidden states (the embedding table)."""
    return params["wte"][ids.long()]


def lm_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Hidden states (final-normed by the steps) → logits; tied to the
    embedding unless the weights carry ``w_lm``."""
    return x @ (params["w_lm"] if "w_lm" in params else params["wte"].T)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _mlp(lw: dict, x):
    return (torch.nn.functional.silu(x @ lw["w_gate"]) * (x @ lw["w_up"])) @ lw["w_down"]


def _mlp_q(lq: dict, x, plain: bool):
    """W8A8 MLP: ``w8a8.mlp_swiglu`` over the stacked gate ‖ up matrix."""
    return w8a8.mlp_swiglu(x, lq["w_gate_up"], lq["w_down"], x.dtype, plain=plain)


def _qkv_attn_proj(lq: dict, hidden_n, plain: bool):
    """W8A8 q / k / v projections off one per-token quant of the normed
    hidden state."""
    x_q, sx = (quant_per_token_ref if plain else quant_per_token)(hidden_n)
    return tuple(w8a8.qmm(x_q, sx, lq[nm], hidden_n.dtype, plain=plain)
                 for nm in ("wq", "wk", "wv"))


def _write(slot_mapping):
    """The default K / V store of :func:`_stack`: each row at its slot."""
    def store(k, v, k_cache, v_cache, ks, vs):
        write_kv(k, k_cache, slot_mapping, ks)
        write_kv(v, v_cache, slot_mapping, vs)

    return store


def _stack(cfg: LlamaConfig, layers: list, x, positions, caches, store, attend, weights_q,
           kv_scales, lora, lora_idx, plain: bool):
    """``layers`` over ``x [N, hidden]`` (no final norm): each layer hands
    its K / V rows to ``store(k, v, k_cache, v_cache, k_scale, v_scale)``
    (:func:`_write`: int8 levels on the int8 path), then ``attend(q [N, Hq,
    D], k, v, k_cache, v_cache, k_scale, v_scale)`` gives the attention rows
    (from the caches, or from the fresh ``k`` / ``v [N, Hkv, D]``).  With
    ``lora`` the q and o projections add each row's adapter delta
    (``lora_idx [N]``)."""
    norm = rms_norm_ref if plain else rms_norm
    n, d = x.shape[0], cfg.head_dim
    if lora is not None and (lora_idx is None or lora_idx.shape != (n,)):
        raise ValueError(f"lora needs lora_idx [{n}], an adapter per row, got "
                         f"{None if lora_idx is None else tuple(lora_idx.shape)}")
    cos, sin = rope_cos_sin(positions, d, base=cfg.rope_theta)
    for li, lw in enumerate(layers):
        lq = None if weights_q is None else weights_q["layers"][li]
        k_cache, v_cache = caches[li]
        hidden_n = norm(x, lw["ln1"], cfg.rms_eps)
        if lq is not None:
            qp, kp, vp = _qkv_attn_proj(lq, hidden_n, plain)
        else:
            qp, kp, vp = hidden_n @ lw["wq"], hidden_n @ lw["wk"], hidden_n @ lw["wv"]
        if lora is not None:
            la = lora["layers"][li]
            qp = qp + _lora_delta(hidden_n, la["qA"], la["qB"], lora_idx, plain)
        q = apply_rope(qp.reshape(n, cfg.num_heads, d), cos, sin)
        k = apply_rope(kp.reshape(n, cfg.num_kv_heads, d), cos, sin)
        v = vp.reshape(n, cfg.num_kv_heads, d)
        ks, vs = (None, None) if kv_scales is None else kv_scales[li]
        ks, vs = _kv_scale(cfg, ks), _kv_scale(cfg, vs)
        store(k, v, k_cache, v_cache, ks, vs)
        attn = attend(q, k, v, k_cache, v_cache, ks, vs).reshape(n, -1)
        op = attn @ lw["wo"] if lq is None else w8a8.project(attn, lq["wo"], x.dtype, plain=plain)
        if lora is not None:
            op = op + _lora_delta(attn, la["oA"], la["oB"], lora_idx, plain)
        x = x + op
        mlp_in = norm(x, lw["ln2"], cfg.rms_eps)
        x = x + (_mlp(lw, mlp_in) if lq is None else _mlp_q(lq, mlp_in, plain))
    return x, caches


def _final_norm(cfg: LlamaConfig, params: dict, x, plain: bool = False):
    """The final RMSNorm (``ln_f``) the steps end with."""
    return (rms_norm_ref if plain else rms_norm)(x, params["ln_f"], cfg.rms_eps)


def _layers(cfg: LlamaConfig, params: dict, x, positions, caches, slot_mapping, attend,
            weights_q, kv_scales, lora, lora_idx, plain: bool):
    """The whole stack with the K / V rows written at ``slot_mapping``, then
    the final norm."""
    x, caches = _stack(cfg, params["layers"], x, positions, caches, _write(slot_mapping),
                       attend, weights_q, kv_scales, lora, lora_idx, plain)
    return _final_norm(cfg, params, x, plain), caches


def _decode_attend(cfg: LlamaConfig, block_tables, context_lens, plain: bool = False):
    """A decode step's ``attend`` for :func:`_stack`: K11a over the cache
    (its plain version with ``plain``)."""
    decode = decode_gqa_plain if plain else decode_gqa
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def attend(q, k, v, kc, vc, ks, vs):
        return decode(q, kc, vc, context_lens, scale, block_tables, k_scale=ks, v_scale=vs)

    return attend


def _prefill_positions(seq_lens, context_lens, s: int, dev):
    """Each packed prefill row's position: its request's context before the
    chunk plus its place in the chunk (pad rows past the requests: the last
    request's next places)."""
    sl = seq_lens.to(dev).long()
    req, j = packed_rows(sl, s)
    return context_lens.to(dev).long()[req] - sl[req] + j


def _prefill_attend(cfg: LlamaConfig, s: int, seq_lens, block_tables, context_lens,
                    max_q: int | None = None, use_pallas: bool = True, plain: bool = False):
    """A varlen prefill's ``attend`` for :func:`_stack` over ``s`` packed
    rows: K12d without sinks or window (its plain version with ``plain``,
    the golden :func:`attention_sinks_prefill` with ``use_pallas=False``)."""
    prefill = attention_sinks_prefill_plain if plain else attention_sinks_prefill_pallas
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def attend(q, k, v, kc, vc, ks, vs):
        args = (q.reshape(s, -1), kc, vc, None, seq_lens, block_tables, context_lens, scale, 0,
                cfg.num_heads, cfg.num_kv_heads)
        if not use_pallas:
            return attention_sinks_prefill(*args, ks, vs)
        return prefill(*args, max_q=max_q, k_scale=ks, v_scale=vs)

    return attend


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def decode_step(cfg: LlamaConfig, params: dict, x, positions, caches, block_tables,
                context_lens, slot_mapping, *, lora=None, lora_idx=None, weights_q=None,
                kv_scales=None, plain: bool = False):
    """One decode step over the stack: ``x [B, hidden]`` at ``positions``;
    ``context_lens`` include the new token; slot ``-1`` rows write nothing;
    ``lora_idx [B]`` is each row's adapter under ``lora``.  Returns
    ``(final-normed hidden, caches)``, the caches updated in place."""
    attend = _decode_attend(cfg, block_tables, context_lens, plain)
    return _layers(cfg, params, x, positions, caches, slot_mapping, attend, weights_q,
                   kv_scales, lora, lora_idx, plain)


def prefill_step(cfg: LlamaConfig, params: dict, x, seq_lens, caches, block_tables,
                 context_lens, slot_mapping, *, max_q: int | None = None,
                 use_pallas: bool = True, lora=None, lora_idx=None, weights_q=None,
                 kv_scales=None, plain: bool = False):
    """Varlen (chunked) prefill: ``x [S, hidden]`` holds each request's last
    ``seq_lens[b]`` tokens, packed; K / V land in the paged cache first,
    then attention (no sinks, no window) reads them back.
    ``use_pallas=False`` attends with the golden
    :func:`attention_sinks_prefill`; ``lora_idx [S]`` is each row's adapter
    under ``lora``.  Returns ``(final-normed hidden, caches)``."""
    s = x.shape[0]
    positions = _prefill_positions(seq_lens, context_lens, s, x.device)
    attend = _prefill_attend(cfg, s, seq_lens, block_tables, context_lens, max_q, use_pallas,
                            plain)
    return _layers(cfg, params, x, positions, caches, slot_mapping, attend, weights_q,
                   kv_scales, lora, lora_idx, plain)


def prefill_step_cp(cfg: LlamaConfig, params: dict, x, seq_lens, caches, block_tables,
                    context_lens, slot_mapping, *, group, plain: bool = False):
    """Context-parallel prefill of ONE request's whole prompt over the ranks
    of ``group`` (JAX's ``prefill_step_cp``): ``x [S, hidden]`` the prompt
    and its pad rows (the same on every rank), ``S % R == 0``,
    ``context_lens == seq_lens`` (a fresh prompt: no chunk continues an
    earlier one), pad rows at slot ``-1``.  Rank r runs the layers on rows
    ``[r S/R, (r+1) S/R)``.  Each rank's K / V rows are all-gathered before
    the cache write, so every rank's cache holds all S rows (int8 levels on
    the int8 cache), as JAX's replicated cache does, and decode runs on it
    as usual.  Attention reads the same gathered, fresh K / V at full
    precision (:func:`gathered_attention`: this rank's rows against rows
    ``[0, (r+1) S/R)``), where JAX's ring rotates the blocks: the same
    numbers with no second exchange.  Returns ``(final-normed hidden [S,
    hidden], caches)``, the rows all-gathered: the same bits on every
    rank."""
    from sgl_kernel_npu_tpu_torch.parallel.collectives import (
        all_gather,
        group_rank,
        group_size,
    )
    from sgl_kernel_npu_tpu_torch.parallel.ring_attention import gathered_attention

    r, me = group_size(group), group_rank(group)
    s = x.shape[0]
    if s % r:
        raise ValueError(f"prefill_step_cp: {s} rows do not divide by the ring of {r} ranks "
                         "(the engine's prefill_chunk must)")
    if seq_lens.shape != (1,) or not torch.equal(context_lens.to(seq_lens.device), seq_lens):
        raise ValueError("prefill_step_cp prefills one request's whole prompt from position 0 "
                         "(context_lens == seq_lens): a prompt longer than the engine's "
                         "prefill_chunk, or one whose prefix was already cached, cannot take it")
    tl = s // r
    mine = slice(me * tl, (me + 1) * tl)
    scale = 1.0 / math.sqrt(cfg.head_dim)

    fresh = {}

    def store(k, v, k_cache, v_cache, ks, vs):
        fresh["k"], fresh["v"] = all_gather(k, group), all_gather(v, group)
        write_kv(fresh["k"], k_cache, slot_mapping, ks)
        write_kv(fresh["v"], v_cache, slot_mapping, vs)

    def attend(q, k, v, kc, vc, ks, vs):
        return gathered_attention(q[None], fresh["k"][None], fresh["v"][None], scale,
                                  q_offset=me * tl)[0]

    positions = torch.arange(s, device=x.device)[mine]
    h, caches = _stack(cfg, params["layers"], x[mine], positions, caches, store, attend, None,
                       None, None, None, plain)
    return all_gather(_final_norm(cfg, params, h, plain), group), caches
