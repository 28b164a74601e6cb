"""GPT-OSS for serving: paged decode and varlen prefill over the layer stack.

Counterpart of ``sgl_kernel_npu_tpu/models/gpt_oss.py`` on one GPU: sinks
attention with alternating sliding-window (even layers) and full layers over
the paged KV cache (``attention_sinks`` K12a decode, ``attention_sinks_packed``
K12b / K12c decode over the packed layout, ``attention_sinks_prefill_pallas``
K12d prefill), RMSNorm (``rms_norm`` K6a) and the clamped SwiGLU over
interleaved gate / up (``swiglu_oai`` K7b), with either the dense MLP or the
MoE (softmax over the top-k of the biased router logits; every expert
computed for every token by dense products and the top-k combined by one-hot
weights, as JAX does on one chip: 8 times the routed work at GPT-OSS-20B's 32
experts top-4).  The KV cache is bf16 / f32, or int8 levels ``round(x /
kv_scale)`` (``kv_cache_dtype="int8"``; ``kv_scales`` per layer and kv head
from ``w8a8.calibrate_kv_scales``, else ``cfg.kv_scale``), in the plain
layout or packed (``packed_kv``: two kv heads a row, ``pack_kv_sinks``).
``weights_q`` (:func:`quantize_weights`) runs the projections W8A8 on
``quant_per_token`` (K5) and ``quant_matmul`` (K1): the attention
projections only in MoE mode, as JAX.  ``ep_buffer`` (a
``parallel.buffer.Buffer`` for ``cfg.num_experts``) serves the MoE expert
parallel through ``Buffer.fused_oai_moe``, as JAX: each token's top-k experts
only, on ``grouped_matmul_float`` (K8a's ``none`` mode).

Weights are a plain dict of tensors with the JAX package's names and layouts
(``layers`` a list of per-layer dicts; ``w_lm``, ``rope_inv_freq`` /
``rope_attention_scaling`` and ``rms_eps`` optional, as a checkpoint carries
them); caches are a list of per-layer ``(k_cache, v_cache)`` updated in
place.  ``plain=True`` on the steps runs the kernels' plain PyTorch versions
on the same tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from sgl_kernel_npu_tpu_torch.models import w8a8
from sgl_kernel_npu_tpu_torch.ops.activation import swiglu_oai, swiglu_oai_ref
from sgl_kernel_npu_tpu_torch.ops.attention.sinks_attention import (
    attention_sinks,
    attention_sinks_packed,
    attention_sinks_plain,
    attention_sinks_prefill,
    attention_sinks_prefill_packed,
    attention_sinks_prefill_pallas,
    attention_sinks_prefill_plain,
    attention_sinks_ref,
    packed_rows,
)
from sgl_kernel_npu_tpu_torch.ops.mem_cache.kv_cache import reshape_and_cache, write_kv
from sgl_kernel_npu_tpu_torch.ops.norm import rms_norm, rms_norm_ref
from sgl_kernel_npu_tpu_torch.ops.quant import quant_per_token, quant_per_token_ref
from sgl_kernel_npu_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from sgl_kernel_npu_tpu_torch.utils.common import resolve_device, to_torch, top_k


@dataclasses.dataclass(frozen=True)
class GptOssConfig:
    """The JAX package's config, fields and defaults alike."""

    vocab_size: int = 128
    hidden: int = 256
    num_layers: int = 2
    num_heads: int = 8
    num_kv_heads: int = 2
    head_dim: int = 32
    intermediate: int = 512        # per gate / up half
    sliding_window: int = 128      # even layers use the window, odd layers full
    page_size: int = 16
    rope_theta: float = 10000.0
    alpha: float = 1.702
    limit: float = 7.0
    rms_eps: float = 1e-6          # HF GPT-OSS checkpoints use 1e-5
    num_experts: int = 0           # > 0: the MoE MLP; 0: the dense clamped-SwiGLU MLP
    topk: int = 4
    attention_bias: bool = False   # q / k / v / o biases (GPT-OSS checkpoints: True)
    packed_kv: bool = False        # two kv heads a cache row (needs an even num_kv_heads)
    kv_cache_dtype: str = "bf16"   # "int8": K / V pages hold round(x / kv_scale)
    kv_scale: float = 1.0 / 64     # the int8 cache's scale when no kv_scales are given


# ---------------------------------------------------------------------------
# weights and caches
# ---------------------------------------------------------------------------

def init_weights(cfg: GptOssConfig, seed: int = 0, dtype=torch.float32, device="cuda", *,
                 bias_scale: float = 0.0, untied_lm_head: bool = False) -> dict:
    """Random weights from ``seed`` with the JAX package's shapes and scales
    (N(0, 0.02²), sinks N(0, 1), norms 1).  Biases are 0 as in JAX, or
    N(0, ``bias_scale``²); ``untied_lm_head`` adds ``w_lm [hidden, vocab]``
    (drawn last), as an untied checkpoint carries it."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, d = cfg.hidden, cfg.head_dim

    def rnd(*shape, scale=0.02):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def bias(*shape):
        return rnd(*shape, scale=bias_scale) if bias_scale else torch.zeros(
            shape, dtype=dtype, device=dev)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    layers = []
    for _ in range(cfg.num_layers):
        lw = {
            "ln1": ones(h),
            "wq": rnd(h, cfg.num_heads * d),
            "wk": rnd(h, cfg.num_kv_heads * d),
            "wv": rnd(h, cfg.num_kv_heads * d),
            "wo": rnd(cfg.num_heads * d, h),
            "sinks": rnd(cfg.num_heads, scale=1.0),
            "ln2": ones(h),
        }
        if cfg.num_experts > 0:
            e, i = cfg.num_experts, cfg.intermediate
            lw.update({"router_w": rnd(h, e), "router_b": bias(e),
                       "w_gate_up": rnd(e, h, 2 * i), "b_gate_up": bias(e, 2 * i),
                       "w_down": rnd(e, i, h), "b_down": bias(e, h)})
        else:
            lw.update({"w_gate_up": rnd(h, 2 * cfg.intermediate),   # interleaved gate / up
                       "w_down": rnd(cfg.intermediate, h)})
        if cfg.attention_bias:
            lw.update({"bq": bias(cfg.num_heads * d), "bk": bias(cfg.num_kv_heads * d),
                       "bv": bias(cfg.num_kv_heads * d), "bo": bias(h)})
        layers.append(lw)
    params = {"layers": layers, "ln_f": ones(h), "wte": rnd(cfg.vocab_size, h)}
    if untied_lm_head:
        params["w_lm"] = rnd(h, cfg.vocab_size)
    return params


_SCALARS = ("rms_eps", "rope_attention_scaling")


def from_jax_params(params_np: dict, device="cuda", dtype=None) -> dict:
    """The JAX package's weight pytree (leaves as numpy arrays) → the port's,
    ``w_lm`` and the rope tables included when present; ``dtype`` casts the
    floating weights (not the rope tables), None keeps the arrays' types."""
    dev = resolve_device(device)

    def conv(a):
        t = to_torch(a, dev)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    out = {}
    for k, v in params_np.items():
        if k == "layers":
            out[k] = [{n: conv(a) for n, a in lw.items()} for lw in v]
        elif k in _SCALARS:
            out[k] = float(v)
        elif k == "rope_inv_freq":
            out[k] = to_torch(v, dev).float()
        else:
            out[k] = conv(v)
    return out


def quantize_weights(cfg: GptOssConfig, params: dict) -> dict:
    """Per-out-channel int8 quant of the projections (W8A8 serving,
    ``models/w8a8.py``): q / k / v / o, and in dense mode ``w_gate_up``
    (still interleaved: ``swiglu_oai`` reads it so) and ``w_down``; the
    experts stay float, as in JAX."""
    names = (("wq", "wk", "wv", "wo") if cfg.num_experts > 0 else
             ("wq", "wk", "wv", "wo", "w_gate_up", "w_down"))
    return {"layers": [{name: w8a8.quantize_matrix(lw[name]) for name in names}
                       for lw in params["layers"]]}


def init_kv_cache(cfg: GptOssConfig, num_pages: int, dtype=torch.float32,
                  device="cuda") -> list[tuple]:
    """Per-layer ``(k_cache, v_cache)`` of zeros, ``[pages, Hkv, page, D]``
    or packed ``[pages, Hkv / 2, page, 2 D]``; int8 when
    ``cfg.kv_cache_dtype == "int8"``, else ``dtype``."""
    dev = resolve_device(device)
    if cfg.packed_kv:
        if cfg.num_kv_heads % 2:
            raise ValueError("packed_kv needs an even num_kv_heads")
        shape = (num_pages, cfg.num_kv_heads // 2, cfg.page_size, 2 * cfg.head_dim)
    else:
        shape = (num_pages, cfg.num_kv_heads, cfg.page_size, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        dtype = torch.int8
    return [(torch.zeros(shape, dtype=dtype, device=dev),
             torch.zeros(shape, dtype=dtype, device=dev)) for _ in range(cfg.num_layers)]


def _kv_scale(cfg: GptOssConfig, scale=None):
    """The int8 cache's dequant scale (``cfg.kv_scale`` or a calibrated
    per-kv-head ``[Hkv]``), None on the float path."""
    if cfg.kv_cache_dtype != "int8":
        return None
    return cfg.kv_scale if scale is None else scale


def _cache_rows(cfg: GptOssConfig, kv: torch.Tensor) -> torch.Tensor:
    """Per-token K or V rows ``[N, Hkv, D]`` in the cache layout: packed
    pairs the heads into rows ``[N, Hkv / 2, 2 D]`` (the pack_kv_sinks
    order)."""
    if cfg.packed_kv:
        return kv.reshape(kv.shape[0], cfg.num_kv_heads // 2, 2 * cfg.head_dim)
    return kv


def embed(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["wte"][ids.long()]


def lm_head(params: dict, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """Final norm and head (tied unless the weights carry ``w_lm``), with
    JAX's ``params.get("rms_eps", 1e-6)``: a checkpoint's eps when it
    carries one."""
    w = params["w_lm"] if "w_lm" in params else params["wte"].T
    norm = rms_norm_ref if plain else rms_norm
    return norm(x, params["ln_f"], params.get("rms_eps", 1e-6)) @ w


def _rope_tables(cfg: GptOssConfig, params: dict, positions: torch.Tensor):
    """cos / sin for the positions: a checkpoint's scaled rope (``rope_inv_freq``
    and ``rope_attention_scaling``, the real GPT-OSS's YaRN) or the standard
    neox tables of ``cfg.rope_theta``."""
    if "rope_inv_freq" in params:
        freqs = positions.float()[:, None] * params["rope_inv_freq"][None]
        emb = torch.cat([freqs, freqs], dim=-1)
        f = params["rope_attention_scaling"]
        return torch.cos(emb) * f, torch.sin(emb) * f
    return rope_cos_sin(positions, cfg.head_dim, base=cfg.rope_theta)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _kernels(cfg: GptOssConfig, plain: bool):
    """``(rms_norm, swiglu_oai, decode attention, prefill attention)`` for
    the config's cache layout: the kernels, or with ``plain`` their plain
    versions."""
    if plain:
        return (rms_norm_ref, swiglu_oai_ref,
                functools.partial(attention_sinks_plain, packed=cfg.packed_kv),
                functools.partial(attention_sinks_prefill_plain, packed=cfg.packed_kv))
    if cfg.packed_kv:
        return rms_norm, swiglu_oai, attention_sinks_packed, attention_sinks_prefill_packed
    return rms_norm, swiglu_oai, attention_sinks, attention_sinks_prefill_pallas


def _proj_qkv(cfg: GptOssConfig, lw: dict, lq, hidden_n, n: int, plain: bool):
    """q / k / v projections; W8A8 with ``lq`` (one shared per-token quant)."""
    d = cfg.head_dim
    if lq is not None:
        x_q, sx = (quant_per_token_ref if plain else quant_per_token)(hidden_n)
        qp, kp, vp = (w8a8.qmm(x_q, sx, lq[nm], hidden_n.dtype, plain=plain)
                      for nm in ("wq", "wk", "wv"))
    else:
        qp, kp, vp = (hidden_n @ lw[nm] for nm in ("wq", "wk", "wv"))
    if cfg.attention_bias:
        qp, kp, vp = qp + lw["bq"], kp + lw["bk"], vp + lw["bv"]
    return (qp.reshape(n, cfg.num_heads, d), kp.reshape(n, cfg.num_kv_heads, d),
            vp.reshape(n, cfg.num_kv_heads, d))


def _router(cfg: GptOssConfig, lw: dict, x):
    """Top-k of the biased router logits (equal values: the lower expert
    first, as ``jax.lax.top_k``) → ``(ids [N, k], softmax weights [N, k])``
    in x's dtype.  Routing is discrete: a caller replaces this function to
    record one run's choices and replay them in another."""
    logits = x @ lw["router_w"] + lw["router_b"]
    topw, topi = top_k(logits, cfg.topk)
    return topi, torch.softmax(topw, dim=-1)


def _moe_mlp(cfg: GptOssConfig, lw: dict, x, swiglu, ep_buffer=None,
             plain: bool = False):
    """HF GptOssExperts semantics: biased gate|up (interleaved) → clamped
    SwiGLU → biased down.  ``ep_buffer``: expert parallel through
    ``Buffer.fused_oai_moe`` (x in bf16, the top-k weights in f32), each token's
    top-k experts only.  Otherwise as JAX computes it on one chip: every
    expert for every token, then the top-k combined by one-hot weights, the
    products batched over the experts with the weights as stored ([E, N, .]
    activations; an einsum to JAX's [N, E, .] layout copies the weights on
    every call)."""
    topi, topw = _router(cfg, lw, x)
    if ep_buffer is not None:
        out, _, _ = ep_buffer.fused_oai_moe(
            x.to(torch.bfloat16), topi.to(torch.int32), topw.float(), lw["w_gate_up"],
            lw["b_gate_up"], lw["w_down"], lw["b_down"], alpha=cfg.alpha, limit=cfg.limit,
            plain=plain)
        return out.to(x.dtype)
    n, e = x.shape[0], cfg.num_experts
    gu = torch.matmul(x, lw["w_gate_up"]) + lw["b_gate_up"][:, None]        # [E, N, 2I]
    act = swiglu(gu.reshape(e * n, -1), cfg.alpha, cfg.limit).reshape(e, n, cfg.intermediate)
    y = torch.matmul(act, lw["w_down"]) + lw["b_down"][:, None]             # [E, N, H]
    onehot = torch.nn.functional.one_hot(topi.long(), e).to(x.dtype)       # [N, K, E]
    w = (topw[..., None].to(x.dtype) * onehot).sum(dim=1)                  # [N, E]
    return torch.einsum("ne,enh->nh", w, y)


def _out_mlp(cfg: GptOssConfig, lw: dict, lq, x, attn, plain: bool, ep_buffer=None):
    """Output projection, residual, then the dense or MoE MLP (expert
    parallel with ``ep_buffer``) and residual; W8A8 with ``lq`` (in MoE mode
    the projection only)."""
    norm, swiglu, _, _ = _kernels(cfg, plain)
    op = attn @ lw["wo"] if lq is None else w8a8.project(attn, lq["wo"], x.dtype, plain=plain)
    if cfg.attention_bias:
        op = op + lw["bo"]
    x = x + op
    mlp_in = norm(x, lw["ln2"], cfg.rms_eps)
    if cfg.num_experts > 0:
        return x + _moe_mlp(cfg, lw, mlp_in, swiglu, ep_buffer, plain)
    if lq is not None:
        act = swiglu(w8a8.project(mlp_in, lq["w_gate_up"], torch.bfloat16, plain=plain),
                     cfg.alpha, cfg.limit)
        return x + w8a8.project(act, lq["w_down"], x.dtype, plain=plain)
    return x + swiglu(mlp_in @ lw["w_gate_up"], cfg.alpha, cfg.limit) @ lw["w_down"]


def _window(cfg: GptOssConfig, li: int) -> int:
    return cfg.sliding_window if li % 2 == 0 else 0   # GPT-OSS's alternation


def _layers(cfg: GptOssConfig, params: dict, x, positions, caches, slot_mapping, attend,
            weights_q, kv_scales, ep_buffer, plain: bool):
    """The layer stack over ``x [N, hidden]``: each layer writes its K / V
    rows (int8 levels on the int8 path) at ``slot_mapping``, then
    ``attend(q [N, Hq * D], k_cache, v_cache, sinks, window, k_scale,
    v_scale)`` reads them back."""
    norm = _kernels(cfg, plain)[0]
    n = x.shape[0]
    cos, sin = _rope_tables(cfg, params, positions)
    for li, lw in enumerate(params["layers"]):
        lq = None if weights_q is None else weights_q["layers"][li]
        k_cache, v_cache = caches[li]
        q, k, v = _proj_qkv(cfg, lw, lq, norm(x, lw["ln1"], cfg.rms_eps), n, plain)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        ks, vs = (None, None) if kv_scales is None else kv_scales[li]
        ks, vs = _kv_scale(cfg, ks), _kv_scale(cfg, vs)
        write_kv(_cache_rows(cfg, k), k_cache, slot_mapping, ks)
        write_kv(_cache_rows(cfg, v), v_cache, slot_mapping, vs)
        attn = attend(q.reshape(n, -1), k_cache, v_cache, lw["sinks"], _window(cfg, li), ks, vs)
        x = _out_mlp(cfg, lw, lq, x, attn.reshape(n, -1), plain, ep_buffer)
    return x, caches


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def decode_step(cfg: GptOssConfig, params: dict, x, positions, caches, block_tables,
                context_lens, slot_mapping, *, weights_q=None, kv_scales=None, ep_buffer=None,
                plain: bool = False):
    """One decode step over the layer stack: ``x [B, hidden]`` at
    ``positions``; ``context_lens`` include the new token; slot ``-1`` rows
    write nothing.  ``kv_scales``: per layer ``(k_scale [Hkv], v_scale
    [Hkv])`` of the int8 cache; ``ep_buffer`` serves the MoE expert
    parallel.  Returns ``(hidden, caches)``, the caches updated in place."""
    decode = _kernels(cfg, plain)[2]
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def attend(q, kc, vc, sinks, window, ks, vs):
        return decode(q, kc, vc, sinks, block_tables, context_lens, scale, window,
                      cfg.num_heads, cfg.num_kv_heads, k_scale=ks, v_scale=vs)

    return _layers(cfg, params, x, positions, caches, slot_mapping, attend, weights_q,
                   kv_scales, ep_buffer, plain)


def prefill_step(cfg: GptOssConfig, params: dict, x, seq_lens, caches, block_tables,
                 context_lens, slot_mapping, *, max_q: int | None = None,
                 use_pallas: bool = True, weights_q=None, kv_scales=None, ep_buffer=None,
                 plain: bool = False):
    """Varlen (chunked) prefill over the layer stack: ``x [S, hidden]`` is the
    concatenation of each request's last ``seq_lens[b]`` tokens,
    ``context_lens`` the totals including them.  K/V rows are written to the
    paged cache first, then attention reads them back.  ``use_pallas=False``
    attends with the golden :func:`attention_sinks_prefill` (plain layout
    only, as JAX); ``ep_buffer`` as :func:`decode_step`.  Returns ``(hidden,
    caches)``, the caches updated in place."""
    if cfg.packed_kv and not use_pallas:
        raise ValueError("packed_kv prefill runs the prefill kernel (use_pallas=True), as in JAX")
    prefill = _kernels(cfg, plain)[3]
    s = x.shape[0]
    sl = seq_lens.to(x.device).long()
    req, j = packed_rows(sl, s)
    positions = context_lens.to(x.device).long()[req] - sl[req] + j
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def attend(q, kc, vc, sinks, window, ks, vs):
        args = (q, kc, vc, sinks, seq_lens, block_tables, context_lens, scale, window,
                cfg.num_heads, cfg.num_kv_heads)
        if not use_pallas:
            return attention_sinks_prefill(*args, ks, vs)
        return prefill(*args, max_q=max_q, k_scale=ks, v_scale=vs)

    return _layers(cfg, params, x, positions, caches, slot_mapping, attend, weights_q,
                   kv_scales, ep_buffer, plain)


def decode_step_ref(cfg: GptOssConfig, params: dict, x, positions, caches, block_tables,
                    context_lens, slot_mapping):
    """Golden of the dense model without biases, as JAX's ``decode_step_ref``:
    the same math on the plain versions."""
    b = x.shape[0]
    d = cfg.head_dim
    cos, sin = _rope_tables(cfg, params, positions)
    scale = 1.0 / math.sqrt(d)
    for li, lw in enumerate(params["layers"]):
        k_cache, v_cache = caches[li]
        hidden_n = rms_norm_ref(x, lw["ln1"], cfg.rms_eps)
        q = (hidden_n @ lw["wq"]).reshape(b, cfg.num_heads, d)
        k = (hidden_n @ lw["wk"]).reshape(b, cfg.num_kv_heads, d)
        v = (hidden_n @ lw["wv"]).reshape(b, cfg.num_kv_heads, d)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        reshape_and_cache(k, k_cache, slot_mapping)
        reshape_and_cache(v, v_cache, slot_mapping)
        attn = attention_sinks_ref(q.reshape(b, -1), k_cache, v_cache, lw["sinks"],
                                   block_tables, context_lens, scale, _window(cfg, li),
                                   cfg.num_heads, cfg.num_kv_heads)
        x = x + attn.reshape(b, -1) @ lw["wo"]
        mlp_in = rms_norm_ref(x, lw["ln2"], cfg.rms_eps)
        x = x + swiglu_oai_ref(mlp_in @ lw["w_gate_up"], cfg.alpha, cfg.limit) @ lw["w_down"]
    return x, caches
