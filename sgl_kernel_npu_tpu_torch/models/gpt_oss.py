"""GPT-OSS for serving: paged decode and varlen prefill over the layer stack.

Counterpart of ``sgl_kernel_npu_tpu/models/gpt_oss.py`` on its single-GPU
float path: sinks attention with alternating sliding-window (even layers) and
full layers over an unpacked bf16 / f32 paged KV cache (``attention_sinks``
K12a decode, ``attention_sinks_prefill_pallas`` K12d prefill), RMSNorm
(``rms_norm`` K6a) and the clamped SwiGLU over interleaved gate / up
(``swiglu_oai`` K7b), with either the dense MLP or the MoE (softmax over the
top-k of the biased router logits; every expert computed for every token by
dense products and the top-k combined by one-hot weights, as JAX does on one
chip: 8 times the routed work at GPT-OSS-20B's 32 experts top-4).

Weights are a plain dict of tensors with the JAX package's names and layouts
(``layers`` a list of per-layer dicts; ``w_lm``, ``rope_inv_freq`` /
``rope_attention_scaling`` and ``rms_eps`` optional, as a checkpoint carries
them); caches are a list of per-layer ``(k_cache, v_cache)`` updated in
place.  ``plain=True`` on the steps runs the four kernels' plain PyTorch
versions on the same tensors.  Not ported yet, and raising
``NotImplementedError`` (ROADMAP queue A): W8A8 projections (``weights_q``),
the int8 KV cache (``kv_cache_dtype="int8"``, ``kv_scales``), the packed
KV layout (``packed_kv``) and expert-parallel MoE (``ep_buffer``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sgl_kernel_npu_tpu_torch.ops.activation import swiglu_oai, swiglu_oai_ref
from sgl_kernel_npu_tpu_torch.ops.attention.sinks_attention import (
    attention_sinks,
    attention_sinks_prefill,
    attention_sinks_prefill_pallas,
    attention_sinks_prefill_plain,
    attention_sinks_ref,
    packed_rows,
)
from sgl_kernel_npu_tpu_torch.ops.mem_cache.kv_cache import reshape_and_cache
from sgl_kernel_npu_tpu_torch.ops.norm import rms_norm, rms_norm_ref
from sgl_kernel_npu_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from sgl_kernel_npu_tpu_torch.utils.common import resolve_device, to_torch, top_k


@dataclasses.dataclass(frozen=True)
class GptOssConfig:
    """The JAX package's config, fields and defaults alike (less the int8
    cache's ``kv_scale``: that cache is not ported)."""

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
    packed_kv: bool = False        # not ported
    kv_cache_dtype: str = "bf16"   # "int8": not ported


def _require_float_path(cfg: GptOssConfig, weights_q=None, kv_scales=None,
                        ep_buffer=None) -> None:
    """Raise for the switches this port does not take yet."""
    unported = {"packed_kv": cfg.packed_kv,
                "kv_cache_dtype='int8'": cfg.kv_cache_dtype == "int8",
                "weights_q": weights_q is not None, "kv_scales": kv_scales is not None,
                "ep_buffer": ep_buffer is not None}
    named = [k for k, v in unported.items() if v]
    if named:
        raise NotImplementedError(f"GPT-OSS {', '.join(named)} not ported yet (ROADMAP queue A)")


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


def init_kv_cache(cfg: GptOssConfig, num_pages: int, dtype=torch.float32,
                  device="cuda") -> list[tuple]:
    """Per-layer ``(k_cache, v_cache)`` of zeros ``[pages, Hkv, page, D]``."""
    _require_float_path(cfg)
    dev = resolve_device(device)
    shape = (num_pages, cfg.num_kv_heads, cfg.page_size, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=dev),
             torch.zeros(shape, dtype=dtype, device=dev)) for _ in range(cfg.num_layers)]


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

def _kernels(plain: bool):
    """``(rms_norm, swiglu_oai, decode attention, prefill attention)``: the
    kernels, or with ``plain`` their plain versions."""
    if plain:
        return rms_norm_ref, swiglu_oai_ref, attention_sinks_ref, attention_sinks_prefill_plain
    return rms_norm, swiglu_oai, attention_sinks, attention_sinks_prefill_pallas


def _proj_qkv(cfg: GptOssConfig, lw: dict, hidden_n, n: int):
    d = cfg.head_dim
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


def _moe_mlp(cfg: GptOssConfig, lw: dict, x, swiglu):
    """HF GptOssExperts semantics on one GPU, as JAX computes it there: every
    expert's biased gate|up (interleaved) → clamped SwiGLU → biased down for
    every token, then the top-k combined by one-hot weights.  The products
    are batched over the experts with the weights as stored ([E, N, .]
    activations; an einsum to JAX's [N, E, .] layout copies the weights on
    every call)."""
    topi, topw = _router(cfg, lw, x)
    n, e = x.shape[0], cfg.num_experts
    gu = torch.matmul(x, lw["w_gate_up"]) + lw["b_gate_up"][:, None]        # [E, N, 2I]
    act = swiglu(gu.reshape(e * n, -1), cfg.alpha, cfg.limit).reshape(e, n, cfg.intermediate)
    y = torch.matmul(act, lw["w_down"]) + lw["b_down"][:, None]             # [E, N, H]
    onehot = torch.nn.functional.one_hot(topi.long(), e).to(x.dtype)       # [N, K, E]
    w = (topw[..., None].to(x.dtype) * onehot).sum(dim=1)                  # [N, E]
    return torch.einsum("ne,enh->nh", w, y)


def _out_mlp(cfg: GptOssConfig, lw: dict, x, attn, plain: bool):
    """Output projection, residual, then the dense or MoE MLP and residual."""
    norm, swiglu, _, _ = _kernels(plain)
    op = attn @ lw["wo"]
    if cfg.attention_bias:
        op = op + lw["bo"]
    x = x + op
    mlp_in = norm(x, lw["ln2"], cfg.rms_eps)
    if cfg.num_experts > 0:
        return x + _moe_mlp(cfg, lw, mlp_in, swiglu)
    return x + swiglu(mlp_in @ lw["w_gate_up"], cfg.alpha, cfg.limit) @ lw["w_down"]


def _window(cfg: GptOssConfig, li: int) -> int:
    return cfg.sliding_window if li % 2 == 0 else 0   # GPT-OSS's alternation


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def decode_step(cfg: GptOssConfig, params: dict, x, positions, caches, block_tables,
                context_lens, slot_mapping, *, weights_q=None, kv_scales=None, ep_buffer=None,
                plain: bool = False):
    """One decode step over the layer stack: ``x [B, hidden]`` at
    ``positions``; ``context_lens`` include the new token; slot ``-1`` rows
    write nothing.  Returns ``(hidden, caches)``, the caches updated in
    place."""
    _require_float_path(cfg, weights_q, kv_scales, ep_buffer)
    norm, _, attend, _ = _kernels(plain)
    b = x.shape[0]
    cos, sin = _rope_tables(cfg, params, positions)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    for li, lw in enumerate(params["layers"]):
        k_cache, v_cache = caches[li]
        q, k, v = _proj_qkv(cfg, lw, norm(x, lw["ln1"], cfg.rms_eps), b)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        reshape_and_cache(k, k_cache, slot_mapping)
        reshape_and_cache(v, v_cache, slot_mapping)
        attn = attend(q.reshape(b, -1), k_cache, v_cache, lw["sinks"], block_tables,
                      context_lens, scale, _window(cfg, li), cfg.num_heads, cfg.num_kv_heads)
        x = _out_mlp(cfg, lw, x, attn.reshape(b, -1), plain)
    return x, caches


def prefill_step(cfg: GptOssConfig, params: dict, x, seq_lens, caches, block_tables,
                 context_lens, slot_mapping, *, max_q: int | None = None,
                 use_pallas: bool = True, weights_q=None, kv_scales=None, ep_buffer=None,
                 plain: bool = False):
    """Varlen (chunked) prefill over the layer stack: ``x [S, hidden]`` is the
    concatenation of each request's last ``seq_lens[b]`` tokens,
    ``context_lens`` the totals including them.  K/V rows are written to the
    paged cache first, then attention reads them back.  ``use_pallas=False``
    attends with the golden :func:`attention_sinks_prefill`.  Returns
    ``(hidden, caches)``, the caches updated in place."""
    _require_float_path(cfg, weights_q, kv_scales, ep_buffer)
    norm, _, _, attend = _kernels(plain)
    s = x.shape[0]
    dev = x.device
    sl = seq_lens.to(dev).long()
    req, j = packed_rows(sl, s)
    positions = context_lens.to(dev).long()[req] - sl[req] + j
    cos, sin = _rope_tables(cfg, params, positions)
    kw = {"max_q": max_q} if use_pallas else {}
    if not use_pallas:
        attend = attention_sinks_prefill
    scale = 1.0 / math.sqrt(cfg.head_dim)
    for li, lw in enumerate(params["layers"]):
        k_cache, v_cache = caches[li]
        q, k, v = _proj_qkv(cfg, lw, norm(x, lw["ln1"], cfg.rms_eps), s)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        reshape_and_cache(k, k_cache, slot_mapping)
        reshape_and_cache(v, v_cache, slot_mapping)
        attn = attend(q.reshape(s, -1), k_cache, v_cache, lw["sinks"], seq_lens, block_tables,
                      context_lens, scale, _window(cfg, li), cfg.num_heads, cfg.num_kv_heads,
                      **kw)
        x = _out_mlp(cfg, lw, x, attn.reshape(s, -1), plain)
    return x, caches


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
