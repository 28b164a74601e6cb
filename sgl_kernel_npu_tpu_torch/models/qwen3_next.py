"""Qwen3-Next: gated-delta-rule (GDN) layers and the GDN + attention hybrid.

Counterpart of ``sgl_kernel_npu_tpu/models/qwen3_next.py`` on one GPU.  A GDN
layer runs the causal conv1d over the mixed q ‖ k ‖ v stream
(``ops/mamba``), the gated delta rule (``ops/fla``: chunked prefill from the
request's state, the recurrent update at decode, both over the engine's
state pools), the gated RMSNorm and the output projection; every one is
plain torch, as JAX writes no kernel for them.  The hybrid's full-attention
layer (every ``attn_every``-th) decodes on the paged GQA decode kernel
(``decode_gqa``, K11a) and prefills on the varlen prefill kernel without
sinks or window (``attention_sinks_prefill_pallas``, K12d), at Qwen3-Next's
head_dim 256, with the sigmoid output gate, per-head q / k RMSNorm and
partial rotary of the published checkpoint.  Every layer's MLP is a dense
SwiGLU or the MoE: a softmax over all experts, top-k (``utils/common.top_k``:
JAX's tie order), renormalised, every expert run for every token as JAX's
dense form (products batched over the stored ``[E, H, I]`` / ``[E, I, H]``
weights, no copy of them), plus a sigmoid-gated shared expert.

``weights_q`` (:func:`quantize_hybrid_weights`) runs the wide projections
W8A8 as JAX's: attention q / k / v off one ``quant_per_token`` (K5) and
three ``quant_matmul`` (K1), ``wo``, the GDN ``w_qkvz`` and ``w_out`` by
``w8a8.project``, the dense MLP (without MoE) by ``w8a8.mlp_swiglu``.
``plain=True`` runs the kernels' plain versions.  Weights are a dict with
the JAX package's names and layouts (the layers' ``kind`` tags kept);
caches a list per layer, ``{"k", "v"}`` pages ``[P, Hkv, page, D]`` or
``{"conv" [slots, qkv, W - 1], "ssm" [slots, HV, K, V] f32}`` state pools,
all updated in place.  The steps return the un-normed hidden state, as
JAX's; :func:`hybrid_lm_head` applies the final norm.

``moe_weights_q`` (:func:`quantize_hybrid_moe_weights`) with ``ep_buffer``
(a ``parallel.buffer.Buffer`` built for ``moe_experts``) serves the routed
experts expert parallel through ``Buffer.fused_deep_moe`` (DeepSeek-V3's
W8A8 chain: the wire quant K5, the exchanges K15a / K15b, K8a twice, or K16b
with ``single_kernel``); the shared expert stays local and float.  Passing
one of the two without the other raises ``ValueError`` (JAX serves the dense
MoE then).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sgl_kernel_npu_tpu_torch.models import w8a8
from sgl_kernel_npu_tpu_torch.ops.attention.decode_attention import decode_gqa, decode_gqa_plain
from sgl_kernel_npu_tpu_torch.ops.attention.sinks_attention import (
    attention_sinks_prefill_pallas,
    attention_sinks_prefill_plain,
)
from sgl_kernel_npu_tpu_torch.ops.fla.chunk import chunk_gated_delta_rule
from sgl_kernel_npu_tpu_torch.ops.fla.gating import fused_gdn_gating
from sgl_kernel_npu_tpu_torch.ops.fla.norms import layernorm_gated
from sgl_kernel_npu_tpu_torch.ops.fla.recurrent import fused_sigmoid_gating_delta_rule_update
from sgl_kernel_npu_tpu_torch.ops.mamba.causal_conv1d import (
    causal_conv1d_fn,
    causal_conv1d_update,
)
from sgl_kernel_npu_tpu_torch.ops.mem_cache.kv_cache import write_kv
from sgl_kernel_npu_tpu_torch.ops.norm import rms_norm_ref
from sgl_kernel_npu_tpu_torch.ops.quant import quant_per_token, quant_per_token_ref
from sgl_kernel_npu_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from sgl_kernel_npu_tpu_torch.parallel.fused_moe import quantize_expert_weights
from sgl_kernel_npu_tpu_torch.utils.common import resolve_device, to_torch, top_k

@dataclasses.dataclass(frozen=True)
class Qwen3NextConfig:
    """A GDN layer stack's widths: the JAX package's config, fields and
    defaults alike."""

    hidden: int = 256
    num_k_heads: int = 2        # H (q / k heads)
    num_v_heads: int = 4        # HV
    head_k_dim: int = 32        # K
    head_v_dim: int = 32        # V
    conv_width: int = 4
    mlp_intermediate: int = 512
    chunk_size: int = 16
    rms_eps: float = 1e-6       # the gated norm's eps

    @property
    def qkv_dim(self) -> int:
        """The mixed projection's width: q (H K) ‖ k (H K) ‖ v (HV V)."""
        return 2 * self.num_k_heads * self.head_k_dim + self.num_v_heads * self.head_v_dim


@dataclasses.dataclass(frozen=True)
class Qwen3NextHybridConfig:
    """GDN layers with a full GQA attention layer every ``attn_every``
    layers (layer i is attention iff ``(i + 1) % attn_every == 0``): the JAX
    package's config, fields and defaults alike."""

    vocab_size: int = 128
    hidden: int = 256
    num_layers: int = 2
    attn_every: int = 2
    # GDN widths
    num_k_heads: int = 2
    num_v_heads: int = 4
    head_k_dim: int = 32
    head_v_dim: int = 32
    conv_width: int = 4
    chunk_size: int = 16
    # attention widths
    num_heads: int = 8
    num_kv_heads: int = 2
    head_dim: int = 32
    page_size: int = 16
    rope_theta: float = 10000.0
    mlp_intermediate: int = 512
    # the published checkpoint's attention details (off by default)
    rotary_dim: int = 0            # > 0: rope on the first rotary_dim dims only
    attn_gate: bool = False        # a sigmoid output gate from its own projection
    qk_norm: bool = False          # per-head RMSNorm on q and k before rope
    rms_eps: float = 1e-6
    # the MoE MLP (0 experts: dense SwiGLU)
    moe_experts: int = 0
    moe_topk: int = 4
    moe_intermediate: int = 64
    shared_expert_intermediate: int = 64
    norm_topk_prob: bool = True

    @property
    def gdn(self) -> Qwen3NextConfig:
        return Qwen3NextConfig(
            hidden=self.hidden, num_k_heads=self.num_k_heads, num_v_heads=self.num_v_heads,
            head_k_dim=self.head_k_dim, head_v_dim=self.head_v_dim,
            conv_width=self.conv_width, mlp_intermediate=self.mlp_intermediate,
            chunk_size=self.chunk_size, rms_eps=self.rms_eps)

    def is_attn(self, li: int) -> bool:
        return (li + 1) % self.attn_every == 0


# ---------------------------------------------------------------------------
# weights and caches
# ---------------------------------------------------------------------------

class _Draw:
    """Random tensors on ``dev`` from one generator: ``rnd(*shape)`` is
    N(0, 1) / sqrt(shape[0]) (JAX's scales), ``rnd(*shape, scale=s)`` N(0,
    s²), in ``dtype``."""

    def __init__(self, seed: int, dtype, dev: torch.device):
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.dtype, self.dev = dtype, dev

    def __call__(self, *shape, scale=None):
        s = 1.0 / math.sqrt(shape[0]) if scale is None else scale
        return (torch.randn(shape, generator=self.gen, device=self.dev) * s).to(self.dtype)

    def uniform(self, n: int, lo: float, hi: float):
        u = torch.rand((n,), generator=self.gen, device=self.dev)
        return (lo + (hi - lo) * u).to(self.dtype)

    def const(self, n: int, value: float):
        return torch.full((n,), value, dtype=self.dtype, device=self.dev)


def _gdn_weights(cfg: Qwen3NextConfig, rnd: _Draw, mlp: bool = True) -> dict:
    hv = cfg.num_v_heads
    w = {
        "ln1": rnd.const(cfg.hidden, 1.0),
        "w_qkvz": rnd(cfg.hidden, cfg.qkv_dim + hv * cfg.head_v_dim),   # + the z gate
        "w_ba": rnd(cfg.hidden, 2 * hv),                                 # b, a gates
        "conv_w": rnd(cfg.qkv_dim, cfg.conv_width, scale=1.0),
        "conv_b": rnd.const(cfg.qkv_dim, 0.0),
        "A_log": rnd.uniform(hv, -2.0, 0.0),
        "dt_bias": rnd.const(hv, 0.0),
        "gn_w": rnd.const(hv * cfg.head_v_dim, 1.0),
        "w_out": rnd(hv * cfg.head_v_dim, cfg.hidden),
        "ln2": rnd.const(cfg.hidden, 1.0),
    }
    if mlp:
        w["w_gate_up"] = rnd(cfg.hidden, 2 * cfg.mlp_intermediate)
        w["w_down"] = rnd(cfg.mlp_intermediate, cfg.hidden)
    return w


def init_weights(cfg: Qwen3NextConfig, seed: int = 0, dtype=torch.float32,
                 device="cuda") -> dict:
    """A GDN layer's random weights from ``seed``, with the JAX package's
    shapes and scales."""
    dev = resolve_device(device)
    return _gdn_weights(cfg, _Draw(seed, dtype, dev))


def init_hybrid_weights(cfg: Qwen3NextHybridConfig, seed: int = 0, dtype=torch.float32,
                        device="cuda", *, untied_lm_head: bool = False) -> dict:
    """The hybrid's random weights from ``seed`` (a generator of its own on
    ``device``, so that published widths are drawn on the card) with the JAX
    package's shapes and scales: layer by layer, then the final norm and the
    embedding (N(0, 0.02²)); ``untied_lm_head`` adds ``w_lm [hidden, vocab]``
    (N(0, 0.02²), drawn last), as the published checkpoint carries it."""
    dev = resolve_device(device)
    rnd = _Draw(seed, dtype, dev)
    h, d = cfg.hidden, cfg.head_dim

    def moe_weights():
        e, i, si = cfg.moe_experts, cfg.moe_intermediate, cfg.shared_expert_intermediate
        return {"moe_router": rnd(h, e), "moe_gate": rnd(e, h, i), "moe_up": rnd(e, h, i),
                "moe_down": rnd(e, i, h), "ws_gate": rnd(h, si), "ws_up": rnd(h, si),
                "ws_down": rnd(si, h), "ws_gate_w": rnd(h, 1)}

    def mlp_weights():
        if cfg.moe_experts > 0:
            return moe_weights()
        return {"w_gate_up": rnd(h, 2 * cfg.mlp_intermediate),
                "w_down": rnd(cfg.mlp_intermediate, h)}

    layers = []
    for li in range(cfg.num_layers):
        if cfg.is_attn(li):
            lw = {"kind": "attn", "ln1": rnd.const(h, 1.0), "wq": rnd(h, cfg.num_heads * d),
                  "wk": rnd(h, cfg.num_kv_heads * d), "wv": rnd(h, cfg.num_kv_heads * d),
                  "wo": rnd(cfg.num_heads * d, h), "ln2": rnd.const(h, 1.0)}
            if cfg.attn_gate:
                lw["wg_attn"] = rnd(h, cfg.num_heads * d)
            if cfg.qk_norm:
                lw["q_norm"] = rnd.const(d, 1.0)
                lw["k_norm"] = rnd.const(d, 1.0)
        else:
            lw = {"kind": "gdn", **_gdn_weights(cfg.gdn, rnd, mlp=False)}
        lw.update(mlp_weights())
        layers.append(lw)
    params = {"layers": layers, "ln_f": rnd.const(h, 1.0),
              "wte": rnd(cfg.vocab_size, h, scale=0.02)}
    if untied_lm_head:
        params["w_lm"] = rnd(h, cfg.vocab_size, scale=0.02)
    return params


def from_jax_params(params_np: dict, device="cuda", dtype=None) -> dict:
    """The JAX package's hybrid weights (numpy leaves; each layer's
    ``kind`` tag a string) → the port's: the same dict, ``w_lm`` and
    ``rms_eps`` when present; ``dtype`` casts the floating weights."""
    dev = resolve_device(device)

    def conv(a):
        t = to_torch(a, dev)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    out = {}
    for k, v in params_np.items():
        if k == "layers":
            out[k] = [{n: (str(a) if n == "kind" else conv(a)) for n, a in lw.items()}
                      for lw in v]
        elif k == "rms_eps":
            out[k] = float(v)
        else:
            out[k] = conv(v)
    return out


def quantize_hybrid_weights(cfg: Qwen3NextHybridConfig, params: dict) -> dict:
    """Per-out-channel int8 quant of the wide projections (W8A8 serving,
    ``models/w8a8.py``): attention layers q / k / v / o, GDN layers the qkvz
    in-projection and the out-projection, and with a dense MLP the
    ``w_gate_up`` / ``w_down`` pair; with the MoE no MLP weight is quantized
    (JAX's rule)."""
    mlp = () if cfg.moe_experts > 0 else ("w_gate_up", "w_down")
    return {"layers": [
        {nm: w8a8.quantize_matrix(lw[nm])
         for nm in ((("wq", "wk", "wv", "wo") if cfg.is_attn(li) else ("w_qkvz", "w_out")) + mlp)}
        for li, lw in enumerate(params["layers"])]}


def quantize_hybrid_moe_weights(cfg: Qwen3NextHybridConfig, params: dict, tn=None) -> list:
    """Per-layer W8A8 experts for the expert-parallel MoE: JAX's
    ``quantize_expert_weights`` over each layer's ``moe_gate`` / ``moe_up``
    / ``moe_down`` → ``(w1 [E, H, 2I], w1_scale [E, 2I], w2 [E, I, H],
    w2_scale [E, H])``, gate / up packed at width ``tn`` (full width by
    default)."""
    return [quantize_expert_weights(lw["moe_gate"], lw["moe_up"], lw["moe_down"], tn=tn)
            for lw in params["layers"]]


def from_jax_moe_weights_q(moe_weights_q_np: list, device="cuda") -> list:
    """JAX's :func:`quantize_hybrid_moe_weights` output (numpy leaves) → the
    port's per-layer 4-tuples on ``device``; the layouts already agree."""
    dev = resolve_device(device)
    return [tuple(to_torch(a, dev) for a in t) for t in moe_weights_q_np]


def hybrid_embed(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["wte"][ids.long()]


def hybrid_lm_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The final RMSNorm, then the untied head ``w_lm`` or the embedding's
    transpose."""
    w = params["w_lm"] if "w_lm" in params else params["wte"].T
    return rms_norm_ref(x, params["ln_f"], params.get("rms_eps", 1e-6)) @ w


def init_hybrid_cache(cfg: Qwen3NextHybridConfig, num_pages: int, state_slots: int,
                      dtype=torch.float32, device="cuda") -> list[dict]:
    """Per layer: attention ``{"k", "v"}`` zero pages ``[P, Hkv, page, D]``
    in ``dtype``; GDN ``{"conv" [slots, qkv, W - 1] in dtype, "ssm" [slots,
    HV, K, V] f32}`` zero state pools."""
    dev = resolve_device(device)
    gd = cfg.gdn
    caches = []
    for li in range(cfg.num_layers):
        if cfg.is_attn(li):
            shape = (num_pages, cfg.num_kv_heads, cfg.page_size, cfg.head_dim)
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                           "v": torch.zeros(shape, dtype=dtype, device=dev)})
        else:
            caches.append({
                "conv": torch.zeros((state_slots, gd.qkv_dim, gd.conv_width - 1), dtype=dtype,
                                    device=dev),
                "ssm": torch.zeros((state_slots, gd.num_v_heads, gd.head_k_dim, gd.head_v_dim),
                                   dtype=torch.float32, device=dev)})
    return caches


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _project(cfg: Qwen3NextConfig, w: dict, x, lq=None, plain: bool = False):
    """The GDN layer's in-projections of ``rms_norm(x)`` (JAX's default eps
    here) → ``(qkv, z, b, a)``; W8A8 takes the wide qkvz GEMM, the small
    b / a GEMM stays float."""
    h1 = rms_norm_ref(x, w["ln1"])
    qkvz = h1 @ w["w_qkvz"] if lq is None else w8a8.project(h1, lq["w_qkvz"], h1.dtype,
                                                            plain=plain)
    ba = h1 @ w["w_ba"]
    b, a = ba.chunk(2, dim=-1)
    return qkvz[:, : cfg.qkv_dim], qkvz[:, cfg.qkv_dim:], b, a


def _split_heads(cfg: Qwen3NextConfig, qkv):
    hk = cfg.num_k_heads * cfg.head_k_dim
    n = qkv.shape[0]
    return (qkv[:, :hk].reshape(n, cfg.num_k_heads, cfg.head_k_dim),
            qkv[:, hk : 2 * hk].reshape(n, cfg.num_k_heads, cfg.head_k_dim),
            qkv[:, 2 * hk:].reshape(n, cfg.num_v_heads, cfg.head_v_dim))


def _swiglu(g, u):
    return g * torch.sigmoid(g) * u


def _router(cfg: Qwen3NextHybridConfig, lw: dict, x):
    """A softmax over all experts in f32, top-k (equal values: the lower
    expert first, as ``jax.lax.top_k``), renormalised under
    ``norm_topk_prob`` → ``(ids [N, k], weights [N, k] f32)``.  Routing is
    discrete: a caller replaces this function to record one run's choices
    and replay them in another."""
    probs = torch.softmax((x @ lw["moe_router"]).float(), dim=-1)
    topw, topi = top_k(probs, cfg.moe_topk)
    if cfg.norm_topk_prob:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    return topi, topw


def _hybrid_mlp(cfg: Qwen3NextHybridConfig, lw: dict, lq, x, plain: bool, ep=None):
    """The layer's MLP: the MoE plus the sigmoid-gated shared expert, or the
    dense SwiGLU (W8A8 with ``lq``).  The MoE's routed experts run expert
    parallel with ``ep = (buffer, the layer's W8A8 experts)``
    (``Buffer.fused_deep_moe`` on bf16 rows, cast back to x's type), else
    every expert for every token, batched over the stored weights into
    ``[E, N, .]``, the top-k combined by one-hot weights."""
    if cfg.moe_experts > 0:
        topi, topw = _router(cfg, lw, x)
        if ep is not None:
            buf, wq = ep
            out, _, _ = buf.fused_deep_moe(x.to(torch.bfloat16), topi.to(torch.int32),
                                           topw.float(), *wq, plain=plain)
            out = out.to(x.dtype)
        else:
            g = torch.matmul(x, lw["moe_gate"])                      # [E, N, I]
            u = torch.matmul(x, lw["moe_up"])
            y = torch.matmul(_swiglu(g, u), lw["moe_down"])          # [E, N, H]
            onehot = torch.nn.functional.one_hot(topi.long(), cfg.moe_experts).to(x.dtype)
            w = (topw[..., None].to(x.dtype) * onehot).sum(dim=1)    # [N, E]
            out = torch.einsum("ne,enh->nh", w, y)
        shared = _swiglu(x @ lw["ws_gate"], x @ lw["ws_up"]) @ lw["ws_down"]
        return out + torch.sigmoid(x @ lw["ws_gate_w"]) * shared
    if lq is not None:
        return w8a8.mlp_swiglu(x, lq["w_gate_up"], lq["w_down"], x.dtype, plain=plain)
    g, u = (x @ lw["w_gate_up"]).chunk(2, dim=-1)
    return _swiglu(g, u) @ lw["w_down"]


def _finish(cfg: Qwen3NextConfig, w: dict, core_out, z, x, lq=None, hybrid_cfg=None,
            plain: bool = False, ep=None):
    """The gated RMSNorm of the rule's output, the out-projection and the
    residual, then the MLP block (the hybrid's, or the GDN stack's dense
    SwiGLU)."""
    n = core_out.shape[0]
    o = layernorm_gated(core_out.reshape(n, -1), w["gn_w"], None, z, eps=cfg.rms_eps,
                        group_size=cfg.head_v_dim, norm_before_gate=True, is_rms_norm=True)
    x = x + (o @ w["w_out"] if lq is None else w8a8.project(o, lq["w_out"], x.dtype, plain=plain))
    if hybrid_cfg is not None:
        h2 = rms_norm_ref(x, w["ln2"], hybrid_cfg.rms_eps)
        return x + _hybrid_mlp(hybrid_cfg, w, lq, h2, plain, ep)
    h2 = rms_norm_ref(x, w["ln2"])
    if lq is not None:
        return x + w8a8.mlp_swiglu(h2, lq["w_gate_up"], lq["w_down"], x.dtype, plain=plain)
    g, u = (h2 @ w["w_gate_up"]).chunk(2, dim=-1)
    return x + _swiglu(g, u) @ w["w_down"]


def _attn_projections(cfg: Qwen3NextHybridConfig, lw: dict, lq, hidden_n, s: int,
                      plain: bool):
    """q / k / v (W8A8 off one per-token quant with ``lq``), the output
    gate's projection (float), and the per-head q / k RMSNorm."""
    d = cfg.head_dim
    if lq is not None:
        x_q, sx = (quant_per_token_ref if plain else quant_per_token)(hidden_n)
        qp, kp, vp = (w8a8.qmm(x_q, sx, lq[nm], hidden_n.dtype, plain=plain)
                      for nm in ("wq", "wk", "wv"))
    else:
        qp, kp, vp = (hidden_n @ lw[nm] for nm in ("wq", "wk", "wv"))
    gate = hidden_n @ lw["wg_attn"] if cfg.attn_gate else None
    q = qp.reshape(s, cfg.num_heads, d)
    k = kp.reshape(s, cfg.num_kv_heads, d)
    if cfg.qk_norm:
        q = rms_norm_ref(q, lw["q_norm"], cfg.rms_eps)
        k = rms_norm_ref(k, lw["k_norm"], cfg.rms_eps)
    return q, k, vp.reshape(s, cfg.num_kv_heads, d), gate


def _apply_rope_partial(cfg: Qwen3NextHybridConfig, x, cos, sin):
    """Rope on the first ``rotary_dim`` dims, the rest passed through
    (``rotary_dim`` 0: the whole head)."""
    rd = cfg.rotary_dim
    if rd in (0, cfg.head_dim):
        return apply_rope(x, cos, sin)
    return torch.cat([apply_rope(x[..., :rd], cos, sin), x[..., rd:]], dim=-1)


def _attn_layer(cfg: Qwen3NextHybridConfig, lw: dict, lq, x, cache: dict, slot_mapping, cos,
                sin, attend, plain: bool, ep=None):
    """An attention layer: projections, rope, the K / V rows written into
    the paged cache, ``attend(q [N, Hq, D], k_cache, v_cache)``, the output
    gate, the out-projection and the MLP block."""
    s = x.shape[0]
    hidden_n = rms_norm_ref(x, lw["ln1"], cfg.rms_eps)
    q, k, v, gate = _attn_projections(cfg, lw, lq, hidden_n, s, plain)
    q = _apply_rope_partial(cfg, q, cos, sin)
    k = _apply_rope_partial(cfg, k, cos, sin)
    write_kv(k, cache["k"], slot_mapping)
    write_kv(v, cache["v"], slot_mapping)
    attn = attend(q, cache["k"], cache["v"]).reshape(s, -1)
    if gate is not None:
        attn = attn * torch.sigmoid(gate)
    x = x + (attn @ lw["wo"] if lq is None
             else w8a8.project(attn, lq["wo"], x.dtype, plain=plain))
    return x + _hybrid_mlp(cfg, lw, lq, rms_norm_ref(x, lw["ln2"], cfg.rms_eps), plain, ep)


def check_ep(moe_weights_q, ep_buffer) -> None:
    """The expert-parallel MoE takes both ``moe_weights_q`` and
    ``ep_buffer``: one alone raises ``ValueError`` (JAX silently serves the
    dense MoE then, which would hide the EP path)."""
    if (moe_weights_q is None) != (ep_buffer is None):
        given, missing = (("moe_weights_q", "ep_buffer") if ep_buffer is None
                          else ("ep_buffer", "moe_weights_q"))
        raise ValueError(f"the expert-parallel MoE takes {given} with {missing}: pass both "
                         "or neither")


def _layer_ep(moe_weights_q, ep_buffer, li: int):
    """Layer ``li``'s ``(buffer, W8A8 experts)``, or None (the dense MoE)."""
    return None if ep_buffer is None else (ep_buffer, moe_weights_q[li])


# ---------------------------------------------------------------------------
# the GDN layer stack (one layer's weights)
# ---------------------------------------------------------------------------

def prefill(cfg: Qwen3NextConfig, w: dict, x):
    """``x [B, S, hidden]`` → ``(out [B, S, hidden], conv_state [B, qkv, W -
    1], ssm_state [B, HV, K, V])``: the chunked GDN path from zero states."""
    bsz, s, _ = x.shape
    flat = x.reshape(bsz * s, -1)
    qkv, z, b, a = _project(cfg, w, flat)
    conv_out, conv_state = causal_conv1d_fn(qkv.reshape(bsz, s, -1).transpose(1, 2),
                                            w["conv_w"], w["conv_b"], return_final_states=True,
                                            activation="silu")
    q, k, v = _split_heads(cfg, conv_out.transpose(1, 2).reshape(bsz * s, -1))
    g, beta = fused_gdn_gating(w["A_log"], a.reshape(bsz, s, -1), b.reshape(bsz, s, -1),
                               w["dt_bias"])
    o, ssm_state = chunk_gated_delta_rule(
        q.reshape(bsz, s, cfg.num_k_heads, -1), k.reshape(bsz, s, cfg.num_k_heads, -1),
        v.reshape(bsz, s, cfg.num_v_heads, -1), g, beta, chunk_size=cfg.chunk_size,
        use_qk_l2norm_in_kernel=True)
    out = _finish(cfg, w, o.reshape(bsz * s, cfg.num_v_heads, -1), z, flat)
    return out.reshape(bsz, s, -1), conv_state, ssm_state


def decode_step(cfg: Qwen3NextConfig, w: dict, x, conv_pool, ssm_pool, state_indices):
    """One token a row over the state pools (updated in place): ``x [B,
    hidden]`` → ``(out, conv_pool, ssm_pool)``."""
    qkv, z, b, a = _project(cfg, w, x)
    qkv_tok, conv_pool = causal_conv1d_update(qkv, conv_pool, w["conv_w"], w["conv_b"],
                                              activation="silu", conv_state_indices=state_indices)
    q, k, v = _split_heads(cfg, qkv_tok)
    o, ssm_pool = fused_sigmoid_gating_delta_rule_update(
        w["A_log"], a[:, None], w["dt_bias"], q[:, None], k[:, None], v[:, None], b[:, None],
        ssm_pool, state_indices, use_qk_l2norm_in_kernel=True)
    return _finish(cfg, w, o[:, 0], z, x), conv_pool, ssm_pool


# ---------------------------------------------------------------------------
# the hybrid's serving steps
# ---------------------------------------------------------------------------

def hybrid_prefill_step(cfg: Qwen3NextHybridConfig, params: dict, x, seq_lens, caches,
                        block_tables, context_lens, slot_mapping, state_idx, *,
                        max_q: int | None = None, weights_q=None, moe_weights_q=None,
                        ep_buffer=None, plain: bool = False):
    """One request's prefill chunk (the GDN recurrence is per request):
    ``x [S, hidden]`` whose first ``seq_lens[0]`` rows are the request's
    next tokens (pad rows after them), ``context_lens[0]`` counting them,
    ``state_idx [1]`` the request's state slot.  The GDN layers resume from
    the slot's conv and ssm states and write them back; pad rows touch
    neither.  Returns ``(hidden [S, hidden], caches)``, the caches updated
    in place."""
    check_ep(moe_weights_q, ep_buffer)
    gd = cfg.gdn
    s = x.shape[0]
    dev = x.device
    n = seq_lens.to(dev).long()[:1]                          # [1], on the device: no sync
    ar = torch.arange(s, device=dev)
    mask = ar < n
    positions = context_lens.to(dev).long()[:1] - n + ar
    cos, sin = rope_cos_sin(positions, cfg.rotary_dim or cfg.head_dim, base=cfg.rope_theta)
    slot = state_idx.to(dev).long()[:1]
    prefill_attn = attention_sinks_prefill_plain if plain else attention_sinks_prefill_pallas
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def attend(q, kc, vc):
        return prefill_attn(q.reshape(s, -1), kc, vc, None, seq_lens, block_tables,
                            context_lens, scale, 0, cfg.num_heads, cfg.num_kv_heads,
                            max_q=max_q or s)

    for li, lw in enumerate(params["layers"]):
        lq = None if weights_q is None else weights_q["layers"][li]
        ep = _layer_ep(moe_weights_q, ep_buffer, li)
        cache = caches[li]
        if cfg.is_attn(li):
            x = _attn_layer(cfg, lw, lq, x, cache, slot_mapping, cos, sin, attend, plain, ep)
            continue
        qkv, z, b, a = _project(gd, lw, x, lq, plain)
        qkv = torch.where(mask[:, None], qkv, 0.0)            # pads must not touch the state
        qkv_seq = qkv[None].transpose(1, 2)                     # [1, D, S]
        conv_init = cache["conv"].index_select(0, slot).float()
        conv_out, _ = causal_conv1d_fn(qkv_seq, lw["conv_w"], lw["conv_b"],
                                       initial_states=conv_init, return_final_states=True,
                                       activation="silu")
        # the final conv window: the last W - 1 real inputs (pads excluded)
        cat = torch.cat([conv_init, qkv_seq.float()], dim=-1)
        new_conv = cat.index_select(2, n + torch.arange(gd.conv_width - 1, device=dev))
        q, k, v = _split_heads(gd, conv_out.transpose(1, 2).reshape(s, -1))
        g, beta = fused_gdn_gating(lw["A_log"], a[None], b[None], lw["dt_bias"])   # [1, S, HV]
        g = torch.where(mask[None, :, None], g, 0.0)           # pad: decay 1
        beta = torch.where(mask[None, :, None], beta, 0.0)     # pad: no update
        o, final = chunk_gated_delta_rule(q[None], k[None], v[None], g, beta,
                                          chunk_size=gd.chunk_size,
                                          initial_state=cache["ssm"].index_select(0, slot),
                                          use_qk_l2norm_in_kernel=True)
        x = _finish(gd, lw, o[0], z, x, lq, hybrid_cfg=cfg, plain=plain, ep=ep)
        cache["conv"].index_copy_(0, slot, new_conv.to(cache["conv"].dtype))
        cache["ssm"].index_copy_(0, slot, final)
    return x, caches


def hybrid_decode_step(cfg: Qwen3NextHybridConfig, params: dict, x, positions, caches,
                       block_tables, context_lens, slot_mapping, state_idx, *, weights_q=None,
                       moe_weights_q=None, ep_buffer=None, plain: bool = False):
    """One decode step: ``x [B, hidden]`` at ``positions``; ``context_lens``
    include the new token; ``state_idx [B]`` each row's state slot, -1 on
    pad rows (which read zeros and write nothing), slot ``-1`` rows write no
    K / V.  Returns ``(hidden [B, hidden], caches)``, updated in place."""
    check_ep(moe_weights_q, ep_buffer)
    gd = cfg.gdn
    bsz = x.shape[0]
    cos, sin = rope_cos_sin(positions.to(x.device), cfg.rotary_dim or cfg.head_dim,
                            base=cfg.rope_theta)
    decode = decode_gqa_plain if plain else decode_gqa
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def attend(q, kc, vc):
        return decode(q, kc, vc, context_lens, scale, block_tables)

    for li, lw in enumerate(params["layers"]):
        lq = None if weights_q is None else weights_q["layers"][li]
        ep = _layer_ep(moe_weights_q, ep_buffer, li)
        cache = caches[li]
        if cfg.is_attn(li):
            x = _attn_layer(cfg, lw, lq, x, cache, slot_mapping, cos, sin, attend, plain, ep)
            continue
        qkv, z, b, a = _project(gd, lw, x, lq, plain)
        qkv_tok, _ = causal_conv1d_update(qkv, cache["conv"], lw["conv_w"], lw["conv_b"],
                                          activation="silu", conv_state_indices=state_idx)
        q, k, v = _split_heads(gd, qkv_tok)
        o, _ = fused_sigmoid_gating_delta_rule_update(
            lw["A_log"], a[:, None], lw["dt_bias"], q[:, None], k[:, None], v[:, None],
            b[:, None], cache["ssm"], state_idx, use_qk_l2norm_in_kernel=True)
        x = _finish(gd, lw, o[:, 0], z, x, lq, hybrid_cfg=cfg, plain=plain, ep=ep)
    return x, caches


def hybrid_state_snapshot(cfg: Qwen3NextHybridConfig, caches, state_idx: torch.Tensor) -> list:
    """Copies of the GDN layers' (conv, ssm) pool rows at ``state_idx
    [B]``: the recurrent state a caller rolls back (paged K / V need none)."""
    idx = state_idx.long()
    return [(c["conv"].index_select(0, idx.to(c["conv"].device)),
             c["ssm"].index_select(0, idx.to(c["ssm"].device)))
            for li, c in enumerate(caches) if not cfg.is_attn(li)]


def hybrid_state_restore(cfg: Qwen3NextHybridConfig, caches, snap: list,
                         state_idx: torch.Tensor):
    """Write a :func:`hybrid_state_snapshot` back into the pools, in place;
    returns ``caches``."""
    idx = state_idx.long()
    it = iter(snap)
    for li, c in enumerate(caches):
        if not cfg.is_attn(li):
            conv_r, ssm_r = next(it)
            c["conv"].index_copy_(0, idx.to(c["conv"].device), conv_r.to(c["conv"].dtype))
            c["ssm"].index_copy_(0, idx.to(c["ssm"].device), ssm_r.to(c["ssm"].dtype))
    return caches
