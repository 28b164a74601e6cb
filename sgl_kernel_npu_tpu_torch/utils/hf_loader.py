"""HuggingFace ``transformers`` models → the port's ``(config, params)``.

Counterpart of ``sgl_kernel_npu_tpu/utils/hf_loader.py``: the same four
converters, with the same weight mapping, into the port's model dicts
(tensors on ``device``, floating weights in ``dtype``).  A converter takes a
model object (a ``LlamaForCausalLM``-shaped module, say) and reads its
``state_dict()``; this module imports no ``transformers`` itself, so it
loads where that package is absent.  ``nn.Linear.weight`` ``[out, in]`` is
transposed into the port's ``x @ w``; HF's rope is the neox rotate-half,
which is ``ops.rope.apply_rope``.
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.utils.common import resolve_device


class _Reader:
    """A state dict's tensors on ``device`` in ``dtype``, as JAX's ``_t`` /
    ``_v`` read them (cast, then transposed)."""

    def __init__(self, model, dtype, device):
        self.sd = model.state_dict()
        self.dtype, self.dev = dtype, resolve_device(device)

    def v(self, key: str) -> torch.Tensor:
        """A tensor as stored."""
        return self.sd[key].detach().float().to(self.dev, self.dtype)

    def t(self, key: str) -> torch.Tensor:
        """A transposed ``nn.Linear`` weight."""
        return self.v(key).T.contiguous()


def _head_dim(hf) -> int:
    return getattr(hf, "head_dim", None) or hf.hidden_size // hf.num_attention_heads


def _untied_head(hf, rd: _Reader, params: dict) -> dict:
    if not getattr(hf, "tie_word_embeddings", True):
        params["w_lm"] = rd.t("lm_head.weight")
    return params


def llama_from_hf(model, page_size: int = 16, dtype=torch.float32, device="cuda"):
    """A Llama / Qwen2-style dense GQA model → ``(LlamaConfig, params)``,
    tied or untied head."""
    from sgl_kernel_npu_tpu_torch.models.llama import LlamaConfig

    hf = model.config
    cfg = LlamaConfig(vocab_size=hf.vocab_size, hidden=hf.hidden_size,
                      num_layers=hf.num_hidden_layers, num_heads=hf.num_attention_heads,
                      num_kv_heads=hf.num_key_value_heads, head_dim=_head_dim(hf),
                      intermediate=hf.intermediate_size, page_size=page_size,
                      rope_theta=float(hf.rope_theta), rms_eps=float(hf.rms_norm_eps))
    rd = _Reader(model, dtype, device)
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        layers.append({
            "ln1": rd.v(p + "input_layernorm.weight"),
            "wq": rd.t(p + "self_attn.q_proj.weight"),
            "wk": rd.t(p + "self_attn.k_proj.weight"),
            "wv": rd.t(p + "self_attn.v_proj.weight"),
            "wo": rd.t(p + "self_attn.o_proj.weight"),
            "ln2": rd.v(p + "post_attention_layernorm.weight"),
            "w_gate": rd.t(p + "mlp.gate_proj.weight"),
            "w_up": rd.t(p + "mlp.up_proj.weight"),
            "w_down": rd.t(p + "mlp.down_proj.weight"),
        })
    params = {"layers": layers, "ln_f": rd.v("model.norm.weight"),
              "wte": rd.v("model.embed_tokens.weight")}
    return cfg, _untied_head(hf, rd, params)


def gpt_oss_from_hf(model, page_size: int = 16, dtype=torch.float32, device="cuda"):
    """``GptOssForCausalLM`` → ``(GptOssConfig, params)``: sinks attention
    with q / k / v / o biases, sliding windows on the even layers (any other
    pattern raises ``NotImplementedError``), the biased interleaved gate ‖ up
    experts (stored ``[E, in, out]``: not transposed) and the YaRN rope
    (``inv_freq`` and ``attention_scaling`` read off the HF rotary module)."""
    from sgl_kernel_npu_tpu_torch.models.gpt_oss import GptOssConfig

    hf = model.config
    for i, lt in enumerate(hf.layer_types):
        want = "sliding_attention" if i % 2 == 0 else "full_attention"
        if lt != want:
            raise NotImplementedError(f"layer_types[{i}]={lt}; only the sliding-on-even "
                                      "alternation is mapped")
    cfg = GptOssConfig(vocab_size=hf.vocab_size, hidden=hf.hidden_size,
                       num_layers=hf.num_hidden_layers, num_heads=hf.num_attention_heads,
                       num_kv_heads=hf.num_key_value_heads, head_dim=_head_dim(hf),
                       intermediate=hf.intermediate_size, sliding_window=hf.sliding_window,
                       page_size=page_size, rope_theta=float(hf.rope_theta),
                       num_experts=hf.num_local_experts, topk=hf.num_experts_per_tok,
                       attention_bias=bool(hf.attention_bias), rms_eps=float(hf.rms_norm_eps))
    rd = _Reader(model, dtype, device)
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        lw = {
            "ln1": rd.v(p + "input_layernorm.weight"),
            "wq": rd.t(p + "self_attn.q_proj.weight"),
            "wk": rd.t(p + "self_attn.k_proj.weight"),
            "wv": rd.t(p + "self_attn.v_proj.weight"),
            "wo": rd.t(p + "self_attn.o_proj.weight"),
            "sinks": rd.v(p + "self_attn.sinks"),
            "ln2": rd.v(p + "post_attention_layernorm.weight"),
            "router_w": rd.t(p + "mlp.router.weight"),
            "router_b": rd.v(p + "mlp.router.bias"),
            "w_gate_up": rd.v(p + "mlp.experts.gate_up_proj"),
            "b_gate_up": rd.v(p + "mlp.experts.gate_up_proj_bias"),
            "w_down": rd.v(p + "mlp.experts.down_proj"),
            "b_down": rd.v(p + "mlp.experts.down_proj_bias"),
        }
        if cfg.attention_bias:
            lw.update({n: rd.v(p + f"self_attn.{proj}.bias")
                       for n, proj in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj"),
                                       ("bo", "o_proj"))})
        layers.append(lw)
    rotary = model.model.rotary_emb
    params = {"layers": layers, "ln_f": rd.v("model.norm.weight"),
              "wte": rd.v("model.embed_tokens.weight"),
              "rope_inv_freq": rotary.inv_freq.detach().float().to(rd.dev),
              # an f32 scalar, as JAX's jnp.float32
              "rope_attention_scaling": float(torch.tensor(rotary.attention_scaling,
                                                           dtype=torch.float32)),
              "rms_eps": float(hf.rms_norm_eps)}
    return cfg, _untied_head(hf, rd, params)


def qwen3_next_from_hf(model, page_size: int = 16, dtype=torch.float32, device="cuda"):
    """``Qwen3NextForCausalLM`` → ``(Qwen3NextHybridConfig, params)``: the
    GDN layers (HF's per-k-head-group interleaved ``in_proj_qkvz`` /
    ``in_proj_ba`` columns permuted into the flat q | k | v | z and b | a
    layout), the gated attention layers (q_proj's query | gate halves split,
    per-head q / k norms, partial rotary) and the MoE with its sigmoid-gated
    shared expert on every layer; the norms' weights ``1 + w`` (Gemma
    style), as JAX's."""
    from sgl_kernel_npu_tpu_torch.models.qwen3_next import Qwen3NextHybridConfig

    hf = model.config
    if getattr(hf, "attention_bias", False):
        raise NotImplementedError("attention_bias=True is not mapped")
    if "full_attention" not in hf.layer_types:
        raise NotImplementedError("no full_attention layer")
    attn_every = hf.layer_types.index("full_attention") + 1
    for i, lt in enumerate(hf.layer_types):
        want = "full_attention" if (i + 1) % attn_every == 0 else "linear_attention"
        if lt != want:
            raise NotImplementedError(f"layer_types[{i}]={lt}: only the uniform linear / full "
                                      "interleave is mapped")
    head_dim = _head_dim(hf)
    hk, hv = hf.linear_num_key_heads, hf.linear_num_value_heads
    dk, dv = hf.linear_key_head_dim, hf.linear_value_head_dim
    r = hv // hk
    cfg = Qwen3NextHybridConfig(
        vocab_size=hf.vocab_size, hidden=hf.hidden_size, num_layers=hf.num_hidden_layers,
        attn_every=attn_every, num_k_heads=hk, num_v_heads=hv, head_k_dim=dk, head_v_dim=dv,
        conv_width=hf.linear_conv_kernel_dim, num_heads=hf.num_attention_heads,
        num_kv_heads=hf.num_key_value_heads, head_dim=head_dim, page_size=page_size,
        rope_theta=float(hf.rope_theta), mlp_intermediate=hf.intermediate_size,
        rotary_dim=int(head_dim * hf.partial_rotary_factor), attn_gate=True, qk_norm=True,
        rms_eps=float(hf.rms_norm_eps), moe_experts=hf.num_experts,
        moe_topk=hf.num_experts_per_tok, moe_intermediate=hf.moe_intermediate_size,
        shared_expert_intermediate=hf.shared_expert_intermediate_size,
        norm_topk_prob=bool(hf.norm_topk_prob))
    rd = _Reader(model, dtype, device)

    def cols(start, width, stride, groups):
        return (torch.arange(groups)[:, None] * stride + start
                + torch.arange(width)[None]).reshape(-1)

    stride = 2 * dk + 2 * r * dv
    qkvz_perm = torch.cat([cols(0, dk, stride, hk), cols(dk, dk, stride, hk),
                           cols(2 * dk, r * dv, stride, hk),
                           cols(2 * dk + r * dv, r * dv, stride, hk)]).to(rd.dev)
    ba_perm = torch.cat([cols(0, r, 2 * r, hk), cols(r, r, 2 * r, hk)]).to(rd.dev)

    def moe_weights(p):
        def experts(proj):
            return torch.stack([rd.t(p + f"mlp.experts.{x}.{proj}.weight")
                                for x in range(cfg.moe_experts)])

        return {"moe_router": rd.t(p + "mlp.gate.weight"), "moe_gate": experts("gate_proj"),
                "moe_up": experts("up_proj"), "moe_down": experts("down_proj"),
                "ws_gate": rd.t(p + "mlp.shared_expert.gate_proj.weight"),
                "ws_up": rd.t(p + "mlp.shared_expert.up_proj.weight"),
                "ws_down": rd.t(p + "mlp.shared_expert.down_proj.weight"),
                "ws_gate_w": rd.t(p + "mlp.shared_expert_gate.weight")}

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        if cfg.is_attn(i):
            wq2 = rd.t(p + "self_attn.q_proj.weight").reshape(cfg.hidden, cfg.num_heads,
                                                              2 * head_dim)
            lw = {"kind": "attn",
                  "ln1": 1.0 + rd.v(p + "input_layernorm.weight"),
                  "wq": wq2[:, :, :head_dim].reshape(cfg.hidden, -1),
                  "wg_attn": wq2[:, :, head_dim:].reshape(cfg.hidden, -1),
                  "wk": rd.t(p + "self_attn.k_proj.weight"),
                  "wv": rd.t(p + "self_attn.v_proj.weight"),
                  "wo": rd.t(p + "self_attn.o_proj.weight"),
                  "q_norm": 1.0 + rd.v(p + "self_attn.q_norm.weight"),
                  "k_norm": 1.0 + rd.v(p + "self_attn.k_norm.weight"),
                  "ln2": 1.0 + rd.v(p + "post_attention_layernorm.weight")}
        else:
            lw = {"kind": "gdn",
                  "ln1": 1.0 + rd.v(p + "input_layernorm.weight"),
                  "w_qkvz": rd.t(p + "linear_attn.in_proj_qkvz.weight")[:, qkvz_perm],
                  "w_ba": rd.t(p + "linear_attn.in_proj_ba.weight")[:, ba_perm],
                  "conv_w": rd.v(p + "linear_attn.conv1d.weight")[:, 0, :],
                  "conv_b": torch.zeros((cfg.gdn.qkv_dim,), dtype=dtype, device=rd.dev),
                  "A_log": rd.v(p + "linear_attn.A_log"),
                  "dt_bias": rd.v(p + "linear_attn.dt_bias"),
                  "gn_w": rd.v(p + "linear_attn.norm.weight").repeat(hv),
                  "w_out": rd.t(p + "linear_attn.out_proj.weight"),
                  "ln2": 1.0 + rd.v(p + "post_attention_layernorm.weight")}
        lw.update(moe_weights(p))
        layers.append(lw)
    params = {"layers": layers, "ln_f": 1.0 + rd.v("model.norm.weight"),
              "wte": rd.v("model.embed_tokens.weight"), "rms_eps": float(hf.rms_norm_eps)}
    return cfg, _untied_head(hf, rd, params)


def deepseek_v3_from_hf(model, page_size: int = 16, dtype=torch.float32, device="cuda"):
    """``DeepseekV3ForCausalLM`` → ``(DeepSeekV3Config, params)`` in the
    absorbed MLA form: ``kv_b_proj [H (nope + v), lat]`` splits per head
    into ``wuk [H, nope, lat]`` and ``wvu [H, lat, v]``; HF's interleaved
    rope dims (``rope_interleave``) are permuted into even | odd halves in
    the columns that make q_pe / k_pe.  No q LoRA, leading dense layers or
    more than one shared expert raise ``NotImplementedError``; the DSA
    indexer projections (absent in HF's graph) are zeros."""
    from sgl_kernel_npu_tpu_torch.models.deepseek_v3 import DeepSeekV3Config

    hf = model.config
    if getattr(hf, "q_lora_rank", None) in (None, 0):
        raise NotImplementedError("q_lora_rank=None (no q LoRA) is not mapped")
    if getattr(hf, "first_k_dense_replace", 0) != 0:
        raise NotImplementedError("leading dense layers are not mapped")
    if getattr(hf, "n_shared_experts", 1) != 1:
        raise NotImplementedError("exactly one shared expert is mapped")
    lat, nope, rope = hf.kv_lora_rank, hf.qk_nope_head_dim, hf.qk_rope_head_dim
    cfg = DeepSeekV3Config(
        vocab_size=hf.vocab_size, hidden=hf.hidden_size, num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads, kv_lora_rank=lat, qk_rope_dim=rope,
        qk_nope_dim=nope, q_lora_rank=hf.q_lora_rank, v_head_dim=hf.v_head_dim,
        num_experts=hf.n_routed_experts, num_shared_experts=1, topk=hf.num_experts_per_tok,
        moe_intermediate=hf.moe_intermediate_size, page_size=page_size,
        router_scoring="sigmoid_v3", n_group=hf.n_group, topk_group=hf.topk_group,
        routed_scaling_factor=float(hf.routed_scaling_factor),
        norm_topk_prob=bool(hf.norm_topk_prob))
    rd = _Reader(model, dtype, device)
    h = cfg.num_heads
    perm = (torch.cat([torch.arange(0, rope, 2), torch.arange(1, rope, 2)])
            if getattr(hf, "rope_interleave", True) else torch.arange(rope)).to(rd.dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=rd.dev)

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        kv_a = rd.t(p + "self_attn.kv_a_proj_with_mqa.weight")    # [hidden, lat + rope]
        kv_a[:, lat:] = kv_a[:, lat + perm]
        kv_b = rd.v(p + "self_attn.kv_b_proj.weight").reshape(h, nope + cfg.v_head_dim, lat)
        wuq = rd.t(p + "self_attn.q_b_proj.weight").reshape(-1, h, nope + rope)
        wuq[:, :, nope:] = wuq[:, :, nope + perm]

        def experts(proj):
            return torch.stack([rd.t(p + f"mlp.experts.{e}.{proj}.weight")
                                for e in range(cfg.num_experts)])

        layers.append({
            "ln1": rd.v(p + "input_layernorm.weight"),
            "wdqkv": torch.cat([kv_a, rd.t(p + "self_attn.q_a_proj.weight")], dim=1),
            "q_ln": rd.v(p + "self_attn.q_a_layernorm.weight"),
            "wuq": wuq.reshape(wuq.shape[0], h * (nope + rope)),
            "wuk": kv_b[:, :nope, :].contiguous(),
            "kv_ln": rd.v(p + "self_attn.kv_a_layernorm.weight"),
            "wvu": kv_b[:, nope:, :].transpose(1, 2).contiguous(),
            "wo": rd.t(p + "self_attn.o_proj.weight"),
            "ln2": rd.v(p + "post_attention_layernorm.weight"),
            "router": rd.t(p + "mlp.gate.weight"),
            "router_bias": rd.v(p + "mlp.gate.e_score_correction_bias"),
            "w_gate": experts("gate_proj"),
            "w_up": experts("up_proj"),
            "w_down": experts("down_proj"),
            "ws_gate": rd.t(p + "mlp.shared_experts.gate_proj.weight"),
            "ws_up": rd.t(p + "mlp.shared_experts.up_proj.weight"),
            "ws_down": rd.t(p + "mlp.shared_experts.down_proj.weight"),
            "w_qidx": zeros(cfg.hidden, cfg.idx_heads * cfg.idx_dim),
            "w_kidx": zeros(cfg.hidden, cfg.idx_dim),
            "w_widx": zeros(cfg.hidden, cfg.idx_heads),
        })
    return cfg, {"embed": rd.v("model.embed_tokens.weight"), "layers": layers,
                 "final_ln": rd.v("model.norm.weight"), "w_lm": rd.t("lm_head.weight")}
