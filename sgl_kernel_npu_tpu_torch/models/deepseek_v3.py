"""DeepSeek-V3 MLA + MoE model: paged prefill and decode, and training.

Counterpart of ``sgl_kernel_npu_tpu/models/deepseek_v3.py`` on the
configurations ``decode_step / prefill_step(moe_weights_q=..., mla_wq=...,
dense_wq=...)``: MLA attention over the paged latent cache, bf16 or int8
(``kv_cache_dtype``; ``decode_mla`` K2, ``mla_prefill_pallas`` K9), and the
routed experts either float (``moe_weights_q`` None: the dense MoE, every
expert for every token, as JAX on one chip) or W8A8 through the ring GEMMs
(``gmm1_ring`` K3, ``gmm2_combine_ring`` K4) up to 512 tokens (at other
widths K8a with ``dispatch_p`` and ``grouped_matmul_combine`` K8b) and through
``grouped_matmul`` (K8a, twice) with a gather combine above, behind either
the float MLA prologue or the fused W8A8 one (``mla_wq``: ``mla_preprocess`` on
``quant_matmul`` K1), and with the output projection and the shared expert
either float or W8A8 (``dense_wq``: ``quant_per_token`` K5, ``quant_matmul``
K1, ``swiglu_quant`` K7a).  DeepSeek-V3.2's sparse attention (DSA,
``sparse_count > 0``) adds the lightning indexer: in page mode prefill scores
its q-chunks on ``lightning_indexer_scores_prefill_pallas`` (K10) and attends
their selected pages on ``mla_prefill_block_sparse`` (K9b), decode attends
each row's selected pages on K2; in token mode decode selects tokens through
``lightning_indexer`` (K10) and prefill stays dense (K9a), as in JAX.

Training: ``train_forward`` (the causal LM loss) and ``make_train_step``
(SGD), with causal MLA attention over the whole sequence, either dense (an
einsum) or ``flash=True`` through ``ops.attention.mla_train.mla_flash_train``
(K14a forward, K14b / K14c backward), and the routed experts either dense
(``mesh=None``: every expert for every token, JAX's single-device form) or
expert parallel (``mesh``, a ``DeviceMesh`` with dims ``("dp", "ep")``:
:func:`_ep_moe_train`, ragged dispatch and combine over the mesh's EP group
around three ``gmm_train`` products, K8a's ``none`` mode forward and
``rhs_contract_last`` for dx).  Expert-parallel serving: ``ep_buffer`` (a
``parallel.buffer.Buffer``) with ``moe_weights_q`` runs the W8A8 MoE
through ``Buffer.fused_deep_moe`` (its exchanges on the buffer's transport,
K8a twice), after ``eplb_tables`` (``parallel.eplb.make_remap_tables``)
remap the routing to physical expert slots, in JAX's branch order.
Head-parallel decode: :func:`decode_step_tp` over a process group (each
rank's heads from :func:`tp_shard_layer`, K2 on them).  The
switch this port does not take raises ``NotImplementedError``: the
gradients over a mesh of more than one rank (ROADMAP item 16).  The W8A8
MoE of at most 512 tokens at widths the ring GEMMs do not take runs K8a with
``dispatch_p`` and ``grouped_matmul_combine`` (K8b), as JAX's.

Weights are a plain dict of tensors (``layers`` a list of per-layer dicts),
with the JAX package's names and layouts; caches are a list of per-layer
dicts ``{"nope", "rope"}`` (and ``"kidx"``, the index keys, under DSA)
updated in place.  ``plain=True`` on the steps runs the kernels' plain
PyTorch versions on the same tensors (for comparing the kernels with them on
the card).

Dtypes follow JAX's promotion: with ``dense_wq`` the W8A8 projections return
f32, so the residual stream turns f32 after the first layer's attention.
"""

from __future__ import annotations

import dataclasses

import torch

from sgl_kernel_npu_tpu_torch.models import w8a8
from sgl_kernel_npu_tpu_torch.ops.attention import mla_preprocess as mp
from sgl_kernel_npu_tpu_torch.ops.attention.decode_attention import (
    decode_mla,
    decode_mla_ref,
    decode_mla_sparse,
    pruned_block_table,
    select_decode_pages,
)
from sgl_kernel_npu_tpu_torch.ops.attention.lightning_indexer import (
    lightning_indexer,
    lightning_indexer_scores_decode,
    lightning_indexer_scores_prefill_pallas,
    lightning_indexer_scores_prefill_ref,
)
from sgl_kernel_npu_tpu_torch.ops.attention.mla_prefill import (
    mla_prefill_block_sparse,
    mla_prefill_block_sparse_ref,
    mla_prefill_pallas,
    mla_prefill_ref,
    select_prefill_pages,
)
from sgl_kernel_npu_tpu_torch.ops.attention.mla_train import mla_flash_train
from sgl_kernel_npu_tpu_torch.ops.attention.sinks_attention import packed_rows, prefill_q_chunk
from sgl_kernel_npu_tpu_torch.ops.gmm_ring import (
    gmm1_ring,
    gmm1_ring_ref,
    gmm2_combine_ring,
    gmm2_combine_ring_ref,
)
from sgl_kernel_npu_tpu_torch.ops.grouped_matmul import (
    combine_masks,
    dispatch_onehot,
    gmm_train,
    grouped_matmul,
    grouped_matmul_combine,
    grouped_matmul_combine_plain,
    grouped_matmul_plain,
)
from sgl_kernel_npu_tpu_torch.ops.mem_cache.kv_cache import (
    reshape_and_cache,
    reshape_and_cache_transposed,
)
from sgl_kernel_npu_tpu_torch.ops.norm import rms_norm_ref
from sgl_kernel_npu_tpu_torch.ops.quant import row_scale, saturate_int8
from sgl_kernel_npu_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from sgl_kernel_npu_tpu_torch.parallel import ep_core
from sgl_kernel_npu_tpu_torch.parallel.eplb import remap_topk
from sgl_kernel_npu_tpu_torch.parallel.fused_moe import quantize_expert_weights
from sgl_kernel_npu_tpu_torch.utils.common import cdiv, resolve_device, to_torch


@dataclasses.dataclass(frozen=True)
class DeepSeekV3Config:
    """The JAX package's config fields that this path reads, with the same
    defaults (the unused rope base is left out)."""

    vocab_size: int = 512
    hidden: int = 256
    num_layers: int = 2
    num_heads: int = 8
    kv_lora_rank: int = 128      # latent dim (512 at full scale)
    qk_rope_dim: int = 64
    qk_nope_dim: int = 64        # 128 at full scale
    q_lora_rank: int = 192       # 1536 at full scale
    v_head_dim: int = 64         # 128 at full scale
    num_experts: int = 16
    num_shared_experts: int = 1
    topk: int = 4
    moe_intermediate: int = 128  # per expert (2048 at full scale)
    page_size: int = 16
    # DeepSeek-V3.2 sparse attention (DSA): 0 = dense; > 0 = the lightning
    # indexer (idx_heads x idx_dim queries, one idx_dim key a token) picks that
    # many keys of each decode row ("token"), or ceil(sparse_count /
    # page_size) pages of each decode row and prefill q-chunk ("page")
    sparse_count: int = 0
    idx_heads: int = 4           # 64 at full scale
    idx_dim: int = 64            # 128 at full scale
    sparse_granularity: str = "page"
    router_scoring: str = "softmax"   # or "sigmoid_v3" (needs router_bias)
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    # "int8" stores the latent (nope) cache as round(k / ctkv_scale) int8
    # levels (the int8_nzcache mode); the rope cache stays in the cache dtype
    kv_cache_dtype: str = "bf16"
    ctkv_scale: float = 1.0 / 32      # static calibration: rms-normed latent, |k| <~ 4

    @property
    def qk_dim(self):
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def sm_scale(self):
        return 1.0 / (self.qk_dim ** 0.5)


# ---------------------------------------------------------------------------
# weights and caches
# ---------------------------------------------------------------------------

def _randn(gen, shape, scale, dtype, device):
    # scaled in place: one f32 temporary (15 GiB for a layer's experts), not two
    return torch.randn(shape, generator=gen, device=device).mul_(scale).to(dtype)


def init_weights(cfg: DeepSeekV3Config, seed: int = 0, dtype=torch.float32,
                 device="cuda", *, with_experts: bool = True) -> dict:
    """Random weights from ``seed`` (scales as the JAX package's).

    ``with_experts=False`` leaves out the float routed experts, which at full
    width do not fit beside the rest: build their W8A8 form directly with
    :func:`init_quantized_experts`.  ``router_bias`` (the sigmoid_v3 choice
    bias, which a checkpoint carries) is added for ``sigmoid_v3``.  Under DSA
    (``sparse_count > 0``) each layer also gets the indexer projections
    ``w_qidx``, ``w_kidx`` and ``w_widx``, drawn last from a generator of
    their own, so every other weight keeps the value it has without DSA."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, lat, rope = cfg.hidden, cfg.kv_lora_rank, cfg.qk_rope_dim

    def rnd(*shape, scale=None):
        return _randn(gen, shape, scale if scale is not None else shape[0] ** -0.5, dtype, dev)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    def layer():
        lw = {
            "ln1": ones(h),
            "wdqkv": rnd(h, lat + rope + cfg.q_lora_rank),
            "q_ln": ones(cfg.q_lora_rank),
            "wuq": rnd(cfg.q_lora_rank, cfg.num_heads * cfg.qk_dim),
            "wuk": rnd(cfg.num_heads, cfg.qk_nope_dim, lat, scale=cfg.qk_nope_dim ** -0.5),
            "kv_ln": ones(lat),
            "wvu": rnd(cfg.num_heads, lat, cfg.v_head_dim, scale=lat ** -0.5),
            "wo": rnd(cfg.num_heads * cfg.v_head_dim, h),
            "ln2": ones(h),
            "router": rnd(h, cfg.num_experts),
            "ws_gate": rnd(h, cfg.num_shared_experts * cfg.moe_intermediate),
            "ws_up": rnd(h, cfg.num_shared_experts * cfg.moe_intermediate),
            "ws_down": rnd(cfg.num_shared_experts * cfg.moe_intermediate, h),
        }
        if with_experts:
            e, i = cfg.num_experts, cfg.moe_intermediate
            lw["w_gate"] = rnd(e, h, i, scale=h ** -0.5)
            lw["w_up"] = rnd(e, h, i, scale=h ** -0.5)
            lw["w_down"] = rnd(e, i, h, scale=i ** -0.5)
        if cfg.router_scoring == "sigmoid_v3":
            lw["router_bias"] = rnd(cfg.num_experts, scale=0.01).float()
        return lw

    params = {
        "embed": rnd(cfg.vocab_size, h, scale=0.02),
        "layers": [layer() for _ in range(cfg.num_layers)],
        "final_ln": ones(h),
    }
    if cfg.sparse_count > 0:
        gen = torch.Generator(device=dev).manual_seed(seed + _INDEXER_SEED)
        for lw in params["layers"]:
            lw["w_qidx"] = rnd(h, cfg.idx_heads * cfg.idx_dim)
            lw["w_kidx"] = rnd(h, cfg.idx_dim)
            lw["w_widx"] = rnd(h, cfg.idx_heads, scale=0.2)
    return params


_INDEXER_SEED = 1 << 20   # the indexer projections' stream: seed + this


_EXPERT_CHUNK = 16   # experts made in f32 at once: 2.8 GB at DeepSeek-V3 width


def init_quantized_experts(cfg: DeepSeekV3Config, seed: int = 1, device="cuda",
                           tn: int | None = None) -> list[tuple]:
    """W8A8 routed experts of every layer, made from ``seed`` a chunk of
    experts at a time: the float experts (2 bytes x 3 x H x I each in bf16) are
    never all resident, only one chunk of them in f32.  Gate / up are packed
    at width ``tn`` (:func:`quantize_expert_weights`)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    e, h, i = cfg.num_experts, cfg.hidden, cfg.moe_intermediate
    out = []
    for _ in range(cfg.num_layers):
        w1 = torch.empty((e, h, 2 * i), dtype=torch.int8, device=dev)
        s1 = torch.empty((e, 2 * i), dtype=torch.float32, device=dev)
        w2 = torch.empty((e, i, h), dtype=torch.int8, device=dev)
        s2 = torch.empty((e, h), dtype=torch.float32, device=dev)
        for e0 in range(0, e, _EXPERT_CHUNK):
            c = min(_EXPERT_CHUNK, e - e0)
            wg = _randn(gen, (c, h, i), h ** -0.5, torch.float32, dev)
            wu = _randn(gen, (c, h, i), h ** -0.5, torch.float32, dev)
            wd = _randn(gen, (c, i, h), i ** -0.5, torch.float32, dev)
            q = quantize_expert_weights(wg, wu, wd, tn=tn)
            w1[e0 : e0 + c], s1[e0 : e0 + c], w2[e0 : e0 + c], s2[e0 : e0 + c] = q
            del wg, wu, wd, q
        out.append((w1, s1, w2, s2))
    return out


def from_jax_params(params_np: dict, moe_weights_q_np: list | None = None,
                    device="cuda", *, mla_wq_np: list | None = None,
                    dense_wq_np: list | None = None) -> tuple:
    """The JAX package's weight pytrees (leaves as numpy arrays) → the port's:
    the weights (``router_bias`` included when present) and, each optional,
    the per-layer quantized expert tuples ``(w1, s1, w2, s2)``, the fused
    prologue's ``MlaPreprocessWeights`` and the W8A8 dense weights (dicts of
    ``(w_q, scale)``).  Returns ``(params, moe_weights_q, mla_wq, dense_wq)``,
    None for each one not given."""
    dev = resolve_device(device)

    def conv(a):
        return None if a is None else to_torch(a, dev)

    params = {k: conv(v) for k, v in params_np.items() if k != "layers"}
    params["layers"] = [{k: conv(v) for k, v in lw.items()} for lw in params_np["layers"]]
    moe = mla = dense = None
    if moe_weights_q_np is not None:
        moe = [tuple(conv(a) for a in t) for t in moe_weights_q_np]
    if mla_wq_np is not None:
        mla = [mp.MlaPreprocessWeights(*(conv(a) for a in w)) for w in mla_wq_np]
    if dense_wq_np is not None:
        dense = [{k: tuple(conv(a) for a in v) for k, v in d.items()} for d in dense_wq_np]
    return params, moe, mla, dense


def quantize_moe_weights(cfg: DeepSeekV3Config, params: dict, tn: int | None = None):
    """Per-layer W8A8 expert weights for the fused MoE path, gate / up packed
    at width ``tn`` (``moe_pack_tn``'s by default: full width)."""
    return [quantize_expert_weights(lw["w_gate"], lw["w_up"], lw["w_down"], tn=tn)
            for lw in params["layers"]]


def make_mla_preprocess_weights(cfg: DeepSeekV3Config, params: dict,
                                sample_hidden: torch.Tensor) -> list:
    """The float MLA prologue weights of every layer → W8A8
    :class:`~sgl_kernel_npu_tpu_torch.ops.attention.mla_preprocess.MlaPreprocessWeights`
    for ``decode_step / prefill_step(mla_wq=...)``.

    ``sample_hidden [N, hidden]`` calibrates the two static activation-quant
    scales (max over the sample × 1.25 headroom, over 127) and, on an int8
    cache, the per-head q_nope scales (``126 / (max |q_lat| × 1.25)``).  The
    quantized activations are post-RMSNorm, whose magnitude does not grow
    with depth, so one sample serves every layer (each layer's scales still
    use that layer's own weights).  Weights are quantized per output channel.
    Unlike the JAX package, ``wdqkv`` keeps its own row count (no lane pad:
    the CUDA GEMM masks the ragged edge, and a pad would stream 3% more
    bytes)."""
    lat, rope = cfg.kv_lora_rank, cfg.qk_rope_dim
    margin = 1.25
    out = []
    for lw in params["layers"]:
        h1 = rms_norm_ref(sample_hidden.float(), lw["ln1"])
        qs1 = h1.abs().max() / 127.0 * margin
        wd_q, sw1 = w8a8.quantize_matrix(lw["wdqkv"])
        fused = h1 @ lw["wdqkv"].float()
        cq = rms_norm_ref(fused[:, lat + rope :], lw["q_ln"])
        qs2 = cq.abs().max() / 127.0 * margin
        wuq_q, sw2 = w8a8.quantize_matrix(lw["wuq"])
        zero = torch.zeros((), dtype=torch.float32, device=h1.device)
        qnope_scale = ctkv_scale = None
        if cfg.kv_cache_dtype == "int8":
            q_nope = (cq @ lw["wuq"].float()).reshape(
                cq.shape[0], cfg.num_heads, cfg.qk_dim)[..., : cfg.qk_nope_dim]
            q_lat = torch.einsum("nhk,hkl->nhl", q_nope, lw["wuk"].float())
            denom = q_lat.abs().amax(dim=(0, 2)) * margin + 1e-12
            qnope_scale = torch.full_like(denom, 126.0) / denom
            ctkv_scale = torch.tensor(cfg.ctkv_scale, dtype=torch.float32, device=h1.device)
            del q_nope, q_lat
        out.append(mp.MlaPreprocessWeights(
            gamma1=lw["ln1"], beta1=torch.zeros_like(lw["ln1"]),
            qscale1=qs1.float(), qoffset1=zero,
            wdqkv=wd_q, descale1=(sw1 * qs1).float(),
            bias1=torch.zeros((wd_q.shape[0],), dtype=torch.int32, device=h1.device),
            gamma2=lw["q_ln"], beta2=torch.zeros_like(lw["q_ln"]),
            qscale2=qs2.float(), qoffset2=zero,
            wuq=wuq_q, descale2=(sw2 * qs2).float(),
            bias2=torch.zeros((wuq_q.shape[0],), dtype=torch.int32, device=h1.device),
            gamma3=lw["kv_ln"], wuk=lw["wuk"],
            qnope_scale=qnope_scale, ctkv_scale=ctkv_scale,
        ))
    return out


def quantize_dense_weights(cfg: DeepSeekV3Config, params: dict) -> list:
    """W8A8 ``(w_q [N, K], scale [N])`` of each layer's output projection and
    shared expert (gate ‖ up stacked for the fused SwiGLU requant), for
    ``decode_step / prefill_step(dense_wq=...)``.  Router, ``wvu`` and the
    norms stay float."""
    return [{
        "wo": w8a8.quantize_matrix(lw["wo"]),
        "ws_gate_up": w8a8.quantize_matrix(torch.cat([lw["ws_gate"], lw["ws_up"]], dim=1)),
        "ws_down": w8a8.quantize_matrix(lw["ws_down"]),
    } for lw in params["layers"]]


def init_kv_cache(cfg: DeepSeekV3Config, num_pages: int, dtype=torch.bfloat16,
                  device="cuda") -> list[dict]:
    """Per-layer ``{"nope", "rope"}`` paged caches of zeros; the latent cache
    is int8 when ``cfg.kv_cache_dtype == "int8"``, else ``dtype``.  Under DSA
    the index-key cache ``"kidx" [pages, 1, page, idx_dim]`` too, always in
    ``dtype`` (never int8), written at the latent's slots."""
    dev = resolve_device(device)
    nope_dt = torch.int8 if cfg.kv_cache_dtype == "int8" else dtype

    def layer_cache():
        c = {
            "nope": torch.zeros((num_pages, 1, cfg.page_size, cfg.kv_lora_rank),
                                dtype=nope_dt, device=dev),
            "rope": torch.zeros((num_pages, 1, cfg.qk_rope_dim, cfg.page_size), dtype=dtype,
                                device=dev),
        }
        if cfg.sparse_count > 0:
            c["kidx"] = torch.zeros((num_pages, 1, cfg.page_size, cfg.idx_dim), dtype=dtype,
                                    device=dev)
        return c

    return [layer_cache() for _ in range(cfg.num_layers)]


def embed(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][ids.long()]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype, as JAX's matmul promotes (an f32
    residual after the W8A8 projections meets bf16 weights)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def lm_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    w = params["w_lm"] if "w_lm" in params else params["embed"].T
    return _mm(rms_norm_ref(x, params["final_ln"]), w)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _mla_qkv(cfg: DeepSeekV3Config, lw: dict, x, cos, sin):
    """Float MLA prologue: hidden → (absorbed q_nope, q_rope, latent kv, rope k)."""
    n = x.shape[0]
    lat, rope = cfg.kv_lora_rank, cfg.qk_rope_dim
    h1 = rms_norm_ref(x, lw["ln1"])
    f = _mm(h1, lw["wdqkv"])                                  # [N, lat + rope + q_lora]
    ckv, kpe, cq = f[:, :lat], f[:, lat : lat + rope], f[:, lat + rope :]
    q = _mm(rms_norm_ref(cq, lw["q_ln"]), lw["wuq"]).reshape(n, cfg.num_heads, cfg.qk_dim)
    qn, qpe = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim :]
    q_lat = torch.einsum("nhk,hkl->nhl", qn, lw["wuk"].to(qn.dtype))   # [N, H, lat]
    qpe = apply_rope(qpe, cos, sin)
    kpe = apply_rope(kpe[:, None, :], cos, sin)[:, 0]         # [N, rope]
    k_lat = rms_norm_ref(ckv, lw["kv_ln"])                    # [N, lat]
    return q_lat, qpe, k_lat, kpe, h1


def _nope_scale(cfg: DeepSeekV3Config):
    """Dequant scale of the latent cache, or None on the bf16 path."""
    return cfg.ctkv_scale if cfg.kv_cache_dtype == "int8" else None


def _write_nope(cfg: DeepSeekV3Config, k_lat, cache, slot_mapping):
    """Write latents into the paged nope cache, quantizing on an int8 cache."""
    if cache.dtype == torch.int8:
        kf = k_lat.float()    # true division, as JAX divides
        k_lat = saturate_int8(kf / torch.full_like(kf, cfg.ctkv_scale))
    return reshape_and_cache(k_lat[:, None, :].to(cache.dtype), cache, slot_mapping)


def _mla_preprocess_qkv(cfg: DeepSeekV3Config, w, x, cos, sin, cache, slot_mapping,
                        plain: bool):
    """Fused W8A8 prologue + cache writes (in place) → the absorbed query
    [N, H, lat+rope] in the rope cache's dtype; on an int8 cache the int8
    q_nope is dequantized by ``qnope_scale`` (the attention kernels fold
    ``ctkv_scale`` through ``k_scale``)."""
    int8 = cfg.kv_cache_dtype == "int8"
    qn, qpe, _, _ = mp.mla_preprocess(x, w, (cos, sin), cache["nope"], cache["rope"],
                                      slot_mapping, plain=plain,
                                      cache_mode="int8_nzcache" if int8 else "krope_ctkv")
    qn = qn.float() / w.qnope_scale.float()[None, :, None] if int8 else qn.float()
    return torch.cat([qn, qpe.float()], dim=-1).to(cache["rope"].dtype)


def _mla_output(cfg: DeepSeekV3Config, lw: dict, attn_lat, dq=None, plain: bool = False):
    """Latent attention output → hidden (absorbed V up-proj + output proj).
    ``dq`` (a :func:`quantize_dense_weights` layer): the output projection
    runs W8A8 and returns f32; the per-head ``wvu`` einsum stays float."""
    if dq is not None:
        o = torch.einsum("nhl,hlv->nhv", attn_lat.float(), lw["wvu"].float())
        return w8a8.project(o.reshape(o.shape[0], -1).to(torch.bfloat16), dq["wo"],
                            torch.float32, plain=plain)
    o = torch.einsum("nhl,hlv->nhv", attn_lat.to(lw["wvu"].dtype), lw["wvu"])
    return o.reshape(o.shape[0], -1) @ lw["wo"]


def _routed(ids):
    """Every routing choice (each layer's top-k expert ids) passes through
    here, before the router weighs the chosen experts.  A caller replaces it
    to record one run's choices and replay them in another: the weights stay
    the replaying run's own (differentiable) scores of those experts."""
    return ids


def _router(cfg: DeepSeekV3Config, lw: dict, x):
    """Top-k routing (``softmax``, or DeepSeek-V3's ``sigmoid_v3``: sigmoid
    scores, choice by score + bias within the ``topk_group`` best groups,
    weights the raw scores of the chosen experts, optionally sum-normalized,
    times ``routed_scaling_factor``)."""
    logits = x.float() @ lw["router"].float()
    if cfg.router_scoring == "softmax":
        topi = _routed(torch.topk(logits, cfg.topk, dim=-1).indices)
        return topi.to(torch.int32), torch.softmax(logits.gather(1, topi.long()), dim=-1)
    if cfg.router_scoring != "sigmoid_v3":
        raise ValueError(f"unknown router_scoring {cfg.router_scoring!r}")
    n, e = logits.shape
    scores = torch.sigmoid(logits)
    choice = scores + lw["router_bias"].float()[None, :]
    if cfg.n_group > 1:
        g = choice.reshape(n, cfg.n_group, e // cfg.n_group)
        group_scores = torch.topk(g, 2, dim=-1).values.sum(dim=-1)       # [N, G]
        gi = torch.topk(group_scores, cfg.topk_group, dim=-1).indices
        gmask = torch.zeros((n, cfg.n_group), dtype=torch.bool, device=x.device)
        gmask.scatter_(1, gi, True)
        choice = torch.where(gmask.repeat_interleave(e // cfg.n_group, dim=1), choice, 0.0)
    topi = _routed(torch.topk(choice, cfg.topk, dim=-1).indices)
    topw = scores.gather(1, topi.long())
    if cfg.norm_topk_prob:
        topw = topw / (topw.sum(dim=-1, keepdim=True) + 1e-20)
    return topi.to(torch.int32), topw * cfg.routed_scaling_factor


def _shared_expert(lw: dict, x):
    g = _mm(x, lw["ws_gate"])
    u = _mm(x, lw["ws_up"])
    return _mm(g * torch.sigmoid(g) * u, lw["ws_down"])


def _shared_expert_q(dq: dict, x, plain: bool):
    return w8a8.mlp_swiglu(x.to(torch.bfloat16), dq["ws_gate_up"], dq["ws_down"],
                           torch.float32, plain=plain)


def _combine(y: torch.Tensor, dest: torch.Tensor, topk_w: torch.Tensor) -> torch.Tensor:
    """The weighted top-k combine as a gather: ``out[t] = Σ_k topk_w[t, k] ·
    y[dest[t, k]]`` in f32, k summed in order.  (JAX builds an ``[n, n·k]``
    mask, splits it into bf16 hi + lo and makes two dense products; the port
    keeps the f32 weights, as the ring GEMM2 does.)"""
    d = dest.long()
    w = topk_w.float()
    out = w[:, 0, None] * y[d[:, 0]].float()
    for j in range(1, d.shape[1]):
        out = out + w[:, j, None] * y[d[:, j]].float()
    return out


def _moe_rows(x, topk_idx, num_experts: int):
    """The routing glue of the W8A8 MoE, as JAX's ``_gmm_moe``: per-token int8
    quant ``(xq_tok [n, H], sx_tok [n])``, then a counting sort of the (token,
    k) pairs by expert: ``group_sizes [E]``, ``dest [n, k]`` (each pair's
    sorted row) and ``tok_of_row [S]`` (each sorted row's token)."""
    n, k = topk_idx.shape
    xf = x.float()
    sx_tok = torch.clamp_min(row_scale(xf), 1e-12)
    xq_tok = saturate_int8(xf / sx_tok[:, None])
    flat_e = topk_idx.reshape(-1).long()
    gsizes = torch.bincount(flat_e, minlength=num_experts).to(torch.int32)
    src = torch.argsort(flat_e, stable=True).to(torch.int32)      # sorted slot → pair row
    dest = torch.empty_like(src)
    dest[src.long()] = torch.arange(n * k, dtype=torch.int32, device=x.device)
    return xq_tok, sx_tok, gsizes, dest.reshape(n, k), src // k


def _gmm_moe_ring(wq: tuple, rows: tuple, topk_w, *, plain: bool = False):
    """``_gmm_moe``'s branch up to 512 tokens at the ring GEMMs' widths:
    ``gmm1_ring`` (gather, GMM1, SwiGLU, requant) and ``gmm2_combine_ring``
    (GMM2 and the weighted top-k combine) → f32 ``[n, H]``."""
    w1, s1, w2, s2 = wq
    xq_tok, sx_tok, gsizes, dest, tok_of_row = rows
    gm1, gm2 = (gmm1_ring_ref, gmm2_combine_ring_ref) if plain else (gmm1_ring,
                                                                    gmm2_combine_ring)
    h1, hs = gm1(xq_tok, tok_of_row, w1, gsizes, sx_tok, s1)
    return gm2(h1, w2, gsizes, hs, s2, dest, topk_w.float())


def _gmm_moe_dispatch(wq: tuple, rows: tuple, topk_w, *, plain: bool = False):
    """``_gmm_moe``'s branch up to 512 tokens at other widths: the one-hot
    dispatch matrix (``dispatch_onehot``) into K8a's
    ``dequant_swiglu_quant`` with ``dispatch_p``, then K8b
    (``grouped_matmul_combine``) on the combine mask's bf16 hi / lo split →
    f32 ``[n, H]``."""
    w1, s1, w2, s2 = wq
    xq_tok, sx_tok, gsizes, dest, tok_of_row = rows
    n, k = dest.shape
    m_hi, m_lo = combine_masks(dest, topk_w, n * k)
    gm, comb = ((grouped_matmul_plain, grouped_matmul_combine_plain) if plain
                else (grouped_matmul, grouped_matmul_combine))
    h1, hs = gm(xq_tok, w1, gsizes, sx_tok[tok_of_row.long()], s1,
                epilogue="dequant_swiglu_quant", dispatch_p=dispatch_onehot(tok_of_row, n))
    return comb(h1, w2, gsizes, hs, s2, m_hi, m_lo)


def _gmm_moe_gather(wq: tuple, rows: tuple, topk_w, *, plain: bool = False):
    """``_gmm_moe``'s branch above 512 tokens: the gather ``xq_tok[tok_of_row]``,
    K8a's ``dequant_swiglu_quant`` then ``dequant`` (bf16), and the gather
    combine (:func:`_combine`) → f32 ``[n, H]``."""
    w1, s1, w2, s2 = wq
    xq_tok, sx_tok, gsizes, dest, tok_of_row = rows
    idx = tok_of_row.long()
    gm = grouped_matmul_plain if plain else grouped_matmul
    h1, hs = gm(xq_tok[idx], w1, gsizes, sx_tok[idx], s1, epilogue="dequant_swiglu_quant")
    y = gm(h1, w2, gsizes, hs, s2, epilogue="dequant")
    return _combine(y, dest, topk_w)


def _gmm_moe(cfg: DeepSeekV3Config, wq: tuple, x, topk_idx, topk_w, *, plain: bool = False):
    """Single-GPU W8A8 grouped MoE, JAX's ``_gmm_moe``: the routing glue
    (:func:`_moe_rows`), then on JAX's conditions up to 512 tokens
    :func:`_gmm_moe_ring` (widths permitting: H % 128, I % 128, 2I % 256) or
    :func:`_gmm_moe_dispatch`, above 512 tokens :func:`_gmm_moe_gather`;
    the result in x's dtype."""
    w1, _, w2, _ = wq
    n, hidden = x.shape
    rows = _moe_rows(x, topk_idx, w1.shape[0])
    if n > 512:
        branch = _gmm_moe_gather
    elif hidden % 128 == 0 and w2.shape[1] % 128 == 0 and w1.shape[2] % 256 == 0:
        branch = _gmm_moe_ring
    else:
        branch = _gmm_moe_dispatch
    return branch(wq, rows, topk_w, plain=plain).to(x.dtype)


def _dense_moe(cfg: DeepSeekV3Config, lw: dict, x, topk_idx, topk_w):
    """The float routed experts on one GPU, JAX's ``_dense_moe``: every
    expert's SwiGLU MLP for every token, then each token's top-k outputs
    weighed by its f32 router weights, so the result is f32 (JAX promotes
    the experts' outputs against the weights).  The products are batched
    over the experts on the weights as stored (``[E, H, I]``, ``[E, I, H]``;
    x broadcast over the experts, never an expert weight copied per call);
    the combine gathers each token's k outputs where JAX multiplies by an
    ``[N, E]`` one-hot matrix (the same f32 products, without the zero
    terms).  The activations take the experts' dtype: an f32 residual meets
    bf16 experts from a bf16 model's second layer on, where JAX converts the
    experts to f32 (ROADMAP §C)."""
    w_gate, w_up, w_down = lw["w_gate"], lw["w_up"], lw["w_down"]
    xe = x.to(w_gate.dtype).expand(cfg.num_experts, *x.shape)            # [E, N, H]
    gate = torch.bmm(xe, w_gate)                                          # [E, N, I]
    up = torch.bmm(xe, w_up)
    y = torch.bmm(gate * torch.sigmoid(gate) * up, w_down)                # [E, N, H]
    tok = torch.arange(x.shape[0], device=x.device)
    yk = y[topk_idx.T.long(), tok]                                        # [K, N, H]
    return (topk_w.T.float()[..., None] * yk.float()).sum(dim=0)


def _moe_and_shared(cfg, lw, wq, dq, x, plain, ep=None):
    """The MoE and the shared expert, and the residual, in JAX's branch
    order: ``ep`` (``(ep_buffer, use_int8_dispatch, eplb_tables)``) remaps
    the routing with the EPLB tables, then with ``wq`` runs
    ``ep_buffer.fused_deep_moe`` on the bf16 rows (x's dtype out); else
    ``wq`` runs the W8A8 MoE on one GPU and ``wq`` None the float one."""
    ep_buffer, use_int8_dispatch, eplb_tables = ep or (None, True, None)
    h2 = rms_norm_ref(x, lw["ln2"])
    topk_idx, topk_w = _router(cfg, lw, h2)
    if eplb_tables is not None:
        if ep_buffer is None:
            raise ValueError("EPLB serving rides the EP buffer: pass ep_buffer with eplb_tables")
        topk_idx = remap_topk(topk_idx, *eplb_tables)
    shared = _shared_expert(lw, h2) if dq is None else _shared_expert_q(dq, h2, plain)
    if ep_buffer is not None and wq is not None:
        moe, _, _ = ep_buffer.fused_deep_moe(h2.to(torch.bfloat16), topk_idx, topk_w, *wq,
                                             use_int8_dispatch=use_int8_dispatch, plain=plain)
        moe = moe.to(x.dtype)
    elif wq is not None:
        moe = _gmm_moe(cfg, wq, h2, topk_idx, topk_w, plain=plain)
    else:
        moe = _dense_moe(cfg, lw, h2, topk_idx, topk_w)
    return x + moe + shared


def _attention_inputs(cfg, lw, mw, x, cos, sin, cache, slot_mapping, plain):
    """Prologue (float, or the fused W8A8 one given ``mw``) + cache writes (in
    place) → the absorbed query [N, H, lat+rope]."""
    if mw is not None:
        return _mla_preprocess_qkv(cfg, mw, x, cos, sin, cache, slot_mapping, plain)
    q_lat, qpe, k_lat, kpe, _ = _mla_qkv(cfg, lw, x, cos, sin)
    _write_nope(cfg, k_lat, cache["nope"], slot_mapping)
    reshape_and_cache_transposed(kpe[:, None, :].to(cache["rope"].dtype), cache["rope"],
                                 slot_mapping)
    return torch.cat([q_lat, qpe], dim=-1).to(cache["rope"].dtype)


# ---------------------------------------------------------------------------
# DSA: the lightning indexer and the sparse attention
# ---------------------------------------------------------------------------

def _selected(sel):
    """Every DSA selection of a step passes through here: each prefill
    chunk's pages, each decode row's pages or tokens.  A caller replaces it
    to record one run's selections and replay them in another, as it does
    with :func:`_router` for routing (the f32 scores of two runs can rank a
    page or token at the boundary differently)."""
    return sel


def _write_index_keys(lw: dict, x, cache, slot_mapping):
    """The indexer's input ``h1 = rms_norm(x)`` (the prologue's first norm);
    its index keys ``h1 @ w_kidx`` go to ``cache["kidx"]`` (in place) at the
    latent's slots.  Returns ``h1``."""
    h1 = rms_norm_ref(x, lw["ln1"])
    kidx = cache["kidx"]
    reshape_and_cache(_mm(h1, lw["w_kidx"])[:, None, :].to(kidx.dtype), kidx, slot_mapping)
    return h1


def _index_queries(cfg: DeepSeekV3Config, lw: dict, h1, dtype):
    """The indexer's queries ``[N, idx_heads, idx_dim]`` in ``dtype`` (the key
    cache's) and weights ``[N, idx_heads]``."""
    qidx = _mm(h1, lw["w_qidx"]).reshape(h1.shape[0], cfg.idx_heads, cfg.idx_dim)
    return qidx.to(dtype), _mm(h1, lw["w_widx"])


def _dsa_decode(cfg: DeepSeekV3Config, lw: dict, x, q, cache, block_table, seq_lens,
                slot_mapping, ks, plain: bool):
    """DSA decode attention: the indexer's pages (page mode, K2 over the
    pruned block table) or tokens (token mode, K10 through
    ``lightning_indexer``, then the sparse gather)."""
    h1 = _write_index_keys(lw, x, cache, slot_mapping)
    kidx = cache["kidx"]
    qidx, widx = _index_queries(cfg, lw, h1, kidx.dtype)
    if cfg.sparse_granularity == "page":
        scores = lightning_indexer_scores_decode(qidx, kidx, widx, seq_lens, block_table)
        sel = _selected(select_decode_pages(scores, seq_lens, cfg.page_size,
                                            cdiv(cfg.sparse_count, cfg.page_size)))
        bt_sel, seq_sel = pruned_block_table(block_table, seq_lens, sel, cfg.page_size)
        attend = decode_mla_ref if plain else decode_mla
        return attend(q, cache["nope"], cache["rope"], seq_sel, cfg.sm_scale, bt_sel,
                      k_scale=ks)
    if cfg.sparse_granularity != "token":
        raise ValueError(f"unknown sparse_granularity {cfg.sparse_granularity!r}")
    n = x.shape[0]
    sel = _selected(lightning_indexer(qidx[:, None], kidx, widx[:, None], None, seq_lens,
                                      block_table, sparse_count=cfg.sparse_count,
                                      backend="xla" if plain else "pallas"))
    return decode_mla_sparse(q, cache["nope"], cache["rope"], seq_lens, cfg.sm_scale,
                             block_table, sel.reshape(n, cfg.sparse_count), k_scale=ks)


def _dsa_prefill(cfg: DeepSeekV3Config, lw: dict, h1, q, cache, seq_lens, block_tables,
                 context_lens, req, j, max_q, ks, plain: bool):
    """DSA page-mode prefill attention: the indexer's queries dense-padded per
    request, K10's masked scores, their page maxima, the top pages of each
    q-chunk (:func:`select_prefill_pages`), then K9b over those pages."""
    kidx = cache["kidx"]
    qidx, widx = _index_queries(cfg, lw, h1, kidx.dtype)
    bsz, s = seq_lens.shape[0], h1.shape[0]
    mq = max_q or s
    cq = prefill_q_chunk(mq)
    mq_pad = cdiv(mq, cq) * cq
    if s > mq_pad:                  # rows past max_q: JAX scatters with mode="drop"
        keep = j < mq_pad
        req, j, qidx, widx = req[keep], j[keep], qidx[keep], widx[keep]
    qd = qidx.new_zeros((bsz, mq_pad, cfg.idx_heads, cfg.idx_dim))
    qd[req, j] = qidx
    wd = torch.zeros((bsz, mq_pad, cfg.idx_heads), dtype=torch.float32, device=h1.device)
    wd[req, j] = widx.float()
    score = (lightning_indexer_scores_prefill_ref if plain
             else lightning_indexer_scores_prefill_pallas)
    scores = score(qd, wd, kidx, seq_lens, context_lens, block_tables, q_chunk=cq)
    max_pages = block_tables.shape[1]
    page_scores = scores.reshape(bsz, mq_pad, max_pages, cfg.page_size).amax(dim=-1)
    num_sel = min(cdiv(cfg.sparse_count, cfg.page_size), max_pages)
    pos_sel = _selected(select_prefill_pages(page_scores, seq_lens, context_lens, cq=cq,
                                             page_size=cfg.page_size, num_sel=num_sel))
    attend = mla_prefill_block_sparse_ref if plain else mla_prefill_block_sparse
    return attend(q, cache["nope"], cache["rope"], seq_lens, block_tables, context_lens,
                  cfg.sm_scale, pos_sel, max_q=mq, q_chunk=cq, k_scale=ks)


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def _layer_switches(mla_wq, dense_wq, moe_weights_q, li):
    return tuple(None if w is None else w[li] for w in (mla_wq, dense_wq, moe_weights_q))


def decode_step(cfg: DeepSeekV3Config, params: dict, hidden, positions, kv_caches,
                block_table, seq_lens, slot_mapping, moe_weights_q=None, *,
                ep_buffer=None, use_int8_dispatch: bool = True, mla_wq=None, dense_wq=None,
                eplb_tables=None, plain: bool = False):
    """One decode step over all layers: ``hidden [N, H]`` current-token
    activations at ``positions``; ``seq_lens`` include the current token;
    slot ``-1`` rows write nothing.  ``moe_weights_q``
    (:func:`quantize_moe_weights`) runs the W8A8 MoE, else the float experts
    (:func:`_dense_moe`); with ``ep_buffer`` the W8A8 MoE runs expert
    parallel (``Buffer.fused_deep_moe``, ``use_int8_dispatch`` its wire),
    ``eplb_tables`` remapping the routing first; ``mla_wq``
    (:func:`make_mla_preprocess_weights`) runs the fused W8A8 prologue,
    ``dense_wq`` (:func:`quantize_dense_weights`) the W8A8 output projection
    and shared expert.  Returns ``(hidden, kv_caches)`` with the caches
    updated in place."""
    ks = _nope_scale(cfg)
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_dim)
    x = hidden
    for li, lw in enumerate(params["layers"]):
        cache = kv_caches[li]
        mw, dq, wq = _layer_switches(mla_wq, dense_wq, moe_weights_q, li)
        q = _attention_inputs(cfg, lw, mw, x, cos, sin, cache, slot_mapping, plain)
        if cfg.sparse_count > 0:
            attn = _dsa_decode(cfg, lw, x, q, cache, block_table, seq_lens, slot_mapping, ks,
                               plain)
        elif plain:
            attn = decode_mla_ref(q, cache["nope"], cache["rope"], seq_lens, cfg.sm_scale,
                                  block_table, k_scale=ks)
        else:
            attn = decode_mla(q, cache["nope"], cache["rope"], seq_lens, cfg.sm_scale,
                              block_table, k_scale=ks)
        x = x + _mla_output(cfg, lw, attn, dq, plain)
        x = _moe_and_shared(cfg, lw, wq, dq, x, plain, (ep_buffer, use_int8_dispatch,
                                                         eplb_tables))
    return x, kv_caches


def prefill_step(cfg: DeepSeekV3Config, params: dict, hidden, seq_lens, kv_caches,
                 block_tables, context_lens, slot_mapping, *, max_q: int | None = None,
                 moe_weights_q=None, ep_buffer=None, use_int8_dispatch: bool = True,
                 mla_wq=None, dense_wq=None, eplb_tables=None, plain: bool = False):
    """Varlen (chunked) prefill over all layers: ``hidden [S, H]`` packed by
    request, ``seq_lens [B]`` new tokens, ``context_lens [B]`` totals including
    them; ``moe_weights_q``, ``ep_buffer``, ``use_int8_dispatch``,
    ``eplb_tables``, ``mla_wq`` and ``dense_wq`` as in :func:`decode_step`.
    Returns ``(hidden, kv_caches)`` with the caches updated in place."""
    ks = _nope_scale(cfg)
    dev = hidden.device
    sl = seq_lens.to(dev).long()
    req, j = packed_rows(sl, hidden.shape[0])
    positions = context_lens.to(dev).long()[req] - sl[req] + j
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_dim)
    x = hidden
    for li, lw in enumerate(params["layers"]):
        cache = kv_caches[li]
        mw, dq, wq = _layer_switches(mla_wq, dense_wq, moe_weights_q, li)
        q = _attention_inputs(cfg, lw, mw, x, cos, sin, cache, slot_mapping, plain)
        if cfg.sparse_count > 0:                    # token mode: then dense attention, as JAX
            h1 = _write_index_keys(lw, x, cache, slot_mapping)
        if cfg.sparse_count > 0 and cfg.sparse_granularity == "page":
            attn = _dsa_prefill(cfg, lw, h1, q, cache, seq_lens, block_tables, context_lens,
                                req, j, max_q, ks, plain)
        elif plain:
            attn = mla_prefill_ref(q, cache["nope"], cache["rope"], seq_lens, block_tables,
                                   context_lens, cfg.sm_scale, k_scale=ks)
        else:
            attn = mla_prefill_pallas(q, cache["nope"], cache["rope"], seq_lens,
                                      block_tables, context_lens, cfg.sm_scale, max_q=max_q,
                                      k_scale=ks)
        x = x + _mla_output(cfg, lw, attn, dq, plain)
        x = _moe_and_shared(cfg, lw, wq, dq, x, plain, (ep_buffer, use_int8_dispatch,
                                                         eplb_tables))
    return x, kv_caches


# ---------------------------------------------------------------------------
# tensor-parallel serving: heads over a process group
# ---------------------------------------------------------------------------

def tp_shard_layer(lw: dict, rank: int, ntp: int) -> dict:
    """Rank ``rank``'s heads of one layer's weights under head TP over
    ``ntp`` ranks (JAX's ``_tp_layer_specs``): ``wuq [q_lora, H·qk_dim]`` by
    columns, ``wuk [H, nope, lat]`` and ``wvu [H, lat, v]`` by heads, ``wo
    [H·v, hidden]`` by rows; every other weight the same tensor
    (replicated: MLA's latent K / V is shared by the heads)."""
    h = lw["wuk"].shape[0]
    if h % ntp:
        raise ValueError(f"{h} heads do not divide over {ntp} TP ranks")
    hl = h // ntp
    qk, v = lw["wuq"].shape[1] // h, lw["wvu"].shape[2]
    heads = slice(rank * hl, (rank + 1) * hl)
    # copies, not views: a rank keeps only its own heads' storage
    return {**lw, "wuq": lw["wuq"][:, rank * hl * qk:(rank + 1) * hl * qk].contiguous(),
            "wuk": lw["wuk"][heads].contiguous(), "wvu": lw["wvu"][heads].contiguous(),
            "wo": lw["wo"][rank * hl * v:(rank + 1) * hl * v].contiguous()}


def tp_attention_block(cfg: DeepSeekV3Config, lw: dict, x, cos, sin, cache, block_table,
                       seq_lens, slot_mapping, *, group, plain: bool = False):
    """One MLA decode attention block on this rank's heads (``lw`` from
    :func:`tp_shard_layer`): every rank computes the head-free latent K / V
    and writes the same cache pages, attends its ``H / ntp`` heads on
    ``decode_mla`` (K2; its plain version with ``plain``), and the output
    projections are summed over ``group``.  Returns ``[N, hidden]``, the
    same bits on every rank."""
    from sgl_kernel_npu_tpu_torch.parallel.collectives import all_sum, group_size

    local = dataclasses.replace(cfg, num_heads=cfg.num_heads // group_size(group))
    if lw["wuk"].shape[0] != local.num_heads:
        raise ValueError(f"the layer holds {lw['wuk'].shape[0]} heads; this rank's share is "
                         f"{local.num_heads}: pass tp_shard_layer's weights")
    q = _attention_inputs(local, lw, None, x, cos, sin, cache, slot_mapping, plain)
    attend = decode_mla_ref if plain else decode_mla
    attn = attend(q, cache["nope"], cache["rope"], seq_lens, cfg.sm_scale, block_table,
                  k_scale=_nope_scale(cfg))
    return all_sum(_mla_output(local, lw, attn), group)


def decode_step_tp(cfg: DeepSeekV3Config, params: dict, hidden, positions, kv_caches,
                   block_table, seq_lens, slot_mapping, *, group, plain: bool = False):
    """:func:`decode_step` with head-TP attention over ``group`` (JAX's
    ``decode_step_tp``): ``params["layers"]`` are this rank's
    (:func:`tp_shard_layer`), the float dense MoE and the shared expert run
    replicated, the latent cache is replicated (each rank writes all of it).
    A DSA config (``sparse_count > 0``) raises ``NotImplementedError``, as
    JAX's does.  Returns ``(hidden, kv_caches)``, the caches updated in
    place."""
    if cfg.sparse_count > 0:
        raise NotImplementedError(
            "decode_step_tp does not run the DSA sparse branch (and would drop the kidx "
            "cache leaf): use dense configs for TP serving")
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_dim)
    x = hidden
    for li, lw in enumerate(params["layers"]):
        x = x + tp_attention_block(cfg, lw, x, cos, sin, kv_caches[li], block_table, seq_lens,
                                   slot_mapping, group=group, plain=plain)
        x = _moe_and_shared(cfg, lw, None, None, x, plain)
    return x, kv_caches


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _mesh_dims(mesh):
    """The ``("dp", "ep")`` DeviceMesh's EP sub-mesh and DP sub-mesh."""
    if tuple(getattr(mesh, "mesh_dim_names", None) or ()) != ("dp", "ep"):
        raise ValueError("mesh must be a torch.distributed DeviceMesh with dims ('dp', 'ep'), "
                         "the JAX mesh's axes")
    return mesh["ep"], mesh["dp"]


def _one_rank(mesh, what: str) -> None:
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {mesh.size()} ranks: the gradients of the replicated leaves "
            "need an all-reduce over the mesh, not ported yet (ROADMAP item 16)")


def _ep_moe_train(cfg: DeepSeekV3Config, lw: dict, x_flat, topk_idx, topk_w, *, mesh,
                  plain: bool = False):
    """Differentiable expert-parallel MoE (JAX's ``_ep_moe_train``, the
    ``shard_map`` body on this rank): ragged dispatch of this rank's tokens
    ``x_flat [T, H]`` at their dtype over the mesh's EP group, ``gate`` and
    ``up`` through :func:`gmm_train` on this rank's experts ``[rank·E_local,
    (rank + 1)·E_local)``, SwiGLU in f32 cast to x's dtype, ``down`` through
    :func:`gmm_train`, combine weighed by ``topk_w`` in f32 → ``[T, H]`` in
    x's dtype.  Capacities exact (``T · min(K, E_local)`` a rank pair, ``T``
    a segment): no row drops.  ``plain`` runs K8a's plain versions."""
    ep, _ = _mesh_dims(mesh)
    group, ranks, rank = ep.get_group(), ep.size(), ep.get_local_rank()
    t = x_flat.shape[0]
    e_local = cfg.num_experts // ranks
    kw = dict(group=group, num_ranks=ranks, seg_capacity=t)
    d = ep_core.dispatch_ragged_core(x_flat, topk_idx, num_experts=cfg.num_experts,
                                     pair_capacity=t * min(cfg.topk, e_local), use_int8=False,
                                     **kw)
    gs, xin = d["group_sizes"], d["recv_x_sorted"]

    def local(w):     # never a slice of the whole range: its backward copies the leaf
        return w if ranks == 1 else w[rank * e_local : (rank + 1) * e_local]

    gate = gmm_train(xin, local(lw["w_gate"]), gs, plain=plain)
    up = gmm_train(xin, local(lw["w_up"]), gs, plain=plain)
    act = (gate * torch.sigmoid(gate) * up).to(xin.dtype)
    y = gmm_train(act, local(lw["w_down"]), gs, plain=plain)
    return ep_core.combine_ragged_core(y.to(xin.dtype), topk_w, d["handle"],
                                       num_local_experts=e_local, out_dtype=xin.dtype, **kw)


def _train_attention(cfg: DeepSeekV3Config, lw: dict, x, cos, sin, *, flash: bool = False,
                     plain: bool = False):
    """Causal MLA attention over whole sequences ``x [B, S, H]`` → the
    attention block's output ``[B, S, H]``.  ``flash=False``: dense scores in
    the activations' dtype (JAX's einsum path); ``flash=True``:
    :func:`~sgl_kernel_npu_tpu_torch.ops.attention.mla_train.mla_flash_train`
    (K14a-c on the card, their plain versions on the CPU or with ``plain``)."""
    b, s, h = x.shape
    q_lat, qpe, k_lat, kpe, _ = _mla_qkv(cfg, lw, x.reshape(b * s, h), cos, sin)
    q_lat = q_lat.reshape(b, s, cfg.num_heads, -1)
    qpe = qpe.reshape(b, s, cfg.num_heads, -1)
    k_lat = k_lat.reshape(b, s, -1)
    kpe = kpe.reshape(b, s, -1)
    if flash:
        attn = mla_flash_train(q_lat, qpe, k_lat, kpe, cfg.sm_scale, plain=plain)
    else:
        scores = torch.einsum("bqhl,bkl->bhqk", q_lat, k_lat)
        scores = (scores + torch.einsum("bqhr,bkr->bhqk", qpe, kpe)) * cfg.sm_scale
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
        p = torch.softmax(torch.where(causal, scores, -1e30), dim=-1)
        attn = torch.einsum("bhqk,bkl->bqhl", p, k_lat)
    return _mla_output(cfg, lw, attn.reshape(b * s, cfg.num_heads, -1)).reshape(b, s, h)


def train_forward(cfg: DeepSeekV3Config, params: dict, tokens, *, mesh=None,
                  flash: bool = False, plain: bool = False):
    """The causal LM loss of ``tokens [B, S]``: the mean next-token NLL over
    the first S - 1 positions of every row, from f32 log-softmax logits of
    the tied head (``embed``ᵀ).  Each layer: attention
    (:func:`_train_attention`, ``flash`` and ``plain`` as there), then the
    routed experts and the shared expert.  ``mesh=None``: the dense float MoE
    (:func:`_dense_moe`, f32 out, so the residual turns f32 as in JAX);
    ``mesh``: the expert-parallel MoE (:func:`_ep_moe_train`, out in the
    activations' dtype, as JAX's), ``tokens`` this rank's batch shard and
    the loss the mean over every rank's tokens (its gradient this rank's
    share)."""
    b, s = tokens.shape
    x = embed(params, tokens)                                            # [B, S, H]
    cos, sin = rope_cos_sin(torch.arange(s, device=x.device), cfg.qk_rope_dim)
    cos, sin = cos.repeat(b, 1), sin.repeat(b, 1)
    for lw in params["layers"]:
        x = x + _train_attention(cfg, lw, x, cos, sin, flash=flash, plain=plain)
        h2 = rms_norm_ref(x.reshape(b * s, -1), lw["ln2"])
        topk_idx, topk_w = _router(cfg, lw, h2)
        if mesh is None:
            moe = _dense_moe(cfg, lw, h2, topk_idx, topk_w)
        else:
            moe = _ep_moe_train(cfg, lw, h2, topk_idx, topk_w, mesh=mesh, plain=plain)
        x = x + (moe + _shared_expert(lw, h2)).reshape(b, s, -1)
    logits = _mm(rms_norm_ref(x.reshape(b * s, -1), params["final_ln"]), params["embed"].T)
    labels = torch.roll(tokens, -1, dims=1).reshape(-1).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = (torch.arange(s, device=x.device) < s - 1).repeat(b)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    total, count = (nll * mask).sum(), mask.sum()
    if mesh is not None and mesh.size() > 1:
        sums = torch.stack([total.detach(), count.to(total.dtype)])
        for sub in _mesh_dims(mesh):
            torch.distributed.all_reduce(sums, group=sub.get_group())
        return (total + (sums[0] - total.detach())) / sums[1]
    return total / count


def _flatten(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flatten(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flatten(v)]
    return []


def _unflatten(tree, leaves):
    """``tree`` with its tensor leaves replaced, in :func:`_flatten`'s order,
    by the iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return tree


def _loss_and_leaf_grads(cfg, params, tokens, **kw):
    """The loss, the params' tensor leaves and their gradients (None where the
    loss does not reach a leaf: ``router_bias``, the DSA indexer
    projections)."""
    leaves = _flatten(params)
    live = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
    loss = train_forward(cfg, _unflatten(params, iter(live)), tokens, **kw)
    wrt = [p for p in live if p.requires_grad]
    grads = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    return loss.detach(), leaves, [next(grads) if p.requires_grad else None for p in live]


def loss_and_grads(cfg: DeepSeekV3Config, params: dict, tokens, *, mesh=None,
                   flash: bool = False, plain: bool = False):
    """``jax.value_and_grad(train_forward)``: the loss and its gradient
    w.r.t. every tensor of ``params``, in ``params``' own structure (zeros
    where the loss does not reach, as JAX).  ``mesh``: of one rank (more
    raise, ROADMAP item 16)."""
    _one_rank(mesh, "loss_and_grads")
    loss, leaves, grads = _loss_and_leaf_grads(cfg, params, tokens, mesh=mesh, flash=flash,
                                                plain=plain)
    full = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss, _unflatten(params, iter(full))


def make_train_step(cfg: DeepSeekV3Config, mesh=None, lr: float = 1e-3, flash: bool = False,
                    plain: bool = False):
    """``step(params, tokens) -> (new_params, loss)``: one SGD step ``p - lr
    g`` out of place, as JAX's (``lr`` rounded to each leaf's dtype first, as
    JAX's weak-typed scalar is).  Each gradient is freed as its new leaf is
    made, so the peak holds the weights, the gradients and the activations,
    not three copies of the weights.  Leaves the loss does not reach come
    back unchanged (the same tensors).  ``mesh`` (of one rank; more raise,
    ROADMAP item 16) trains the routed experts expert parallel
    (:func:`_ep_moe_train`).  Returns the step alone, where JAX's returns it
    with the parameters' shardings for a mesh."""
    _one_rank(mesh, "make_train_step")

    def step(params, tokens):
        loss, leaves, grads = _loss_and_leaf_grads(cfg, params, tokens, mesh=mesh, flash=flash,
                                                    plain=plain)
        new = []
        with torch.no_grad():
            for i, p in enumerate(leaves):
                g, grads[i] = grads[i], None
                if g is None:
                    new.append(p)
                    continue
                new.append(p - g.mul_(torch.tensor(lr, dtype=g.dtype).item()))
                del g
        return _unflatten(params, iter(new)), loss

    return step
