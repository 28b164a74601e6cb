"""Fused MLA prologue (DeepSeek-V3): the W8A8 ``mla_preprocess`` op.

Counterpart of ``sgl_kernel_npu_tpu/ops/attention/mla_preprocess.py``:
RMSNorm(+beta) → static per-tensor int8 quant → W8A8 GEMM ``wdqkv`` (K1) →
split, latent first (ckv 512 ‖ k_pe 64 ‖ cq 1536) → RMSNorm(+beta) → quant →
W8A8 GEMM ``wuq`` (K1) → split (q_nope 128 ‖ q_pe 64) → RoPE on q_pe and
k_pe → per-head ``wuk`` einsum → RMSNorm on ckv → the writes into the paged
latent cache and the transposed rope cache.  The glue is torch ops around
the two GEMMs, as it is XLA glue around them in the JAX package.

JAX donates the caches; the port writes them in place and returns them.
JAX's ``use_pallas`` is the port's ``plain`` (inverted): ``plain=True`` runs
the GEMMs' plain version.  Cache modes: ``krope_ctkv`` (bf16 split caches)
and its alias ``nzcache``; ``int8_nzcache``: the latent cache holds
``round(k / ctkv_scale)`` int8 levels and ``q_nope_out`` is returned as
``round(q · qnope_scale)`` int8 per head (both from f32, as in JAX).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sgl_kernel_npu_tpu_torch.ops.matmul import quant_matmul, quant_matmul_ref, quant_per_tensor
from sgl_kernel_npu_tpu_torch.ops.mem_cache.kv_cache import (
    reshape_and_cache,
    reshape_and_cache_transposed,
)
from sgl_kernel_npu_tpu_torch.ops.norm import rms_norm_ref
from sgl_kernel_npu_tpu_torch.ops.quant import saturate_int8
from sgl_kernel_npu_tpu_torch.ops.rope import apply_rope

K_NOPE = 512
K_PE = 64
Q_NOPE_DIM = 128
Q_PE_DIM = 64
Q_DIM = Q_NOPE_DIM + Q_PE_DIM  # 192


class MlaPreprocessWeights(NamedTuple):
    """Static weights of the fused prologue (the JAX package's fields)."""

    gamma1: torch.Tensor        # [hidden] RMSNorm before wdqkv
    beta1: torch.Tensor         # [hidden]
    qscale1: torch.Tensor       # [] per-tensor input quant scale
    qoffset1: torch.Tensor      # []
    wdqkv: torch.Tensor         # [2112, hidden] int8 (rows = out channels)
    descale1: torch.Tensor      # [2112] f32
    bias1: torch.Tensor         # [2112] int32
    gamma2: torch.Tensor        # [1536] RMSNorm on cq
    beta2: torch.Tensor         # [1536] added after the norm
    qscale2: torch.Tensor       # []
    qoffset2: torch.Tensor      # []
    wuq: torch.Tensor           # [heads*192, 1536] int8
    descale2: torch.Tensor      # [heads*192]
    bias2: torch.Tensor         # [heads*192] int32
    gamma3: torch.Tensor        # [512] RMSNorm on ckv
    wuk: torch.Tensor           # [heads, 128, 512] (bf16/f32)
    qnope_scale: torch.Tensor | None = None  # [heads] (int8 cache mode)
    ctkv_scale: torch.Tensor | None = None   # [] (int8 cache mode)


def pad_weights_lane_aligned(w: MlaPreprocessWeights) -> MlaPreprocessWeights:
    """Pad ``wdqkv``'s output dim (2112) to a multiple of 128 at load time, as
    the JAX package does for its TPU tiles.  The CUDA GEMM masks the ragged
    edge and needs no pad, so this only keeps the two packages' weights
    alike; :func:`mla_preprocess` never reads the pad channels."""
    pad = (-w.wdqkv.shape[0]) % 128
    if pad == 0:
        return w
    return w._replace(
        wdqkv=torch.nn.functional.pad(w.wdqkv, (0, 0, 0, pad)),
        descale1=torch.nn.functional.pad(w.descale1, (0, pad)),
        bias1=torch.nn.functional.pad(w.bias1, (0, pad)),
    )


def mla_preprocess(hidden, w: MlaPreprocessWeights, cos_sin, kv_cache_nope, kv_cache_rope,
                   slot_mapping, *, cache_mode: str = "krope_ctkv", plain: bool = False,
                   first_norm: bool = True):
    """Fused MLA prologue over ``hidden [N, hidden]`` with rope tables
    ``cos_sin ([N, 64], [N, 64])``, caches ``[pages, 1, page, 512]`` and
    ``[pages, 1, 64, page]``, and ``slot_mapping [N]`` (-1 writes nothing).

    Returns ``(q_nope_out [N, heads, 512], q_pe [N, heads, 64],
    kv_cache_nope, kv_cache_rope)``, the caches written in place.
    ``first_norm=False`` quantizes ``hidden`` directly (the first norm folded
    into the caller).  ``int8_nzcache`` needs ``w.qnope_scale`` and
    ``w.ctkv_scale`` and an int8 latent cache."""
    int8 = cache_mode == "int8_nzcache"
    if cache_mode not in ("krope_ctkv", "nzcache", "int8_nzcache"):
        raise ValueError(f"unknown cache_mode {cache_mode!r}")
    if int8 and (w.qnope_scale is None or w.ctkv_scale is None
                 or kv_cache_nope.dtype != torch.int8):
        raise ValueError("cache_mode='int8_nzcache' needs qnope_scale, ctkv_scale and an "
                         f"int8 latent cache (got {kv_cache_nope.dtype})")
    n = hidden.shape[0]
    heads = w.wuk.shape[0]
    dtype = hidden.dtype
    gemm = quant_matmul_ref if plain else quant_matmul
    cos, sin = cos_sin

    x1 = rms_norm_ref(hidden, w.gamma1) + w.beta1.to(dtype) if first_norm else hidden
    x1q = quant_per_tensor(x1, w.qscale1, w.qoffset1)
    fused = gemm(x1q, w.wdqkv, w.descale1, w.bias1, out_dtype=torch.float32)

    # split dims come from the norms and the rope table, never from wdqkv
    # (which may carry pad channels)
    k_nope_d, q_rms_d, k_pe_d = w.gamma3.shape[0], w.gamma2.shape[0], cos.shape[-1]
    if fused.shape[1] < k_nope_d + k_pe_d + q_rms_d:
        raise ValueError(f"wdqkv has {fused.shape[1]} channels < "
                         f"{k_nope_d} + {k_pe_d} + {q_rms_d}")
    ckv = fused[:, :k_nope_d]
    k_pe = fused[:, k_nope_d : k_nope_d + k_pe_d][:, None, :]             # [N, 1, 64]
    cq = fused[:, k_nope_d + k_pe_d : k_nope_d + k_pe_d + q_rms_d]

    # q path: RMSNorm in the hidden dtype, + beta2 in f32 (the sum promotes)
    q = rms_norm_ref(cq.to(dtype), w.gamma2) + w.beta2.float()
    qq = quant_per_tensor(q, w.qscale2, w.qoffset2)
    q_out = gemm(qq, w.wuq, w.descale2, w.bias2, out_dtype=torch.float32)
    q_out = q_out.reshape(n, heads, w.wuq.shape[0] // heads)
    q_nope_d = w.wuk.shape[1]
    q_nope, q_pe = q_out[..., :q_nope_d], q_out[..., q_nope_d:]

    q_pe = apply_rope(q_pe.to(dtype), cos, sin)
    k_pe = apply_rope(k_pe.to(dtype), cos, sin)
    q_nope_out = torch.einsum("nhk,hkd->nhd", q_nope, w.wuk.float())    # [N, H, 512] f32
    k_nope = rms_norm_ref(ckv.to(dtype), w.gamma3)[:, None, :]            # [N, 1, 512]
    if int8:
        q_nope_out = saturate_int8(q_nope_out * w.qnope_scale.float()[None, :, None])
        kf = k_nope.float()   # true division by a tensor (never a reciprocal multiply)
        k_nope = saturate_int8(kf / w.ctkv_scale.to(kf.device, torch.float32).expand_as(kf))
    else:
        q_nope_out = q_nope_out.to(dtype)

    reshape_and_cache(k_nope, kv_cache_nope, slot_mapping)
    reshape_and_cache_transposed(k_pe.to(kv_cache_rope.dtype), kv_cache_rope, slot_mapping)
    return q_nope_out, q_pe, kv_cache_nope, kv_cache_rope
