"""Launch counters of the kernel wrappers.

Each kernel wrapper carries a plain integer ``launches`` that it raises by one
where it launches its CUDA kernel (and nowhere else: the plain path for CPU
tensors does not count).  A wrapper of several modes also counts each launch
under its mode (``modes``; :func:`read` names them ``"wrapper:mode"``).  A
run resets the counters, drives the main path, and reads them to show which
kernels the path went through.
"""

from __future__ import annotations


def counted(fn=None, *, modes: tuple = ()):
    """Give a wrapper its ``launches`` counter and one counter for each of
    ``modes``, all starting at 0 (``@counted`` or ``@counted(modes=...)``)."""
    def give(f):
        f.launches = 0
        f.modes = dict.fromkeys(modes, 0)
        return f

    return give if fn is None else give(fn)


def launched(fn, *modes: str) -> None:
    """Count one launch of ``fn``, under each of ``modes`` too."""
    fn.launches += 1
    for mode in modes:
        fn.modes[mode] += 1


def wrappers() -> dict:
    """Every kernel wrapper of the port, by name."""
    from sgl_kernel_npu_tpu_torch.ops import (
        activation,
        gmm_ring,
        grouped_matmul,
        lora_pallas,
        matmul,
        norm,
        quant,
    )
    from sgl_kernel_npu_tpu_torch.ops.attention import (
        decode_attention,
        lightning_indexer,
        mla_prefill,
        mla_train,
        sinks_attention,
    )
    from sgl_kernel_npu_tpu_torch.parallel import fused_full, fused_kernel, pallas_a2a

    return {
        "decode_mla": decode_attention.decode_mla,
        "decode_gqa": decode_attention.decode_gqa,
        "mla_prefill_pallas": mla_prefill.mla_prefill_pallas,
        "gmm1_ring": gmm_ring.gmm1_ring,
        "gmm2_combine_ring": gmm_ring.gmm2_combine_ring,
        "quant_matmul": matmul.quant_matmul,
        "quant_per_token": quant.quant_per_token,
        "swiglu_quant": activation.swiglu_quant,
        "grouped_matmul": grouped_matmul.grouped_matmul,
        "grouped_matmul_float": grouped_matmul.grouped_matmul_float,
        "grouped_matmul_dx": grouped_matmul.grouped_matmul_dx,
        "grouped_matmul_combine": grouped_matmul.grouped_matmul_combine,
        "lightning_indexer_scores_prefill_pallas":
            lightning_indexer.lightning_indexer_scores_prefill_pallas,
        "mla_prefill_block_sparse": mla_prefill.mla_prefill_block_sparse,
        "rms_norm": norm.rms_norm,
        "add_rms_norm_bias": norm.add_rms_norm_bias,
        "add_gemma_rms_norm": norm.add_gemma_rms_norm,
        "l1_norm": norm.l1_norm,
        "swiglu_oai": activation.swiglu_oai,
        "attention_sinks": sinks_attention.attention_sinks,
        "attention_sinks_packed": sinks_attention.attention_sinks_packed,
        "attention_sinks_prefill_pallas": sinks_attention.attention_sinks_prefill_pallas,
        "bgmv_fused": lora_pallas.bgmv_fused,
        "sgmv_fused": lora_pallas.sgmv_fused,
        "mla_flash_fwd": mla_train.mla_flash_fwd,
        "mla_flash_bwd_dq": mla_train.mla_flash_bwd_dq,
        "mla_flash_bwd_dk": mla_train.mla_flash_bwd_dk,
        "pallas_all_to_all": pallas_a2a.pallas_all_to_all,
        "pallas_ragged_all_to_all": pallas_a2a.pallas_ragged_all_to_all,
        "pallas_ragged_all_to_all_monitored": pallas_a2a.pallas_ragged_all_to_all_monitored,
        "fused_deep_moe_full_rank": fused_full.fused_deep_moe_full_rank,
        "fused_dispatch_gmm1_rank": fused_kernel.fused_dispatch_gmm1_rank,
    }


def reset() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        fn.modes = dict.fromkeys(fn.modes, 0)


def read() -> dict[str, int]:
    out = {}
    for name, fn in wrappers().items():
        out[name] = fn.launches
        out.update({f"{name}:{mode}": n for mode, n in fn.modes.items()})
    return out
