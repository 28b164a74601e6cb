"""Pipeline-parallel serving for the Llama family: layer stages over a
process group.

Counterpart of ``sgl_kernel_npu_tpu/models/llama_pp.py``.  The layer stack
is cut into ``R`` contiguous stages, one a rank of ``group``; each rank holds
its stage's weights and its stage's slice of the paged KV pool.  A step runs
the stages in turn: stage r applies its layers at step r, then the hidden
state moves one rank on
(:func:`~sgl_kernel_npu_tpu_torch.parallel.collectives.ring_permute`); after
the last stage the final hidden is broadcast from the rank that holds it
(JAX rotates it once more and sums it from rank 0), and every rank applies
``ln_f`` to the same bits.  The stage runs ``models.llama._stack``, the same
layer as the one-GPU steps: decode on K11a, prefill on K12d (JAX's stage
calls the jnp golden ``attention_sinks_prefill``; the kernel differs from it
only in rounding), RMSNorm on K6a.  The embedding and the head stay
replicated (the engine's adapter).
"""

from __future__ import annotations

import dataclasses

import torch

from sgl_kernel_npu_tpu_torch.models import llama
from sgl_kernel_npu_tpu_torch.parallel.collectives import (
    broadcast,
    group_rank,
    group_size,
    ring_permute,
)


def _layers_per_stage(cfg: llama.LlamaConfig, num_stages: int) -> int:
    if cfg.num_layers % num_stages:
        raise ValueError(f"{cfg.num_layers} layers do not cut into {num_stages} stages")
    return cfg.num_layers // num_stages


def stack_stage_params(cfg: llama.LlamaConfig, params: dict, num_stages: int,
                       rank: int | None = None) -> dict:
    """The per-layer weight dicts restacked by stage: ``{"stages": {name:
    [num_stages, L/R, ...]}, "ln_f"}`` (JAX's); with ``rank`` only that
    stage, ``[1, L/R, ...]`` (what a rank keeps)."""
    lps = _layers_per_stage(cfg, num_stages)
    layers = params["layers"]
    stages = range(num_stages) if rank is None else (rank,)
    stacked = {name: torch.stack([torch.stack([layers[s * lps + i][name] for i in range(lps)])
                                  for s in stages])
               for name in layers[0]}
    return {"stages": stacked, "ln_f": params["ln_f"]}


def _stage_layers(pp_params: dict, rank: int) -> list[dict]:
    """This rank's layers as ``llama._stack`` takes them (views)."""
    stages = pp_params["stages"]
    lead = next(iter(stages.values()))
    s = rank if lead.shape[0] > 1 else 0
    return [{name: w[s, i] for name, w in stages.items()} for i in range(lead.shape[1])]


def init_kv_cache_pp(cfg: llama.LlamaConfig, num_pages: int, num_stages: int,
                     dtype=torch.float32, device="cuda") -> list[tuple]:
    """This rank's stage slice of the paged KV pool: ``L/R`` layers' ``(k,
    v)`` of ``[pages, Hkv, page, D]`` (JAX's ``[num_stages, L/R, ...]`` pool
    is this on every rank of its ``pp`` axis), int8 when ``cfg`` says so."""
    lps = _layers_per_stage(cfg, num_stages)
    return llama.init_kv_cache(dataclasses.replace(cfg, num_layers=lps), num_pages, dtype,
                               device=device)


def _pp(cfg, pp_params, x, positions, caches, slot_mapping, attend, group, plain):
    r, me = group_size(group), group_rank(group)
    layers = _stage_layers(pp_params, me)
    h = x
    for step in range(r):
        if step == me:
            h, caches = llama._stack(cfg, layers, h, positions, caches,
                                     llama._write(slot_mapping), attend, None, None, None, None,
                                     plain)
        if step < r - 1:
            h = ring_permute(h, group)
    h = broadcast(h, r - 1, group)
    return llama._final_norm(cfg, pp_params, h, plain), caches


def decode_step_pp(cfg: llama.LlamaConfig, pp_params: dict, x, positions, caches, block_tables,
                   context_lens, slot_mapping, *, group, plain: bool = False):
    """One PP decode step: ``[B, hidden]`` → ``(final-normed [B, hidden],
    this rank's caches)``, the caches updated in place."""
    attend = llama._decode_attend(cfg, block_tables, context_lens, plain)
    return _pp(cfg, pp_params, x, positions, caches, slot_mapping, attend, group, plain)


def prefill_step_pp(cfg: llama.LlamaConfig, pp_params: dict, x, seq_lens, caches, block_tables,
                    context_lens, slot_mapping, *, group, max_q: int | None = None,
                    plain: bool = False):
    """Varlen (chunked) prefill through the stages: ``x [S, hidden]``
    packed rows, as :func:`models.llama.prefill_step`."""
    s = x.shape[0]
    positions = llama._prefill_positions(seq_lens, context_lens, s, x.device)
    attend = llama._prefill_attend(cfg, s, seq_lens, block_tables, context_lens, max_q,
                                   plain=plain)
    return _pp(cfg, pp_params, x, positions, caches, slot_mapping, attend, group, plain)
