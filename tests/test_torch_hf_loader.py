"""Port parity: ``utils/hf_loader`` (the four ``transformers`` converters)
against the JAX package's converters and the ``transformers`` forward.

Tiny random ``transformers`` models, JAX's ``tests/test_hf_parity.py``
configurations and seeds.  Each port converter's config equals JAX's
converter's field for field, and its params equal JAX's converted params
(through the port's ``from_jax_params``) bit for bit.  The port's paged
varlen prefill (plain versions on the CPU) reproduces the ``transformers``
logits at JAX's tolerances: Llama 2e-4, DeepSeek-V3 and GPT-OSS 5e-4,
Qwen3-Next 2e-3."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import port_config
from sgl_kernel_npu_tpu.utils import hf_loader as jh
from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tds
from sgl_kernel_npu_tpu_torch.models import gpt_oss as tgo
from sgl_kernel_npu_tpu_torch.models import llama as tll
from sgl_kernel_npu_tpu_torch.models import qwen3_next as tqn
from sgl_kernel_npu_tpu_torch.utils import hf_loader as th

transformers = pytest.importorskip("transformers")

IDS = [1, 5, 9, 2, 33, 17, 4, 60, 21, 7]


def _hf(name, seed, **kw):
    cfg = getattr(transformers, name + "Config")(**kw)
    torch.manual_seed(seed)
    model = getattr(transformers, name + "ForCausalLM")(cfg).eval()
    return model


def _llama(tied):
    return _hf("Llama", 3, vocab_size=64, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=128, rope_theta=10000.0, tie_word_embeddings=tied,
               attention_bias=False, mlp_bias=False)


def _deepseek():
    model = _hf("DeepseekV3", 11, vocab_size=64, hidden_size=64, intermediate_size=128,
                moe_intermediate_size=32, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, n_routed_experts=8, num_experts_per_tok=2,
                n_shared_experts=1, n_group=2, topk_group=1, routed_scaling_factor=2.5,
                norm_topk_prob=True, first_k_dense_replace=0, kv_lora_rank=32,
                q_lora_rank=48, qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
                max_position_embeddings=128, rope_theta=10000.0)
    with torch.no_grad():
        for layer in model.model.layers:
            layer.mlp.gate.e_score_correction_bias.uniform_(-0.05, 0.05)
    return model


def _gpt_oss():
    return _hf("GptOss", 7, vocab_size=64, hidden_size=64, intermediate_size=48,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               num_local_experts=4, num_experts_per_tok=2, sliding_window=6,
               max_position_embeddings=128, tie_word_embeddings=False)


def _qwen3_next():
    return _hf("Qwen3Next", 13, vocab_size=64, hidden_size=64, intermediate_size=96,
               num_hidden_layers=4,
               layer_types=["linear_attention"] * 3 + ["full_attention"],
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               partial_rotary_factor=0.25, linear_num_key_heads=2, linear_num_value_heads=4,
               linear_key_head_dim=16, linear_value_head_dim=16, linear_conv_kernel_dim=4,
               num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
               shared_expert_intermediate_size=32, norm_topk_prob=True,
               decoder_sparse_step=1, mlp_only_layers=[], max_position_embeddings=128,
               tie_word_embeddings=False)


def _paged(cfg, n):
    pages = -(-n // cfg.page_size)
    bt = torch.arange(1, pages + 1, dtype=torch.int32)[None]
    seq = torch.tensor([n], dtype=torch.int32)
    slots = torch.tensor([int(bt[0, t // cfg.page_size]) * cfg.page_size + t % cfg.page_size
                          for t in range(n)], dtype=torch.int32)
    return pages + 1, bt, seq, slots


def _logits(kind, cfg, params, ids):
    x_ids = torch.tensor(ids, dtype=torch.int32)
    n = len(ids)
    num_pages, bt, seq, slots = _paged(cfg, n)
    if kind == "llama":
        caches = tll.init_kv_cache(cfg, num_pages, device="cpu")
        h, _ = tll.prefill_step(cfg, params, tll.embed(params, x_ids), seq, caches, bt, seq,
                                slots, max_q=max(8, n))
        return tll.lm_head(params, h)
    if kind == "deepseek":
        caches = tds.init_kv_cache(cfg, num_pages, torch.float32, device="cpu")
        h, _ = tds.prefill_step(cfg, params, tds.embed(params, x_ids), seq, caches, bt, seq,
                                slots, max_q=max(8, n))
        return tds.lm_head(params, h)
    if kind == "gpt_oss":
        caches = tgo.init_kv_cache(cfg, num_pages, device="cpu")
        h, _ = tgo.prefill_step(cfg, params, tgo.embed(params, x_ids), seq, caches, bt, seq,
                                slots, max_q=16)
        return tgo.lm_head(params, h)
    caches = tqn.init_hybrid_cache(cfg, 16, 2, device="cpu")
    h, _ = tqn.hybrid_prefill_step(cfg, params, tqn.hybrid_embed(params, x_ids), seq, caches, bt,
                                   seq, slots, torch.tensor([0], dtype=torch.int32), max_q=16)
    return tqn.hybrid_lm_head(params, h)


def _from_jax(kind, jparams):
    np_params = jax.tree.map(np.asarray, jparams)
    if kind == "llama":
        return tll.from_jax_params(np_params, device="cpu")
    if kind == "deepseek":
        return tds.from_jax_params(np_params, device="cpu")[0]
    if kind == "gpt_oss":
        return tgo.from_jax_params(np_params, device="cpu")
    return tqn.from_jax_params(np_params, device="cpu")


def _equal(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=path)
    else:
        assert got == want, (path, got, want)


MODELS = {
    "llama-tied": ("llama", lambda: _llama(True), jh.llama_from_hf, th.llama_from_hf,
                   tll.LlamaConfig, 2e-4),
    "llama-untied": ("llama", lambda: _llama(False), jh.llama_from_hf, th.llama_from_hf,
                     tll.LlamaConfig, 2e-4),
    "deepseek_v3": ("deepseek", _deepseek, jh.deepseek_v3_from_hf, th.deepseek_v3_from_hf,
                    tds.DeepSeekV3Config, 5e-4),
    "gpt_oss": ("gpt_oss", _gpt_oss, jh.gpt_oss_from_hf, th.gpt_oss_from_hf, tgo.GptOssConfig,
                5e-4),
    "qwen3_next": ("qwen3_next", _qwen3_next, jh.qwen3_next_from_hf, th.qwen3_next_from_hf,
                   tqn.Qwen3NextHybridConfig, 2e-3),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_converter_matches_jax_and_transformers(name):
    kind, make, jconv, tconv, tcls, tol = MODELS[name]
    model = make()
    ids = IDS + ([40, 3] if kind == "qwen3_next" else [])
    with torch.no_grad():
        want = model(torch.tensor([ids])).logits[0].float().numpy()
    jcfg, jparams = jconv(model, page_size=4)
    cfg, params = tconv(model, page_size=4, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(port_config(jcfg, tcls))
    _equal(params, _from_jax(kind, jparams))
    with torch.no_grad():
        got = _logits(kind, cfg, params, ids).float().numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_converters_take_dtype_and_refuse_unmapped_layouts():
    model = _llama(False)
    cfg, params = th.llama_from_hf(model, dtype=torch.bfloat16, device="cpu")
    assert params["w_lm"].dtype == torch.bfloat16
    assert params["layers"][0]["wq"].shape == (cfg.hidden,
                                                                 cfg.num_heads * cfg.head_dim)
    ds = _deepseek()
    ds.config.first_k_dense_replace = 1
    with pytest.raises(NotImplementedError, match="dense layers"):
        th.deepseek_v3_from_hf(ds, device="cpu")
    go = _gpt_oss()
    go.config.layer_types = ["full_attention", "sliding_attention"]
    with pytest.raises(NotImplementedError, match="alternation"):
        th.gpt_oss_from_hf(go, device="cpu")
