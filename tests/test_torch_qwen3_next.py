"""Port parity: Qwen3-Next (``models/qwen3_next.py``): a GDN layer's
prefill / decode, the hybrid's steps, chunked prefill resuming its state,
against the JAX package (the engine: ``test_torch_qwen3_next_engine.py``).

Small widths (hidden 64; GDN 2 k / 4 v heads of 16; attention 4 q / 2 kv
heads of 32; 2 or 4 layers), JAX's weights through ``from_jax_params``, its
quantized weights through ``w8a8.from_jax_weights_q``.  The JAX side runs
its Pallas kernels in interpret mode, the port its plain versions.
Tolerances: f32 within 1e-4 of the largest value (the chunked rule's
inverse and state carry, and the attention, sum in another order), 2e-3
where W8A8 levels take part (a rounding tie moves a level) or the port's
own chunked and one-shot prefills are compared (JAX's test holds its own
at 2e-3), bf16 within 5e-2 (JAX's prefill returns the rule's output in
f32, so its residual turns f32 where the port's stays bf16); the engines'
greedy tokens equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, tt
from _torch_qwen3 import FULL, _cfgs, _close, _params, run_steps
from sgl_kernel_npu_tpu.models import qwen3_next as jm
from sgl_kernel_npu_tpu_torch.models import qwen3_next as tm

def test_gdn_layer_prefill_decode_match_jax():
    """A GDN layer (``init_weights``' layout): the chunked prefill of two
    16-token sequences (final conv and ssm states too), then decode steps
    over pools, against JAX's."""
    jcfg = jm.Qwen3NextConfig(hidden=64, num_k_heads=2, num_v_heads=4, head_k_dim=16,
                              head_v_dim=16, mlp_intermediate=128, chunk_size=8)
    tcfg = tm.Qwen3NextConfig(**dataclasses.asdict(jcfg))
    wnp = jax.tree.map(np.asarray, jm.init_weights(jax.random.key(0), jcfg))
    wj, wt = jax.tree.map(jx, wnp), {k: tt(v) for k, v in wnp.items()}
    assert set(wt) == set(tm.init_weights(tcfg, 0, device="cpu"))
    x = (np.random.default_rng(1).standard_normal((2, 13, 64)) * 0.5).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        oj, cj, sj = jax.jit(functools.partial(jm.prefill, jcfg))(wj, jx(x))
    ot, ct, st = tm.prefill(tcfg, wt, tt(x))
    _close(ot, oj, 1e-4)
    _close(ct, cj, 1e-5)
    _close(st, sj, 1e-4)
    pool_c = np.zeros((3, jcfg.qkv_dim, 3), np.float32)
    pool_s = np.zeros((3, 4, 16, 16), np.float32)
    idx = np.asarray([2, 0], np.int32)
    pcj, psj, pct, pst = jx(pool_c), jx(pool_s), tt(pool_c), tt(pool_s)
    dec = jax.jit(functools.partial(jm.decode_step, jcfg))
    for t in range(3):
        with jax.default_matmul_precision("float32"):
            yj, pcj, psj = dec(wj, jx(x[:, t]), pcj, psj, jx(idx))
        yt, pct, pst = tm.decode_step(tcfg, wt, tt(x[:, t]), pct, pst, tt(idx))
        _close(yt, yj, 1e-4)
    _close(pct, pcj, 1e-5)
    _close(pst, psj, 1e-4)
    assert not pst[1].any()


@pytest.mark.parametrize("mode", ["moe", "dense", "bf16"])
def test_hybrid_steps_match_jax(mode):
    """``hybrid_decode_step`` then ``hybrid_prefill_step`` on caches of random
    history: the published checkpoint's attention (``attn_gate``,
    ``qk_norm``, rotary on 16 of 32) with the MoE in f32; the lean dense
    config in f32 and bf16 (W8A8: ``test_torch_qwen3_next_engine.py``)."""
    fields = FULL if mode == "moe" else {}
    jcfg, tcfg = _cfgs(num_layers=2, **fields)
    jdt, tdt, rel = ((jnp.bfloat16, torch.bfloat16, 5e-2) if mode == "bf16"
                     else (None, torch.float32, 1e-4))
    jp, tp = _params(jcfg, 3, tdt, jdt)
    run_steps(jcfg, tcfg, jp, tp, 4, jdt, tdt, rel)


def test_init_hybrid_weights_shapes():
    """The port's own random weights (a generator of its own) have JAX's
    names and shapes layer by layer; ``w_lm`` when untied."""
    jcfg, tcfg = _cfgs(num_layers=4, attn_every=4, **FULL)
    with jax.default_matmul_precision("float32"):
        jp = jm.init_hybrid_weights(jax.random.key(0), jcfg)
    tp = tm.init_hybrid_weights(tcfg, 0, torch.bfloat16, device="cpu", untied_lm_head=True)
    assert tp["w_lm"].shape == (tcfg.hidden, tcfg.vocab_size)
    for lj, lt in zip(jp["layers"], tp["layers"]):
        assert set(lj) == set(lt) and lj["kind"] == lt["kind"]
        for k in lj:
            if k != "kind":
                assert tuple(lt[k].shape) == tuple(lj[k].shape) and lt[k].dtype == torch.bfloat16
    again = tm.init_hybrid_weights(tcfg, 0, torch.bfloat16, device="cpu")
    assert torch.equal(again["layers"][1]["moe_gate"], tp["layers"][1]["moe_gate"])
