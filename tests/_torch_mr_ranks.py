"""One rank of the port's multi-rank serving tests (not a test module: a
test starts ``world`` of these processes with :func:`start_ranks`).

    python tests/_torch_mr_ranks.py <work dir> <rank>

Reads ``inputs.pkl`` from the work directory, joins a gloo group of
``inputs["world"]`` ranks through a ``FileStore`` there, makes the groups
every task draws on (``dist.new_group``: the two halves and one group a
rank), runs ``inputs["task"]`` and writes ``rank<r>.pkl``: ``"ring"`` ring
attention and ``pipeline_forward`` (``test_torch_ring_pipeline.py``),
``"llama"`` the context- and pipeline-parallel Llama steps and engines
(``test_torch_llama_cp_pp.py``), ``"tp"`` DeepSeek-V3's head-parallel
decode (``test_torch_deepseek_tp.py``).  Imports torch and the port, never
JAX.
"""

import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

HERE = pathlib.Path(__file__).resolve().parent


def start_ranks(work: pathlib.Path, inputs: dict):
    """Write ``inputs`` and start its ``world`` rank processes; returns a
    function that waits for them (each within 120 s, every return code
    checked, a failing rank's log in the message) and gives their outputs.
    The caller computes its goldens in between."""
    (work / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    env = dict(os.environ, PYTHONPATH=str(HERE.parent), OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen([sys.executable, str(HERE / "_torch_mr_ranks.py"), str(work),
                               str(r)], cwd=HERE.parent, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(inputs["world"])]

    def wait() -> list[dict]:
        try:
            logs = [p.communicate(timeout=120)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
        return [pickle.loads((work / f"rank{r}.pkl").read_bytes())
                for r in range(inputs["world"])]

    return wait


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().numpy() if t.is_floating_point() else t.detach().numpy()


class Groups:
    """The groups of a run: ``of(size)`` is this rank's group of ``size``
    ranks (the world, its half, itself)."""

    def __init__(self, world: int, rank: int):
        self.rank = rank
        halves = [dist.new_group(list(range(h, h + world // 2)))
                  for h in range(0, world, world // 2)] if world > 2 else []
        ones = [dist.new_group([r]) for r in range(world)]
        self.by_size = {world: dist.group.WORLD, 1: ones[rank]}
        if halves:
            self.by_size[world // 2] = halves[rank // (world // 2)]

    def of(self, size: int):
        return self.by_size[size]


# ---------------------------------------------------------------------------
# ring attention and the pipeline
# ---------------------------------------------------------------------------

def _stage_fn(sp, x):
    return torch.tanh(x @ sp["w1"] + sp["b1"]) @ sp["w2"]


def ring_task(inp: dict, groups: Groups) -> dict:
    from sgl_kernel_npu_tpu_torch.parallel.pipeline import pipeline_forward
    from sgl_kernel_npu_tpu_torch.parallel.ring_attention import ring_attention_sharded

    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    out = {"ring": {}, "pipe": {}}
    for name, case in inp["ring"].items():
        q, k, v = (_t(case[n], dts[case["dtype"]]) for n in ("q", "k", "v"))
        for size in inp["sizes"]:
            got = ring_attention_sharded(q, k, v, group=groups.of(size), sm_scale=case["scale"],
                                         causal=case["causal"])
            out["ring"][name, size] = _np(got)
    for name, case in inp["pipe"].items():
        params = {n: _t(case[n]).requires_grad_() for n in ("w1", "b1", "w2")}
        y = pipeline_forward(_stage_fn, params, _t(case["x"]), group=groups.of(case["stages"]),
                             num_micro=case["num_micro"])
        (y * y).sum().backward()
        out["pipe"][name] = {"y": _np(y), **{n: _np(p.grad) for n, p in params.items()}}
    return out


# ---------------------------------------------------------------------------
# Llama: context and pipeline parallel
# ---------------------------------------------------------------------------

def _llama(inp, kv_cache_dtype="bf16"):
    from sgl_kernel_npu_tpu_torch.models import llama as tm

    cfg = dataclasses.replace(tm.LlamaConfig(**inp["cfg"]), kv_cache_dtype=kv_cache_dtype)
    return cfg, tm.from_jax_params(inp["params"], device="cpu")


def _caches(cache_np):
    return [tuple(_t(a) for a in layer) for layer in cache_np]


def _caches_np(caches):
    return [tuple(_np(t) for t in layer) for layer in caches]


def llama_task(inp: dict, groups: Groups) -> dict:
    from sgl_kernel_npu_tpu_torch.models import llama as tm
    from sgl_kernel_npu_tpu_torch.models import llama_pp as tpp
    from sgl_kernel_npu_tpu_torch.runtime.engine import Engine, llama_cp_adapter, llama_pp_adapter

    out = {"cp": {}, "pp": {}, "engine": {}}
    cp = inp["cp"]
    for kind in ("bf16", "int8"):
        cfg, params = _llama(inp, kind)
        for size in inp["cp_sizes"]:
            caches = _caches(cp["caches"][kind])
            h, caches = tm.prefill_step_cp(cfg, params, _t(cp["x"]), _t(cp["seq"]), caches,
                                           _t(cp["bt"]), _t(cp["seq"]), _t(cp["slots"]),
                                           group=groups.of(size))
            out["cp"][kind, size] = {"h": _np(h), "caches": _caches_np(caches)}
    cfg, params = _llama(inp)
    try:
        tm.prefill_step_cp(cfg, params, _t(cp["x"][:6]), _t(cp["seq"]),
                           _caches(cp["caches"]["bf16"]), _t(cp["bt"]), _t(cp["seq"]),
                           _t(cp["slots"][:6]), group=groups.of(4))
    except ValueError as err:
        out["cp_refusal"] = str(err)
    pp = inp["pp"]
    g2 = groups.of(pp["stages"])
    pp_params = tpp.stack_stage_params(cfg, params, pp["stages"], rank=groups.rank % 2)
    caches = tpp.init_kv_cache_pp(cfg, pp["num_pages"], pp["stages"], device="cpu")
    h_pre, caches = tpp.prefill_step_pp(cfg, pp_params, _t(pp["x_pre"]), _t(pp["seq"]), caches,
                                        _t(pp["bt"]), _t(pp["ctx_pre"]), _t(pp["slots_pre"]),
                                        group=g2, max_q=pp["x_pre"].shape[0])
    h_dec, caches = tpp.decode_step_pp(cfg, pp_params, _t(pp["x_dec"]), _t(pp["pos"]), caches,
                                       _t(pp["bt"]), _t(pp["ctx_dec"]), _t(pp["slots_dec"]),
                                       group=g2)
    out["pp"] = {"prefill": _np(h_pre), "decode": _np(h_dec), "caches": _caches_np(caches)}
    eng = inp["engine"]
    for name, make, size in (("cp", llama_cp_adapter, eng["cp_ranks"]),
                             ("pp", llama_pp_adapter, eng["pp_ranks"])):
        adapter = make(cfg, params, groups.of(size), device="cpu")
        engine = Engine(adapter, device="cpu", **eng[name + "_kw"])
        out["engine"][name] = engine.run(eng["prompts"], eng["new_tokens"])
    # one request after another that shares its first pages: no prefix match
    engine = Engine(llama_cp_adapter(cfg, params, groups.of(eng["cp_ranks"]), device="cpu"),
                    device="cpu", **eng["cp_kw"])
    out["engine"]["cp_reuse"] = {
        "tokens": [engine.run([p], eng["new_tokens"])[0] for p in eng["reuse_prompts"]],
        "cached": engine.stats["cached_tokens"]}
    return out


# ---------------------------------------------------------------------------
# DeepSeek-V3: head-parallel decode
# ---------------------------------------------------------------------------

def tp_task(inp: dict, groups: Groups) -> dict:
    from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tm

    out = {}
    for kind, case in inp["cases"].items():
        cfg = tm.DeepSeekV3Config(**case["cfg"])
        params, _, _, _ = tm.from_jax_params(inp["params"], device="cpu")
        size = inp["tp"]
        mine = {**params, "layers": [tm.tp_shard_layer(lw, groups.rank % size, size)
                                     for lw in params["layers"]]}
        caches = [{n: _t(a) for n, a in layer.items()} for layer in case["caches"]]
        args = (_t(inp["hidden"]), _t(inp["pos"]), caches, _t(inp["bt"]), _t(inp["seq"]),
                _t(inp["slots"]))
        h, caches = tm.decode_step_tp(cfg, mine, *args, group=groups.of(size))
        out[kind] = {"h": _np(h), "caches": [{n: _np(t) for n, t in layer.items()}
                                             for layer in caches]}
    return out


TASKS = {"ring": ring_task, "llama": llama_task, "tp": tp_task}


def main(work: pathlib.Path, rank: int) -> None:
    torch.set_num_threads(1)
    inp = pickle.loads((work / "inputs.pkl").read_bytes())
    world = inp["world"]
    dist.init_process_group("gloo", store=dist.FileStore(str(work / "store"), world), rank=rank,
                            world_size=world)
    out = TASKS[inp["task"]](inp, Groups(world, rank))
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1]), int(sys.argv[2]))
