"""One rank of ``test_torch_ep_two_ranks.py`` (not a test module: the test
starts two of these processes).

    python tests/_torch_ep_ranks.py <work dir> <rank>

Reads ``inputs.pkl`` from the work directory, joins a two-rank gloo group
through a ``FileStore`` there (no port of its own to pick; gloo's pair
connections use the loopback), runs its task on this rank's share of the
inputs and writes ``rank<r>.pkl``: by default the port's ``Buffer``
methods (on the three transports; ``fused_deep_moe`` unfused and as K16b's
plain version) and the expert-parallel ``train_forward``; ``"unequal"``
the ``Buffer`` calls on unequal token counts; ``"fused_kernel"`` K16a's
plain version and its routed wrapper.  Imports torch and the port, never
JAX.
"""

import pathlib
import pickle
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)


def main(work: pathlib.Path, rank: int) -> None:
    inp = pickle.loads((work / "inputs.pkl").read_bytes())
    dist.init_process_group("gloo", store=dist.FileStore(str(work / "store"), 2), rank=rank,
                            world_size=2)
    task = inp.get("task")
    out = (unequal_tokens(rank) if task == "unequal" else
           fused_kernel_task(inp, rank) if task == "fused_kernel" else buffer_task(inp, rank))
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    dist.destroy_process_group()


def unequal_tokens(rank: int) -> dict:
    """``Buffer.dispatch`` and ``Buffer.fused_deep_moe`` on 4 tokens (rank
    0) and 6 (rank 1): the ``ValueError`` messages each call raised."""
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer

    t, h, e, i = 4 + 2 * rank, 128, 4, 64
    x = torch.randn((t, h))
    idx = torch.stack([torch.randperm(e)[:2] for _ in range(t)]).to(torch.int32)
    w = torch.full((t, 2), 0.5)
    wq = (torch.zeros((e, h, 2 * i), dtype=torch.int8), torch.ones((e, 2 * i)),
          torch.zeros((e, i, h), dtype=torch.int8), torch.ones((e, h)))
    buf = Buffer(None, num_experts=e)
    errors = []
    for call in (lambda: buf.dispatch(x, idx), lambda: buf.fused_deep_moe(x, idx, w, *wq)):
        try:
            call()
        except ValueError as err:
            errors.append(str(err))
    return {"errors": errors}


def fused_kernel_task(inp: dict, rank: int) -> dict:
    """K16a's plain version on this rank's ``xsend`` and scales, then the
    routed wrapper on this rank's half of the tokens."""
    from sgl_kernel_npu_tpu_torch.parallel import fused_kernel
    from sgl_kernel_npu_tpu_torch.parallel.ep_core import make_routing_plan

    xs = torch.from_numpy(inp["xsend"][rank].copy())
    w1, sw = torch.from_numpy(inp["w1"]), torch.from_numpy(inp["sw"])
    out = fused_kernel.fused_dispatch_gmm1_rank(
        xs, w1, sw, torch.from_numpy(inp["sx"][rank].copy()), num_ranks=2, seg=inp["seg"])
    rt = inp["routed"]
    t = rt["x"].shape[0] // 2
    mine = slice(rank * t, (rank + 1) * t)
    e_local = rt["e"] // 2
    local = slice(rank * e_local, (rank + 1) * e_local)
    idx = torch.from_numpy(rt["idx"][mine].copy())
    r_out, counts, _ = fused_kernel.fused_dispatch_gmm1(
        torch.from_numpy(rt["x"][mine].copy()), idx, torch.from_numpy(rt["w1"][local].copy()),
        torch.from_numpy(rt["sw"][local].copy()), num_experts=rt["e"], num_ranks=2,
        seg_capacity=rt["seg"])
    sent = make_routing_plan(idx, num_experts=rt["e"], num_ranks=2, my_rank=rank,
                             pair_capacity=e_local * rt["seg"],
                             seg_capacity=rt["seg"]).counts_per_expert
    received = sent.clone()
    dist.all_reduce(received)
    return {"out": out.float().numpy(), "routed_out": r_out.float().numpy(),
            "routed_counts": counts.numpy(), "plan_counts": sent.numpy(),
            "received": received[local].numpy()}


def buffer_task(inp: dict, rank: int) -> dict:
    """The ``Buffer`` methods and ``train_forward`` of the main test."""
    from torch.distributed.device_mesh import init_device_mesh

    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tm
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer

    t = inp["x"].shape[0] // 2
    mine = slice(rank * t, (rank + 1) * t)

    def local(name, dtype=None):
        v = torch.from_numpy(inp[name][mine].copy())
        return v if dtype is None else v.to(dtype)

    out = {}
    for case in inp["cases"]:
        buf = Buffer(None, num_experts=inp["E"], config=EPConfig(**case["config"]))
        xs, sc, gs, handle, st = buf.dispatch(local("x"), local("idx"), use_int8=case["int8"])
        y = torch.from_numpy(case["y"][rank].copy())
        comb = buf.combine(y, local("w"), handle, out_dtype=torch.float32)
        out[case["name"]] = dict(xs=xs.float().numpy(), sc=None if sc is None else sc.numpy(),
                                 gs=gs.numpy(), counts=st["recv_count_matrix"].numpy(),
                                 dropped=int(st["num_dropped"]), combined=comb.numpy())
    deep = inp["deep"]
    dx, didx, dw = (torch.from_numpy(deep[k][mine].copy()) for k in ("x", "idx", "w"))
    for backend in ("xla", "pallas", "pallas_ragged"):
        buf = Buffer(None, num_experts=deep["E"], config=EPConfig(comm_backend=backend))
        for single in (False, True):
            o, gs, dropped = buf.fused_deep_moe(dx, didx, dw, *map(torch.from_numpy, deep["wq"]),
                                                single_kernel=single)
            out[f"deep-{backend}-{single}"] = dict(out=o.float().numpy(), gs=gs.numpy(),
                                                   dropped=int(dropped))
    buf = Buffer(None, num_experts=inp["E"])
    moe = inp["oai"]
    o, gs, dropped = buf.fused_oai_moe(local("x", torch.bfloat16), local("idx_live"), local("w"),
                                       *(torch.from_numpy(moe[k]) for k in
                                         ("w_gate_up", "b_gate_up", "w_down", "b_down")))
    out["oai"] = dict(out=o.float().numpy(), gs=gs.numpy(), dropped=int(dropped))

    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("dp", "ep"))
    cfg = tm.DeepSeekV3Config(**inp["train_cfg"])
    params, _, _, _ = tm.from_jax_params(inp["train_params"], device="cpu")
    tokens = torch.from_numpy(inp["tokens"][rank : rank + 1].copy())
    out["loss"] = float(tm.train_forward(cfg, params, tokens, mesh=mesh))
    try:
        tm.make_train_step(cfg, mesh)
        out["step_refused"] = ""
    except NotImplementedError as e:
        out["step_refused"] = str(e)
    return out


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1]), int(sys.argv[2]))
