"""One rank of the port's multi-process tests (not a test module: a test
starts ``world`` of these processes, ``test_torch_ep_two_ranks.run_ranks``).

    python tests/_torch_ep_ranks.py <work dir> <rank>

Reads ``inputs.pkl`` from the work directory, joins a gloo group of
``inputs["world"]`` ranks (2 by default) through a ``FileStore`` there (no
port of its own to pick; gloo's pair connections use the loopback), runs
its task on this rank's share of the inputs and writes ``rank<r>.pkl``: by
default the port's ``Buffer`` methods (on the three transports;
``fused_deep_moe`` unfused and as K16b's plain version) and the
expert-parallel ``train_forward``; ``"unequal"`` the ``Buffer`` calls on
unequal token counts; ``"fused_kernel"`` K16a's plain version and its
routed wrapper; ``"modes"`` the low-latency mode, multi-round dispatch, the
placements, the TP all-gather, both modes on one buffer and the validated
exchange with planted faults (``test_torch_ep_modes.py``); ``"layered"``
the two-tier dispatch / combine on a (node, ici) grid of four ranks
(``test_torch_layered.py``).  Imports torch and the port, never JAX.
"""

import contextlib
import pathlib
import pickle
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)


def main(work: pathlib.Path, rank: int) -> None:
    inp = pickle.loads((work / "inputs.pkl").read_bytes())
    world = inp.get("world", 2)
    dist.init_process_group("gloo", store=dist.FileStore(str(work / "store"), world), rank=rank,
                            world_size=world)
    task = inp.get("task")
    out = (unequal_tokens(rank) if task == "unequal" else
           fused_kernel_task(inp, rank) if task == "fused_kernel" else
           modes_task(inp, rank) if task == "modes" else
           layered_task(inp, rank) if task == "layered" else buffer_task(inp, rank))
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


def _np(v):
    return None if v is None else v.float().numpy() if v.is_floating_point() else v.numpy()


def modes_task(inp: dict, rank: int) -> dict:
    """The low-latency mode on each transport, multi-round dispatch (and one
    round), ``rank_remap``, ``shared_expert_layout``, the TP all-gather at
    TP 2 (the two ranks one TP group, each its own EP group) and both modes
    on one buffer, on this rank's half of the tokens."""
    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.parallel import ep_core
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer, MultiRoundHandle

    e = inp["E"]
    el = e // 2
    t = inp["x"].shape[0] // 2
    mine, experts = slice(rank * t, (rank + 1) * t), slice(rank * el, (rank + 1) * el)
    x, idx, w = (torch.from_numpy(inp[k][mine].copy()) for k in ("x", "idx", "w"))
    out = {}
    for case in inp["ll"]:
        buf = Buffer(None, num_experts=e, config=EPConfig(**case["config"]))
        mon = case["config"].get("comm_backend") == "pallas_ragged"
        rx, sc, cnt, h, st = buf.low_latency_dispatch(x, idx, use_int8=case["int8"],
                                                      monitor=mon, validate=True)
        y = torch.from_numpy(case["y"][experts].copy())
        comb = buf.low_latency_combine(y, w, h, out_dtype=torch.float32, monitor=mon)
        comb, cst = comb if mon else (comb, {})
        out["ll-" + case["name"]] = dict(
            rx=_np(rx), sc=_np(sc), cnt=_np(cnt), counts=_np(st["recv_count_matrix"]),
            dropped=int(st["num_dropped"]), combined=_np(comb),
            vflags=_np(st["validation_flags"]), tflags=_np(st.get("timeout_flags")),
            ctflags=_np(cst.get("timeout_flags")))
    mr = inp["mr"]
    for backend in ("xla", "pallas_ragged"):
        buf = Buffer(None, num_experts=e, config=EPConfig(comm_backend=backend, **mr["config"]))
        xs, sc, gs, h, st = buf.dispatch(x, idx)
        assert isinstance(h, MultiRoundHandle) and h.rounds == 2, h
        comb = buf.combine((xs.float() * sc[:, None]) * 3.0, w, h, out_dtype=torch.float32)
        xs1, sc1, gs1, h1, _ = buf.dispatch(x, idx, rounds=1)
        comb1 = buf.combine((xs1.float() * sc1[:, None]) * 3.0, w, h1, out_dtype=torch.float32)
        out["mr-" + backend] = dict(xs=_np(xs), sc=_np(sc), gs=_np(gs),
                                    counts=_np(st["recv_count_matrix"]),
                                    dropped=int(st["num_dropped"]), combined=_np(comb),
                                    gs1=_np(gs1), combined1=_np(comb1))
    pair, seg = t * idx.shape[1], t
    d = ep_core.dispatch_core(x, idx, group=None, num_experts=e, num_ranks=2, pair_capacity=pair,
                              seg_capacity=seg, use_int8=False,
                              rank_remap=torch.from_numpy(inp["remap"]))
    out["remap"] = dict(rx=_np(d["recv_x"]), counts=_np(d["recv_count_matrix"]),
                        dropped=int(d["num_dropped"]))
    sh = inp["shared"]
    owner, slot, slots = ep_core.shared_expert_layout(sh["E"], 2, 1, device="cpu")
    sidx = torch.cat([torch.from_numpy(sh["idx"][mine].copy()),
                      torch.full((t, 1), sh["E"], dtype=torch.int32)], dim=1)
    sw = torch.cat([w[:, :sh["idx"].shape[1]], torch.ones((t, 1))], dim=1)
    d = ep_core.dispatch_core(x, sidx, group=None, num_experts=sh["E"], num_ranks=2,
                              pair_capacity=t * sidx.shape[1], seg_capacity=t, use_int8=False,
                              expert_owner=owner, expert_slot=slot, num_local_slots=slots)
    scale = (torch.full((slots,), 100.0) if rank < 1 else
             ((rank - 1) * slots + torch.arange(slots) + 1).float())
    comb = ep_core.combine_core(d["recv_x"] * scale[:, None, None], sw, d["handle"], group=None,
                                num_ranks=2, seg_capacity=t, out_dtype=torch.float32)
    out["shared"] = dict(combined=_np(comb), dropped=int(d["num_dropped"]), layout=(
        owner.numpy(), slot.numpy(), slots))
    # TP 2 x EP 1: every process makes both one-rank EP groups, in order
    ep_groups = [dist.new_group([r]) for r in (0, 1)]
    tp = inp["tp"]
    tx, tidx, tw = (torch.from_numpy(tp[k][mine].copy()) for k in ("x", "idx", "w"))
    d = ep_core.dispatch_core(tx, tidx, group=ep_groups[rank], num_experts=tp["E"], num_ranks=1,
                              pair_capacity=t * tidx.shape[1], seg_capacity=t, use_int8=True)
    gx, gsc, gcnt = ep_core.dispatch_tp_allgather(d["recv_x"], d["recv_scales"],
                                                  d["recv_count_matrix"], tp_group=None)
    eid = (torch.arange(tp["E"]) + 1).float()
    y_part = gx.float() * gsc[..., None] * (eid[:, None, None] / 2)
    y_mine = ep_core.combine_tp_reduce(y_part, tp_group=None, seg_total=t)
    comb = ep_core.combine_core(y_mine, tw, d["handle"], group=ep_groups[rank], num_ranks=1,
                                seg_capacity=t, out_dtype=torch.float32)
    out["tp"] = dict(combined=_np(comb), counts=_np(gcnt), gathered=_np(gx))
    both = inp["both"]
    buf = Buffer(None, num_experts=e, config=EPConfig(**both["config"]))
    bidx, bw = (torch.from_numpy(both[k][mine].copy()) for k in ("idx", "w"))
    xs, _, _, h_n, _ = buf.dispatch(x, bidx)
    norm_out = buf.combine(xs.float(), bw, h_n, out_dtype=torch.float32)
    rx, _, _, h_l, _ = buf.low_latency_dispatch(x, bidx)
    ll_out = buf.low_latency_combine(rx.float() * 2.0, bw, h_l, out_dtype=torch.float32)
    out["both"] = dict(norm=_np(norm_out), ll=_np(ll_out))
    out.update(fault_drills(x, idx, e, rank))
    return out


@contextlib.contextmanager
def _wrapped(module, name, wrap):
    """``module.name`` replaced by ``wrap(module.name)`` for the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def fault_drills(x, idx, e: int, rank: int) -> dict:
    """The validated int8 low-latency dispatch with a fault planted in what a
    transport delivers.  ``"fault-<backend>"``: on each transport, rank 0
    receives source 1's first row with one bit flipped (only source 1's flag
    at rank 0 may rise).  ``"stale"``: on ``"pallas_ragged"``, every row
    past a source's received count holds garbage, in the payload and in the
    slot / scale blob (the flags stay 0, the packed rows and scales are the
    clean call's)."""
    from sgl_kernel_npu_tpu_torch.config import EPConfig
    from sgl_kernel_npu_tpu_torch.parallel import ep_core
    from sgl_kernel_npu_tpu_torch.parallel.buffer import Buffer

    hidden = x.shape[1]
    garbled = []                     # rows past the counts, a ragged exchange

    def flip(recv):
        if rank == 0:
            recv = recv.clone()
            recv.view(torch.uint8)[1, 0, 0] ^= 1
        return recv

    def equal_blocks(orig):          # "xla" / "pallas": the [R, C, H] payload only
        return lambda v, *a, **kw: (flip(orig(v, *a, **kw)) if v.dim() == 3
                                    and v.shape[-1] == hidden else orig(v, *a, **kw))

    def ragged(fault):
        def wrap(orig):
            def call(v, counts, **kw):
                res = orig(v, counts, **kw)
                if v.dim() != 3:
                    return res
                if fault == "flip":
                    got = flip(res[0]) if v.shape[-1] == hidden else res[0]
                else:                # garbage past each source's count, payload and blob
                    got = res[0].clone()
                    for s, n in enumerate(res[1].tolist()):
                        got.view(torch.uint8)[s, n:] = 0x5A
                    garbled.append(got.shape[0] * got.shape[1] - int(res[1].sum()))
                return (got,) + tuple(res[1:])
            return call
        return wrap

    drills = {"fault-xla": ("xla", "_exchange", equal_blocks),
              "fault-pallas": ("pallas", "pallas_all_to_all", equal_blocks),
              "fault-pallas_ragged": ("pallas_ragged", "pallas_ragged_all_to_all", ragged("flip")),
              "stale": ("pallas_ragged", "pallas_ragged_all_to_all", ragged("stale"))}
    out = {}
    for name, (backend, target, wrap) in drills.items():
        buf = Buffer(None, num_experts=e, config=EPConfig(comm_backend=backend))
        clean = buf.low_latency_dispatch(x, idx, use_int8=True, validate=True)
        with _wrapped(ep_core, target, wrap):
            rx, sc, _, _, st = buf.low_latency_dispatch(x, idx, use_int8=True, validate=True)
        out[name] = dict(vflags=_np(st["validation_flags"]),
                         clean_vflags=_np(clean[4]["validation_flags"]),
                         counts=_np(st["recv_count_matrix"]),
                         same_rows=torch.equal(rx, clean[0]) and torch.equal(sc, clean[1]))
    out["stale"]["garbled"] = garbled
    return out


def _grid_groups(n_nodes: int, p: int, rank: int) -> dict:
    """The node and ICI groups of this rank on an ``n_nodes`` x ``p`` grid
    (global rank = node · p + ici; no ICI group at one rank a node).  Every
    process makes every group, in the same order."""
    node_groups = [dist.new_group([i + j * p for j in range(n_nodes)]) for i in range(p)]
    ici_groups = [dist.new_group([j * p + i for i in range(p)]) for j in range(n_nodes)]
    node, ici = divmod(rank, p)
    return dict(node_group=node_groups[ici], ici_group=ici_groups[node] if p > 1 else None,
                num_nodes=n_nodes, ranks_per_node=p)


def layered_task(inp: dict, rank: int) -> dict:
    """``parallel/layered`` on the (node, ici) grid of ``inp["grid"]`` (a
    case's own ``grid`` where it names one): each case's dispatch, its
    expert step (y = dequant(recv_x) · (global expert id + 1)) and combine,
    on this rank's tokens."""
    from sgl_kernel_npu_tpu_torch.parallel import layered
    from sgl_kernel_npu_tpu_torch.parallel.ep_core import sorted_row_expert

    grids = {tuple(g): _grid_groups(*g, rank)
             for g in dict.fromkeys([tuple(inp["grid"])] + [tuple(c["grid"]) for c in
                                                            inp["cases"] if "grid" in c])}
    e, t = inp["E"], inp["T"]
    el = e // dist.get_world_size()
    mine = slice(rank * t, (rank + 1) * t)
    eid = (rank * el + torch.arange(el) + 1).float()
    out = {}
    for case in inp["cases"]:
        kw = grids[tuple(case.get("grid", inp["grid"]))]
        n_nodes = kw["num_nodes"]
        x = torch.from_numpy(inp["x"][mine].copy())
        idx = torch.from_numpy(case["idx"][mine].copy())
        w = torch.full(idx.shape, 1.0 / idx.shape[1])
        opts = dict(num_experts=e, phase1_capacity=t, phase2_capacity=n_nodes * t * idx.shape[1],
                    seg_capacity=t, **case["opts"], **kw)
        comb_kw = dict(seg_capacity=t, num_tokens=t, out_dtype=torch.float32, **kw)
        if case["normal"]:
            d = layered.dispatch_layered_normal(x, idx, **opts)
            e_of_row, live = sorted_row_expert(d["group_sizes"], d["recv_x_sorted"].shape[0])
            deq = d["recv_x_sorted"].float() * d["recv_scales_sorted"][:, None]
            y = torch.where(live[:, None], deq * eid[e_of_row][:, None], 0.0)
            comb = layered.combine_layered_normal(y, w, d["handle"], **comb_kw)
            rx, sc = d["recv_x_sorted"], d["recv_scales_sorted"]
        else:
            d = layered.dispatch_layered(x, idx, **opts)
            rx, sc = d["recv_x"], d.get("recv_scales")
            deq = rx.float() * (sc[..., None] if sc is not None else 1.0)
            comb = layered.combine_layered(deq * eid[:, None, None], w, d["handle"], **comb_kw)
        stats = {k: (_np(v) if isinstance(v, torch.Tensor) else v)
                 for k, v in d.get("stats", {}).items()}
        out[case["name"]] = dict(rx=_np(rx), sc=_np(sc), cnt=_np(d["recv_count_matrix"]),
                                 dcn=_np(d["dcn_rows"]), dropped=int(d["num_dropped"]),
                                 combined=_np(comb), stats=stats)
    return out


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
