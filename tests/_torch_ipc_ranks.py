"""One rank of ``test_torch_cuda_kernels.py::test_two_processes_on_one_card``
(not a test module: the test starts two of these processes on one GPU).

    python tests/_torch_ipc_ranks.py <work dir> <rank>

Joins a two-rank gloo group through a ``FileStore`` in the work directory,
makes the group's window (each process opens the other's by CUDA IPC), runs
K15a (``pallas_all_to_all``: the per-expert counts on one block, a 600 KB
payload on several), K15b (``pallas_ragged_all_to_all``), K16b
(``fused_deep_moe_full_rank``) and K16a (``fused_dispatch_gmm1_rank``) on
CUDA tensors, runs the same calls' plain versions on CPU copies over the same
group, and prints ``ok`` when they agree (K15a and K15b bit-exact, K15b on
the live rows and counts; K16b's counts and drops exact, its output within
1e-2 of a row's largest |value|; K16a within one bf16 ulp of each value);
then K15a on two groups of the same two ranks in turn, two windows in
flight, each call bit-exact.
"""

import pathlib
import sys

import torch
import torch.distributed as dist


def main(work: pathlib.Path, rank: int) -> None:
    from sgl_kernel_npu_tpu_torch.parallel import fused_full, fused_kernel
    from sgl_kernel_npu_tpu_torch.parallel import pallas_a2a as pa
    from sgl_kernel_npu_tpu_torch.parallel.fused_moe import quantize_expert_weights

    dist.init_process_group("gloo", store=dist.FileStore(str(work / "store"), 2), rank=rank,
                            world_size=2)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(100 + rank)
    # K15a: the per-expert counts (one block) and a payload of several blocks,
    # each peer's block through the window
    for x in (torch.randint(0, 1000, (2, 256), generator=gen).to(torch.int32),
              torch.randint(-128, 128, (2, 300, 1024), generator=gen).to(torch.int8)):
        got = pa.pallas_all_to_all(x.to(dev))
        want = pa.pallas_all_to_all_plain(x)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), tuple(x.shape)
    x = torch.randint(-128, 128, (2, 96, 1024), generator=gen).to(torch.int8)
    counts = torch.tensor([[0, 96], [37, 5]][rank], dtype=torch.int32)
    got, rc = pa.pallas_ragged_all_to_all(x.to(dev), counts.to(dev), chunk_rows=16)
    want, wrc = pa.pallas_ragged_all_to_all_plain(x, counts)
    torch.cuda.synchronize()
    assert torch.equal(rc.cpu(), wrc), (rc, wrc)
    for s in range(2):
        n = int(wrc[s])
        assert torch.equal(got[s, :n].cpu(), want[s, :n]), s

    wgen = torch.Generator(device="cpu").manual_seed(7)          # the same weights on both ranks
    w = quantize_expert_weights(*(torch.randn(s, generator=wgen) * 0.05
                                  for s in ((8, 256, 128), (8, 256, 128), (8, 128, 256))))
    t, k = 24, 4
    xs = torch.randn((t, 256), generator=gen).to(torch.bfloat16)
    idx = torch.argsort(torch.rand((t, 8), generator=gen), dim=-1)[:, :k].to(torch.int32)
    tw = torch.rand((t, k), generator=gen)
    local = [a[rank * 4:(rank + 1) * 4] for a in w]
    kw = dict(num_experts=8, num_ranks=2, seg_capacity=t)
    out, cnt, drop = fused_full.fused_deep_moe_full_rank(
        xs.to(dev), idx.to(dev), tw.to(dev), *(a.to(dev) for a in local), **kw)
    ref, wcnt, wdrop = fused_full.fused_deep_moe_full_rank(xs, idx, tw, *local, **kw)
    torch.cuda.synchronize()
    assert torch.equal(cnt.cpu(), wcnt) and int(drop) == int(wdrop) == 0
    err = (out.cpu().float() - ref.float()).abs().amax(-1) / ref.float().abs().amax(-1)
    assert float(err.max()) <= 1e-2, float(err.max())

    # K16a: this rank's placed rows to both ranks' windows, ragged counts
    seg, n = 16, 256
    xsend = torch.randint(-40, 40, (2, 4 * seg, 256), generator=gen).to(torch.int8)
    cnt = torch.randint(0, seg + 1, (2, 4), generator=gen).to(torch.int32)
    live = torch.arange(seg)[None, None, :] < cnt[:, :, None]
    xsend = torch.where(live.reshape(2, 4 * seg, 1), xsend, 0)
    w1 = torch.randint(-40, 40, (4, 256, n), generator=wgen).to(torch.int8)
    sw1 = torch.rand((4, n), generator=wgen) / 100
    sx = torch.rand((4, 2 * seg), generator=gen) / 10 + 0.01
    kw = dict(num_ranks=2, seg=seg)
    got = fused_kernel.fused_dispatch_gmm1_rank(xsend.to(dev), w1.to(dev), sw1.to(dev),
                                                sx.to(dev), counts=cnt.to(dev), **kw)
    ref = fused_kernel.fused_dispatch_gmm1_rank(xsend, w1, sw1, sx, counts=cnt, **kw)
    torch.cuda.synchronize()
    rel = (got.cpu().float() - ref.float()).abs() / ref.float().abs().clamp_min(1e-30)
    assert float(rel.max()) <= 2 ** -7, float(rel.max())

    # two windows in flight: a second group over the same two ranks has a
    # window and epochs of its own (no id pool, as JAX's collective ids are);
    # calls on the two groups interleave, each bit-exact
    second = dist.new_group([0, 1])
    card = torch.device("cuda", torch.cuda.current_device())
    for _ in range(3):
        for g in (None, second):
            x = torch.randint(-128, 128, (2, 64, 512), generator=gen).to(torch.int8)
            got = pa.pallas_all_to_all(x.to(dev), group=g)
            want = pa.pallas_all_to_all_plain(x, group=g)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want)
    first, other = pa.window(None, card), pa.window(second, card)
    assert first is not other and other.epoch == 3 and first.epoch > other.epoch
    print("ok", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1]), int(sys.argv[2]))
