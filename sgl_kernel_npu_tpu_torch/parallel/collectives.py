"""Rank-to-rank exchanges on a ``torch.distributed`` group: the port's
counterparts of JAX's ``ppermute`` and ``psum`` inside ``shard_map``.

Each process is one rank and passes its own slice; ``group`` is the caller's
process group (None: the default group).  On a group of one rank every
function returns its input and launches nothing, as JAX's collectives over a
one-device axis are the identity.

:func:`ring_permute` (rank r sends to ``(r + shift) mod R``) and
:func:`all_sum` are autograd functions: the permute's gradient is the
permute back, and :func:`all_sum` takes its result as replicated (every rank
computes the same loss from it), so its gradient passes each rank's own
through.  :func:`all_gather` and :func:`broadcast` carry no gradient.

Host staging: gloo takes CUDA tensors in few collectives (``send`` /
``recv``, ``all_gather`` and ``all_to_all`` are CPU only; its CUDA
``all_reduce`` copies through the host itself).  So on a gloo group a CUDA
tensor is copied to the host, exchanged there and copied back, chosen by the
group's backend, never after a failure; :func:`staged_bytes` counts the
bytes copied each way.  On an NCCL group the tensors move device to device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_STAGED = [0]


def staged_bytes() -> int:
    """Bytes copied between the card and the host for gloo exchanges since
    :func:`reset_staged` (device → host and host → device both counted)."""
    return _STAGED[0]


def reset_staged() -> None:
    _STAGED[0] = 0


def group_size(group) -> int:
    if group is None and not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group) -> int:
    if group is None and not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def _peer(group, rank: int) -> int:
    """The global rank of ``rank`` of ``group`` (point-to-point ops take global ranks)."""
    return rank if group is None else dist.get_global_rank(group, rank)


def _to_wire(group, t: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """``t`` as the group's backend takes it: a host copy of a CUDA tensor on
    gloo; with ``copy`` never ``t``'s own storage (for the in-place
    collectives), otherwise ``t`` itself where the backend takes it."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        _STAGED[0] += t.numel() * t.element_size()
        return t.contiguous().cpu()
    return t.clone(memory_format=torch.contiguous_format) if copy else t.contiguous()


def _from_wire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if t.device == like.device:
        return t
    _STAGED[0] += t.numel() * t.element_size()
    return t.to(like.device)


def _permute(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    r = group_size(group)
    me = group_rank(group)
    send = _to_wire(group, t)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _peer(group, (me + shift) % r), group),
           dist.P2POp(dist.irecv, recv, _peer(group, (me - shift) % r), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _from_wire(recv, t)


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    wire = _to_wire(group, t, copy=True)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    return _from_wire(wire, t)


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(t, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, -ctx.shift), None, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ring_permute(t: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """JAX's ``ppermute`` with ``perm = [(i, (i + shift) % R)]``: this rank's
    ``t`` goes to rank ``me + shift``, and the result is rank ``me - shift``'s
    (same shape and dtype on every rank)."""
    if group_size(group) == 1:
        return t
    return _RingPermute.apply(t, group, shift)


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """JAX's ``psum``: the sum of every rank's ``t``, the same bits on every
    rank (gloo's and NCCL's ring all-reduce hand each reduced piece to every
    rank as it was summed)."""
    if group_size(group) == 1:
        return t
    return _AllSum.apply(t, group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (JAX's
    ``all_gather(tiled=True)``)."""
    r = group_size(group)
    if r == 1:
        return t
    wire = _to_wire(group, t)
    parts = [torch.empty_like(wire) for _ in range(r)]
    dist.all_gather(parts, wire, group=group)
    return _from_wire(torch.cat(parts, dim=dim), t)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (a new tensor; ``t`` is unchanged)."""
    if group_size(group) == 1:
        return t
    wire = _to_wire(group, t, copy=True)
    dist.broadcast(wire, src=_peer(group, src), group=group)
    return _from_wire(wire, t)
