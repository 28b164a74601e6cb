"""Pipeline parallelism: the GPipe microbatch schedule over a process group.

Counterpart of ``sgl_kernel_npu_tpu/parallel/pipeline.py``.  Each rank of
``group`` owns one stage; the batch is cut into ``num_micro`` microbatches
that flow through the ring, the fill / steady / drain loop of ``num_micro +
R - 1`` steps: stage 0 takes microbatch t at step t, stage s works on
microbatch ``t - s``, and the last stage's outputs are summed to every rank.
The exchanges are autograd functions
(:mod:`~sgl_kernel_npu_tpu_torch.parallel.collectives`), so the schedule is
differentiable: with the same loss on every rank, each rank's gradients are
its stage's gradients of the sequential model.  A rank computes only on
steps that hold one of its microbatches (JAX's scan computes every step and
masks the rest), and passes zeros on the others.

``stage_fn(stage_params, x)`` is any torch function that maps a microbatch
to a tensor of the same shape and dtype (JAX's ``where`` between the
injected and the received microbatch needs the same).
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves, tree_map

from sgl_kernel_npu_tpu_torch.parallel.collectives import (
    all_sum,
    group_rank,
    group_size,
    ring_permute,
)


class _Tie(torch.autograd.Function):
    """``out``, with ``others`` tied into its graph at a zero gradient.  A
    rank's stage outputs leave it through permutes whose results it may
    never use; the tie makes every rank's backward run every permute of the
    schedule (in reverse order on every rank), and each permute's backward
    brings its input's gradient back from the rank it went to."""

    @staticmethod
    def forward(ctx, out, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return out.clone()

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev) for s, dt, dev in ctx.others))


def pipeline_forward_rank(stage_fn, stage_params, x: torch.Tensor, *, group,
                          num_micro: int) -> torch.Tensor:
    """This rank's part of the schedule: ``stage_params`` is this rank's
    stage, ``x [B, ...]`` the whole batch (the same on every rank); returns
    the whole output on every rank.  With gradients on (a stage parameter
    or ``x`` requires them), every rank must call backward on the same loss
    of the output: the backward's exchanges are collective."""
    r, me = group_size(group), group_rank(group)
    b = x.shape[0]
    if b % num_micro:
        raise ValueError(f"batch {b} does not divide into {num_micro} microbatches")
    track = torch.is_grad_enabled() and (x.requires_grad or any(
        leaf.requires_grad for leaf in tree_leaves(stage_params)
        if isinstance(leaf, torch.Tensor)))
    x_mb = x.reshape(num_micro, b // num_micro, *x.shape[1:])
    total = num_micro + r - 1
    outs, recvs = [], []
    for t in range(total):
        mb = t - me
        if 0 <= mb < num_micro:
            y = stage_fn(stage_params, x_mb[mb] if me == 0 else recvs[-1])
            if y.shape != x_mb[0].shape or y.dtype != x.dtype:
                raise ValueError(f"stage_fn maps a microbatch {tuple(x_mb[0].shape)} "
                                 f"{x.dtype} to {tuple(y.shape)} {y.dtype}; a stage must "
                                 "keep its input's shape and dtype")
            outs.append(y)
        else:               # no microbatch here at step t: pass zeros on
            y = torch.zeros_like(x_mb[0]).requires_grad_(track)
        if t < total - 1:
            recvs.append(ring_permute(y, group))
    out = torch.stack(outs) if me == r - 1 else torch.zeros_like(x_mb)
    out = all_sum(out, group).reshape(x.shape)
    return _Tie.apply(out, *recvs) if track and recvs else out


def pipeline_forward(stage_fn, stage_params, x: torch.Tensor, *, group,
                     num_micro: int) -> torch.Tensor:
    """``stage_params``' leaves lead with the stage axis ``[R, ...]`` (the
    same tree on every rank; rank r runs stage r), ``x`` the whole batch;
    the output is the whole batch on every rank."""
    r, me = group_size(group), group_rank(group)
    for leaf in tree_leaves(stage_params):
        if leaf.shape[0] != r:
            raise ValueError(f"a stage leaf leads with {leaf.shape[0]} stages; the group "
                             f"has {r} ranks")
    mine = tree_map(lambda a: a[me], stage_params)
    return pipeline_forward_rank(stage_fn, mine, x, group=group, num_micro=num_micro)
