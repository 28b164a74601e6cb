"""EAGLE speculative decoding: tree build and greedy tree verification.

Counterpart of ``sgl_kernel_npu_tpu/ops/speculative.py``
(``build_tree_efficient``, ``verify_tree_greedy``; the reference's
``build_tree_kernel_efficient`` and ``verify_tree_greedy``).  Plain torch on
the inputs' device, batched over the rows: a parent lookup per node, a pass
in node order building depths and ancestor masks, and the greedy walk of the
tree.  JAX's ``lax.while_loop`` sibling walk becomes a loop of a fixed
``D`` steps with masked updates (a sibling chain has fewer than ``D``
nodes), so no value is read back to the host; draft trees are tiny (at most
a few dozen nodes).
"""

from __future__ import annotations

from enum import IntEnum

import torch

_INT_MAX = 2 ** 31 - 1


class TreeMaskMode(IntEnum):
    FULL_MASK = 0
    QLEN_ONLY = 1
    QLEN_ONLY_BITPACKING = 2


def _resolve_parents(parent_list: torch.Tensor, selected_index: torch.Tensor, topk: int):
    """``[bs, D-1]``: the parent node of node ``i`` (1..D-1) in draft-token
    order at ``[:, i - 1]``: parent table index 0 is the root, else the node
    after the first position of ``parent_list[ptb]`` in ``selected_index``;
    ``D`` where that token is not among the selected (invalid)."""
    d = selected_index.shape[-1] + 1
    ptb = torch.div(selected_index, topk, rounding_mode="floor")
    parent_token = parent_list.gather(1, ptb.long())
    eq = selected_index[:, None, :] == parent_token[:, :, None]    # [bs, node, position]
    first = torch.argmax(eq.to(torch.uint8), dim=-1).to(torch.int32) + 1
    found = eq.any(dim=-1)
    invalid = torch.full_like(first, d)
    return torch.where(ptb == 0, torch.zeros_like(first), torch.where(found, first, invalid))


def _tree_links(parent_node: torch.Tensor, d: int):
    """``next_token`` / ``next_sibling`` ``[bs, D]``: a node's smallest
    child, and the smallest child of its parent above it (-1 for none);
    children of an invalid parent (``D``) link among themselves only."""
    bs = parent_node.shape[0]
    dev = parent_node.device
    nodes = torch.arange(1, d, dtype=torch.int32, device=dev).expand(bs, d - 1)
    nt = torch.full((bs, d + 1), _INT_MAX, dtype=torch.int32, device=dev)
    nt.scatter_reduce_(1, parent_node.long(), nodes, reduce="amin")   # column D: dropped
    nt = nt[:, :d]
    next_token = torch.where(nt == _INT_MAX, -1, nt)
    same_parent = parent_node[:, None, :] == parent_node[:, :, None]
    greater = nodes[:, None, :] > nodes[:, :, None]
    cand = torch.where(same_parent & greater, nodes[:, None, :], _INT_MAX)
    sib = cand.amin(dim=-1)
    sib = torch.where(sib == _INT_MAX, -1, sib)
    next_sibling = torch.cat([torch.full((bs, 1), -1, dtype=torch.int32, device=dev), sib], 1)
    return next_token.to(torch.int32), next_sibling.to(torch.int32)


def _depth_and_ancestors(parent_node: torch.Tensor, d: int):
    """``depth [bs, D]`` and the ancestor mask ``[bs, D, D]`` (``[i, j]``: j
    is an ancestor of i or i itself), one node after another in draft order
    (parents precede their children; an invalid parent is clipped to D-1)."""
    bs = parent_node.shape[0]
    dev = parent_node.device
    rows = torch.arange(bs, device=dev)
    parent_full = torch.cat([torch.zeros((bs, 1), dtype=parent_node.dtype, device=dev),
                             parent_node], 1).clamp(0, d - 1).long()
    depth = torch.zeros((bs, d), dtype=torch.int32, device=dev)
    anc = torch.zeros((bs, d, d), dtype=torch.bool, device=dev)
    anc[:, 0, 0] = True
    for i in range(1, d):
        p = parent_full[:, i]
        depth[:, i] = depth[rows, p] + 1
        row = anc[rows, p].clone()
        row[:, i] = True
        anc[:, i] = row
    return depth, anc


def build_tree_efficient(parent_list: torch.Tensor, selected_index: torch.Tensor,
                         verified_seq_len: torch.Tensor, *, topk: int, draft_token_num: int,
                         tree_mask_mode: int = TreeMaskMode.QLEN_ONLY,
                         prefix_len: int | None = None):
    """The EAGLE tree's attention metadata from ``parent_list [bs, P]``
    (token ids of candidate parents), ``selected_index [bs, D-1]`` (the
    chosen draft tokens, indices into the top-k grid) and
    ``verified_seq_len [bs]`` → ``(positions [bs·D], retrive_index [bs, D],
    retrive_next_token [bs, D], retrive_next_sibling [bs, D], tree_mask)``:
    ``tree_mask`` is ``[bs, D, D]`` bool for QLEN_ONLY, ``[bs, D, ceil(D /
    8)]`` uint8 for QLEN_ONLY_BITPACKING, ``[bs, D, prefix_len + D]`` bool
    for FULL_MASK (prefix columns below the sequence length True)."""
    bs = parent_list.shape[0]
    d = draft_token_num
    dev = parent_list.device
    parent_node = _resolve_parents(parent_list, selected_index, topk)
    next_token, next_sibling = _tree_links(parent_node, d)
    depth, anc = _depth_and_ancestors(parent_node, d)
    positions = (verified_seq_len[:, None].to(torch.int32) + depth).reshape(-1)
    retrive_index = (torch.arange(bs, dtype=torch.int32, device=dev)[:, None] * d
                     + torch.arange(d, dtype=torch.int32, device=dev)[None])
    if tree_mask_mode == TreeMaskMode.QLEN_ONLY:
        tree_mask = anc
    elif tree_mask_mode == TreeMaskMode.QLEN_ONLY_BITPACKING:
        pad = (-d) % 8
        bits = torch.nn.functional.pad(anc, (0, pad)).reshape(bs, d, -1, 8)
        weights = 1 << torch.arange(8, dtype=torch.int32, device=dev)
        tree_mask = (bits.to(torch.int32) * weights).sum(-1).to(torch.uint8)
    elif tree_mask_mode == TreeMaskMode.FULL_MASK:
        if prefix_len is None:
            raise ValueError("FULL_MASK needs a prefix_len")
        prefix = (torch.arange(prefix_len, device=dev)[None, None, :]
                  < verified_seq_len[:, None, None].to(dev))
        tree_mask = torch.cat([prefix.expand(bs, d, prefix_len), anc], dim=-1)
    else:
        raise ValueError(f"unknown tree_mask_mode {tree_mask_mode}")
    return positions, retrive_index, next_token, next_sibling, tree_mask


def verify_tree_greedy(candidates: torch.Tensor, retrive_index: torch.Tensor,
                       retrive_next_token: torch.Tensor, retrive_next_sibling: torch.Tensor,
                       target_predict: torch.Tensor):
    """Greedy tree verification: from the root, step to the first child (in
    sibling order) whose token is the target's prediction at the last
    accepted node, until none matches.  ``candidates`` / ``target_predict``
    ``[bs, D]`` token ids, ``retrive_index`` global output slots → ``(predicts
    [bs·D], accept_index [bs, D] int32, accept_token_num [bs] int32)``;
    ``predicts[b·D + i]`` is the target's token at accepted node ``i`` (-1
    elsewhere), unaccepted slots of ``accept_index`` -1."""
    bs, d = candidates.shape
    dev = candidates.device
    rows = torch.arange(bs, device=dev)
    cand, ridx = candidates.long(), retrive_index.long()
    nt, ns, tgt = retrive_next_token.long(), retrive_next_sibling.long(), target_predict
    predicts = torch.full((bs, d), -1, dtype=tgt.dtype, device=dev)
    accept = torch.full((bs, d), -1, dtype=torch.int32, device=dev)
    accept[:, 0] = retrive_index[:, 0].to(torch.int32)
    zero = torch.zeros(bs, dtype=torch.long, device=dev)
    cur, last, n_acc = zero, zero, zero
    done = torch.zeros(bs, dtype=torch.bool, device=dev)
    for _ in range(1, d):
        want = tgt[rows, last]
        node = nt[rows, cur]
        found = torch.zeros(bs, dtype=torch.bool, device=dev)
        for _ in range(d):                            # the sibling walk
            active = (node != -1) & ~found
            safe = node.clamp(min=0)
            match = active & (cand[rows, safe] == want.long())
            found = found | match
            node = torch.where(active & ~match, ns[rows, safe], node)
        take = found & ~done
        predicts[rows, last] = torch.where(take, want, predicts[rows, last])
        n_new = n_acc + 1
        safe = node.clamp(min=0)
        accept[rows, n_new] = torch.where(take, ridx[rows, safe].to(torch.int32),
                                          accept[rows, n_new])
        cur = torch.where(take, node, cur)
        last = torch.where(take, node, last)
        n_acc = torch.where(take, n_new, n_acc)
        done = done | ~found
    predicts[rows, last] = tgt[rows, last]
    return predicts.reshape(-1), accept, n_acc.to(torch.int32)
