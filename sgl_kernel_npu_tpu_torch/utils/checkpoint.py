"""Checkpoint / resume of training state.

Counterpart of ``sgl_kernel_npu_tpu/utils/checkpoint.py`` (orbax there):
``torch.save`` of the state into ``<path>/state.pt`` and ``torch.load(...,
weights_only=True)`` back.  State is any tree of dicts, lists and tuples
with tensors and Python scalars at the leaves (params, optimizer state, a
step counter).  The restore takes ``like``'s structure, dtypes and devices:

    save_checkpoint("/ckpt/dir", {"params": params, "step": 100})
    state = restore_checkpoint("/ckpt/dir", like={"params": params0, "step": 0})
"""

from __future__ import annotations

import os
import pathlib

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

_FILE = "state.pt"


def save_checkpoint(path, state, *, force: bool = True) -> None:
    """Write ``state`` to the directory ``path`` (made if missing); an
    existing checkpoint there is replaced with ``force``, else raises
    ``FileExistsError``."""
    target = pathlib.Path(path) / _FILE
    if target.exists() and not force:
        raise FileExistsError(f"a checkpoint exists at {path}; pass force=True to replace it")
    target.parent.mkdir(parents=True, exist_ok=True)
    leaves, spec = tree_flatten(state)
    tmp = target.with_suffix(".tmp")
    torch.save({"tree": str(spec), "leaves": [t.detach().cpu() if isinstance(t, torch.Tensor)
                                              else t for t in leaves]}, tmp)
    os.replace(tmp, target)


def restore_checkpoint(path, *, like):
    """The state :func:`save_checkpoint` wrote at ``path``, in ``like``'s
    structure, each tensor in the dtype and on the device of ``like``'s
    tensor there (scalars as saved).  A checkpoint of another structure
    raises ``ValueError``."""
    ckpt = torch.load(pathlib.Path(path) / _FILE, weights_only=True)
    saved = ckpt["leaves"]
    want, spec = tree_flatten(like)
    if ckpt["tree"] != str(spec):
        raise ValueError(f"the checkpoint's structure {ckpt['tree']} is not like's {spec}")
    out = []
    for s, w in zip(saved, want):
        if isinstance(w, torch.Tensor):
            if not isinstance(s, torch.Tensor) or s.shape != w.shape:
                raise ValueError(f"a saved leaf {getattr(s, 'shape', s)} where like holds a "
                                 f"tensor {tuple(w.shape)}")
            s = s.to(device=w.device, dtype=w.dtype)
        out.append(s)
    return tree_unflatten(out, spec)
