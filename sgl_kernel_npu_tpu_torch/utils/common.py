"""Shared helpers for the port's modules.

Counterpart of ``sgl_kernel_npu_tpu/utils/common.py``.  Where the JAX package
chose Pallas interpret mode from the backend (``interpret_default``), the port
chooses per tensor: a wrapper runs its hand-written CUDA kernel for a CUDA
tensor and its plain PyTorch version for a CPU tensor, and never falls back
from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def kernels_available() -> bool:
    """True where the hand-written kernels can run: a CUDA device is present.
    (Replaces ``interpret_default``: there is no interpret mode for CUDA.)"""
    return torch.cuda.is_available()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) raises when no GPU is present: the port never carries on
    quietly on the CPU unless the caller asks for ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """Dispatch rule of every kernel wrapper: all CUDA → kernel, all CPU →
    plain version, anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all lie on one CUDA device or all on the CPU, got {kinds}")


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last dimension and their indices,
    in ``jax.lax.top_k``'s order: descending, equal values by ascending index
    (a stable sort; ``torch.topk`` leaves the order of ties open, and the DSA
    selections meet ties of -inf at every dead position)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def to_torch(a, dev: torch.device) -> torch.Tensor:
    """A numpy array (an ml_dtypes bfloat16 one too) → a tensor on ``dev``."""
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":       # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)
