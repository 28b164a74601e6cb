"""Shared helpers for the port's modules.

Counterpart of ``sgl_kernel_npu_tpu/utils/common.py``.  Where the JAX package
chose Pallas interpret mode from the backend (``interpret_default``), the port
chooses per tensor: a wrapper runs its hand-written CUDA kernel for a CUDA
tensor and its plain PyTorch version for a CPU tensor, and never falls back
from one to the other.
"""

from __future__ import annotations

import functools
import inspect
import logging

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_power_of_2(x: int) -> int:
    """The least power of 2 at or above ``x`` (1 for ``x <= 1``)."""
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


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


def get_logger() -> logging.Logger:
    """The port's package logger."""
    return logging.getLogger("sgl_kernel_npu_tpu_torch")


def _describe(v) -> str:
    """A parameter as :func:`log_parameters` logs it: a tensor by shape,
    dtype and device (its values never read, so no host sync), a long list
    or tuple by its length, a short one (a handle too) item by item."""
    if isinstance(v, torch.Tensor):
        return f"Tensor{tuple(v.shape)}:{str(v.dtype).removeprefix('torch.')}@{v.device}"
    if isinstance(v, (list, tuple)):
        if len(v) > 4:
            return f"{type(v).__name__}(len={len(v)})"
        return f"{type(v).__name__}({', '.join(_describe(i) for i in v)})"
    return repr(v)


def log_parameters(fn):
    """Log every call's parameters at DEBUG level on :func:`get_logger`
    (JAX's ``log_parameters``): ``self`` left out, tensors described by
    :func:`_describe`.  Nothing is formatted while DEBUG is off."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        logger = get_logger()
        if logger.isEnabledFor(logging.DEBUG):
            try:
                bound = sig.bind(*args, **kwargs)
                params = ", ".join(f"{k}={_describe(v)}" for k, v in bound.arguments.items()
                                   if k != "self")
                logger.debug("%s(%s)", fn.__qualname__, params)
            except TypeError:
                logger.debug("%s(<unbindable args>)", fn.__qualname__)
        return fn(*args, **kwargs)

    return wrapped
