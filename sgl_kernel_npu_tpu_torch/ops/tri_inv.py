"""Unit-lower-triangular matrix inverse.

Counterpart of ``sgl_kernel_npu_tpu/ops/tri_inv.py`` (``triangular_inverse``,
``triangular_inverse_ref``): the exact nilpotent-squaring product in f32
(``fla.chunk.tril_nilpotent_inverse``), and the column-sweep golden in f64.
"""

from __future__ import annotations

import numpy as np
import torch

from sgl_kernel_npu_tpu_torch.ops.fla.chunk import tril_nilpotent_inverse


def triangular_inverse(l: torch.Tensor) -> torch.Tensor:  # noqa: E741
    """Inverse of a unit-lower-triangular matrix, batched on leading dims."""
    c = l.shape[-1]
    eye = torch.eye(c, dtype=torch.float32, device=l.device)
    return tril_nilpotent_inverse(eye - l.float()).to(l.dtype)


def triangular_inverse_ref(l: torch.Tensor) -> torch.Tensor:  # noqa: E741
    """Column-sweep golden: row i of the inverse is ``e_i - Σ_{j<i} L[i, j]
    x_j``, in f64, cast to l's type."""
    ln = l.detach().double().cpu().numpy()
    c = ln.shape[-1]
    out = np.broadcast_to(np.eye(c), ln.shape).copy()
    for i in range(1, c):
        out[..., i, :i] = -np.einsum("...j,...jk->...k", ln[..., i, :i], out[..., :i, :i])
    return torch.from_numpy(out).to(device=l.device, dtype=l.dtype)
