"""Failure diagnosis from the expert-parallel exchange's statistics.

Counterpart of ``sgl_kernel_npu_tpu/utils/diagnostics.py``: given a rank ×
rank cost or wait matrix (the monitored dispatch's ``wait_recv_cost_stats``
gathered over the ranks, or a ``recv_count_matrix``), flag the rows, columns
and points far above the mean, the signature of a slow or straggling rank.
They take the port's stats tensors (on the card too) or arrays, and move
each to the host once.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(mat) -> np.ndarray:
    if isinstance(mat, torch.Tensor):
        mat = mat.detach().to("cpu", torch.float64)
    return np.asarray(mat, np.float64)


def diagnose_matrix(mat, thres_col: float = 3.0, thres_row: float = 3.0,
                    thres_point: float = 5.0) -> dict:
    """``abnormal_rows`` / ``abnormal_cols`` / ``abnormal_points``: where a
    row's or column's mean, or a value, exceeds its threshold times the
    matrix's mean."""
    m = _host(mat)
    overall = m.mean() + 1e-12
    rows = np.where(m.mean(axis=1) > thres_row * overall)[0].tolist()
    cols = np.where(m.mean(axis=0) > thres_col * overall)[0].tolist()
    pts = [tuple(p) for p in np.argwhere(m > thres_point * overall).tolist()]
    return {"abnormal_rows": rows, "abnormal_cols": cols, "abnormal_points": pts}


def expert_balance_report(recv_count_matrix) -> dict:
    """EPLB's signal from ``recv_count_matrix [src rank, local expert]``:
    the tokens of each expert, the largest over the mean, the empty
    experts."""
    per_expert = _host(recv_count_matrix).sum(axis=0)
    mean = per_expert.mean() + 1e-12
    return {
        "per_expert_tokens": per_expert.tolist(),
        "max_over_mean": float(per_expert.max() / mean),
        "empty_experts": int((per_expert == 0).sum()),
    }
