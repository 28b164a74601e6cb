"""SwiGLU with per-row dynamic int8 quant: plain versions and the Hopper kernel
(K7a).

Counterpart of ``sgl_kernel_npu_tpu/ops/activation.py`` (``swiglu_ref``,
``swiglu_quant_ref``, ``swiglu_quant``).  The input's last dim is gate ‖ up;
``group_list`` bounds the live rows (type 0 cumulative sums, type 1 counts,
``None`` every row) and rows past the total are zeros.  GPT-OSS's
``swiglu_oai`` (K7b) is not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.quant import row_scale, saturate_int8
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda
from sgl_kernel_npu_tpu_torch.utils.counters import counted


def swiglu_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain SwiGLU: silu(x1) * x2 with x split in half on the last dim."""
    x1, x2 = x.chunk(2, dim=-1)
    x1f = x1.float()
    return (x1f * torch.sigmoid(x1f) * x2.float()).to(x.dtype)


def _valid_rows(group_list, group_list_type: int):
    if group_list_type not in (0, 1):
        raise ValueError(f"group_list_type must be 0 or 1, got {group_list_type}")
    if group_list is None:
        return None
    if group_list_type == 0:                  # cumulative sums: the last is the total
        return group_list[-1].to(torch.int32)
    return group_list.sum().to(torch.int32)   # per-group counts


def swiglu_quant_ref(x, group_list=None, group_list_type: int = 1, need_quant: bool = True):
    """Plain :func:`swiglu_quant`: ``(out [rows, H/2], scale [rows] f32)``;
    the scale is amax / 127 unclamped (0 for a zero row), only the division
    uses max(scale, 1e-12)."""
    rows, h = x.shape
    x1f = x[:, : h // 2].float()
    out = x1f * torch.sigmoid(x1f) * x[:, h // 2 :].float()
    total = _valid_rows(group_list, group_list_type)
    if total is not None:
        live = torch.arange(rows, device=x.device) < total.to(x.device)
        out = torch.where(live[:, None], out, 0.0)
    if not need_quant:
        return out.to(x.dtype), torch.zeros((rows,), dtype=torch.float32, device=x.device)
    scale = row_scale(out)
    return saturate_int8(out / torch.clamp_min(scale, 1e-12)[:, None]), scale


@counted
def swiglu_quant(x, group_list=None, group_list_type: int = 1, need_quant: bool = True):
    """Fused SwiGLU + per-row dynamic int8 quant over ``x [rows, 2H]`` (gate ‖
    up) → ``(out [rows, H] int8, or x.dtype without quant; scale [rows]
    f32)``.  CUDA tensors launch ``csrc/quant.cu``; CPU tensors take
    :func:`swiglu_quant_ref`."""
    args = (x, *(() if group_list is None else (group_list,)))
    if not on_cuda(*args):
        return swiglu_quant_ref(x, group_list, group_list_type, need_quant)
    if x.dim() != 2 or x.shape[1] % 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"swiglu_quant takes a 2-D bf16 or f32 tensor of even width, got "
                         f"{x.dtype} {tuple(x.shape)}")
    total = _valid_rows(group_list, group_list_type)
    x = x.contiguous()
    rows, h = x.shape
    out = torch.empty((rows, h // 2), dtype=torch.int8 if need_quant else x.dtype,
                      device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    tot = None if total is None else total.reshape(1).contiguous()
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.swiglu_quant_launch(
        x.data_ptr(), rows, h // 2, int(x.dtype == torch.bfloat16),
        None if tot is None else tot.data_ptr(), int(need_quant), out.data_ptr(),
        scale.data_ptr(), cuda_lib.stream_ptr(x)), "swiglu_quant")
    swiglu_quant.launches += 1
    return out, scale
