"""SwiGLU activations: plain versions and the Hopper kernels (K7a, K7b).

Counterpart of ``sgl_kernel_npu_tpu/ops/activation.py`` (``swiglu_ref``,
``swiglu_quant_ref``, ``swiglu_quant``, ``swiglu_oai_ref``, ``swiglu_oai``).
For ``swiglu_quant`` the input's last dim is gate ‖ up; ``group_list`` bounds
the live rows (type 0 cumulative sums, type 1 counts, ``None`` every row) and
rows past the total are zeros.  ``swiglu_oai`` (GPT-OSS) takes gate and up
interleaved (even lanes gate, odd lanes up) and clamps them.
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.quant import row_scale, saturate_int8
from sgl_kernel_npu_tpu_torch.ops.row_reduce import launch_plan
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
    f32)``.  CUDA tensors launch ``csrc/quant.cu`` (a row reduction on
    ``csrc/row_reduce.cuh`` over the output row, its plan from
    ``ops/row_reduce.launch_plan(..., halves=2)``); CPU tensors take
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
    plan = launch_plan(x, out, halves=2)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.swiglu_quant_launch(
        x.data_ptr(), rows, h // 2, int(x.dtype == torch.bfloat16),
        None if tot is None else tot.data_ptr(), int(need_quant), *plan, out.data_ptr(),
        scale.data_ptr(), cuda_lib.stream_ptr(x)), "swiglu_quant")
    swiglu_quant.launches += 1
    return out, scale


def swiglu_oai_ref(gate_up: torch.Tensor, alpha: float = 1.702, limit: float = 7.0):
    """Plain GPT-OSS SwiGLU over interleaved gate / up (f32 math):
    ``(clip(up, ±limit) + 1) · g · σ(α g)`` with ``g = min(gate, limit)``."""
    gate = torch.clamp(gate_up[..., ::2].float(), max=limit)
    up = torch.clamp(gate_up[..., 1::2].float(), -limit, limit)
    return ((up + 1.0) * (gate * torch.sigmoid(gate * alpha))).to(gate_up.dtype)


@counted
def swiglu_oai(gate_up: torch.Tensor, alpha: float = 1.702, limit: float = 7.0):
    """GPT-OSS SwiGLU over interleaved ``gate_up [rows, 2I]`` → ``[rows, I]``
    in its dtype.  CUDA tensors launch ``csrc/activation.cu`` (bf16 or f32),
    which reads the interleaved rows directly (the JAX wrapper's
    de-interleave is a TPU workaround); CPU tensors take
    :func:`swiglu_oai_ref`."""
    if not on_cuda(gate_up):
        return swiglu_oai_ref(gate_up, alpha, limit)
    if gate_up.dim() != 2 or gate_up.shape[1] % 2 \
            or gate_up.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"swiglu_oai takes a 2-D bf16 or f32 tensor of even width, got "
                         f"{gate_up.dtype} {tuple(gate_up.shape)}")
    x = gate_up.contiguous()
    rows, width = x.shape
    out = torch.empty((rows, width // 2), dtype=x.dtype, device=x.device)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.swiglu_oai_launch(
        x.data_ptr(), out.data_ptr(), rows, width // 2, int(x.dtype == torch.bfloat16),
        float(alpha), float(limit), cuda_lib.stream_ptr(x)), "swiglu_oai")
    swiglu_oai.launches += 1
    return out
