"""RMSNorm: plain version and the Hopper kernel (K6a).

Counterpart of ``sgl_kernel_npu_tpu/ops/norm.py`` (``rms_norm_ref``,
``rms_norm``).  The DeepSeek path calls the plain version; GPT-OSS calls the
kernel (``csrc/norm.cu``).  The fused variants (``add_rms_norm_bias``,
``add_gemma_rms_norm``, ``l1_norm``: K6b-d) are not ported yet (ROADMAP
queue B).
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda
from sgl_kernel_npu_tpu_torch.utils.counters import counted

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


@counted
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of ``x [rows, hidden]`` in f32, out in x's
    dtype.  CUDA tensors launch ``csrc/norm.cu`` (bf16 or f32 x and weight);
    CPU tensors take :func:`rms_norm_ref`."""
    if not on_cuda(x, weight):
        return rms_norm_ref(x, weight, eps)
    if x.dim() != 2 or weight.shape != (x.shape[1],) or x.dtype not in _KERNEL_DTYPES \
            or weight.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"rms_norm takes bf16 or f32 x [rows, hidden] and weight [hidden], "
                         f"got {x.dtype} {tuple(x.shape)}, {weight.dtype} {tuple(weight.shape)}")
    x, weight = x.contiguous(), weight.contiguous()
    out = torch.empty_like(x)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.rms_norm_launch(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
        int(x.dtype == torch.bfloat16), int(weight.dtype == torch.bfloat16), float(eps),
        cuda_lib.stream_ptr(x)), "rms_norm")
    rms_norm.launches += 1
    return out
