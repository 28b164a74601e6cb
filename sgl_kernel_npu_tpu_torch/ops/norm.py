"""RMSNorm and its fused variants: plain versions and the Hopper kernels.

Counterpart of ``sgl_kernel_npu_tpu/ops/norm.py``: ``rms_norm`` (K6a; the
DeepSeek path calls the plain version, GPT-OSS and Llama the kernel),
``add_rms_norm_bias`` (K6b: residual add, RMSNorm, bias, optional static
per-channel int8 quant), ``add_gemma_rms_norm`` (K6c: residual add, RMSNorm
scaled by ``w + 1``; K6b's kernel launches it) and ``l1_norm`` (K6d: each row
over its signed sum, f32 out), and ``split_qkv_rmsnorm_rope`` (JAX's jnp
chain, no Pallas kernel: torch ops).  The kernels live in ``csrc/norm.cu``; no
model calls K6b-d, they are ops.  K6a, K6b / K6c and K6d are row reductions
on ``csrc/row_reduce.cuh`` (their plan from ``ops/row_reduce.py``);
:func:`rms_norm_rows_plain`, :func:`add_rms_norm_rows_plain` and
:func:`l1_norm_rows_plain` repeat their order of operations on the CPU.
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.quant import quant_static_per_channel_ref
from sgl_kernel_npu_tpu_torch.ops.rope import apply_rope
from sgl_kernel_npu_tpu_torch.ops.row_reduce import (L1_CHUNK_VECS, L1_ELEM_BYTES, RowPlan,
                                                      launch_plan, row_vectors)
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda
from sgl_kernel_npu_tpu_torch.utils.counters import counted

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def _row_sum(vals: torch.Tensor, plan: RowPlan) -> torch.Tensor:
    """Each row's signed f32 sum of ``vals [rows, hidden]`` in the
    row-reduction kernels' order on ``plan`` (K6d's; K6a's and K6b / K6c's
    over x²): each thread sums its vectors' elements in order (each sum
    rounded), a warp adds by butterfly, the block adds its warps in index
    order and the cluster its blocks in rank order."""
    rows, hidden = vals.shape
    n = plan.elems
    vals = vals.reshape(rows, hidden // n, n)
    index, live = row_vectors(plan, hidden)                    # [cluster, vecs, threads]
    vals = torch.where(live[None, ..., None], vals[:, index.clamp(max=max(hidden // n - 1, 0))],
                       torch.zeros((), dtype=torch.float32))   # [rows, C, V, T, n]
    acc = torch.zeros((rows, plan.cluster, plan.threads))
    for v in range(plan.vecs):
        for i in range(n):
            acc = acc + vals[:, :, v, :, i]
    acc = acc.reshape(rows, plan.cluster, plan.threads // 32, 32)
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    warps = acc[..., 0]                                        # [rows, C, warps]
    blocks = warps[..., 0]
    for w in range(1, warps.shape[-1]):
        blocks = blocks + warps[..., w]
    total = blocks[:, 0]
    for r in range(1, plan.cluster):
        total = total + blocks[:, r]
    return total


def _row_sum_squares(xf: torch.Tensor, plan: RowPlan) -> torch.Tensor:
    """Each row's f32 sum of x² (each product rounded) in the order of
    :func:`_row_sum` (K6a, K6b / K6c)."""
    return _row_sum(xf * xf, plan)


def _row_rsqrt(total: torch.Tensor, hidden: int, eps: float) -> torch.Tensor:
    """``1 / sqrt(total / hidden + eps)`` in f32, each operation rounded."""
    f32 = lambda v: torch.full((), v, dtype=torch.float32)  # noqa: E731
    mean = total / f32(float(hidden)) + f32(eps)
    # sqrt rounded once, as the kernel's __fsqrt_rn: torch.sqrt on the CPU
    # (MKL) misses the nearest f32 now and then; f64 then f32 does not
    return f32(1.0) / torch.sqrt(mean.double()).float()


def rms_norm_rows_plain(x: torch.Tensor, weight: torch.Tensor, eps: float,
                        plan: RowPlan) -> torch.Tensor:
    """K6a's arithmetic in the CUDA kernel's order on ``plan``, bit for bit:
    the sum of x² as :func:`_row_sum_squares`, then ``1 / sqrt(sum / hidden +
    eps)``, and ``(x · r) · w`` rounded once to x's type."""
    xf = x.float()
    scale = _row_rsqrt(_row_sum_squares(xf, plan), x.shape[1], eps)
    return (xf * scale[:, None] * weight.float()).to(x.dtype)


def add_rms_norm_rows_plain(x, residual, weight, bias, quant_scale, quant_offset, mode: str,
                            eps: float, plan: RowPlan):
    """K6b / K6c's arithmetic in the CUDA kernel's order on ``plan``, bit for
    bit → ``(out, added)``: ``added = x + residual`` in f32 rounded to x's
    type, its sum of squares in K6a's order (:func:`_row_sum_squares`), ``r =
    1 / sqrt(sum / hidden + eps)``, then ``(a · r) · w + b`` (mode
    ``"bias"``), the same ``· qs + qo`` saturated to int8 (``"quant"``), or
    ``(a · r) · (w + 1)`` (``"gemma"``, no bias), each operation rounded, the
    float output rounded once to x's type."""
    added = (x.float() + residual.float()).to(x.dtype)
    af = added.float()
    scale = _row_rsqrt(_row_sum_squares(af, plan), x.shape[1], eps)
    wf = weight.float()
    out = af * scale[:, None] * (wf + 1.0 if mode == "gemma" else wf)
    if mode == "gemma":
        return out.to(x.dtype), added
    out = out + bias.float()
    if mode == "quant":
        return quant_static_per_channel_ref(out, quant_scale, quant_offset), added
    return out.to(x.dtype), added


def l1_norm_rows_plain(x: torch.Tensor, plan: RowPlan) -> torch.Tensor:
    """K6d's arithmetic in the CUDA kernel's order on ``plan``, bit for bit:
    the signed sum as :func:`_row_sum`, then ``x / sum`` in IEEE division, f32
    out (a row summing to 0 gives ±inf or NaN, as :func:`l1_norm_ref`)."""
    xf = x.float()
    return xf / _row_sum(xf, plan)[:, None]


def add_rms_norm_bias_ref(x, residual, norm_weight, norm_bias, eps, quant_scale=None,
                          quant_offset=None):
    """``added = x + residual`` (rounded to x's type), then ``rmsnorm(added) ·
    w + b`` in f32: int8 by ``saturate_int8(normed · qs + qo)`` when a
    ``quant_scale`` is given, else x's type.  Returns ``(out, added)``."""
    added = (x + residual).to(x.dtype)
    af = added.float()
    var = (af * af).mean(dim=-1, keepdim=True)
    normed = af * torch.rsqrt(var + eps) * norm_weight.float() + norm_bias.float()
    if quant_scale is not None:
        return quant_static_per_channel_ref(normed, quant_scale, quant_offset), added
    return normed.to(x.dtype), added


def add_gemma_rms_norm_ref(hidden_state, weight, residual, eps):
    """``added = h + residual``, then ``rmsnorm(added) · (w + 1)`` → ``(normed,
    added)``, both in h's type."""
    added = (hidden_state + residual).to(hidden_state.dtype)
    af = added.float()
    var = (af * af).mean(dim=-1, keepdim=True)
    normed = af * torch.rsqrt(var + eps) * (weight.float() + 1.0)
    return normed.to(hidden_state.dtype), added


def l1_norm_ref(x: torch.Tensor) -> torch.Tensor:
    """Each row over its signed sum (not the sum of |x|, as the original
    kernel), in f32."""
    xf = x.float()
    return xf / xf.sum(dim=-1, keepdim=True)


def _check_rows(name: str, *tensors: torch.Tensor) -> None:
    """The fused kernels take bf16 or f32 ``[rows, hidden]`` rows of one type."""
    x = tensors[0]
    if x.dim() != 2 or x.dtype not in _KERNEL_DTYPES or any(
            t.shape != x.shape or t.dtype != x.dtype for t in tensors[1:]):
        raise ValueError(f"{name} takes bf16 or f32 [rows, hidden] rows of one type, got "
                         f"{[(t.dtype, tuple(t.shape)) for t in tensors]}")


def _check_vectors(name: str, hidden: int, *vectors: torch.Tensor) -> None:
    for v in vectors:
        if v.shape != (hidden,) or v.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"{name} takes bf16 or f32 vectors of [{hidden}], got "
                             f"{v.dtype} {tuple(v.shape)}")


# modes of add_rms_norm_launch (csrc/norm.cu)
_MODES = {"bias": 0, "quant": 1, "gemma": 2}


def _add_rms_norm(x, residual, weight, bias, qs, qo, mode: str, eps: float):
    """Launch the fused add + RMSNorm kernel → ``(out, added)``."""
    x, residual = x.contiguous(), residual.contiguous()
    weight = weight.contiguous()
    bias = weight if bias is None else bias.contiguous()   # unread in the Gemma mode
    out = torch.empty(x.shape, dtype=torch.int8 if mode == "quant" else x.dtype,
                      device=x.device)
    added = torch.empty_like(x)
    quant = [t for t in (qs, qo) if t is not None]
    plan = launch_plan(x, residual, added, out, weight, bias, *quant, inputs=2)
    lib = cuda_lib.load_library()
    ptr = lambda t: 0 if t is None else t.data_ptr()   # noqa: E731
    cuda_lib.check(lib, lib.add_rms_norm_launch(
        x.data_ptr(), residual.data_ptr(), weight.data_ptr(), bias.data_ptr(), ptr(qs), ptr(qo),
        out.data_ptr(), added.data_ptr(), x.shape[0], x.shape[1],
        int(x.dtype == torch.bfloat16), int(weight.dtype == torch.bfloat16),
        int(bias.dtype == torch.bfloat16), _MODES[mode], float(eps), *plan,
        cuda_lib.stream_ptr(x)), "add_rms_norm")
    return out, added


@counted
def add_rms_norm_bias(x, residual, norm_weight, norm_bias, eps: float = 1e-6, quant_scale=None,
                      quant_offset=None):
    """Fused residual add + RMSNorm + bias (K6b), optionally quantized to
    int8 with a static per-channel scale and offset → ``(out, x +
    residual)``.  CUDA tensors launch ``csrc/norm.cu`` (bit-equal to
    :func:`add_rms_norm_rows_plain` on the launch's plan); CPU tensors take
    :func:`add_rms_norm_bias_ref`."""
    quantize = quant_scale is not None
    vectors = (norm_weight, norm_bias) + ((quant_scale, quant_offset) if quantize else ())
    if not on_cuda(x, residual, *vectors):
        return add_rms_norm_bias_ref(x, residual, norm_weight, norm_bias, eps, quant_scale,
                                     quant_offset)
    _check_rows("add_rms_norm_bias", x, residual)
    _check_vectors("add_rms_norm_bias", x.shape[1], *vectors)
    qs = qo = None
    if quantize:
        qs, qo = quant_scale.float().contiguous(), quant_offset.float().contiguous()
    out = _add_rms_norm(x, residual, norm_weight, norm_bias, qs, qo,
                        "quant" if quantize else "bias", eps)
    add_rms_norm_bias.launches += 1
    return out


@counted
def add_gemma_rms_norm(hidden_state, weight, residual, eps: float = 1e-6):
    """Fused residual add + Gemma RMSNorm (scale ``weight + 1``, K6c) →
    ``(normed, hidden_state + residual)``.  CUDA tensors launch K6b's kernel
    in its Gemma mode (counted here, not under K6b); CPU tensors take
    :func:`add_gemma_rms_norm_ref`."""
    if not on_cuda(hidden_state, weight, residual):
        return add_gemma_rms_norm_ref(hidden_state, weight, residual, eps)
    _check_rows("add_gemma_rms_norm", hidden_state, residual)
    _check_vectors("add_gemma_rms_norm", hidden_state.shape[1], weight)
    out = _add_rms_norm(hidden_state, residual, weight, None, None, None, "gemma", eps)
    add_gemma_rms_norm.launches += 1
    return out


def l1_launch_plan(x: torch.Tensor, out: torch.Tensor) -> RowPlan:
    """K6d's launch plan over ``x`` into ``out`` (``ops/row_reduce.l1_plan``
    on the card's SMs): vectors of 16 bytes of the f32 output where both
    start 16-byte aligned, else the element path."""
    return launch_plan(x, out, elem_bytes=L1_ELEM_BYTES, chunk_vecs=L1_CHUNK_VECS)


@counted
def l1_norm(x: torch.Tensor) -> torch.Tensor:
    """Each row of ``x [rows, hidden]`` over its signed sum, f32 out (K6d).
    CUDA tensors launch ``csrc/norm.cu`` (bit-equal to
    :func:`l1_norm_rows_plain` on :func:`l1_launch_plan`); CPU tensors take
    :func:`l1_norm_ref`."""
    if not on_cuda(x):
        return l1_norm_ref(x)
    _check_rows("l1_norm", x)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    plan = l1_launch_plan(x, out)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.l1_norm_launch(
        x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], int(x.dtype == torch.bfloat16),
        *plan, cuda_lib.stream_ptr(x)), "l1_norm")
    l1_norm.launches += 1
    return out


@counted
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of ``x [rows, hidden]`` in f32, out in x's
    dtype.  CUDA tensors launch ``csrc/norm.cu`` (bf16 or f32 x and weight;
    bit-equal to :func:`rms_norm_rows_plain` on the launch's plan); CPU
    tensors take :func:`rms_norm_ref`."""
    if not on_cuda(x, weight):
        return rms_norm_ref(x, weight, eps)
    if x.dim() != 2 or weight.shape != (x.shape[1],) or x.dtype not in _KERNEL_DTYPES \
            or weight.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"rms_norm takes bf16 or f32 x [rows, hidden] and weight [hidden], "
                         f"got {x.dtype} {tuple(x.shape)}, {weight.dtype} {tuple(weight.shape)}")
    x, weight = x.contiguous(), weight.contiguous()
    out = torch.empty_like(x)
    plan = launch_plan(x, weight, out)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.rms_norm_launch(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
        int(x.dtype == torch.bfloat16), int(weight.dtype == torch.bfloat16), float(eps), *plan,
        cuda_lib.stream_ptr(x)), "rms_norm")
    rms_norm.launches += 1
    return out


def split_qkv_rmsnorm_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                           q_hidden_size: int, kv_hidden_size: int, head_dim: int,
                           eps: float | None = None, q_weight=None, k_weight=None, q_bias=None,
                           k_bias=None):
    """Split ``x [B, q_hidden + 2 kv_hidden]`` into q / k / v; q and k get a
    per-head RMSNorm (:func:`rms_norm_ref` over ``head_dim``, scaled by
    ``q_weight`` / ``k_weight``, plus the optional bias; none where ``eps``
    is None) and rotate-half RoPE (``ops.rope.apply_rope``, ``sin`` / ``cos
    [B, head_dim]``), in f32, back to x's dtype; v passes through.  Returns
    ``(q, k, v)`` (JAX's)."""
    b = x.shape[0]
    q, k, v = torch.split(x, [q_hidden_size, kv_hidden_size, kv_hidden_size], dim=-1)

    def norm_rope(t, w, bias):
        th = t.reshape(b, -1, head_dim).float()
        if eps is not None:
            th = rms_norm_ref(th, w, eps)
            if bias is not None:
                th = th + bias.float()
        return apply_rope(th, cos, sin).to(x.dtype).reshape(b, -1)

    return norm_rope(q, q_weight, q_bias), norm_rope(k, k_weight, k_bias), v
