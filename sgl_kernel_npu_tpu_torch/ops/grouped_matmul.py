"""Grouped (ragged) expert GEMMs: host helpers, plain versions and the Hopper
kernel K8a ``grouped_matmul``.

Counterpart of ``sgl_kernel_npu_tpu/ops/grouped_matmul.py``.  Rows are grouped
contiguously by expert (``group_sizes [G]``, a device tensor: the kernel path
never syncs on it); rows past the groups' total come out as zeros.

- :func:`grouped_matmul` (K8a, ``csrc/grouped_matmul.cu``) takes int8 rows and
  weights with the ``dequant`` epilogue (``out = acc * scale_x[row] *
  scale_w[g, col]`` cast to bf16) and the
  ``dequant_swiglu_quant`` one (SwiGLU on the full-width gate ‖ up packing,
  then a per-row int8 requant; rows past the total get scale 0).  The TPU
  kernel's tile arguments (``tm``/``tk``/``tn``) and its tile schedule
  (``make_gmm_metadata``) are TPU schedule, not semantics: the CUDA kernel
  finds its groups from the offsets and picks its own tiles.
- Not ported yet (ROADMAP queue B): the float epilogues ``none`` and
  ``dequant_swiglu`` (training and expert parallelism), ``dispatch_p``,
  ``rhs_contract_last``, outputs other than bf16, and
  ``grouped_matmul_combine`` (K8b).
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.quant import row_scale, saturate_int8
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda
from sgl_kernel_npu_tpu_torch.utils.counters import counted

EPILOGUES = ("none", "dequant", "dequant_swiglu", "dequant_swiglu_quant")
PORTED_EPILOGUES = ("dequant", "dequant_swiglu_quant")
TILE_M = 64   # sorted rows per work item of the CUDA kernel (csrc/grouped_matmul.cu BM)


def _offsets(group_sizes: torch.Tensor) -> torch.Tensor:
    """``[G + 1]`` int32 row offsets of the groups (a device cumsum)."""
    off = torch.zeros(group_sizes.shape[0] + 1, dtype=torch.int32, device=group_sizes.device)
    off[1:] = torch.cumsum(group_sizes.to(torch.int32), 0)
    return off


def _row_groups(group_sizes: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Group id per row (rows past the total get the last group)."""
    ends = torch.cumsum(group_sizes.long(), 0)
    rows = torch.arange(num_rows, device=group_sizes.device)
    return torch.clamp(torch.searchsorted(ends, rows, right=True), 0, group_sizes.shape[0] - 1)


def _group_slices(group_sizes: torch.Tensor):
    """``(g, rows slice)`` of every non-empty group (syncs on the sizes)."""
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        if size:
            yield g, slice(start, start + size)
        start += size


def grouped_matmul_ref(x, w, group_sizes):
    """``out[i] = x[i] @ w[g(i)]`` in f32 with rows grouped contiguously (the
    golden, JAX's ``ragged_dot``); rows past the total are zeros.  Integer
    inputs are summed exactly (float64 holds every int8 dot product of these
    widths)."""
    wide = torch.float64 if not x.dtype.is_floating_point else torch.float32
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32, device=x.device)
    for g, rs in _group_slices(group_sizes):
        out[rs] = (x[rs].to(wide) @ w[g].to(wide)).float()
    return out


def gmm_dequant_ref(x_q, w_q, group_sizes, scale_x, scale_w):
    """Plain W8A8 grouped matmul with per-row × per-channel dequant:
    ``out[i] = (x_q[i] @ w_q[g(i)]) * scale_x[i] * scale_w[g(i)]`` over rows
    grouped contiguously; rows past the groups' total are zeros.  The integer
    products are summed exactly, then rounded to f32 as the int32 accumulator
    would be."""
    out = torch.zeros((x_q.shape[0], w_q.shape[2]), dtype=torch.float32, device=x_q.device)
    for g, rs in _group_slices(group_sizes):
        acc = (x_q[rs].double() @ w_q[g].double()).float()
        out[rs] = acc * scale_x[rs, None] * scale_w[g][None, :]
    return out


def swiglu_block(acc: torch.Tensor) -> torch.Tensor:
    """SwiGLU over a ``[rows, gate ‖ up]`` tile: silu(gate) * up."""
    half = acc.shape[-1] // 2
    gate, up = acc[:, :half], acc[:, half:]
    return gate * torch.sigmoid(gate) * up


def swiglu_requant_ref(y: torch.Tensor, live: torch.Tensor):
    """SwiGLU of the dequantized ``y [rows, gate ‖ up]``, then the per-row int8
    requant: scale ``max(amax / 127, 1e-12)`` by true division, round half to
    even, saturate.  Rows where ``live`` is False → zeros and scale 0."""
    act = swiglu_block(y)
    scale = torch.clamp_min(row_scale(act), 1e-12)
    q = saturate_int8(act / scale[:, None])
    return torch.where(live[:, None], q, 0).to(torch.int8), torch.where(live, scale, 0.0)


def grouped_matmul_plain(x, w, group_sizes, scale_x, scale_w, *, epilogue):
    """The plain version of :func:`grouped_matmul` (its ported modes):
    :func:`gmm_dequant_ref`, then the bf16 cast (``dequant``) or
    :func:`swiglu_requant_ref` (``dequant_swiglu_quant``)."""
    y = gmm_dequant_ref(x, w, group_sizes, scale_x.float(), scale_w.float())
    if epilogue == "dequant":
        return y.to(torch.bfloat16)
    live = torch.arange(x.shape[0], device=x.device) < group_sizes.sum()
    return swiglu_requant_ref(y, live)


def _check_modes(x, w, epilogue, out_dtype, dispatch_p, rhs_contract_last) -> None:
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue not in PORTED_EPILOGUES:
        raise NotImplementedError(
            f"grouped_matmul epilogue {epilogue!r} (float input: training and expert "
            "parallelism) is not ported yet (ROADMAP queue B, K8a)")
    if dispatch_p is not None:
        raise NotImplementedError("grouped_matmul with dispatch_p (the in-kernel one-hot "
                                  "dispatch) is not ported yet (ROADMAP queue B, K8a)")
    if rhs_contract_last:
        raise NotImplementedError("grouped_matmul with rhs_contract_last (the dx of "
                                  "gmm_train) is not ported yet (ROADMAP queue B, K8a)")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise NotImplementedError(
            f"grouped_matmul {epilogue!r} takes int8 rows and weights in the port; float "
            f"input ({x.dtype}, {w.dtype}) is not ported yet (ROADMAP queue B, K8a)")
    if epilogue == "dequant" and out_dtype not in (None, torch.bfloat16):
        raise NotImplementedError(f"grouped_matmul 'dequant' to {out_dtype}: the port writes "
                                  "bf16 only (ROADMAP queue B, K8a)")


@counted
def grouped_matmul(x, w, group_sizes, scale_x, scale_w, *, epilogue="none", out_dtype=None,
                   dispatch_p=None, rhs_contract_last=False):
    """Ragged grouped W8A8 GEMM with a fused epilogue (K8a).

    ``x [S, K]`` int8 rows grouped contiguously by expert, ``w [G, K, N]``
    int8, ``group_sizes [G]``, ``scale_x [S]``, ``scale_w [G, N]``.
    ``dequant`` → bf16 ``[S, N]``; ``dequant_swiglu_quant`` (gate ‖ up at
    full width, ``N = 2I``) → ``(int8 [S, I], f32 scale [S])``.  CUDA tensors
    launch ``csrc/grouped_matmul.cu``; CPU tensors take
    :func:`grouped_matmul_plain`."""
    _check_modes(x, w, epilogue, out_dtype, dispatch_p, rhs_contract_last)
    if not on_cuda(x, w, group_sizes, scale_x, scale_w):
        return grouped_matmul_plain(x, w, group_sizes, scale_x, scale_w, epilogue=epilogue)
    s, k = x.shape
    g, k_w, n = w.shape
    swiglu = epilogue == "dequant_swiglu_quant"
    if (k_w != k or k % 16 or n % (32 if swiglu else 16) or not x.is_contiguous()
            or not w.is_contiguous() or group_sizes.shape != (g,)):
        raise ValueError(f"grouped_matmul shapes: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"groups {tuple(group_sizes.shape)} (contiguous, K % 16 == 0, "
                         "N % 16 == 0, I % 16 == 0)")
    dev = x.device
    sx, sw = scale_x.float().contiguous(), scale_w.float().contiguous()
    if sx.shape != (s,) or sw.shape != (g, n):
        raise ValueError(f"grouped_matmul scales: {tuple(sx.shape)}, {tuple(sw.shape)}")
    offsets = _offsets(group_sizes)
    tile_off = _offsets(torch.div(group_sizes.to(torch.int32) + TILE_M - 1, TILE_M,
                                  rounding_mode="floor"))
    lib = cuda_lib.load_library()
    if swiglu:
        act = torch.empty((s, n // 2), dtype=torch.float32, device=dev)
        amax = torch.empty((s,), dtype=torch.int32, device=dev)
        out = torch.empty((s, n // 2), dtype=torch.int8, device=dev)
        scale = torch.empty((s,), dtype=torch.float32, device=dev)
        rc = lib.grouped_matmul_swiglu_quant_launch(
            x.data_ptr(), w.data_ptr(), offsets.data_ptr(), tile_off.data_ptr(), g, s, k, n,
            sx.data_ptr(), sw.data_ptr(), act.data_ptr(), amax.data_ptr(), out.data_ptr(),
            scale.data_ptr(), cuda_lib.stream_ptr(x))
        result = out, scale
    else:
        out = torch.empty((s, n), dtype=torch.bfloat16, device=dev)
        rc = lib.grouped_matmul_dequant_launch(
            x.data_ptr(), w.data_ptr(), offsets.data_ptr(), tile_off.data_ptr(), g, s, k, n,
            sx.data_ptr(), sw.data_ptr(), out.data_ptr(), cuda_lib.stream_ptr(x))
        result = out
    cuda_lib.check(lib, rc, "grouped_matmul")
    grouped_matmul.launches += 1
    return result


def default_pack_tn(n: int) -> int:
    """Widest pack width (≤ 2048) dividing ``n``; ``n`` itself otherwise."""
    for t in (2048, 1024, 512, 256):
        if n % t == 0:
            return t
    return n


def moe_pack_tn(n: int) -> int:
    """Pack width of the fused-MoE GMM1 weights: full width (the ring GEMM's
    SwiGLU needs gate ‖ up at full width) unless ``n`` is very large.  Same
    rule as the JAX package so both quantize to one layout."""
    if 128 * n * 4 + 2 * 256 * (128 + n) <= 12 * 2**20:
        return n
    return default_pack_tn(n)


def pack_gmm1_weights(w_gate: torch.Tensor, w_up: torch.Tensor, tn: int) -> torch.Tensor:
    """Interleave gate/up column blocks: each tn-wide slab = [gate tn/2 | up tn/2].
    ``[G, K, I]`` x2 → ``[G, K, 2I]``."""
    g, k, i = w_gate.shape
    half = tn // 2
    if i % half:
        raise ValueError(f"intermediate {i} is not a multiple of tn/2 = {half}")
    blocks = i // half
    return torch.stack([w_gate.reshape(g, k, blocks, half),
                        w_up.reshape(g, k, blocks, half)], dim=3).reshape(g, k, 2 * i)


def pack_gmm1_scales(s_gate: torch.Tensor, s_up: torch.Tensor, tn: int) -> torch.Tensor:
    """Per-channel scales packed to match :func:`pack_gmm1_weights`."""
    g, i = s_gate.shape
    half = tn // 2
    blocks = i // half
    return torch.stack([s_gate.reshape(g, blocks, half),
                        s_up.reshape(g, blocks, half)], dim=2).reshape(g, 2 * i)
