"""Grouped (ragged) expert GEMMs: host helpers, plain versions and the Hopper
kernel K8a ``grouped_matmul``.

Counterpart of ``sgl_kernel_npu_tpu/ops/grouped_matmul.py``.  Rows are grouped
contiguously by expert (``group_sizes [G]``, a device tensor: the kernel path
never syncs on it); rows past the groups' total come out as zeros.

- :func:`grouped_matmul` (K8a, ``csrc/grouped_matmul.cu``) takes int8 rows and
  weights with the ``dequant`` epilogue (``out = acc * scale_x[row] *
  scale_w[g, col]`` cast to bf16) and the
  ``dequant_swiglu_quant`` one (SwiGLU on the full-width gate ‖ up packing,
  then a per-row int8 requant; rows past the total get scale 0), and float
  rows and weights with the ``none`` epilogue (f32 out), which it hands to
  :func:`grouped_matmul_float` (``out[i] = x[i] @ w[g(i)]``, ``w [G, K, N]``)
  or, with ``rhs_contract_last``, :func:`grouped_matmul_dx` (``out[i] = x[i]
  @ w[g(i)]ᵀ``, ``w [G, N, K]``: the dx of :func:`gmm_train`).  On the card
  the float modes take bf16 rows and weights.  The TPU
  kernel's tile arguments (``tm``/``tk``/``tn``) and its tile schedule
  (``make_gmm_metadata``) are TPU schedule, not semantics: the CUDA kernel
  finds its groups from the offsets and picks its own tiles.
- :func:`gmm_train` is the differentiable grouped matmul (JAX's
  ``custom_vjp``): forward on ``none``, dx on ``rhs_contract_last``, dw a loop
  of ``torch.matmul`` over the groups, as JAX leaves dw to XLA's
  ``ragged_dot_general``.
- Not ported yet (ROADMAP queue B): the float epilogue ``dequant_swiglu``,
  ``dispatch_p``, ``dequant`` to f32, and ``grouped_matmul_combine`` (K8b).
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.ops.quant import row_scale, saturate_int8
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda
from sgl_kernel_npu_tpu_torch.utils.counters import counted

EPILOGUES = ("none", "dequant", "dequant_swiglu", "dequant_swiglu_quant")
PORTED_EPILOGUES = ("none", "dequant", "dequant_swiglu_quant")
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


def grouped_matmul_float_plain(x, w, group_sizes, *, rhs_contract_last: bool = False):
    """The plain version of the float modes: per group, the f32 product of
    the rows and the weights (``w [G, K, N]``, or ``[G, N, K]`` contracted on
    its last dim with ``rhs_contract_last``), each input rounded to its own
    type and then taken to f32; rows past the groups' total are zeros."""
    n = w.shape[1] if rhs_contract_last else w.shape[2]
    out = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
    for g, rs in _group_slices(group_sizes):
        wg = w[g].float()
        out[rs] = x[rs].float() @ (wg.T if rhs_contract_last else wg)
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
            f"grouped_matmul epilogue {epilogue!r} (the float SwiGLU of tile-packed gate / up) "
            "is not ported yet (ROADMAP queue B, K8a)")
    if dispatch_p is not None:
        raise NotImplementedError("grouped_matmul with dispatch_p (the in-kernel one-hot "
                                  "dispatch) is not ported yet (ROADMAP queue B, K8a)")
    if rhs_contract_last and epilogue != "none":
        raise ValueError("rhs_contract_last takes the epilogue 'none' only, as in JAX")
    if epilogue == "none":
        if not (x.dtype.is_floating_point and w.dtype.is_floating_point):
            raise NotImplementedError(
                f"grouped_matmul 'none' on {x.dtype} rows and {w.dtype} weights (integer "
                "products to f32) is not ported yet (ROADMAP queue B, K8a)")
        if out_dtype not in (None, torch.float32):
            raise NotImplementedError(f"grouped_matmul 'none' to {out_dtype}: the port writes "
                                      "f32 only (ROADMAP queue B, K8a)")
        return
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise NotImplementedError(
            f"grouped_matmul {epilogue!r} takes int8 rows and weights in the port; float "
            f"input ({x.dtype}, {w.dtype}) is not ported yet (ROADMAP queue B, K8a)")
    if epilogue == "dequant" and out_dtype not in (None, torch.bfloat16):
        raise NotImplementedError(f"grouped_matmul 'dequant' to {out_dtype}: the port writes "
                                  "bf16 only (ROADMAP queue B, K8a)")


@counted
def grouped_matmul(x, w, group_sizes, scale_x=None, scale_w=None, *, epilogue="none",
                   out_dtype=None, dispatch_p=None, rhs_contract_last=False):
    """Ragged grouped GEMM with a fused epilogue (K8a).

    ``x [S, K]`` rows grouped contiguously by expert, ``w [G, K, N]``,
    ``group_sizes [G]``.  ``none`` (float rows and weights, no scales) → f32
    ``[S, N]`` through :func:`grouped_matmul_float`, or with
    ``rhs_contract_last`` (``w [G, N, K]``) :func:`grouped_matmul_dx`; those
    count their own launches.  W8A8 (int8 rows and weights, ``scale_x
    [S]``, ``scale_w [G, N]``): ``dequant`` → bf16 ``[S, N]``;
    ``dequant_swiglu_quant`` (gate ‖ up at full width, ``N = 2I``) → ``(int8
    [S, I], f32 scale [S])``.  CUDA tensors launch
    ``csrc/grouped_matmul.cu``; CPU tensors take :func:`grouped_matmul_plain`."""
    _check_modes(x, w, epilogue, out_dtype, dispatch_p, rhs_contract_last)
    if epilogue == "none":
        return (grouped_matmul_dx if rhs_contract_last else grouped_matmul_float)(
            x, w, group_sizes)
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


def _launch_float(x, w, group_sizes, contract_last: bool) -> torch.Tensor:
    """Launch K8a's bf16 mode on ``x [S, K]`` and ``w`` (``[G, K, N]``, or
    ``[G, N, K]`` with ``contract_last``) → f32 ``[S, N]``."""
    what = "grouped_matmul_dx" if contract_last else "grouped_matmul_float"
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"{what} takes bf16 rows and weights on the card, got {x.dtype} and "
                         f"{w.dtype} (ROADMAP §C; the plain version takes other types on the CPU)")
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"{what} takes x [S, K] and w [G, ., .], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    s, k = x.shape
    g = w.shape[0]
    n, k_w = (w.shape[1], w.shape[2]) if contract_last else (w.shape[2], w.shape[1])
    if (k_w != k or k % 8 or n % 8 or not x.is_contiguous() or not w.is_contiguous()
            or group_sizes.shape != (g,)):
        raise ValueError(f"{what} shapes: x {tuple(x.shape)}, w {tuple(w.shape)}, groups "
                         f"{tuple(group_sizes.shape)} (contiguous, K % 8 == 0, N % 8 == 0)")
    out = torch.empty((s, n), dtype=torch.float32, device=x.device)
    offsets = _offsets(group_sizes)
    tile_off = _offsets(torch.div(group_sizes.to(torch.int32) + TILE_M - 1, TILE_M,
                                  rounding_mode="floor"))
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.grouped_matmul_bf16_launch(
        x.data_ptr(), w.data_ptr(), offsets.data_ptr(), tile_off.data_ptr(), g, s, k, n,
        int(contract_last), out.data_ptr(), cuda_lib.stream_ptr(x)), what)
    return out


@counted
def grouped_matmul_float(x, w, group_sizes):
    """K8a's ``none`` mode: ``out[i] = x[i] @ w[g(i)]`` in f32 for ``x [S, K]``
    rows grouped contiguously by expert and ``w [G, K, N]``; rows past the
    groups' total are zeros.  CUDA tensors (bf16) launch
    ``csrc/grouped_matmul.cu``; CPU tensors take
    :func:`grouped_matmul_float_plain`."""
    if not on_cuda(x, w, group_sizes):
        return grouped_matmul_float_plain(x, w, group_sizes)
    out = _launch_float(x, w, group_sizes, False)
    grouped_matmul_float.launches += 1
    return out


@counted
def grouped_matmul_dx(x, w, group_sizes):
    """K8a's ``rhs_contract_last`` mode: ``out[i] = x[i] @ w[g(i)]ᵀ`` in f32
    for ``w [G, N, K]`` (read as stored: no transposed copy), the dx of
    :func:`gmm_train`; otherwise as :func:`grouped_matmul_float`."""
    if not on_cuda(x, w, group_sizes):
        return grouped_matmul_float_plain(x, w, group_sizes, rhs_contract_last=True)
    out = _launch_float(x, w, group_sizes, True)
    grouped_matmul_dx.launches += 1
    return out


def gmm_dw(x, dy, group_sizes, dtype) -> torch.Tensor:
    """The weight gradient of :func:`gmm_train`: ``dw[g] = x[rows of g]ᵀ @
    dy[rows of g]`` ``[G, K, N]``, zeros for an empty group, accumulated in
    f32 and rounded once to ``dtype`` (JAX's ``ragged_dot_general`` with
    ``preferred_element_type=f32``, then ``astype``).  A library product over
    the groups, one host read of ``group_sizes``: JAX computes it outside any
    Pallas kernel too.  bf16 inputs multiply on the tensor cores, which
    accumulate in f32 and round the product once."""
    prod = torch.promote_types(x.dtype, dtype)
    dw = torch.empty((group_sizes.shape[0], x.shape[1], dy.shape[1]), dtype=dtype,
                     device=x.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        rs = slice(start, start + size)
        start += size
        if not size:
            dw[e].zero_()
        elif prod == dtype:                     # the product lands in dw itself
            torch.matmul(x[rs].T.to(prod), dy[rs].to(prod), out=dw[e])
        else:
            dw[e] = torch.matmul(x[rs].T.to(prod), dy[rs].to(prod))
    return dw


class _GmmTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group_sizes, plain):
        ctx.save_for_backward(x, w, group_sizes)
        ctx.plain = plain
        fwd = grouped_matmul_float_plain if plain else grouped_matmul_float
        return fwd(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, gs = ctx.saved_tensors
        dy_b = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if ctx.plain:
                dx = grouped_matmul_float_plain(dy_b, w, gs, rhs_contract_last=True)
            else:
                dx = grouped_matmul_dx(dy_b, w, gs)
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = gmm_dw(x, dy_b, gs, w.dtype)
        return dx, dw, None, None


def gmm_train(x, w, group_sizes, *, plain: bool = False):
    """Differentiable grouped matmul ``out[i] = x[i] @ w[g(i)]`` (f32), JAX's
    ``gmm_train`` ``custom_vjp`` as a ``torch.autograd.Function``: the
    forward on :func:`grouped_matmul_float`; dx on :func:`grouped_matmul_dx`
    with ``dy`` rounded to x's type, the result cast to x's type; dw by
    :func:`gmm_dw` with the same rounded ``dy``.  ``plain`` runs the plain
    versions of both kernel modes."""
    return _GmmTrain.apply(x, w, group_sizes, plain)


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
