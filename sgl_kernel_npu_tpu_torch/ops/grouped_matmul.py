"""Grouped (ragged) expert GEMMs: host helpers, plain versions and the Hopper
kernels K8a ``grouped_matmul`` and K8b ``grouped_matmul_combine``.

Counterpart of ``sgl_kernel_npu_tpu/ops/grouped_matmul.py``.  Rows are grouped
contiguously by expert (``group_sizes [G]``, a device tensor: the kernel path
never syncs on it); rows past the groups' total come out as zeros.

- :func:`grouped_matmul` (K8a, ``csrc/grouped_matmul.cu``) takes every mode
  of JAX's: int8 rows and weights with the epilogues ``none`` (the exact
  int32 sums, f32 out), ``dequant`` (``acc * scale_x[row] * scale_w[g,
  col]``, bf16 out), ``dequant_swiglu`` (then SwiGLU on the gate / up
  packing of pack width ``tn``, bf16 out) and ``dequant_swiglu_quant``
  (SwiGLU on the full-width packing, then a per-row int8 requant; rows past
  the total get scale 0), each to ``out_dtype``; float rows and weights with
  ``none``, which it hands to :func:`grouped_matmul_float` (``out[i] = x[i] @
  w[g(i)]``, ``w [G, K, N]``) or, with ``rhs_contract_last``,
  :func:`grouped_matmul_dx` (``out[i] = x[i] @ w[g(i)]ᵀ``, ``w [G, N, K]``:
  the dx of :func:`gmm_train`); and ``dispatch_p`` with any of them: ``x``
  is then the unsorted token array and each sorted row is ``P @ x``
  (:func:`dispatch_onehot` builds P).  On the card the float modes take bf16
  rows and weights, float rows into a dequant epilogue raise (ROADMAP §C),
  a ``dispatch_p`` whose rows are not one-hot or zero raises, and the
  kernels write f32, bf16 or f16.  The TPU kernel's ``tm`` / ``tk``
  and its tile schedule (``make_gmm_metadata``) are TPU schedule, not
  semantics: the CUDA kernel finds its groups from the offsets and picks its
  own tiles.  So is ``tn``, except in ``dequant_swiglu``, where it is the
  pack width of the weights (:func:`pack_gmm1_weights`): there ``tn`` None
  takes JAX's default, :func:`select_gmm_tiles`'s width.
- :func:`grouped_matmul_combine` (K8b) is the W8A8 GMM2 with the weighted
  top-k combine as a product of the bf16 hi / lo split of the f32 combine
  mask with the bf16-rounded expert rows;
  :func:`grouped_matmul_combine_tiled_plain` is its kernel's order of work
  on the CPU, for tests.
- :func:`gmm_train` is the differentiable grouped matmul (JAX's
  ``custom_vjp``): forward on ``none``, dx on ``rhs_contract_last``, dw a loop
  of ``torch.matmul`` over the groups, as JAX leaves dw to XLA's
  ``ragged_dot_general``.
"""

from __future__ import annotations

import bisect

import torch

from sgl_kernel_npu_tpu_torch.ops.quant import row_scale, saturate_int8
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda
from sgl_kernel_npu_tpu_torch.utils.counters import counted, launched

EPILOGUES = ("none", "dequant", "dequant_swiglu", "dequant_swiglu_quant")
TILE_M_WG = 128   # item rows of K8a, K8b, K16a, K16b (gmm_int8_ring.cuh QM, grouped_matmul.cu WM)
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}   # csrc OutKind
_P_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}        # dispatch_rows
_EPI = {"dequant": 0, "none": 0, "dequant_swiglu_quant": 1, "dequant_swiglu": 2}


def _offsets(group_sizes: torch.Tensor) -> torch.Tensor:
    """``[G + 1]`` int32 row offsets of the groups (a device cumsum)."""
    off = torch.zeros(group_sizes.shape[0] + 1, dtype=torch.int32, device=group_sizes.device)
    off[1:] = torch.cumsum(group_sizes.to(torch.int32), 0)
    return off


def _tile_offsets(group_sizes: torch.Tensor, tile_m: int = TILE_M_WG) -> torch.Tensor:
    """``[G + 1]`` prefix sums of each group's work items of ``tile_m`` rows
    (``TILE_M_WG`` for the kernels): a device computation, no host sync."""
    return _offsets(torch.div(group_sizes.to(torch.int32) + tile_m - 1, tile_m,
                              rounding_mode="floor"))


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


def dispatch_onehot(tok_of_row: torch.Tensor, n_tok: int, dtype=torch.int8) -> torch.Tensor:
    """One-hot ``[S, n_tok]`` row → token matrix for ``dispatch_p``: row r
    has its 1 at column ``tok_of_row[r]`` (none for an id outside ``[0,
    n_tok)``)."""
    tok = torch.arange(n_tok, dtype=torch.int32, device=tok_of_row.device)
    return (tok_of_row[:, None] == tok[None, :]).to(dtype)


def select_gmm_tiles(s: int, k: int, n: int, in_dtype, *, num_groups: int = 8,
                     out_esize: int = 2, vmem_budget: int = 12 * 2**20) -> tuple[int, int, int]:
    """JAX's analytic tile selector (a traffic model under a TPU VMEM
    budget), kept for one reason: its ``tn`` is the default pack width of
    ``dequant_swiglu`` when the caller gives none, which is semantics."""
    esize = torch.empty((), dtype=in_dtype).element_size()
    best = (min(128, max(8, s)), min(128, k), min(128, n))
    best_cost = (float("inf"), 0, 0)
    for tm in (128, 256, 512):
        if tm > max(128, s):
            continue
        steps = max(-(-s // tm), num_groups)
        for tk in (256, 512, 1024, 2048):
            if k % tk or tk > k:
                continue
            for tn in (256, 512, 1024, 2048):
                if n % tn or tn > n:
                    continue
                vmem = 2 * (tm * tk + tk * tn) * esize + tm * tn * 4 + 2 * tm * tn * out_esize
                if vmem > vmem_budget:
                    continue
                traffic = (steps * k * n * esize + steps * (n // tn) * tm * k * esize
                           + steps * tm * n * out_esize)
                cost = (traffic, -tk, -tn)
                if cost < best_cost:
                    best, best_cost = (tm, tk, tn), cost
    return best


def _pack_width(x, w, s, out_dtype, tn) -> int:
    """``dequant_swiglu``'s gate / up pack width: ``tn`` (JAX's default when
    None), at most N."""
    n = w.shape[2]
    if tn is None:
        esize = torch.empty((), dtype=out_dtype or torch.float32).element_size()
        tn = select_gmm_tiles(s, x.shape[1], n, x.dtype, num_groups=w.shape[0],
                              out_esize=esize)[2]
    tn = min(tn, n)
    if n % tn or tn % 2:
        raise ValueError(f"dequant_swiglu's pack width {tn} must be even and divide N = {n}")
    return tn


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
    type and then taken to f32; rows past the groups' total are zeros.  Two
    int8 inputs are summed exactly (in float64), then rounded to f32."""
    n = w.shape[1] if rhs_contract_last else w.shape[2]
    exact = x.dtype == torch.int8 and w.dtype == torch.int8
    wide = torch.float64 if exact else torch.float32
    out = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
    for g, rs in _group_slices(group_sizes):
        wg = w[g].to(wide)
        out[rs] = (x[rs].to(wide) @ (wg.T if rhs_contract_last else wg)).float()
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


def swiglu_packed(y: torch.Tensor, tn: int) -> torch.Tensor:
    """SwiGLU of ``y [rows, N]`` packed by :func:`pack_gmm1_weights` at
    width ``tn``: each ``tn``-wide slab ``[gate tn/2 | up tn/2]`` gives
    ``tn/2`` output columns (:func:`swiglu_block` of each slab)."""
    rows, n = y.shape
    slabs = y.reshape(rows, n // tn, 2, tn // 2)
    gate, up = slabs[:, :, 0], slabs[:, :, 1]
    return (gate * torch.sigmoid(gate) * up).reshape(rows, n // 2)


def swiglu_requant_ref(y: torch.Tensor, live: torch.Tensor):
    """SwiGLU of the dequantized ``y [rows, gate ‖ up]``, then the per-row int8
    requant: scale ``max(amax / 127, 1e-12)`` by true division, round half to
    even, saturate.  Rows where ``live`` is False → zeros and scale 0."""
    act = swiglu_block(y)
    scale = torch.clamp_min(row_scale(act), 1e-12)
    q = saturate_int8(act / scale[:, None])
    return torch.where(live[:, None], q, 0).to(torch.int8), torch.where(live, scale, 0.0)


def dispatch_plain(x: torch.Tensor, dispatch_p: torch.Tensor) -> torch.Tensor:
    """The sorted rows ``P @ x`` as JAX's kernel forms them: int8 tokens by
    exact integer sums cast to int8 (a two's-complement wrap, as int32 →
    int8), float tokens by f32 sums cast to x's type."""
    if x.dtype == torch.int8:
        return (dispatch_p.double() @ x.double()).to(torch.int64).to(torch.int8)
    return (dispatch_p.float() @ x.float()).to(x.dtype)


def grouped_matmul_plain(x, w, group_sizes, scale_x=None, scale_w=None, *, epilogue="none",
                         tn=None, out_dtype=None, dispatch_p=None, rhs_contract_last=False):
    """The plain version of :func:`grouped_matmul`, every mode: the sorted
    rows (:func:`dispatch_plain` with ``dispatch_p``), their grouped product
    (:func:`grouped_matmul_float_plain`: exact for int8), then JAX's
    epilogue: ``* scale_x[row] * scale_w[g]`` (ones where None), SwiGLU by
    slabs of the pack width (:func:`swiglu_packed`), or
    :func:`swiglu_requant_ref`; rows past the total zero."""
    _check_modes(epilogue, rhs_contract_last)
    rows = x if dispatch_p is None else dispatch_plain(x, dispatch_p)
    acc = grouped_matmul_float_plain(rows, w, group_sizes, rhs_contract_last=rhs_contract_last)
    if epilogue == "none":
        return acc.to(out_dtype or torch.float32)
    s, n = acc.shape
    live = torch.arange(s, device=acc.device) < group_sizes.sum()
    sx = torch.ones(s, device=acc.device) if scale_x is None else scale_x.float()
    sw = torch.ones((w.shape[0], n), device=acc.device) if scale_w is None else scale_w.float()
    y = acc * sx[:, None] * sw[_row_groups(group_sizes, s)]
    y = torch.where(live[:, None], y, 0.0)
    if epilogue == "dequant_swiglu_quant":
        return swiglu_requant_ref(y, live)
    if epilogue == "dequant_swiglu":
        y = swiglu_packed(y, _pack_width(x, w, s, out_dtype, tn))
    return y.to(out_dtype or torch.bfloat16)


def _gate_col(j: torch.Tensor, ht: int) -> torch.Tensor:
    """The gate column of SwiGLU output column ``j`` when gate / up are packed
    in slabs of ``2 ht`` columns (csrc/gmm_int8_ring.cuh ``gate_col``); its up
    column is ``ht`` further."""
    return torch.div(j, ht, rounding_mode="floor") * 2 * ht + j % ht


def grouped_matmul_tiled_plain(x, w, group_sizes, scale_x=None, scale_w=None, *,
                               epilogue="none", tn=None, out_dtype=None, dispatch_p=None,
                               rhs_contract_last=False):
    """The walk of the CUDA K8a int8 kernel on the CPU, for tests (int8 rows
    and weights; no caller on the main path) → :func:`grouped_matmul`'s
    output.

    Work items of ``TILE_M_WG`` sorted rows of one group, aligned to the
    group's first row (the wrapper's tile offsets, each item's group found as
    the kernel finds it), times column tiles of 128 columns (``dequant``,
    ``none``) or of 64 gate columns and their 64 up columns (the SwiGLU
    modes, paired by the pack width's slabs); each tile's exact sum over
    stages of 128 k, rounded to f32 once, then the kernel's epilogue in its
    order: ``× scale_x[row] × scale_w[g, col]``, SwiGLU ``d0 · (1 / (1 +
    exp(-d0))) · d1``, and for ``dequant_swiglu_quant`` the per-row requant
    pass; rows past the groups' total are zeros (scale 0)."""
    _check_modes(epilogue, rhs_contract_last)
    rows_x = x if dispatch_p is None else dispatch_plain(x, dispatch_p)
    wk = w.transpose(1, 2) if rhs_contract_last else w              # [G, K, N]
    s = rows_x.shape[0]
    k, n = wk.shape[1], wk.shape[2]
    swiglu = epilogue in ("dequant_swiglu", "dequant_swiglu_quant")
    ht = n // 2
    if epilogue == "dequant_swiglu":
        ht = _pack_width(x, w, s, out_dtype, tn) // 2
    width, n_out = (64, n // 2) if swiglu else (128, n)
    offsets = _offsets(group_sizes).tolist()
    tile_off = _tile_offsets(group_sizes, TILE_M_WG).tolist()
    sx = None if scale_x is None or epilogue == "none" else scale_x.float()
    sw = None if scale_w is None or epilogue == "none" else scale_w.float()
    if swiglu and sw is None:
        sw = torch.ones((wk.shape[0], n))
    y = torch.zeros((s, n_out), dtype=torch.float32, device=x.device)
    for item in range(tile_off[-1]):
        g = sum(1 for t in tile_off[1:-1] if t <= item)           # the kernel's group count
        r0 = offsets[g] + (item - tile_off[g]) * TILE_M_WG
        r1 = min(r0 + TILE_M_WG, offsets[g + 1], s)
        sxr = torch.ones(r1 - r0) if sx is None else sx[r0:r1]
        for bx in range(-(-n_out // width)):
            j = bx * width + torch.arange(width)
            live = j < n_out
            cols = _gate_col(j, ht) if swiglu else j
            cols = torch.cat([cols, cols + ht]) if swiglu else cols
            cols = torch.where(torch.cat([live, live]) if swiglu else live, cols, 0)
            acc = torch.zeros((r1 - r0, cols.numel()), dtype=torch.float64)
            for k0 in range(0, k, 128):                             # exact: int8 sums in f64
                acc += rows_x[r0:r1, k0:k0 + 128].double() @ wk[g, k0:k0 + 128][:, cols].double()
            acc = acc.float()
            scw = torch.ones(cols.numel()) if sw is None else sw[g, cols]
            d = acc * sxr[:, None] * scw[None, :]
            if swiglu:
                d0, d1 = d[:, :width], d[:, width:]
                d = d0 * (1.0 / (1.0 + torch.exp(-d0))) * d1
            y[r0:r1, j[live]] = d[:, live]
    if epilogue == "dequant_swiglu_quant":
        live = torch.arange(s) < offsets[-1]
        scale = torch.where(live, torch.clamp_min(y.abs().amax(-1) / 127.0, 1e-12), 0.0)
        q = torch.clamp(torch.round(y / torch.where(live, scale, 1.0)[:, None]), -128, 127)
        return torch.where(live[:, None], q, 0).to(torch.int8), scale
    return y.to(out_dtype or (torch.float32 if epilogue == "none" else torch.bfloat16))


def _check_modes(epilogue, rhs_contract_last) -> None:
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if rhs_contract_last and epilogue != "none":
        raise ValueError("rhs_contract_last takes the epilogue 'none' only, as in JAX")


def _ptr(t):
    """A launch argument: the tensor's device pointer, or NULL for None."""
    return None if t is None else t.data_ptr()


def _out_kind(what: str, dtype) -> int:
    if dtype not in _OUT_KIND:
        raise ValueError(f"{what} writes f32, bf16 or f16 on the card, not {dtype}")
    return _OUT_KIND[dtype]


def _dispatch_args(what: str, x, dispatch_p, s: int):
    """``(p, n_tok, p_kind, xrow scratch, bad count)`` of a launch (Nones
    without P)."""
    if dispatch_p is None:
        return None, 0, 0, None, None
    if (dispatch_p.dim() != 2 or dispatch_p.shape != (s, x.shape[0])
            or dispatch_p.dtype not in _P_KIND):
        raise ValueError(f"{what}: dispatch_p must be [S, n_tok] = [{s}, {x.shape[0]}] of int8, "
                         f"bf16 or f32, got {dispatch_p.dtype} {tuple(dispatch_p.shape)}")
    p = dispatch_p.contiguous()
    xrow = torch.empty(s, dtype=torch.int32, device=x.device)
    bad = torch.empty(1, dtype=torch.int32, device=x.device)
    return p, x.shape[0], _P_KIND[p.dtype], xrow, bad


def _check_one_hot(what: str, bad) -> None:
    """Refuse a ``dispatch_p`` the card's prologue cannot take: it finds each
    row's token instead of multiplying, so a row of P must be one-hot (a
    single 1) or zero.  Reads the prologue's count (one device sync a call
    with P)."""
    if bad is not None and int(bad.item()):
        raise ValueError(f"{what}: {int(bad.item())} rows of dispatch_p are neither one-hot nor "
                         "zero; the card takes a one-hot P only (the plain version takes any P, "
                         "ROADMAP §C)")


@counted(modes=("dequant", "dequant_f32", "dequant_swiglu", "dequant_swiglu_quant",
                "none_int8", "dispatch_p"))
def grouped_matmul(x, w, group_sizes, scale_x=None, scale_w=None, *, epilogue="none",
                   tn=None, out_dtype=None, dispatch_p=None, rhs_contract_last=False):
    """Ragged grouped GEMM with a fused epilogue (K8a), JAX's signature.

    ``x [S, K]`` rows grouped contiguously by expert (with ``dispatch_p [S,
    n_tok]``: the unsorted tokens ``[n_tok, K]``), ``w [G, K, N]`` (``[G, N,
    K]`` with ``rhs_contract_last``), ``group_sizes [G]``, ``scale_x [S]`` and
    ``scale_w [G, N]`` (the dequant epilogues; ones where None).  ``none`` →
    ``[S, N]`` f32; ``dequant`` → bf16 ``[S, N]``; ``dequant_swiglu`` → bf16
    ``[S, N / 2]`` from weights packed at width ``tn``;
    ``dequant_swiglu_quant`` → ``(int8 [S, N / 2], f32 scale [S])``;
    ``out_dtype`` overrides the output type.  Float rows and weights with
    ``none`` go to :func:`grouped_matmul_float` / :func:`grouped_matmul_dx`,
    which count their own launches.  JAX's ``tm`` / ``tk`` are TPU schedule
    and not taken, nor is ``tn`` outside ``dequant_swiglu``.  On the card a
    row of ``dispatch_p`` must be one-hot or zero (else ``ValueError``).
    CUDA tensors launch ``csrc/grouped_matmul.cu``; CPU tensors take
    :func:`grouped_matmul_plain`."""
    _check_modes(epilogue, rhs_contract_last)
    float_rows = x.dtype.is_floating_point
    if epilogue == "none" and float_rows and w.dtype.is_floating_point:
        return (grouped_matmul_dx if rhs_contract_last else grouped_matmul_float)(
            x, w, group_sizes, out_dtype=out_dtype, dispatch_p=dispatch_p)
    args = (x, w, group_sizes, scale_x, scale_w)
    kw = dict(epilogue=epilogue, tn=tn, out_dtype=out_dtype, dispatch_p=dispatch_p,
              rhs_contract_last=rhs_contract_last)
    if not on_cuda(*(t for t in (*args, dispatch_p) if t is not None)):
        return grouped_matmul_plain(*args, **kw)
    if float_rows:
        raise NotImplementedError(
            f"grouped_matmul {epilogue!r} on {x.dtype} rows runs on the plain path only: the "
            "card's kernel takes int8 rows into an epilogue (ROADMAP §C)")
    s = x.shape[0] if dispatch_p is None else dispatch_p.shape[0]
    k = x.shape[1]
    g, k_w, n = w.shape
    if rhs_contract_last:             # w [G, N, K]: K-major, as the kernel reads it
        n, k_w = k_w, n
    if (x.dtype != torch.int8 or w.dtype != torch.int8 or k_w != k or k % 16 or n % 16
            or group_sizes.shape != (g,)):
        raise ValueError(f"grouped_matmul takes int8 rows and weights with K % 16 == 0 and N % "
                         f"16 == 0 on the card: x {x.dtype} {tuple(x.shape)}, w {w.dtype} "
                         f"{tuple(w.shape)}, groups {tuple(group_sizes.shape)}")
    dev = x.device
    sx = None if scale_x is None else scale_x.float().contiguous()
    sw = None if scale_w is None else scale_w.float().contiguous()
    if (sx is not None and sx.shape != (s,)) or (sw is not None and sw.shape != (g, n)):
        raise ValueError(f"grouped_matmul scales: {None if sx is None else tuple(sx.shape)}, "
                         f"{None if sw is None else tuple(sw.shape)}; want ({s},), ({g}, {n})")
    swiglu = epilogue in ("dequant_swiglu", "dequant_swiglu_quant")
    if epilogue == "none":
        sx = sw = None                  # the kernel takes a NULL scale as 1
    elif swiglu and sw is None:         # the SwiGLU tile reads its weight scales
        sw = torch.ones((g, n), device=dev)
    ht = n // 2
    if epilogue == "dequant_swiglu":
        ht = _pack_width(x, w, s, out_dtype, tn) // 2
        if ht % 16:
            raise ValueError(f"dequant_swiglu on the card needs a pack width divisible by 32, "
                             f"got {2 * ht}")
    p, n_tok, p_kind, xrow, bad = _dispatch_args("grouped_matmul", x, dispatch_p, s)
    x, w = x.contiguous(), w.contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("grouped_matmul: x and w must start 16-byte aligned (TMA)")
    act = amax = hs = None
    if epilogue == "dequant_swiglu_quant":
        out = torch.empty((s, n // 2), dtype=torch.int8, device=dev)
        act = torch.empty((s, n // 2), dtype=torch.float32, device=dev)
        amax = torch.empty((s,), dtype=torch.int32, device=dev)
        hs = torch.empty((s,), dtype=torch.float32, device=dev)
        out_kind = 0
    else:
        dtype = out_dtype or (torch.float32 if epilogue == "none" else torch.bfloat16)
        out_kind = _out_kind("grouped_matmul", dtype)
        out = torch.empty((s, n // 2 if swiglu else n), dtype=dtype, device=dev)
    offsets, tile_off = _offsets(group_sizes), _tile_offsets(group_sizes, TILE_M_WG)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.grouped_matmul_int8_launch(
        x.data_ptr(), w.data_ptr(), offsets.data_ptr(), tile_off.data_ptr(), g, s, k, n, ht,
        _EPI[epilogue], int(rhs_contract_last), out_kind, _ptr(sx), _ptr(sw), _ptr(p), n_tok,
        p_kind, _ptr(xrow),
        _ptr(bad), out.data_ptr(), _ptr(act), _ptr(amax), _ptr(hs), cuda_lib.stream_ptr(x)),
        "grouped_matmul")
    _check_one_hot("grouped_matmul", bad)
    mode = epilogue
    if epilogue == "none":
        mode = "none_int8"
    elif epilogue == "dequant" and out.dtype != torch.bfloat16:
        mode = "dequant_f32"
    launched(grouped_matmul, mode, *(("dispatch_p",) if p is not None else ()))
    return (out, hs) if epilogue == "dequant_swiglu_quant" else out


def _launch_float(x, w, group_sizes, contract_last: bool, out_dtype, dispatch_p):
    """Launch K8a's bf16 mode on ``x [S, K]`` (with ``dispatch_p``: the
    tokens) and ``w`` (``[G, K, N]``, or ``[G, N, K]`` with
    ``contract_last``) → ``[S, N]`` in ``out_dtype`` (f32 by default)."""
    what = "grouped_matmul_dx" if contract_last else "grouped_matmul_float"
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"{what} takes bf16 rows and weights on the card, got {x.dtype} and "
                         f"{w.dtype} (ROADMAP §C; the plain version takes other types on the CPU)")
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"{what} takes x [S, K] and w [G, ., .], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    k = x.shape[1]
    s = x.shape[0] if dispatch_p is None else dispatch_p.shape[0]
    g = w.shape[0]
    n, k_w = (w.shape[1], w.shape[2]) if contract_last else (w.shape[2], w.shape[1])
    if (k_w != k or k % 8 or n % 8 or not x.is_contiguous() or not w.is_contiguous()
            or group_sizes.shape != (g,)):
        raise ValueError(f"{what} shapes: x {tuple(x.shape)}, w {tuple(w.shape)}, groups "
                         f"{tuple(group_sizes.shape)} (contiguous, K % 8 == 0, N % 8 == 0)")
    dtype = out_dtype or torch.float32
    out_kind = _out_kind(what, dtype)
    p, n_tok, p_kind, xrow, bad = _dispatch_args(what, x, dispatch_p, s)
    out = torch.empty((s, n), dtype=dtype, device=x.device)
    offsets, tile_off = _offsets(group_sizes), _tile_offsets(group_sizes, TILE_M_WG)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.grouped_matmul_bf16_launch(
        x.data_ptr(), w.data_ptr(), offsets.data_ptr(), tile_off.data_ptr(), g, s, k, n,
        int(contract_last), out_kind, _ptr(p), n_tok, p_kind, _ptr(xrow), _ptr(bad),
        out.data_ptr(), cuda_lib.stream_ptr(x)), what)
    _check_one_hot(what, bad)
    return out


def _float_modes(out, dispatch_p) -> tuple:
    return (*(("bf16_out",) if out.dtype != torch.float32 else ()),
            *(("dispatch_p",) if dispatch_p is not None else ()))


@counted(modes=("bf16_out", "dispatch_p"))
def grouped_matmul_float(x, w, group_sizes, *, out_dtype=None, dispatch_p=None):
    """K8a's ``none`` mode: ``out[i] = x[i] @ w[g(i)]`` (f32, or
    ``out_dtype``) for ``x [S, K]`` rows grouped contiguously by expert (with
    ``dispatch_p``: the tokens, each row ``P @ x``) and ``w [G, K, N]``; rows
    past the groups' total are zeros.  CUDA tensors (bf16) launch
    ``csrc/grouped_matmul.cu``; CPU tensors take
    :func:`grouped_matmul_float_plain`."""
    if not on_cuda(x, w, group_sizes, *(() if dispatch_p is None else (dispatch_p,))):
        rows = x if dispatch_p is None else dispatch_plain(x, dispatch_p)
        return grouped_matmul_float_plain(rows, w, group_sizes).to(out_dtype or torch.float32)
    out = _launch_float(x, w, group_sizes, False, out_dtype, dispatch_p)
    launched(grouped_matmul_float, *_float_modes(out, dispatch_p))
    return out


@counted(modes=("bf16_out", "dispatch_p"))
def grouped_matmul_dx(x, w, group_sizes, *, out_dtype=None, dispatch_p=None):
    """K8a's ``rhs_contract_last`` mode: ``out[i] = x[i] @ w[g(i)]ᵀ`` for ``w
    [G, N, K]`` (read as stored: no transposed copy), the dx of
    :func:`gmm_train`; otherwise as :func:`grouped_matmul_float`."""
    if not on_cuda(x, w, group_sizes, *(() if dispatch_p is None else (dispatch_p,))):
        rows = x if dispatch_p is None else dispatch_plain(x, dispatch_p)
        return grouped_matmul_float_plain(rows, w, group_sizes, rhs_contract_last=True).to(
            out_dtype or torch.float32)
    out = _launch_float(x, w, group_sizes, True, out_dtype, dispatch_p)
    launched(grouped_matmul_dx, *_float_modes(out, dispatch_p))
    return out


# ---------------------------------------------------------------------------
# K8b: the combine-fused grouped matmul
# ---------------------------------------------------------------------------

def combine_masks(dest: torch.Tensor, topk_w: torch.Tensor, rows: int):
    """JAX's combine mask of the ``_gmm_moe`` branch: ``[n, rows]`` f32 with
    each token's top-k weights at its sorted rows ``dest [n, k]``, split into
    bf16 ``(hi, lo)`` with ``hi + lo`` the f32 mask to bf16 precision twice."""
    n = dest.shape[0]
    mask = torch.zeros((n, rows), dtype=torch.float32, device=dest.device)
    mask.scatter_add_(1, dest.long(), topk_w.float())
    hi = mask.to(torch.bfloat16)
    return hi, (mask - hi.float()).to(torch.bfloat16)


def grouped_matmul_combine_plain(x, w, group_sizes, scale_x, scale_w, combine_hi, combine_lo,
                                 *, out_dtype=torch.float32):
    """The plain version of :func:`grouped_matmul_combine`: ``d =
    bf16(gmm_dequant_ref(...))`` with rows outside every group 0, then
    ``hi @ d + lo @ d`` in f32 with the mask columns past the groups' total
    0 (JAX masks each tile's columns to its group)."""
    s = x.shape[0]
    live = torch.arange(s, device=x.device) < group_sizes.sum()
    d = gmm_dequant_ref(x, w, group_sizes, scale_x.float(), scale_w.float())
    d = torch.where(live[:, None], d, 0.0).to(torch.bfloat16).float()
    hi = torch.where(live[None, :], combine_hi.float(), 0.0)
    lo = torch.where(live[None, :], combine_lo.float(), 0.0)
    return (hi @ d + lo @ d).to(out_dtype)


COMBINE_BLOCKS = 264   # K8b's first pass on an H100: two blocks on each of 132 SMs


def combine_row_units(group_sizes, s: int, n: int, blocks: int = COMBINE_BLOCKS) -> list[list]:
    """The units of K8b's first pass (csrc/grouped_matmul.cu
    ``combine_rows_kernel``) by block: (128-row item, 128-column tile) units
    ``w = item · ct + bx``, block b taking ``b, b + blocks, ...``, each as
    ``(g, r0, rows, bx)`` with its group found as the kernel finds it (the
    last group whose first item is at or before it) and its rows cut at the
    group's end and at ``s`` (syncs on the sizes)."""
    offsets = _offsets(group_sizes).tolist()
    tile_off = _tile_offsets(group_sizes, TILE_M_WG).tolist()
    ct = -(-n // TILE_M_WG)
    by_block = []
    for b in range(blocks):
        units = []
        for w in range(b, tile_off[-1] * ct, blocks):
            item = w // ct
            g = bisect.bisect_right(tile_off, item, 0, len(tile_off) - 1) - 1
            r0 = offsets[g] + (item - tile_off[g]) * TILE_M_WG
            units.append((g, r0, min(r0 + TILE_M_WG, offsets[g + 1], s) - r0, w % ct))
        by_block.append(units)
    return by_block


def grouped_matmul_combine_tiled_plain(x, w, group_sizes, scale_x, scale_w, combine_hi,
                                       combine_lo, *, out_dtype=torch.float32):
    """The CUDA K8b kernels' order of work on the CPU, for tests (no caller
    on the main path) → :func:`grouped_matmul_combine`'s output.  ``d`` unit
    by unit of :func:`combine_row_units` (each unit's exact sum, rounded to
    f32 once, ``× scale_x[row] × scale_w[g, col]``, to bf16; rows past the
    total 0), then the mask products over the rows of d below the total in
    order, in steps of 16 rows (a ``wgmma`` k-step), each the hi product then
    the lo product, its exact sum (f64) added into one f32 accumulator; the
    mask columns past the total are never read."""
    s, n = x.shape[0], w.shape[2]
    sx, sw = scale_x.float(), scale_w.float()
    d = torch.zeros((s, n), dtype=torch.float32)
    for units in combine_row_units(group_sizes, s, n):
        for g, r0, rows, bx in units:
            cols = slice(bx * TILE_M_WG, min((bx + 1) * TILE_M_WG, n))
            acc = (x[r0:r0 + rows].double() @ w[g, :, cols].double()).float()   # exact
            d[r0:r0 + rows, cols] = acc * sx[r0:r0 + rows, None] * sw[g, cols][None, :]
    d = d.to(torch.bfloat16).double()
    total = min(int(group_sizes.sum()), s)
    acc = torch.zeros((combine_hi.shape[0], n), dtype=torch.float32)
    for k0 in range(0, total, 16):
        k1 = min(k0 + 16, total)
        for m in (combine_hi, combine_lo):
            acc = (acc.double() + m[:, k0:k1].double() @ d[k0:k1]).float()
    return acc.to(out_dtype)


def _combine_launch(x, w, group_sizes, scale_x, scale_w, combine_hi, combine_lo, out_dtype):
    """K8b's three launches → ``(out, d)``: the wrapper's output and its first
    pass's bf16 rows (a scratch the caller may read)."""
    s, k = x.shape
    g, k_w, n = w.shape
    n_tok = combine_hi.shape[0]
    if (x.dtype != torch.int8 or w.dtype != torch.int8 or k_w != k or k % 16 or n % 16
            or group_sizes.shape != (g,) or combine_hi.shape != (n_tok, s)
            or combine_lo.shape != (n_tok, s) or combine_hi.dtype != torch.bfloat16
            or combine_lo.dtype != torch.bfloat16):
        raise ValueError(f"grouped_matmul_combine takes int8 x [S, K] and w [G, K, N] (K % 16 == "
                         f"0, N % 16 == 0) and bf16 masks [n_tok, S]: x {x.dtype} "
                         f"{tuple(x.shape)}, w {w.dtype} {tuple(w.shape)}, masks "
                         f"{combine_hi.dtype} {tuple(combine_hi.shape)}")
    dev = x.device
    sx, sw = scale_x.float().contiguous(), scale_w.float().contiguous()
    if sx.shape != (s,) or sw.shape != (g, n):
        raise ValueError(f"grouped_matmul_combine scales: {tuple(sx.shape)}, {tuple(sw.shape)}")
    x, w = x.contiguous(), w.contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("grouped_matmul_combine reads x and w by TMA: both must start 16-byte "
                         "aligned")
    hi, lo = combine_hi.contiguous(), combine_lo.contiguous()
    sizes = group_sizes.to(torch.int32).contiguous()
    offs = torch.empty(2 * (g + 1), dtype=torch.int32, device=dev)
    d = torch.empty((s, n), dtype=torch.bfloat16, device=dev)
    out = torch.empty((n_tok, n), dtype=out_dtype, device=dev)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.grouped_matmul_combine_launch(
        x.data_ptr(), w.data_ptr(), sizes.data_ptr(), g, s, k, n, sx.data_ptr(), sw.data_ptr(),
        hi.data_ptr(), lo.data_ptr(), n_tok, _out_kind("grouped_matmul_combine", out_dtype),
        offs.data_ptr(), d.data_ptr(), out.data_ptr(), cuda_lib.stream_ptr(x)),
        "grouped_matmul_combine")
    return out, d


@counted
def grouped_matmul_combine(x, w, group_sizes, scale_x, scale_w, combine_hi, combine_lo, *,
                           out_dtype=torch.float32):
    """W8A8 grouped matmul with the weighted top-k combine fused (K8b):
    ``out [n_tok, N] = hi @ d + lo @ d`` with ``d[r] = bf16(x[r] @ w[g(r)] *
    scale_x[r] * scale_w[g(r)])`` for the rows in a group (0 elsewhere).
    ``x [S, K]`` int8 expert-sorted rows, ``w [G, K, N]`` int8, ``scale_x
    [S]``, ``scale_w [G, N]``, ``combine_hi`` / ``combine_lo [n_tok, S]`` the
    bf16 hi / lo split of the f32 weight mask (:func:`combine_masks`).
    JAX's ``tm`` / ``tk`` / ``tn`` are TPU schedule and not taken.  CUDA
    tensors launch ``csrc/grouped_matmul.cu`` (x and w 16-byte aligned);
    CPU tensors take :func:`grouped_matmul_combine_plain`."""
    args = (x, w, group_sizes, scale_x, scale_w, combine_hi, combine_lo)
    if not on_cuda(*args):
        return grouped_matmul_combine_plain(*args, out_dtype=out_dtype)
    out, _ = _combine_launch(*args, out_dtype)
    grouped_matmul_combine.launches += 1
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
