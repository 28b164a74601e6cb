"""Fused LoRA delta kernels (shrink and expand in one op): plain versions and
the Hopper kernels (K13a ``bgmv_fused``, K13b ``sgmv_fused``).

Counterpart of ``sgl_kernel_npu_tpu/ops/lora_pallas.py``.  CUDA tensors
launch ``csrc/lora.cu`` (a shrink launch into an f32 ``[T, R]`` scratch, then
an expand launch; the two count once); CPU tensors take
:func:`bgmv_fused_plain` / :func:`sgmv_fused_plain`;
:func:`lora_kernel_order_plain` is the kernels' order of work on the CPU,
for tests.  Each token works with
its own adapter only: the TPU kernel's "every adapter for every token, then
mask" (L times the products, to fill the MXU) is not carried over.  B is
read in its stored ``[L, D, R]`` layout, or from ``bt [L, R, D]`` when the
caller passes one: no per-call transpose.  Both return f32.
"""

from __future__ import annotations

import torch

from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import on_cuda
from sgl_kernel_npu_tpu_torch.utils.counters import counted

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_RANK = 4096     # the expand kernel holds a token's shrink in shared memory


def _live(idx: torch.Tensor, num_adapters: int):
    """(live mask, ids with dead ones set to 0) of per-row adapter ids."""
    idx = idx.long()
    live = (idx >= 0) & (idx < num_adapters)
    return live, torch.where(live, idx, torch.zeros_like(idx))


def _expand_plain(shrink, b, bt, safe, live):
    """``shrink [T, R] f32`` through each row's B (``[L, D, R]``, or ``bt [L,
    R, D]``) → ``[T, D]`` f32, dead rows 0."""
    if bt is not None:
        y = torch.einsum("tr,trd->td", shrink, bt[safe].float())
    else:
        y = torch.einsum("tr,tdr->td", shrink, b[safe].float())
    return torch.where(live[:, None], y, torch.zeros_like(y))


def bgmv_fused_plain(x, a, b=None, idx=None, *, bt=None, scaling: float = 1.0):
    """``Δ[t] = scaling · (x[t] @ A[idx_t]ᵀ) @ B[idx_t]ᵀ`` in f32, the shrink
    kept in f32; a token whose id lies outside ``[0, L)`` gets 0."""
    live, safe = _live(idx, a.shape[0])
    shrink = torch.einsum("th,trh->tr", x.float(), a[safe].float()) * scaling
    return _expand_plain(shrink, b, bt, safe, live)


def sgmv_fused_plain(x, a, b, weight_indices, seq_lengths, lora_ranks, lora_scalings):
    """Per-sequence LoRA delta over packed varlen rows (sequences contiguous,
    ``Σ seq_lengths ≤ S``) in f32: rank components at or above
    ``lora_ranks[adapter]`` are masked, the shrink scaled by
    ``lora_scalings[adapter]``; rows past the sequences (and rows of an
    adapter id outside ``[0, L)``) are 0."""
    s, r = x.shape[0], a.shape[1]
    ends = torch.cumsum(seq_lengths.long(), 0)
    rows = torch.arange(s, device=x.device)
    seq = torch.searchsorted(ends, rows, right=True)
    in_seq = seq < ends.shape[0]
    adapter = weight_indices.long()[seq.clamp(max=ends.shape[0] - 1)]
    live, safe = _live(torch.where(in_seq, adapter, torch.full_like(adapter, -1)), a.shape[0])
    shrink = torch.einsum("th,trh->tr", x.float(), a[safe].float())
    rank = lora_ranks.long()[safe]
    keep = torch.arange(r, device=x.device)[None, :] < rank[:, None]
    shrink = torch.where(keep, shrink * lora_scalings.float()[safe][:, None],
                         torch.zeros_like(shrink))
    return _expand_plain(shrink, b, None, safe, live)


def _check(name, x, a, w, transposed):
    """Shapes and types the kernels take: x ``[T, H]``, a ``[L, R, H]``, the
    expand weights ``[L, D, R]`` (or ``[L, R, D]`` transposed) of a's type."""
    ok = (x.dim() == 2 and a.dim() == 3 and w.dim() == 3 and x.dtype in _DTYPES
          and a.dtype in _DTYPES and w.dtype == a.dtype and a.shape[2] == x.shape[1]
          and w.shape[0] == a.shape[0] and w.shape[1 if transposed else 2] == a.shape[1]
          and 0 < a.shape[1] <= _MAX_RANK)
    if not ok:
        raise ValueError(f"{name} takes bf16 or f32 x [T, H], a [L, R, H] and b [L, D, R] (or bt "
                         f"[L, R, D]) of a's type, 0 < R <= {_MAX_RANK}; got x {x.dtype} "
                         f"{tuple(x.shape)}, a {a.dtype} {tuple(a.shape)}, "
                         f"{'bt' if transposed else 'b'} {w.dtype} {tuple(w.shape)}")


LANES = 32   # a shrink warp's lanes, striding over H (csrc/lora.cu)


def lora_kernel_order_plain(x, a, w, adapter, rank, scale, *, transposed: bool = False):
    """K13a / K13b's order of work on the CPU, for tests → ``[T, D]`` f32.
    ``adapter [T]`` each row's adapter (-1 dead: zeros), ``rank [T]`` its
    live rank components, ``scale [T]`` its scaling; ``w`` B ``[L, D, R]``
    or, ``transposed``, ``bt [L, R, D]``.  The shrink: a row's component is
    a warp's, lane ``l`` summing elements ``l V + 32 V k + i`` (``V`` 8 when
    H is a multiple of 8, else 1) in order, the lanes then summed by the
    butterfly of ``sgl::warp_sum`` (xor 16, 8, 4, 2, 1), times the scale,
    components at or above the rank 0.  The expand: each output the sum over
    r ascending of the row's shrink times B.  In f32, each product rounded
    before its add (the card fuses them)."""
    t, h = x.shape
    v = 8 if h % 8 == 0 else 1
    step = LANES * v
    hp = -(-h // step) * step
    ad = adapter.long()
    live = ad >= 0
    safe = torch.where(live, ad, torch.zeros_like(ad))
    xs = torch.nn.functional.pad(x.float(), (0, hp - h))
    af = torch.nn.functional.pad(a.float(), (0, hp - h))
    acc = torch.zeros((t, a.shape[1], LANES), dtype=torch.float32, device=x.device)
    for k in range(0, hp, step):                           # a stride of the warp's lanes
        prod = xs[:, None, k:k + step] * af[:, :, k:k + step][safe]
        prod = prod.reshape(t, a.shape[1], LANES, v)
        for i in range(v):
            acc = acc + prod[..., i]
    lanes = torch.arange(LANES, device=x.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, lanes ^ o]
    s = acc[:, :, 0] * scale.float()[:, None]
    keep = torch.arange(a.shape[1], device=x.device)[None, :] < rank.long()[:, None]
    s = torch.where(keep & live[:, None], s, torch.zeros_like(s))
    wr = w[safe].float()                                   # [T, R, D] or [T, D, R]
    out = torch.zeros((t, wr.shape[2] if transposed else wr.shape[1]), dtype=torch.float32,
                      device=x.device)
    for r in range(a.shape[1]):
        out = out + s[:, r:r + 1] * (wr[:, r, :] if transposed else wr[:, :, r])
    return torch.where(live[:, None], out, torch.zeros_like(out))


def bgmv_rows(idx, num_adapters, rank, scaling):
    """``(adapter, rank, scale)`` of each row of a bgmv call (the kernel
    order's inputs): ids outside ``[0, L)`` dead."""
    live, safe = _live(idx, num_adapters)
    ad = torch.where(live, safe, -1)
    return ad, torch.full_like(ad, rank), torch.full(ad.shape, scaling, dtype=torch.float32,
                                                    device=ad.device)


def sgmv_rows(s, weight_indices, seq_lengths, lora_ranks, lora_scalings, num_adapters, rank):
    """``(adapter, rank, scale)`` of each of ``s`` packed rows of a sgmv call
    (the kernel order's inputs): rows past the sequences and ids outside
    ``[0, L)`` dead; ranks clamped to ``[0, rank]``."""
    ends = torch.cumsum(seq_lengths.long(), 0)
    seq = torch.searchsorted(ends, torch.arange(s, device=ends.device), right=True)
    in_seq = seq < ends.shape[0]
    adapter = weight_indices.long()[seq.clamp(max=ends.shape[0] - 1)]
    live, safe = _live(torch.where(in_seq, adapter, torch.full_like(adapter, -1)), num_adapters)
    return (torch.where(live, safe, -1), lora_ranks.long()[safe].clamp(0, rank),
            lora_scalings.float()[safe])


def _launch(name, x, a, w, transposed, ids, lens, ranks, scalings, scaling):
    """Shrink then expand on the card → ``[T, D]`` f32."""
    x, a, w = x.contiguous(), a.contiguous(), w.contiguous()
    t, h = x.shape
    l, r = a.shape[0], a.shape[1]
    d = w.shape[2] if transposed else w.shape[1]
    dev = x.device
    shrink = torch.empty((t, r), dtype=torch.float32, device=dev)
    row_adapter = torch.empty((t,), dtype=torch.int32, device=dev)
    out = torch.empty((t, d), dtype=torch.float32, device=dev)
    lib = cuda_lib.load_library()
    stream = cuda_lib.stream_ptr(x)
    ptr = lambda v: 0 if v is None else v.data_ptr()   # noqa: E731
    nseq = 0 if lens is None else lens.shape[0]
    bf16 = lambda v: int(v.dtype == torch.bfloat16)   # noqa: E731
    cuda_lib.check(lib, lib.lora_shrink_launch(
        x.data_ptr(), a.data_ptr(), ids.data_ptr(), ptr(lens), ptr(ranks), ptr(scalings),
        float(scaling), nseq, t, h, l, r, bf16(x), bf16(a), shrink.data_ptr(),
        row_adapter.data_ptr(), stream), name)
    cuda_lib.check(lib, lib.lora_expand_launch(
        shrink.data_ptr(), row_adapter.data_ptr(), w.data_ptr(), t, d, r, int(transposed),
        bf16(w), out.data_ptr(), stream), name)
    return out


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


@counted
def bgmv_fused(x, a, b=None, idx=None, *, bt=None, scaling: float = 1.0):
    """Fused per-token LoRA delta ``scaling · (x[t] @ A[idx_t]ᵀ) @ B[idx_t]ᵀ``
    (K13a): x ``[T, H]``, a ``[L, R, H]``, b ``[L, D, R]`` or ``bt [L, R,
    D]``, idx ``[T]`` → ``[T, D]`` f32; an id outside ``[0, L)`` gives 0.
    CUDA tensors launch ``csrc/lora.cu`` (two launches, counted once); CPU
    tensors take :func:`bgmv_fused_plain`."""
    w = b if bt is None else bt
    if not on_cuda(x, a, w, idx):
        return bgmv_fused_plain(x, a, b, idx, bt=bt, scaling=scaling)
    _check("bgmv_fused", x, a, w, bt is not None)
    if idx.shape != (x.shape[0],):
        raise ValueError(f"bgmv_fused takes idx [{x.shape[0]}], got {tuple(idx.shape)}")
    out = _launch("bgmv_fused", x, a, w, bt is not None, _int32(idx), None, None, None, scaling)
    bgmv_fused.launches += 1
    return out


@counted
def sgmv_fused(x, a, b, weight_indices, seq_lengths, lora_ranks, lora_scalings):
    """Fused per-sequence LoRA delta over packed varlen rows (K13b): x ``[S,
    H]`` (sequences contiguous, ``Σ seq_lengths ≤ S``; rows past them give
    0), a ``[L, R, H]``, b ``[L, D, R]``, weight_indices / seq_lengths
    ``[nseq]``, lora_ranks / lora_scalings ``[L]`` → ``[S, D]`` f32.  CUDA
    tensors launch ``csrc/lora.cu`` (two launches, counted once; a row finds
    its sequence by a scan of the lengths in the shrink: no prefix-sum
    launch, no host sync); CPU tensors take :func:`sgmv_fused_plain`."""
    args = (weight_indices, seq_lengths, lora_ranks, lora_scalings)
    if not on_cuda(x, a, b, *args):
        return sgmv_fused_plain(x, a, b, *args)
    _check("sgmv_fused", x, a, b, False)
    nseq, l = weight_indices.shape[0], a.shape[0]
    if nseq == 0 or seq_lengths.shape != (nseq,) or lora_ranks.shape != (l,) \
            or lora_scalings.shape != (l,):
        raise ValueError(f"sgmv_fused takes weight_indices and seq_lengths [nseq > 0] and "
                         f"lora_ranks and lora_scalings [{l}], got "
                         f"{[tuple(t.shape) for t in args]}")
    out = _launch("sgmv_fused", x, a, b, False, _int32(weight_indices), _int32(seq_lengths),
                  _int32(lora_ranks), lora_scalings.float().contiguous(), 1.0)
    sgmv_fused.launches += 1
    return out
