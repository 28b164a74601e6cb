"""Differentiable dense causal MLA flash attention for training: plain
versions and the Hopper kernels (K14a forward, K14b dQ, K14c dK).

Counterpart of ``sgl_kernel_npu_tpu/ops/attention/mla_train.py``
(``mla_train_ref``, ``mla_flash_train``, whose ``jax.custom_vjp`` becomes a
``torch.autograd.Function``; the kernels are CUDA: ``csrc/mla_train.cu``).
Queries ``q_lat [B, S, H, L]`` ‖ ``q_pe [B, S, H, R]`` attend to the latent
keys of their batch row, ``k_lat [B, S, L]`` + ``k_pe [B, S, R]`` (shared by
the heads), token t to keys ``0 .. t``; V aliases ``k_lat``, so its gradient
collects the dK and the dV terms.  The log-sum-exp rides as ``[B, S, H]``
f32 (JAX's ``[rows, 128]`` lane broadcast is a TPU layout).

The plain versions follow the TPU kernels' arithmetic: f32 scores of the
inputs' products, P rounded to the inputs' dtype for the PV product while
the denominator sums the unrounded P, dS rounded to it before the dQ / dK
products, f32 sums rounded once.  They compute the whole ``[B, H, S, S]``
score matrix at once where the kernels walk key chunks (the online
softmax's rescaling rounds P at another scale: bf16 rounding-level
differences).  :func:`mla_flash_fwd_tiled_plain`,
:func:`mla_flash_bwd_dq_tiled_plain` and :func:`mla_flash_bwd_dk_tiled_plain`
walk the CUDA kernels' blocks, chunks and partial sums instead (tests only).

The CUDA kernels take bf16 with L = 512 and R = 64 (DeepSeek-V3's widths,
as the MLA serving kernels); f32 or other widths raise ``ValueError`` on the
card, where JAX takes any (ROADMAP §C).  JAX's tile arguments (``q_chunk``,
``k_chunk``, ``bwd_k_chunk``, ``interpret``) are dropped: the CUDA kernels
fix their own tiles.
"""

from __future__ import annotations

import functools

import torch

from sgl_kernel_npu_tpu_torch.ops.attention.decode_attention import D_NOPE, D_ROPE, NEG_INF
from sgl_kernel_npu_tpu_torch.utils import cuda_lib
from sgl_kernel_npu_tpu_torch.utils.common import cdiv, on_cuda
from sgl_kernel_npu_tpu_torch.utils.counters import counted

FWD_ROWS = 64    # flat rows of a K14a / K14b block, csrc/mla_train.cu k14a::M, k14b::M
FWD_KEYS = 64    # keys of a K14a chunk, k14a::CHUNK
DQ_KEYS = 32     # keys of a K14b chunk, k14b::KC
DK_KEYS = 64     # keys of a K14c chunk, k14c::KC
DK_ROWS = 32     # flat rows of a K14c tile, k14c::RT
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _causal(s: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))


def _scores(q_lat, q_pe, k_lat, k_pe, sm_scale):
    """Masked f32 scores ``[B, H, S, S]``: exact products of the inputs, f32
    sums, dead keys ``NEG_INF``."""
    s = torch.einsum("bqhl,bkl->bhqk", q_lat.float(), k_lat.float())
    s = (s + torch.einsum("bqhr,bkr->bhqk", q_pe.float(), k_pe.float())) * sm_scale
    return torch.where(_causal(q_lat.shape[1], q_lat.device), s, NEG_INF)


def mla_train_ref(q_lat, q_pe, k_lat, k_pe, sm_scale):
    """Golden dense causal MLA attention: ``[B, S, H, L]`` in f32 math, cast
    to q's dtype."""
    p = torch.softmax(_scores(q_lat, q_pe, k_lat, k_pe, sm_scale), dim=-1)
    return torch.einsum("bhqk,bkl->bqhl", p, k_lat.float()).to(q_lat.dtype)


def mla_flash_fwd_plain(q_lat, q_pe, k_lat, k_pe, sm_scale):
    """K14a's plain version → ``(out [B, S, H, L] in q's dtype, lse [B, S, H]
    f32)``."""
    s = _scores(q_lat, q_pe, k_lat, k_pe, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    acc = torch.einsum("bhqk,bkl->bhql", p.to(k_lat.dtype).float(), k_lat.float())
    out = (acc / l).permute(0, 2, 1, 3).to(q_lat.dtype)
    return out, (m + torch.log(l))[..., 0].permute(0, 2, 1).contiguous()


def mla_flash_fwd_tiled_plain(q_lat, q_pe, k_lat, k_pe, sm_scale):
    """The walk of the CUDA K14a on the CPU, for tests → ``(out, lse)`` as
    :func:`mla_flash_fwd_plain` (any widths; no caller on the main path).

    Blocks of ``FWD_ROWS`` consecutive flat rows ``f = t H + h`` of one batch
    row walk ``FWD_KEYS``-key chunks from key 0 up to the chunk that holds
    their last row's token; each row masks keys past its own token.  The
    scores are f32 products scaled by ``sm_scale · log2 e`` (rounded to f32
    once, as the kernel folds it), the online softmax is base 2 (masked keys
    weigh 0), P is rounded to k's dtype for the PV product while the
    denominator sums the unrounded P, ``out = acc / max(l, 1e-30)`` is
    rounded once and ``lse = (m + log2(max(l, 1e-30))) · ln 2``."""
    b, s, h, dl = q_lat.shape
    n = s * h
    blocks = cdiv(n, FWD_ROWS)
    rows = blocks * FWD_ROWS
    q = torch.cat([q_lat, q_pe], dim=-1).reshape(b, n, -1).float()
    q = torch.nn.functional.pad(q, (0, 0, 0, rows - n)).reshape(b, blocks, FWD_ROWS, -1)
    f = torch.arange(rows, device=q.device)
    tok = torch.where(f < n, f // h, -1).reshape(blocks, FWD_ROWS)
    last = (torch.clamp_max(torch.arange(blocks, device=q.device) * FWD_ROWS + FWD_ROWS, n)
            - 1) // h                                         # each block's last token
    k = torch.cat([k_lat, k_pe], dim=-1).float()
    scale2 = torch.tensor(sm_scale, dtype=torch.float32) * torch.tensor(LOG2E,
                                                                       dtype=torch.float32)
    m = torch.full((b, blocks, FWD_ROWS), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, blocks, FWD_ROWS, dl), dtype=torch.float32, device=q.device)
    for k0 in range(0, s, FWD_KEYS):
        kpos = torch.arange(k0, min(k0 + FWD_KEYS, s), device=q.device)
        sc = torch.einsum("bnrd,bcd->bnrc", q, k[:, k0:k0 + FWD_KEYS]) * scale2
        ok = kpos <= tok[..., None]
        sc = torch.where(ok, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(sc - m_new[..., None]), 0.0)
        pv = torch.einsum("bnrc,bcl->bnrl", p.to(k_lat.dtype).float(),
                          k_lat[:, k0:k0 + FWD_KEYS].float())
        walk = (k0 <= last)[None, :, None]                    # blocks still walking
        l = torch.where(walk, l * alpha + p.sum(dim=-1), l)
        acc = torch.where(walk[..., None], acc * alpha[..., None] + pv, acc)
        m = torch.where(walk, m_new, m)
    l = torch.clamp_min(l, 1e-30)
    out = (acc / l[..., None]).reshape(b, rows, dl)[:, :n].reshape(b, s, h, dl)
    lse = ((m + torch.log2(l)) * LN2).reshape(b, rows)[:, :n].reshape(b, s, h)
    return out.to(q_lat.dtype), lse


def _p_ds(q_lat, q_pe, k_lat, k_pe, do, lse, delta, sm_scale):
    """The backward's f32 ``P = exp(S - lse)`` (0 on dead keys) and ``dS = P
    (dP - delta) sm_scale`` rounded to the keys' dtype, ``[B, H, S, S]``."""
    s = _scores(q_lat, q_pe, k_lat, k_pe, sm_scale)
    live = _causal(q_lat.shape[1], q_lat.device)
    p = torch.where(live, torch.exp(s - lse.permute(0, 2, 1)[..., None]), 0.0)
    dp = torch.einsum("bqhl,bkl->bhqk", do.float(), k_lat.float())
    ds = p * (dp - delta.permute(0, 2, 1)[..., None]) * sm_scale
    return p, ds.to(k_lat.dtype).float()


def mla_flash_bwd_dq_plain(q_lat, q_pe, k_lat, k_pe, do, lse, delta, sm_scale):
    """K14b's plain version → ``(dq_lat, dq_pe)`` in q's dtypes; ``do`` in q's
    dtype, ``lse`` / ``delta`` ``[B, S, H]`` f32."""
    _, ds = _p_ds(q_lat, q_pe, k_lat, k_pe, do, lse, delta, sm_scale)
    dq_lat = torch.einsum("bhqk,bkl->bqhl", ds, k_lat.float())
    dq_pe = torch.einsum("bhqk,bkr->bqhr", ds, k_pe.float())
    return dq_lat.to(q_lat.dtype), dq_pe.to(q_pe.dtype)


def mla_flash_bwd_dk_plain(q_lat, q_pe, k_lat, k_pe, do, lse, delta, sm_scale):
    """K14c's plain version → ``(dk_lat, dk_pe)`` in k's dtypes: ``dk_lat =
    dSᵀ q_lat + Pᵀ dO`` (P rounded to k's dtype), ``dk_pe = dSᵀ q_pe``."""
    p, ds = _p_ds(q_lat, q_pe, k_lat, k_pe, do, lse, delta, sm_scale)
    pb = p.to(k_lat.dtype).float()
    dk_lat = (torch.einsum("bhqk,bqhl->bkl", ds, q_lat.float())
              + torch.einsum("bhqk,bqhl->bkl", pb, do.float()))
    dk_pe = torch.einsum("bhqk,bqhr->bkr", ds, q_pe.float())
    return dk_lat.to(k_lat.dtype), dk_pe.to(k_pe.dtype)


def _bwd_tiled_inputs(q_lat, q_pe, k_lat, k_pe, do, lse, delta, sm_scale):
    """The backward walks' f32 operands: ``q [B, S H, L + R]``, ``do [B, S H,
    L]``, the keys ``[B, S, L + R]``, ``lse · log2 e`` and delta ``[B, S H]``,
    and ``sm_scale · log2 e`` rounded to f32 once, as the kernels fold them."""
    b, s, h, _ = q_lat.shape
    q = torch.cat([q_lat, q_pe], dim=-1).reshape(b, s * h, -1).float()
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    lse2 = lse.reshape(b, s * h).float() * log2e
    scale2 = torch.tensor(sm_scale, dtype=torch.float32) * log2e
    return (q, do.reshape(b, s * h, -1).float(), torch.cat([k_lat, k_pe], dim=-1).float(),
            lse2, delta.reshape(b, s * h).float(), scale2)


def mla_flash_bwd_dq_tiled_plain(q_lat, q_pe, k_lat, k_pe, do, lse, delta, sm_scale):
    """The walk of the CUDA K14b on the CPU, for tests → ``(dq_lat, dq_pe)`` as
    :func:`mla_flash_bwd_dq_plain` (any widths; no caller on the main path).

    K14a's blocks (``FWD_ROWS`` consecutive flat rows ``f = t H + h`` of one
    batch row) walk ``DQ_KEYS``-key chunks from key 0 up to the chunk that
    holds their last row's token, each row masking keys past its own token.
    Per chunk: f32 scores over latent ‖ rope, ``P = 2^(S · sm_scale log2 e −
    lse · log2 e)`` (0 on dead keys), ``dS = P (dP − delta) sm_scale``
    rounded to k's dtype, ``dQ += dS K`` in f32 chunk after chunk; dQ is
    rounded once."""
    b, s, h, dl = q_lat.shape
    n = s * h
    blocks = cdiv(n, FWD_ROWS)
    rows = blocks * FWD_ROWS
    q, dof, k, lse2, dlt, scale2 = _bwd_tiled_inputs(q_lat, q_pe, k_lat, k_pe, do, lse, delta,
                                                     sm_scale)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, rows - n)).reshape(  # noqa: E731
        b, blocks, FWD_ROWS, -1)
    q, dof = pad(q), pad(dof)
    lse2, dlt = pad(lse2[..., None])[..., 0], pad(dlt[..., None])[..., 0]
    f = torch.arange(rows, device=q.device)
    tok = torch.where(f < n, f // h, -1).reshape(blocks, FWD_ROWS)
    last = (torch.clamp_max(torch.arange(blocks, device=q.device) * FWD_ROWS + FWD_ROWS, n)
            - 1) // h                                         # each block's last token
    acc = torch.zeros_like(q)
    for k0 in range(0, s, DQ_KEYS):
        kc = k[:, k0:k0 + DQ_KEYS]
        kpos = torch.arange(k0, k0 + kc.shape[1], device=q.device)
        sc = torch.einsum("bnrd,bcd->bnrc", q, kc)
        ok = kpos <= tok[..., None]
        p = torch.where(ok, torch.exp2(sc * scale2 - lse2[..., None]), 0.0)
        dp = torch.einsum("bnrl,bcl->bnrc", dof, kc[..., :dl])
        ds = (p * (dp - dlt[..., None]) * sm_scale).to(k_lat.dtype).float()
        walk = (k0 <= last)[None, :, None, None]              # blocks still walking
        acc = torch.where(walk, acc + torch.einsum("bnrc,bcd->bnrd", ds, kc), acc)
    acc = acc.reshape(b, rows, -1)[:, :n].reshape(b, s, h, -1)
    return acc[..., :dl].to(q_lat.dtype), acc[..., dl:].to(q_pe.dtype)


def dk_items(s: int, h: int, u: int) -> int:
    """K14c's items of a batch row at ``u`` bands a chunk's width: its flat
    rows form ``ts = cdiv(S H, DK_ROWS)`` tiles, cut into bands of ``L = 2 H
    / u`` tiles (key chunk c is seen by tiles ``2 H c ..``, a band's edge);
    band j is seen by chunks ``0 .. j // u``, one item each."""
    nb = cdiv(cdiv(s * h, DK_ROWS), 2 * h // u)
    return sum(j // u + 1 for j in range(nb))


def dk_bands(b: int, s: int, h: int, sms: int) -> int:
    """K14c's ``u``: the fewest bands a chunk's width (a divisor of 2 H) that
    give at least 4 items an SM over the batch, so that the last wave is
    short; else one tile a band."""
    for u in range(1, 2 * h + 1):
        if 2 * h % u == 0 and b * dk_items(s, h, u) >= 4 * sms:
            return u
    return 2 * h


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def mla_flash_bwd_dk_tiled_plain(q_lat, q_pe, k_lat, k_pe, do, lse, delta, sm_scale, u):
    """The walk of the CUDA K14c on the CPU, for tests → ``(dk_lat, dk_pe)`` as
    :func:`mla_flash_bwd_dk_plain` (any widths; no caller on the main path).

    A batch row's flat rows form tiles of ``DK_ROWS``, cut into bands of ``2
    H / u`` tiles (``u`` divides 2 H); key chunk c (``DK_KEYS`` keys) is seen
    by the bands from ``u c`` on, each (band, chunk) an item.  Per chunk:
    ``Sᵀ`` in f32 over latent ‖ rope, ``Pᵀ = 2^(Sᵀ · sm_scale log2 e − lse ·
    log2 e)`` (0 on dead keys and rows), ``dSᵀ = Pᵀ (dPᵀ − delta) sm_scale``
    rounded to k's dtype and Pᵀ rounded for the ``Pᵀ dO`` term; each item
    adds its band's ``dSᵀ Q + Pᵀ dO`` into an f32 partial, and a chunk's
    partials are added in band order from 0 and rounded once."""
    b, s, h, dl = q_lat.shape
    n = s * h
    if u < 1 or 2 * h % u:
        raise ValueError(f"K14c's bands take a divisor of 2 H = {2 * h}; got {u}")
    q, dof, k, lse2, dlt, scale2 = _bwd_tiled_inputs(q_lat, q_pe, k_lat, k_pe, do, lse, delta,
                                                     sm_scale)
    band = 2 * h // u * DK_ROWS                                 # flat rows a band
    dk = torch.zeros_like(k)
    for bi in range(b):
        for c in range(cdiv(s, DK_KEYS)):
            k0, r0 = DK_KEYS * c, DK_KEYS * c * h               # r0: band u c's first row
            kc = k[bi, k0:k0 + DK_KEYS]
            kpos = torch.arange(k0, k0 + kc.shape[0], device=q.device)
            f = torch.arange(r0, n, device=q.device)
            st = torch.einsum("cd,rd->cr", kc, q[bi, r0:])
            ok = kpos[:, None] <= (f // h)[None]
            pt = torch.where(ok, torch.exp2(st * scale2 - lse2[bi, r0:]), 0.0)
            dpt = torch.einsum("cl,rl->cr", kc[:, :dl], dof[bi, r0:])
            dst = (pt * (dpt - dlt[bi, r0:]) * sm_scale).to(k_lat.dtype).float()
            pt = pt.to(k_lat.dtype).float()
            part = torch.zeros_like(kc)
            for lo in range(0, n - r0, band):
                rows = slice(lo, lo + band)
                item = dst[:, rows] @ q[bi, r0:][rows]
                item[:, :dl] += pt[:, rows] @ dof[bi, r0:][rows]
                part = part + item
            dk[bi, k0:k0 + DK_KEYS] = part
    return dk[..., :dl].to(k_lat.dtype), dk[..., dl:].to(k_pe.dtype)


def check_train_operands(q_lat, q_pe, k_lat, k_pe, do=None, lse=None, delta=None) -> None:
    """What the K14 kernels take: bf16 ``q_lat [B, S, H, 512]``, ``q_pe [B, S,
    H, 64]``, ``k_lat [B, S, 512]``, ``k_pe [B, S, 64]`` (and ``do`` like
    ``q_lat``, f32 ``lse`` / ``delta [B, S, H]``), all contiguous.  Raises
    ``ValueError`` on anything else: the JAX kernels take f32 and any width,
    the port's only these (ROADMAP §C)."""
    bf16 = [t for t in (q_lat, q_pe, k_lat, k_pe, do) if t is not None]
    if any(t.dtype != torch.bfloat16 for t in bf16):
        raise ValueError("the CUDA MLA training kernels take bf16 q, k and dO, got "
                         f"{[t.dtype for t in bf16]} (f32 runs on the CPU only; ROADMAP §C)")
    b, s, h, dl = q_lat.shape
    want = {"q_pe": (b, s, h, D_ROPE), "k_lat": (b, s, D_NOPE), "k_pe": (b, s, D_ROPE),
            "do": (b, s, h, D_NOPE)}
    got = {"q_pe": q_pe, "k_lat": k_lat, "k_pe": k_pe, "do": do}
    if dl != D_NOPE or any(t is not None and tuple(t.shape) != want[k] for k, t in got.items()):
        raise ValueError(f"the CUDA MLA training kernels take latent {D_NOPE} and rope "
                         f"{D_ROPE}: q_lat [B, S, H, 512], q_pe [B, S, H, 64], k_lat [B, S, "
                         f"512], k_pe [B, S, 64]; got {tuple(q_lat.shape)}, "
                         f"{tuple(q_pe.shape)}, {tuple(k_lat.shape)}, {tuple(k_pe.shape)} "
                         "(ROADMAP §C)")
    for t in (lse, delta):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (b, s, h)):
            raise ValueError(f"lse and delta are f32 [B, S, H], got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in bf16 + [t for t in (lse, delta) if t is not None]):
        raise ValueError("the CUDA MLA training kernels take contiguous tensors")


@counted
def mla_flash_fwd(q_lat, q_pe, k_lat, k_pe, sm_scale):
    """K14a → ``(out [B, S, H, 512], lse [B, S, H] f32)``.  CUDA tensors
    launch ``csrc/mla_train.cu``; CPU tensors take :func:`mla_flash_fwd_plain`."""
    if not on_cuda(q_lat, q_pe, k_lat, k_pe):
        return mla_flash_fwd_plain(q_lat, q_pe, k_lat, k_pe, sm_scale)
    check_train_operands(q_lat, q_pe, k_lat, k_pe)
    b, s, h, _ = q_lat.shape
    out = torch.empty_like(q_lat)
    lse = torch.empty((b, s, h), dtype=torch.float32, device=q_lat.device)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.mla_train_fwd_launch(
        q_lat.data_ptr(), q_pe.data_ptr(), k_lat.data_ptr(), k_pe.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, float(sm_scale), cuda_lib.stream_ptr(q_lat)), "mla_flash_fwd")
    mla_flash_fwd.launches += 1
    return out, lse


@counted
def mla_flash_bwd_dq(q_lat, q_pe, k_lat, k_pe, do, lse, delta, sm_scale):
    """K14b → ``(dq_lat, dq_pe)``.  CUDA tensors launch ``csrc/mla_train.cu``;
    CPU tensors take :func:`mla_flash_bwd_dq_plain`."""
    if not on_cuda(q_lat, q_pe, k_lat, k_pe, do, lse, delta):
        return mla_flash_bwd_dq_plain(q_lat, q_pe, k_lat, k_pe, do, lse, delta, sm_scale)
    check_train_operands(q_lat, q_pe, k_lat, k_pe, do, lse, delta)
    b, s, h, _ = q_lat.shape
    dq_lat, dq_pe = torch.empty_like(q_lat), torch.empty_like(q_pe)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.mla_train_bwd_dq_launch(
        q_lat.data_ptr(), q_pe.data_ptr(), k_lat.data_ptr(), k_pe.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq_lat.data_ptr(), dq_pe.data_ptr(), b, s, h,
        float(sm_scale), cuda_lib.stream_ptr(q_lat)), "mla_flash_bwd_dq")
    mla_flash_bwd_dq.launches += 1
    return dq_lat, dq_pe


@counted
def mla_flash_bwd_dk(q_lat, q_pe, k_lat, k_pe, do, lse, delta, sm_scale):
    """K14c → ``(dk_lat, dk_pe)``: an f32 partial a (band of rows, key
    chunk) item (:func:`dk_bands`, :func:`dk_items`), a chunk's summed in
    band order by the kernel's second pass.  CUDA tensors launch
    ``csrc/mla_train.cu``; CPU tensors take :func:`mla_flash_bwd_dk_plain`."""
    if not on_cuda(q_lat, q_pe, k_lat, k_pe, do, lse, delta):
        return mla_flash_bwd_dk_plain(q_lat, q_pe, k_lat, k_pe, do, lse, delta, sm_scale)
    check_train_operands(q_lat, q_pe, k_lat, k_pe, do, lse, delta)
    b, s, h, _ = q_lat.shape
    u = dk_bands(b, s, h, _sm_count(q_lat.device.index))
    part = torch.empty((b * dk_items(s, h, u), DK_KEYS, D_NOPE + D_ROPE), dtype=torch.float32,
                       device=q_lat.device)
    dk_lat, dk_pe = torch.empty_like(k_lat), torch.empty_like(k_pe)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib, lib.mla_train_bwd_dk_launch(
        q_lat.data_ptr(), q_pe.data_ptr(), k_lat.data_ptr(), k_pe.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), part.data_ptr(), dk_lat.data_ptr(), dk_pe.data_ptr(),
        b, s, h, u, float(sm_scale), cuda_lib.stream_ptr(q_lat)), "mla_flash_bwd_dk")
    mla_flash_bwd_dk.launches += 1
    return dk_lat, dk_pe


class _MlaFlash(torch.autograd.Function):
    """JAX's ``_flash`` ``custom_vjp``: the forward saves ``(q_lat, q_pe,
    k_lat, k_pe, out, lse)``, the backward runs dQ and dK."""

    @staticmethod
    def forward(ctx, q_lat, q_pe, k_lat, k_pe, sm_scale, plain):
        fwd = mla_flash_fwd_plain if plain else mla_flash_fwd
        out, lse = fwd(q_lat, q_pe, k_lat, k_pe, sm_scale)
        ctx.save_for_backward(q_lat, q_pe, k_lat, k_pe, out, lse)
        ctx.sm_scale, ctx.plain = sm_scale, plain
        return out

    @staticmethod
    def backward(ctx, g):
        q_lat, q_pe, k_lat, k_pe, out, lse = ctx.saved_tensors
        do = g.to(q_lat.dtype).contiguous()
        # delta = rowsum(dO o O) in f32 from the f32 gradient (JAX :267-270)
        delta = (g.float() * out.float()).sum(dim=-1)
        dq, dk = ((mla_flash_bwd_dq_plain, mla_flash_bwd_dk_plain) if ctx.plain
                  else (mla_flash_bwd_dq, mla_flash_bwd_dk))
        args = (q_lat, q_pe, k_lat, k_pe, do, lse, delta, ctx.sm_scale)
        return (*dq(*args), *dk(*args), None, None)


def mla_flash_train(q_lat, q_pe, k_lat, k_pe, sm_scale, *, plain: bool = False):
    """Differentiable dense causal MLA flash attention → ``[B, S, H, L]``.

    The forward is K14a (saving the LSE), the backward K14b (dQ) and K14c
    (dK, V = ``k_lat``) on CUDA tensors; CPU tensors, or ``plain=True``, run
    the plain versions."""
    return _MlaFlash.apply(q_lat.contiguous(), q_pe.contiguous(), k_lat.contiguous(),
                           k_pe.contiguous(), sm_scale, plain)
