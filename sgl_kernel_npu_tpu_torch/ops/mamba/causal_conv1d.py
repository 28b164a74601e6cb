"""Causal depthwise conv1d for Mamba-style layers (Qwen3-Next's GDN input).

Counterpart of ``sgl_kernel_npu_tpu/ops/mamba/causal_conv1d.py``
(``causal_conv1d_fn``, ``causal_conv1d_update``): the conv width is tiny
(4), so the convolution is W shifted multiply-adds in f32, as JAX's; the
decode side reads and writes a pool of conv states by request slot
(``conv_state_indices``; ``pad_slot_id`` rows neither read nor write it).
Where JAX returns new pools, the port writes their rows in place and
returns them.
"""

from __future__ import annotations

import torch

PAD_SLOT_ID = -1


def _act(out: torch.Tensor, activation) -> torch.Tensor:
    if activation in ("silu", "swish", True):
        return out * torch.sigmoid(out)
    if activation in (None, False):
        return out
    raise NotImplementedError(f"activation must be None or silu/swish, got {activation}")


def causal_conv1d_fn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                     initial_states: torch.Tensor | None = None,
                     return_final_states: bool = False, activation: str | None = "silu"):
    """Prefill conv: ``x [B, D, T]``, ``weight [D, W]``, ``initial_states
    [B, D, W - 1]`` (zeros when None) → ``out [B, D, T]`` in x's type, or
    ``(out, final_states [B, D, W - 1])``."""
    b, d, t = x.shape
    w = weight.shape[1]
    xf = x.float()
    prefix = (torch.zeros((b, d, w - 1), dtype=torch.float32, device=x.device)
              if initial_states is None else initial_states.float())
    xp = torch.cat([prefix, xf], dim=-1)                    # [B, D, T + W - 1]
    wf = weight.float()
    out = torch.zeros((b, d, t), dtype=torch.float32, device=x.device)
    for i in range(w):
        out = out + wf[None, :, i : i + 1] * xp[:, :, i : i + t]
    if bias is not None:
        out = out + bias.float()[None, :, None]
    out = _act(out, activation).to(x.dtype)
    if return_final_states:
        return out, xp[:, :, xp.shape[-1] - (w - 1):].to(x.dtype)
    return out


def causal_conv1d_update(x: torch.Tensor, conv_state: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor | None = None, activation=None,
                         conv_state_indices: torch.Tensor | None = None,
                         num_accepted_tokens: torch.Tensor | None = None,
                         intermediate_conv_window: torch.Tensor | None = None,
                         pad_slot_id: int = PAD_SLOT_ID):
    """Decode conv over a state pool: ``x [B, D]`` or ``[B, D, S]``,
    ``conv_state [P, D, state_len]``, ``conv_state_indices [B]`` →
    ``(out, conv_state)``, or ``(out, conv_state, intermediate_conv_window)``
    when the window ``[P, S_prev, D, state_len]`` is given.

    MTP: the previous step saved the conv window after each draft token in
    ``intermediate_conv_window``; with ``num_accepted_tokens`` this step
    resumes from the window of the last accepted one and records fresh
    windows a token (zeros past S) for the next round."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[:, :, None]
    b, d, s = x.shape
    w = weight.shape[1]
    pool, _, state_len = conv_state.shape
    dev = conv_state.device
    idx = (torch.arange(b, device=dev) if conv_state_indices is None
           else conv_state_indices.to(device=dev, dtype=torch.long))
    valid = idx != pad_slot_id
    safe = torch.where(valid, idx, 0).clamp(0, pool - 1)
    if num_accepted_tokens is not None and intermediate_conv_window is not None:
        off = (num_accepted_tokens.to(device=dev, dtype=torch.long) - 1).clamp(
            0, intermediate_conv_window.shape[1] - 1)
        state = intermediate_conv_window[safe, off]           # [B, D, state_len]
    else:
        state = conv_state.index_select(0, safe)
    state = torch.where(valid[:, None, None], state.float(), 0.0)
    window = torch.cat([state, x.float()], dim=-1)            # [B, D, state_len + S]
    wf = weight.float()
    tail = window[:, :, window.shape[-1] - (s + w - 1):]
    out = torch.zeros((b, d, s), dtype=torch.float32, device=x.device)
    for i in range(w):
        out = out + wf[None, :, i : i + 1] * tail[:, :, i : i + s]
    if bias is not None:
        out = out + bias.float()[None, :, None]
    out = _act(out, activation).to(x.dtype)
    keep = valid & (idx >= 0) & (idx < pool)
    rows = idx[keep]
    conv_state.index_copy_(0, rows, window[keep, :, window.shape[-1] - state_len:]
                           .to(conv_state.dtype))
    out = out[:, :, 0] if squeeze else out
    if intermediate_conv_window is None:
        return out, conv_state
    # the window ending after token j (inclusive), zeros past S
    s_prev = intermediate_conv_window.shape[1]
    wins = torch.stack([window[:, :, j + 1 : j + 1 + state_len] for j in range(s)], dim=1)
    if s < s_prev:
        wins = torch.nn.functional.pad(wins, (0, 0, 0, 0, 0, s_prev - s))
    intermediate_conv_window.index_copy_(
        0, rows, wins[keep, :s_prev].to(intermediate_conv_window.dtype))
    return out, conv_state, intermediate_conv_window
