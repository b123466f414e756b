"""Rotary position embeddings (RoPE): split halves, not interleaved
pairs, rotated in float32 and cast back to the input's dtype."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies, float32[head_dim // 2]."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., T, D] (D even); positions: int[T] absolute positions."""
    inv = rope_freqs(x.shape[-1], theta, x.device)             # [D/2]
    ang = positions.to(torch.float32)[:, None] * inv[None, :]  # [T, D/2]
    return _rotate(x, ang)


def apply_rope_per_batch(x: torch.Tensor, positions: torch.Tensor,
                         theta: float = 10000.0) -> torch.Tensor:
    """Decode variant: x [B, H, 1, D], positions int[B] (per-sequence
    cache lengths — continuous batching)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)             # [D/2]
    ang = (positions.to(torch.float32)[:, None, None, None]
           * inv[None, None, None, :])                         # [B,1,1,D/2]
    return _rotate(x, ang)
