"""Streamlined Leaky Integrate-and-Fire (LIF), the paper's integer NU.

    V' = V + count            # integrate this cycle's valid-spike count
    fire = V' >= threshold
    V  <- 0           if fire            # hard reset
    V  <- max(V' - leak, 0)  otherwise   # single-subtraction leak, floor 0

All state is int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LIFParams(NamedTuple):
    threshold: int
    leak: int


def lif_params(threshold: int, leak: int) -> LIFParams:
    return LIFParams(int(threshold), int(leak))


def lif_step(v: torch.Tensor, count: torch.Tensor, p: LIFParams
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One streamlined-LIF cycle.

    v: int32[...] membrane potentials; count: int32[...] valid-spike
    counts (may include a teacher current, possibly negative).
    Returns (v_next int32, fired bool).
    """
    v_int = v + count
    fired = v_int >= p.threshold
    v_next = torch.where(fired, torch.zeros_like(v_int),
                         torch.clamp(v_int - p.leak, min=0))
    return v_next.to(torch.int32), fired


def lif_reset(n: int, device=None) -> torch.Tensor:
    """Fresh membrane state int32[n] (the paper resets V between
    samples)."""
    return torch.zeros((n,), dtype=torch.int32, device=device)
