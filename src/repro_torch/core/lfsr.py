"""16-bit Fibonacci LFSR and the stateless counter draw.

Bit-exact with the Wenquxing 22A hardware PRNG (x^16 + x^14 + x^13 +
x^11 + 1, period 65535; state 0 is absorbing and never produced by
:func:`seed`).  Every function is vectorized over a tensor of per-lane
16-bit states held in integer lanes with the high bits zero.

:func:`counter_hash` is the stateless draw the in-kernel encode uses:
the CUDA kernel (``kernels/csrc/snn_infer.cu``) computes it in wrapping
``uint32_t`` arithmetic; here it is computed on ``int64`` values in
``[0, 2**32)``, with every product split so that it stays below 2**63.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitpack import MASK32

# Feedback taps as right-shift amounts in the Fibonacci form
# (tap t of the polynomial reads register bit 16 - t).
_TAP_SHIFTS = (0, 2, 3, 5)  # taps 16, 14, 13, 11

LFSR_PERIOD = (1 << 16) - 1

# The constants of the counter draw; the CUDA kernel must use EXACTLY
# these (PHI32 is the 32-bit golden ratio, 0x9E37 its 16-bit truncation).
PHI32 = 0x9E3779B9
_WEYL_IDX = 0x85EBCA6B     # odd, decorrelates the lane axis from time
_MIX1 = 0x7FEB352D         # xorshift-multiply finalizer ("lowbias32")
_MIX2 = 0x846CA68B


def u32(x, device=None) -> torch.Tensor:
    """Python ints or an integer tensor -> int64 values mod 2**32.

    Negative int32 values (bit-cast seeds) map to their u32 pattern.
    """
    t = torch.as_tensor(x, dtype=torch.int64, device=device)
    return t & MASK32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) and a constant
    ``c`` < 2**32.  ``c`` is split into 16-bit halves so no product
    reaches 2**63 (a full 32x32-bit product can)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def seed(base: int, n: int, device=None) -> torch.Tensor:
    """``n`` distinct nonzero 16-bit LFSR states from ``base`` (int32[n]).

    A Weyl sequence on the odd constant 0x9E37 decorrelates the lanes;
    0 maps to 0xACE1 to avoid the absorbing state.
    """
    idx = torch.arange(n, dtype=torch.int64, device=device)
    s = ((base & 0xFFFF) + idx * 0x9E37) & 0xFFFF
    return torch.where(s == 0, 0xACE1, s).to(torch.int32)


def step(state: torch.Tensor) -> torch.Tensor:
    """Advance every lane one LFSR step (same shape and dtype)."""
    s = state.to(torch.int64)
    fb = torch.zeros_like(s)
    for sh in _TAP_SHIFTS:
        fb = fb ^ (s >> sh)
    fb = fb & 1
    return (((s >> 1) | (fb << 15)) & 0xFFFF).to(state.dtype)


def counter_hash(seed, cycle, idx, device=None) -> torch.Tensor:
    """Stateless uint32 draw for (seed, cycle, lane) triples.

    A Weyl sequence over two axes (``cycle`` steps by :data:`PHI32`,
    ``idx`` by another odd constant), finalized with an xorshift-multiply
    mix, in wrapping u32 arithmetic.  All three arguments broadcast.
    Returns int64 values in [0, 2**32).  The encode path fires a spike
    iff ``hash & 0xFF < intensity`` (P = intensity / 256).
    """
    s, c, i = (u32(x, device) for x in (seed, cycle, idx))
    h = (s + mul32(c, PHI32) + mul32(i, _WEYL_IDX)) & MASK32
    h = h ^ (h >> 16)
    h = mul32(h, _MIX1)
    h = h ^ (h >> 15)
    h = mul32(h, _MIX2)
    return h ^ (h >> 16)


def draw10(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One LTD draw per lane: advance the LFSR, return (new_state, x).

    ``x`` is the low 10 bits of the new state, in [0, 1023].
    """
    new = step(state)
    return new, new & 0x3FF
